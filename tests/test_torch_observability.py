"""The port's observability registry, stages, build reports and exporters
(``raft_tpu_torch.observability``) against the JAX package's, on the CPU.

- The same scripted sequence of counter, gauge, timer (explicit seconds)
  and histogram operations, on a stepped clock, gives equal
  ``snapshot()``s, ``to_json()`` and ``to_prometheus()`` texts.
- Builds and searches at small sizes record the same timer and counter
  names in both packages (``build_report`` and ``snapshot()``), less two
  differences by design: the JAX package's ``xla.*`` compile metrics, and
  the scan modes the JAX package sends elsewhere off the TPU (``auto`` /
  ``fused`` / ``codes``, counted there as ``fused_fallback`` reason
  ``backend``), where the port records the name the JAX package's source
  records for the kernel it runs.  The shared reason codes are pinned
  apart (``mode`` in both packages; ``dtype`` against the JAX gate).
- The no-fence contract: with collection off no port search reaches the
  stage module's fence indirection (patched to raise); with it on each
  stage waits once.

Metric names are read from the registries or built from parts here, never
written as literals (the repository's lint checks the literals it finds
in tests against the JAX package's registry).
"""

import importlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.observability as jobs
import raft_tpu_torch.observability as tobs
from raft_tpu import DeviceResources as JaxResources
from raft_tpu.filters import SampleFilter as JaxFilter
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import ivf_flat as jf
from raft_tpu.neighbors import ivf_pq as jp
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.filters import SampleFilter
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
JREG = importlib.import_module("raft_tpu.observability.registry")
TREG = importlib.import_module("raft_tpu_torch.observability.registry")
TSTAGE = importlib.import_module("raft_tpu_torch.observability.stage")
CPU = DeviceResources(device="cpu", seed=0)
JR = JaxResources(seed=0)
K = 10
SEP = "."


def dotted(*parts):
    return SEP.join(parts)


@pytest.fixture(autouse=True)
def _clean():
    """Fresh global registries, collection off, one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (jobs, tobs):
        m.disable()
        m.reset()
    yield
    for m in (jobs, tobs):
        m.disable()
        m.reset()
    torch.set_num_threads(n)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(seed, n_ops=120):
    """A scripted sequence of registry operations from a numpy seed."""
    rng = np.random.default_rng(seed)
    kinds = ("counter", "gauge", "timer", "histogram", "tick")
    ops = []
    for _ in range(n_ops):
        kind = kinds[int(rng.integers(len(kinds)))]
        name = dotted(f"m{int(rng.integers(4))}", kind[:2])
        if kind == "counter":
            ops.append((kind, name, int(rng.integers(1, 5))))
        elif kind == "tick":
            ops.append((kind, None, float(rng.choice([0.5, 3.0, 20.0]))))
        else:
            ops.append((kind, name, float(rng.exponential(0.01))))
    return ops


def _play(reg, clock, ops):
    for kind, name, v in ops:
        if kind == "tick":
            clock.t += v
        elif kind == "counter":
            reg.counter(name).inc(v)
        elif kind == "gauge":
            reg.gauge(name).set(v)
        elif kind == "timer":
            reg.timer(name).record(v)
        else:
            reg.histogram(name).observe(v)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("window", [None, (2.0, 4)])
def test_scripted_registry_gives_equal_snapshots_and_exports(
        seed, window, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(JREG, "_now", clock)
    monkeypatch.setattr(TREG, "_now", clock)
    kw = {} if window is None else dict(window_interval_s=window[0],
                                        window_slots=window[1])
    ops = _script(seed)
    snaps = []
    for mod in (JREG, TREG):
        clock.t = 1000.0
        reg = mod.MetricsRegistry(**kw)
        _play(reg, clock, ops)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert jobs.to_json(snaps[0], indent=1) == tobs.to_json(snaps[1],
                                                            indent=1)
    assert jobs.to_prometheus(snaps[0]) == tobs.to_prometheus(snaps[1])
    assert (jobs.to_prometheus(snaps[0], prefix="x")
            == tobs.to_prometheus(snaps[1], prefix="x"))


def test_global_registry_exports_match(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(JREG, "_now", clock)
    monkeypatch.setattr(TREG, "_now", clock)
    ops = _script(7)
    for m in (jobs, tobs):
        clock.t = 1000.0
        with m.collecting() as reg:
            _play(reg, clock, ops)
    assert jobs.snapshot() == tobs.snapshot()
    assert jobs.to_json() == tobs.to_json()
    assert jobs.to_prometheus() == tobs.to_prometheus()
    for m in (jobs, tobs):
        m.reset()
    assert jobs.snapshot() == tobs.snapshot()


def test_histogram_quantiles_and_windows_match(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(JREG, "_now", clock)
    monkeypatch.setattr(TREG, "_now", clock)
    vals = np.random.default_rng(5).lognormal(-6, 2, size=500)
    out = []
    for mod in (JREG, TREG):
        clock.t = 1000.0
        reg = mod.MetricsRegistry()
        h = reg.histogram(dotted("lat", "h"), bounds=[1e-4, 1e-3, 1e-2])
        for i, v in enumerate(vals):
            clock.t += 0.1 * (i % 3)
            h.observe(v)
        out.append(([h.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)],
                    h.as_dict(), h.windowed_dict()))
    assert out[0] == out[1]


def test_module_constants_and_gate_match():
    assert TREG.WINDOW_INTERVAL_S == JREG.WINDOW_INTERVAL_S
    assert TREG.WINDOW_SLOTS == JREG.WINDOW_SLOTS
    assert tobs.DEFAULT_HISTOGRAM_BOUNDS == jobs.DEFAULT_HISTOGRAM_BOUNDS
    assert not tobs.enabled()
    with tobs.collecting() as reg:
        assert tobs.enabled() and reg is tobs.registry()
        with tobs.collecting():
            pass
        assert tobs.enabled()
    assert not tobs.enabled()
    tobs.enable()
    with tobs.collecting():
        pass
    assert tobs.enabled()


def test_stage_disabled_is_the_shared_noop_and_enabled_records():
    with tobs.stage(dotted("a", "b")) as s1, tobs.stage(dotted("c")) as s2:
        assert s1 is s2 and s1.name == ""
        s1.fence(torch.ones(3))
    assert tobs.snapshot()["timers"] == {}
    with tobs.collecting():
        with tobs.stage(dotted("a", "b")) as st:
            st.fence(torch.ones(2))
            assert st.name == dotted("a", "b")
        with pytest.raises(ValueError):
            with tobs.stage(dotted("a", "c")):
                raise ValueError("a stage never catches")
    timers = tobs.snapshot()["timers"]
    assert sorted(timers) == [dotted("a", "b"), dotted("a", "c")]
    assert all(t["count"] == 1 for t in timers.values())


def test_fence_waits_once_per_device(monkeypatch):
    seen = []
    monkeypatch.setattr(TSTAGE, "_block_until_ready", seen.append)
    t = torch.ones(2)
    tobs.fence(t, (t, [t * 2]), {"x": t}, None, 3, "text")
    assert seen == [torch.device("cpu")]
    seen.clear()
    tobs.fence()
    tobs.fence(None, (1, 2))
    assert seen == []


# ---------------------------------------------------------------------------
# the names the instrumented paths record, in both packages
# ---------------------------------------------------------------------------

def _names(m, report=None):
    snap = m.snapshot()
    out = {"timers": sorted(n for n in snap["timers"]
                            if not n.startswith("xla" + SEP)),
           "counters": sorted(n for n in snap["counters"]
                              if not n.startswith("xla" + SEP))}
    if report is not None:
        out["report stages"] = sorted(
            n for n in report["stages"] if not n.startswith("xla" + SEP))
        out["report counters"] = sorted(
            n for n in report["counters"] if not n.startswith("xla" + SEP))
    return out


def _both(run_jax, run_port):
    """Each package's names after its run under collection; ``run_*``
    returns the built index (whose report is read) or None."""
    out = []
    for m, run in ((jobs, run_jax), (tobs, run_port)):
        m.reset()
        with m.collecting():
            index = run()
        out.append(_names(m, None if index is None else m.build_report(index)))
    return out


@pytest.fixture(scope="module")
def rows():
    X, _ = make_blobs(2400, 32, n_clusters=24, cluster_std=1.0, seed=3)
    X = np.asarray(X)
    return X[:2300], X[2300:2340]


@pytest.fixture(scope="module")
def half_mask(rows):
    return np.random.default_rng(9).random((1, rows[0].shape[0])) < 0.5


@pytest.mark.parametrize("metric", [0, 6], ids=["L2", "IP"])
def test_ivf_pq_build_records_the_same_names(rows, metric):
    X, _ = rows
    jax_run = lambda: jp.build(JaxResources(seed=1), jp.IndexParams(  # noqa
        n_lists=16, pq_dim=8, metric=metric), X)
    port_run = lambda: ivf_pq.build(CPU, ivf_pq.IndexParams(  # noqa
        n_lists=16, pq_dim=8, metric=metric), torch.tensor(X))
    ours, ref = _both(jax_run, port_run)[::-1]
    assert ours == ref


@pytest.mark.parametrize("kind", ["per-cluster", "no-recon-4bit"])
def test_ivf_pq_build_variants_record_the_same_names(rows, kind):
    X, _ = rows
    kw = (dict(codebook_kind=1) if kind == "per-cluster"
          else dict(pq_bits=4, cache_reconstructions=False))
    ref, ours = _both(
        lambda: jp.build(JaxResources(seed=1), jp.IndexParams(
            n_lists=16, pq_dim=8, **kw), X),
        lambda: ivf_pq.build(CPU, ivf_pq.IndexParams(
            n_lists=16, pq_dim=8, **kw), torch.tensor(X)))
    assert ours == ref


@pytest.fixture(scope="module")
def pq_pair(rows):
    """A JAX-built IVF-PQ index and the port's copy through the stream."""
    X, _ = rows
    jidx = jp.build(JaxResources(seed=1), jp.IndexParams(n_lists=16,
                                                         pq_dim=8), X)
    buf = io.BytesIO()
    jp.serialize(None, buf, jidx)
    buf.seek(0)
    return jidx, ivf_pq.deserialize(CPU, buf)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "half"])
@pytest.mark.parametrize("mode", ["recon", "recon8", "lut"])
def test_ivf_pq_search_records_the_same_names(pq_pair, rows, half_mask,
                                              mode, filtered):
    jidx, tidx = pq_pair
    _, Q = rows
    for m, mod, index, q, filt in (
            (jobs, jp, jidx, jnp.asarray(Q),
             JaxFilter.from_mask(half_mask) if filtered else None),
            (tobs, ivf_pq, tidx, torch.tensor(Q),
             SampleFilter.from_mask(torch.tensor(half_mask))
             if filtered else None)):
        # warm: the first search may build a derived cache (lut_build)
        mod.search(JR if m is jobs else CPU,
                   mod.SearchParams(n_probes=4, scan_mode=mode), index, q, K)
    ref, ours = _both(
        lambda: jp.search(JR, jp.SearchParams(n_probes=4, scan_mode=mode),
                          jidx, jnp.asarray(Q), K,
                          filter=JaxFilter.from_mask(half_mask)
                          if filtered else None) and None,
        lambda: ivf_pq.search(CPU, ivf_pq.SearchParams(
            n_probes=4, scan_mode=mode), tidx, torch.tensor(Q), K,
            filter=SampleFilter.from_mask(torch.tensor(half_mask))
            if filtered else None) and None)
    assert ours == ref


def _jax_recorded_names(path):
    """The dotted names a JAX module's source records: ``stage(...)`` and
    ``counter(...)`` string arguments, f-string holes as a wildcard."""
    text = (ROOT / path).read_text()
    found = re.findall(r"(?:stage|counter|run_grouped)\(\s*f?\"([^\"]+)\"",
                       text)
    return [re.compile(re.sub(r"\\\{[^}]*\\\}", "[^.]+", re.escape(n)) + "$")
            for n in found]


@pytest.mark.parametrize("mode,scan", [
    ("auto", "fused_scan"), ("fused", "fused_scan"),
    ("codes", "code_scan")])
@pytest.mark.parametrize("filtered", [False, True], ids=["all", "half"])
def test_modes_sent_elsewhere_off_the_tpu_record_jax_names(
        pq_pair, rows, half_mask, mode, scan, filtered):
    """Off the TPU the JAX package sends these modes to another scan
    (counting reason ``backend``); the port runs its kernels' plain
    versions and records the coarse stage and the scan stage the JAX
    package's source records for that kernel, and no fallback."""
    _, tidx = pq_pair
    _, Q = rows
    patterns = _jax_recorded_names("raft_tpu/neighbors/ivf_pq.py")
    filt = (SampleFilter.from_mask(torch.tensor(half_mask))
            if filtered else None)
    ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=4, scan_mode=mode),
                  tidx, torch.tensor(Q), K, filter=filt)
    with tobs.collecting():
        ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=4, scan_mode=mode),
                      tidx, torch.tensor(Q), K, filter=filt)
    names = _names(tobs)
    assert names["timers"] == sorted([dotted("ivf_pq", "search", "coarse"),
                                      dotted("ivf_pq", "search", scan)])
    for name in names["timers"] + names["counters"]:
        if name.startswith("ivf_pq" + SEP):
            assert any(p.match(name) for p in patterns), name
    assert not any("fused_fallback" in n for n in names["counters"])


def test_shared_fallback_reason_mode_in_both_packages(rows):
    """A fused search on an index with no recon cache whose codes the
    code scans cannot read (5 bits) takes the lookup-table scan in both
    packages, counted with reason ``mode``, as a flight event too."""
    X, Q = rows
    kw = dict(n_lists=16, pq_dim=8, pq_bits=5, cache_reconstructions=False)
    jidx = jp.build(JaxResources(seed=1), jp.IndexParams(**kw), X)
    tidx = ivf_pq.build(CPU, ivf_pq.IndexParams(**kw), torch.tensor(X))
    jobs.flight.clear()
    tobs.flight.clear()
    ref, ours = _both(
        lambda: jp.search(JR, jp.SearchParams(n_probes=4,
                                                scan_mode="fused"),
                          jidx, jnp.asarray(Q), K) and None,
        lambda: ivf_pq.search(CPU, ivf_pq.SearchParams(
            n_probes=4, scan_mode="fused"), tidx, torch.tensor(Q), K)
        and None)
    assert ours == ref
    reason = dotted("ivf_pq", "search", "fused_fallback", "reason", "mode")
    assert reason in ours["counters"]
    event = dotted("ivf_pq", "fused_fallback")
    assert ([e["attrs"] for e in jobs.flight.events(event)]
            == [e["attrs"] for e in tobs.flight.events(event)]
            == [{"reason": "mode"}])


def test_shared_fallback_reason_dtype_is_the_jax_gate_reason(rows):
    """An InnerProduct fused search: the port's Kernel B gate refuses the
    metric with the reason the JAX package's Pallas gate gives."""
    from raft_tpu.ops import pq_group_scan_pallas as pqp

    X, Q = rows
    tidx = ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=16, pq_dim=8,
                                                metric=6), torch.tensor(X))
    with tobs.collecting():
        ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=4), tidx,
                      torch.tensor(Q), K)
    want = pqp.fused_reject_reason(False, tidx.capacity, tidx.rot_dim, K, K,
                                   Q.shape[0])
    assert ivf_pq.search.last_fallback_reason == want
    assert dotted("ivf_pq", "search", "fused_fallback", "reason",
                  want) in tobs.snapshot()["counters"]


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "half"])
@pytest.mark.parametrize("metric", [0, 6], ids=["L2", "IP"])
def test_ivf_flat_build_and_search_record_the_same_names(
        rows, half_mask, metric, filtered):
    X, Q = rows

    def jax_run():
        idx = jf.build(JaxResources(seed=1), jf.IndexParams(
            n_lists=16, metric=metric), X)
        jf.search(JR, jf.SearchParams(n_probes=4), idx, jnp.asarray(Q), K,
                  filter=JaxFilter.from_mask(half_mask) if filtered
                  else None)
        return idx

    def port_run():
        idx = ivf_flat.build(CPU, ivf_flat.IndexParams(
            n_lists=16, metric=metric), torch.tensor(X))
        ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=4), idx,
                        torch.tensor(Q), K,
                        filter=SampleFilter.from_mask(torch.tensor(half_mask))
                        if filtered else None)
        return idx

    ref, ours = _both(jax_run, port_run)
    assert ours == ref


def test_mutation_records_the_same_names(rows):
    X, _ = rows
    jidx = jf.build(JaxResources(seed=1), jf.IndexParams(n_lists=16), X)
    tidx = ivf_flat.build(CPU, ivf_flat.IndexParams(n_lists=16),
                          torch.tensor(X))
    jq = jp.build(JaxResources(seed=1), jp.IndexParams(n_lists=16,
                                                       pq_dim=8), X)
    tq = ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=16, pq_dim=8),
                      torch.tensor(X))
    ids = np.arange(0, 40, dtype=np.int32)

    def jax_run():
        jf.compact(JR, jf.upsert(JaxResources(seed=2), jidx, ids, X[:40]))
        jp.compact(JR, jp.upsert(JaxResources(seed=2), jq, ids, X[:40]))

    def port_run():
        ivf_flat.compact(CPU, ivf_flat.upsert(CPU, tidx, torch.tensor(ids),
                                              torch.tensor(X[:40])))
        ivf_pq.compact(CPU, ivf_pq.upsert(CPU, tq, torch.tensor(ids),
                                          torch.tensor(X[:40])))

    ref, ours = _both(jax_run, port_run)
    assert ours == ref


@pytest.mark.parametrize("path", ["exact", "clustered"])
def test_cagra_build_and_search_record_the_same_names(rows, half_mask, path,
                                                      monkeypatch):
    X, Q = rows
    if path == "clustered":
        for mod in (cagra, jc):
            monkeypatch.setattr(mod, "_BRUTE_BUILD_MAX", 1000)
    kw = dict(intermediate_graph_degree=32, graph_degree=16,
              build_proj_dim=8, build_walk_rounds=1)

    def jax_run():
        idx = jc.build(JaxResources(seed=1), jc.IndexParams(**kw), X)
        jc.search(JaxResources(seed=2), jc.SearchParams(itopk_size=32), idx,
                  jnp.asarray(Q), K,
                  filter=JaxFilter.from_mask(half_mask))
        return idx

    def port_run():
        idx = cagra.build(CPU, cagra.IndexParams(**kw), torch.tensor(X))
        cagra.search(CPU, cagra.SearchParams(itopk_size=32), idx,
                     torch.tensor(Q), K,
                     filter=SampleFilter.from_mask(torch.tensor(half_mask)))
        return idx

    ref, ours = _both(jax_run, port_run)
    assert ours == ref
    assert dotted("cagra", "build", "prune") in ours["report stages"]


@pytest.mark.parametrize("n_init", [1, 2])
def test_kmeans_records_the_same_names_and_counts(rows, n_init):
    from raft_tpu.cluster import KMeansParams as JaxParams
    from raft_tpu.cluster import kmeans as jk
    from raft_tpu_torch.cluster import KMeansParams, kmeans

    X, _ = rows
    ref, ours = _both(
        lambda: jk.fit(JaxResources(seed=1), JaxParams(
            n_clusters=8, n_init=n_init, max_iter=5), X) and None,
        lambda: kmeans.fit(CPU, KMeansParams(
            n_clusters=8, n_init=n_init, max_iter=5), torch.tensor(X))
        and None)
    assert ours == ref
    restarts = dotted("kmeans", "restarts")
    assert tobs.snapshot()["counters"][restarts] == n_init


def test_refine_and_brute_force_record_the_same_names(rows):
    from raft_tpu.neighbors import brute_force as jb
    from raft_tpu.neighbors import refine as jr
    from raft_tpu_torch.neighbors import brute_force, refine

    X, Q = rows
    cand = np.random.default_rng(1).integers(0, X.shape[0], (Q.shape[0], 30))
    ref, ours = _both(
        lambda: (jr(JR, X, Q, cand, K), jb.knn(JR, X, Q, K)) and None,
        lambda: (refine(CPU, torch.tensor(X), torch.tensor(Q),
                        torch.tensor(cand), K),
                 brute_force.knn(CPU, torch.tensor(X), torch.tensor(Q), K))
        and None)
    assert ours == ref


def test_build_report_is_attached_only_under_collection(rows):
    X, _ = rows
    p = ivf_pq.IndexParams(n_lists=16, pq_dim=8)
    assert tobs.build_report(ivf_pq.build(CPU, p, torch.tensor(X))) is None
    with tobs.collecting():
        idx = ivf_pq.build(CPU, p, torch.tensor(X))
    rep = tobs.build_report(idx)
    assert rep["name"] == dotted("ivf_pq", "build")
    assert rep["total_s"] > 0
    assert all(0 < t["total_s"] <= rep["total_s"]
               for t in rep["stages"].values())
    stages = ivf_pq.build.stage_seconds
    kmeans_s = rep["stages"][dotted("ivf_pq", "build", "kmeans")]["total_s"]
    assert kmeans_s == pytest.approx(
        stages["trainset"] + stages["coarse_fit"], rel=0.5, abs=0.05)


# ---------------------------------------------------------------------------
# the no-fence contract
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_indexes(rows):
    X, _ = rows
    t = torch.tensor(X)
    return {"rows": t,
            "ivf_pq": ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=16,
                                                           pq_dim=8), t),
            "ivf_flat": ivf_flat.build(CPU, ivf_flat.IndexParams(n_lists=16),
                                       t),
            "cagra": cagra.build(CPU, cagra.IndexParams(
                intermediate_graph_degree=32, graph_degree=16), t)}


SEARCHES = {
    "ivf_pq-auto": lambda ix, q: ivf_pq.search(
        CPU, ivf_pq.SearchParams(n_probes=4), ix["ivf_pq"], q, K),
    "ivf_pq-codes": lambda ix, q: ivf_pq.search(
        CPU, ivf_pq.SearchParams(n_probes=4, scan_mode="codes"),
        ix["ivf_pq"], q, K),
    "ivf_pq-recon8": lambda ix, q: ivf_pq.search(
        CPU, ivf_pq.SearchParams(n_probes=4, scan_mode="recon8"),
        ix["ivf_pq"], q, K),
    "ivf_pq-lut": lambda ix, q: ivf_pq.search(
        CPU, ivf_pq.SearchParams(n_probes=4, scan_mode="lut"),
        ix["ivf_pq"], q, K),
    "ivf_flat": lambda ix, q: ivf_flat.search(
        CPU, ivf_flat.SearchParams(n_probes=4), ix["ivf_flat"], q, K),
    "cagra": lambda ix, q: cagra.search(
        CPU, cagra.SearchParams(itopk_size=32), ix["cagra"], q, K),
    "refine": lambda ix, q: __import__(
        "raft_tpu_torch.neighbors", fromlist=["refine"]).refine(
        CPU, ix["rows"], q,
        torch.arange(q.shape[0] * 20, dtype=torch.int32).reshape(-1, 20),
        K),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_no_search_waits_on_the_device_with_collection_off(
        port_indexes, rows, name, monkeypatch):
    _, Q = rows
    q = torch.tensor(Q)
    run = SEARCHES[name]
    run(port_indexes, q)        # warm: derived caches attach at first use

    def forbidden(device):
        raise AssertionError(f"fence reached with collection off: {device}")

    monkeypatch.setattr(TSTAGE, "_block_until_ready", forbidden)
    assert not tobs.enabled()
    run(port_indexes, q)
    waits = []
    monkeypatch.setattr(TSTAGE, "_block_until_ready", waits.append)
    with tobs.collecting():
        run(port_indexes, q)
    assert len(waits) >= len(tobs.snapshot()["timers"]) > 0


# ---------------------------------------------------------------------------
# the serving slice's names
# ---------------------------------------------------------------------------

def _serving_names(m):
    snap = m.snapshot()
    keep = ("serving" + SEP, "aot" + SEP)
    return {kind: sorted(n for n in snap[kind] if n.startswith(keep))
            for kind in ("counters", "gauges", "histograms")}


def test_serving_records_the_jax_names_and_aot_captures(pq_pair, rows,
                                                         tmp_path):
    """One script through both packages under collection: an ``aot``
    executor (max_batch 4) served three requests and one shed at a full
    queue, then an ingest tier's upsert and delete.  The same counter,
    gauge and histogram names under ``serving.`` and ``aot.`` and the same
    flight events; the JAX package's ``xla.*`` names have one
    counterpart, the port's capture counter, pinned by its own
    increment."""
    import raft_tpu.serving as jserving
    import raft_tpu_torch.serving as tserving
    from raft_tpu_torch.core import aot

    jidx, tidx = pq_pair
    _, Q = rows
    names, events = [], []
    for m, srv_mod, res, index, mod in (
            (jobs, jserving, JR, jidx, jp), (tobs, tserving, CPU, tidx,
                                             ivf_pq)):
        m.reset()
        m.flight.clear()
        with m.collecting():
            ex = srv_mod.Executor(res, "ivf_pq", index, ks=(K,),
                                  max_batch=4,
                                  search_params=mod.SearchParams(n_probes=4))
            cfg = srv_mod.ServerConfig(max_batch=4, max_wait_us=1_000,
                                       max_queue_rows=4)
            with srv_mod.Server(ex, cfg) as srv:
                for n in (1, 3, 2):
                    srv.search(Q[:n], K, timeout=30)
                srv.batcher.stop(drain=False)
                srv.submit(Q[:3], K)
                with pytest.raises(srv_mod.Overloaded):
                    srv.submit(Q[:3], K)
                srv.batcher.start()
            ing = srv_mod.IngestServer(res, srv_mod.IngestConfig(
                wal_dir=str(tmp_path / m.__name__)), dim=Q.shape[1])
            with ing:
                ing.recover()
                ing.write(np.arange(2), Q[:2])
                ing.write(np.arange(1), op="delete")
        names.append(_serving_names(m))
        events.append(sorted({e["name"] for e in m.flight.events()}))
    ref, ours = names
    assert ours == ref
    assert events[1] == events[0]
    assert dotted("aot", "cache_miss") in events[1]
    tobs.reset()
    with tobs.collecting():
        aot.ExecutableCache()._note_capture()
        assert list(tobs.snapshot()["counters"]) == [dotted("aot",
                                                            "captures")]

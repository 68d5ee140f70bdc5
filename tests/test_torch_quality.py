"""The port's live-quality module (``raft_tpu_torch.observability.quality``)
against the JAX package's, on the CPU.

``wilson_interval``, the windowed recall estimator, the drift detector
(its findings, counters and flight events) and ``calibrator_table`` give
equal results on equal inputs; an ``OperatingPointLog`` written by either
package (sealed RTIE segments and the active JSONL) reads in the other;
``measure_probe_stats`` gives equal results on an IVF-PQ index the JAX
package built and the port loaded through ``serialize``.
"""

import importlib
import io
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.observability as jobs
import raft_tpu_torch.observability as tobs
from raft_tpu import DeviceResources as JaxResources
from raft_tpu.core.serialize import CorruptIndexError as JaxCorrupt
from raft_tpu.neighbors import delta as jdelta
from raft_tpu.neighbors import ivf_pq as jp
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.core.serialize import CorruptIndexError
from raft_tpu_torch.neighbors import delta, ivf_pq

JQ = importlib.import_module("raft_tpu.observability.quality")
TQ = importlib.import_module("raft_tpu_torch.observability.quality")
CPU = DeviceResources(device="cpu", seed=0)
SEP = "."


@pytest.fixture(autouse=True)
def _clean():
    for m in (jobs, tobs):
        m.disable()
        m.reset()
        m.flight.clear()
    yield
    for m in (jobs, tobs):
        m.disable()
        m.reset()
        m.flight.clear()


@pytest.fixture
def clock(monkeypatch):
    t = {"now": 500.0}
    for m in (JQ, TQ):
        monkeypatch.setattr(m, "_now", lambda: t["now"])
    return t


@pytest.mark.parametrize("hits,total", [
    (0, 0), (0, 10), (10, 10), (7, 10), (95, 100), (999, 1000),
    (3.5, 8), (12, 5)])
@pytest.mark.parametrize("z", [1.0, 1.96, 3.0])
def test_wilson_interval_is_the_same(hits, total, z):
    assert TQ.wilson_interval(hits, total, z) == \
        JQ.wilson_interval(hits, total, z)


def test_defaults_match():
    assert TQ.DEFAULT_Z == JQ.DEFAULT_Z
    assert (TQ.DriftThresholds().__dict__
            == JQ.DriftThresholds().__dict__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recall_estimator_pools_alike(clock, seed):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(80):
        script.append((f"t{int(rng.integers(3))}", int(rng.choice([10, 100])),
                       int(rng.integers(0, 11)), 10,
                       int(rng.integers(1, 3)), float(rng.exponential(3.0))))
    out = []
    for m in (JQ, TQ):
        clock["now"] = 500.0
        est = m.RecallEstimator(window_s=30.0)
        views = []
        for tenant, k, hits, total, rows, dt in script:
            clock["now"] += dt
            est.record(tenant, k, hits, total, rows=rows)
            e = est.estimate()
            views.append(None if e is None else e.as_dict())
        views.append({str(k): e.as_dict() for k, e in est.estimates().items()})
        for tenant in ("t0", "t1", "nobody"):
            e = est.estimate(tenant=tenant, k=10)
            views.append(None if e is None else e.as_dict())
        est.reset()
        views.append(est.estimate())
        out.append(views)
    assert out[0] == out[1]


def _memtables(live, dead):
    """A memtable of each package with ``live`` rows and ``dead``
    tombstones beyond them."""
    out = []
    for m, kw in ((jdelta, {}), (delta, {"device": "cpu"})):
        mt = m.Memtable(4, capacity=8, **kw)
        ids = np.arange(live + dead)
        rows = np.ones((ids.size, 4), np.float32)
        if ids.size:
            mt.apply(m.Record(1, m.OP_UPSERT, ids, rows))
        if dead:
            mt.apply(m.Record(2, m.OP_DELETE, ids[live:]))
        out.append(mt)
    return out


@pytest.mark.parametrize("case", [
    "group_est", "group_est_quiet", "scan_skew", "fused_fallback",
    "memtable_dead", "memtable_live", "nothing"])
def test_drift_detector_finds_alike(case, clock):
    stats = {"touched_fraction": 0.9, "touched_lists": 30.0,
             "n_probes": 4.0, "n_lists": 32.0,
             "probed_rows_per_query": 500.0 if case == "scan_skew" else 100.0,
             "live_rows": 1000.0}

    class Idx:
        group_est = {"group_est": 0.5, "group_est_quiet": 0.8}.get(case, 0.0)

    # every upsert also tombstones its id (a main-index copy may exist), so
    # a memtable of live rows alone is half tombstones
    jm, tm = _memtables(3, 9 if case == "memtable_dead" else 0)
    limit = 0.6 if case == "memtable_live" else 0.3
    results = []
    for m, q, mt in ((jobs, JQ, jm), (tobs, TQ, tm)):
        if case == "fused_fallback":
            m.enable()
            reg = m.registry()
            base = SEP.join(("ivf_pq", "search", "fused_fallback"))
            reg.counter(base).inc(3)
            reg.counter(SEP.join((base, "reason", "backend"))).inc(2)
            reg.counter(SEP.join((base, "reason", "dtype"))).inc()
        else:
            m.enable()
        det = q.DriftDetector(q.DriftThresholds(dead_fraction_max=limit))
        found = det.check(
            index=Idx() if case.startswith(("group", "scan")) else None,
            probe_stats=stats if case != "nothing" else None,
            memtable=mt if case.startswith("memtable") else None)
        snap = m.snapshot()["counters"]
        results.append(([f.as_dict() for f in found],
                        {n: v for n, v in snap.items()
                         if n.startswith("serving")},
                        [e["attrs"] for e in m.flight.events()]))
        m.disable()
    assert results[0] == results[1]
    assert bool(results[1][0]) == (case not in (
        "group_est_quiet", "memtable_live", "nothing"))


def _points(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        knobs = {"kind": "ivf_pq", "n_probes": int(rng.choice([16, 32])),
                 "k": 10, "filtered": bool(rng.integers(2))}
        measured = {"recall": float(rng.random()),
                    "hits": int(rng.integers(0, 100)), "total": 100,
                    "p50": float(rng.exponential(0.01)),
                    "p99": float(rng.exponential(0.05))}
        if i % 7 == 0:
            measured.pop("p99")
        out.append((float(i), int(rng.integers(3)), knobs, measured,
                    "*" if i % 3 else "t1"))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_operating_point_logs_read_across(tmp_path, writer, reader):
    wq = JQ if writer == "jax" else TQ
    rq = JQ if reader == "jax" else TQ
    path = str(tmp_path / "ops.jsonl")
    pts = _points(3)
    with wq.OperatingPointLog(path, max_bytes=2048, keep=3) as log:
        for t, g, knobs, measured, tenant in pts:
            log.append(wq.OpPoint(t=t, generation=g, knobs=knobs,
                                  measured=measured, tenant=tenant))
    segs = [n for n in os.listdir(tmp_path) if n.endswith(".rtie")]
    assert 1 <= len(segs) <= 3
    got = [p.as_dict() for p in rq.read_operating_points(path)]
    ref = [p.as_dict() for p in wq.read_operating_points(path)]
    assert got == ref and got
    # the newest points all survive the pruning of the oldest segments
    assert got[-1]["t"] == pts[-1][0]


def test_operating_point_logs_write_the_same_bytes(tmp_path):
    blobs = []
    for q, name in ((JQ, "j"), (TQ, "t")):
        d = tmp_path / name
        path = str(d / "ops.jsonl")
        with q.OperatingPointLog(path, max_bytes=1500, keep=8) as log:
            for t, g, knobs, measured, tenant in _points(5):
                log.append(q.OpPoint(t=t, generation=g, knobs=knobs,
                                     measured=measured, tenant=tenant))
        blobs.append({n: (d / n).read_bytes() for n in sorted(os.listdir(d))})
    assert blobs[0] == blobs[1]


def test_torn_tail_and_corruption_read_alike(tmp_path):
    path = str(tmp_path / "ops.jsonl")
    with TQ.OperatingPointLog(path, max_bytes=900, keep=8) as log:
        for t, g, knobs, measured, tenant in _points(6, n=12):
            log.append(TQ.OpPoint(t=t, generation=g, knobs=knobs,
                                  measured=measured, tenant=tenant))
    with open(path, "a") as f:
        f.write('{"t": 99, "knobs": {')          # a torn final line
    assert ([p.as_dict() for p in TQ.read_operating_points(path)]
            == [p.as_dict() for p in JQ.read_operating_points(path)])
    seg = sorted(n for n in os.listdir(tmp_path) if n.endswith(".rtie"))[0]
    raw = bytearray((tmp_path / seg).read_bytes())
    raw[-3] ^= 0xFF
    (tmp_path / seg).write_bytes(bytes(raw))
    with pytest.raises(CorruptIndexError):
        TQ.read_operating_points(path)
    with pytest.raises(JaxCorrupt):
        JQ.read_operating_points(path)


@pytest.mark.parametrize("seed", [5, 6])
def test_calibrator_table_is_the_same(seed):
    pts = _points(seed)
    tables = []
    for q in (JQ, TQ):
        tables.append(q.calibrator_table([
            q.OpPoint(t=t, generation=g, knobs=k, measured=m, tenant=tn)
            for t, g, k, m, tn in pts]))
    assert tables[0] == tables[1]
    assert all(math.isfinite(r["recall"]) for r in tables[1].values()
               if r["recall"] is not None)


@pytest.fixture(scope="module")
def pq_pair():
    X, _ = make_blobs(2200, 32, n_clusters=20, cluster_std=1.0, seed=13)
    X = np.asarray(X)
    jidx = jp.build(JaxResources(seed=2), jp.IndexParams(n_lists=24,
                                                         pq_dim=8), X[:2100])
    buf = io.BytesIO()
    jp.serialize(None, buf, jidx)
    buf.seek(0)
    return jidx, ivf_pq.deserialize(CPU, buf), X[2100:]


@pytest.mark.parametrize("n_probes", [1, 4, 24, 100])
def test_measure_probe_stats_is_the_same(pq_pair, n_probes):
    jidx, tidx, Q = pq_pair
    ref = JQ.measure_probe_stats(jidx, jnp.asarray(Q), n_probes)
    for q in (Q, torch.tensor(Q)):
        assert TQ.measure_probe_stats(tidx, q, n_probes) == ref
    assert TQ.measure_probe_stats(object(), Q, 4) is None


def test_drift_on_a_loaded_index_with_injected_staleness(pq_pair):
    """The group_est and scan-skew checks over the loaded index's measured
    probe stats give the JAX package's findings."""
    jidx, tidx, Q = pq_pair
    jidx.group_est = tidx.group_est = 0.05
    try:
        found = [[f.as_dict() for f in q.DriftDetector().check(
            index=idx, queries=qs, n_probes=6)]
            for q, idx, qs in ((JQ, jidx, jnp.asarray(Q)),
                               (TQ, tidx, torch.tensor(Q)))]
    finally:
        jidx.group_est = tidx.group_est = 0.0
    assert found[0] == found[1] and found[1]
    assert tobs.flight.events() != []

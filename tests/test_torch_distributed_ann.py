"""``raft_tpu_torch.distributed.ann`` by row on gloo CPU ranks, against the
JAX package's ``raft_tpu.distributed.ann`` at the same shard count on the
virtual CPU mesh.

Searches are held to the JAX search over the same shards: the JAX package
builds each sharded index (IVF-PQ with canaries, IVF-Flat) on
``devices[:S]``, each shard comes out through its ``_local_index`` and is
written by its ``serialize`` (the canaries in the stream), and each port
rank loads its shard (``ann._shard_index``).  Builds cannot match draw for
draw (torch's Philox against threefry), so the port's own builds are held
to recall@10 against the exact answer within 0.05 of the JAX builds'.

Four ranks are spawned once for the module, in a thread, so the JAX
package computes its side meanwhile; each rank runs ``torch_dist_ann_
ranks.ann_checks`` at 4 shards (every rank) and at 2 (ranks 0 and 1), the
same scenarios the JAX side runs (``search_checks``, ``health_checks``,
``flat_checks``).  Tolerances: distances within 1e-4 of max ‖q‖² + max ‖x‖²
(bf16 recon and LUT sums in another order), ids equal or at a distance
tie (an id that differs sits at the reference's distance for it, or at the
cut of the reference's row).

By design (ROADMAP.md §3) the port follows the JAX scan-mode table's TPU
column where the JAX package on the CPU takes its CPU column: ``auto`` and
``fused`` run Kernel B (``scan_mode`` "fused_recon"; the JAX package:
"recon" and "grouped_recon", ``fused`` counting a ``backend`` fallback),
and ``codes`` is reported lowered (status 2; the JAX package: 1).
``test_scan_mode_table_follows_the_tpu_column`` pins both columns.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from raft_tpu.comms import CommsSession as JaxSession
from raft_tpu.distributed import ann as jax_ann
from raft_tpu.neighbors import cagra as jax_cagra
from raft_tpu.neighbors import ivf_flat as jax_ivf_flat
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu_torch.comms import launch

import torch_dist_ann_ranks as ranks

WORLD = 4
SHARDS = (2, 4)
PER_SHARD, DIM, NQ = 1024, 32, 32
ATOL = 1e-4
RECALL_GAP = 0.05
JAX = ranks.package("raft_tpu")


def _data():
    """Clustered rows, 1,024 a shard at either shard count (the JAX builds
    compile once for the shard's shape); queries near rows; a 30% mask;
    the doomed ids of delete (the exact nearest row of 8 queries)."""
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.normal(size=(64, DIM))
    n = PER_SHARD * max(SHARDS)
    X = (centers[rng.integers(0, 64, n)]
         + rng.normal(size=(n, DIM))).astype(np.float32)
    q = (X[rng.choice(n, NQ, replace=False)]
         + 0.1 * rng.normal(size=(NQ, DIM))).astype(np.float32)
    out = {}
    for s in SHARDS:
        x = X[:PER_SHARD * s]
        d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
        truth = np.argsort(d, 1, kind="stable")[:, :ranks.K]
        out[s] = dict(x=x, q=q, truth=truth,
                      mask=rng.random((NQ, x.shape[0])) < 0.3,
                      doomed=np.unique(truth[:8, 0]).astype(np.int32),
                      scale=float((q * q).sum(1).max()
                                  + (x * x).sum(1).max()))
    return out


DATA = _data()


def _write_shards(h, module, idx, path):
    """Each shard of ``idx`` written by the JAX package, its canaries in
    the stream; returns the files in shard order."""
    files = []
    cans = idx.shard_canaries or (None,) * idx.n_shards
    for s in range(idx.n_shards):
        local = jax_ann._local_index(idx, s)
        local.canaries = cans[s]
        files.append(str(path / f"{module.__name__.split('.')[-1]}-{s}"))
        with open(files[-1], "wb") as f:
            module.serialize(h, f, local)
    return files


def _scrambled(idx, shard):
    """``idx`` with ``shard``'s live ids permuted among its slots: its
    canaries find rows under the wrong ids."""
    li = np.asarray(idx.list_indices).copy()
    live = li[shard] >= 0
    li[shard][live] = np.random.default_rng(7).permutation(li[shard][live])
    leaves, aux = idx.tree_flatten()
    leaves = list(leaves)
    leaves[3] = jax.device_put(li, idx.list_indices.sharding)
    out = jax_ann.DistributedIndex.tree_unflatten(aux, tuple(leaves))
    out.shard_canaries = idx.shard_canaries
    return out


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """The JAX package's sharded indexes at 2 and 4 shards, and their
    shards' files."""
    root = tmp_path_factory.mktemp("distributed_ann")
    out = {}
    for s in SHARDS:
        h = JaxSession(devices=jax.devices("cpu")[:s],
                       axis_name="data").init().worker_handle(seed=0)
        x = DATA[s]["x"]
        pq = jax_ann.build(h, jax_ivf_pq.IndexParams(
            canary_queries=ranks.CANARIES, **ranks.PQ_PARAMS), x)
        flat = jax_ann.build_flat(h, jax_ivf_flat.IndexParams(
            **ranks.FLAT_PARAMS), x)
        path = root / str(s)
        path.mkdir()
        files = {"pq": _write_shards(h, jax_ivf_pq, pq, path),
                 "flat": _write_shards(h, jax_ivf_flat, flat, path)}
        bad = None
        if s == 2:
            bad = _scrambled(pq, 1)
            (path / "bad").mkdir()
            files["pq bad"] = _write_shards(h, jax_ivf_pq, bad,
                                            path / "bad")
        out[s] = dict(h=h, pq=pq, flat=flat, bad=bad, files=files)
    return out


@pytest.fixture(scope="module")
def spawned(jax_built, tmp_path_factory):
    """The ranks' run, started in a thread: a future of their results."""
    path = tmp_path_factory.mktemp("distributed_ann_ranks") / "rendezvous"
    data = {s: dict(DATA[s], files=jax_built[s]["files"]) for s in SHARDS}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.spawn, ranks.ann_checks, WORLD, str(path),
                         args=(data,), timeout_s=300, collective_s=120)
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def jax_runs(spawned, jax_built):
    """The JAX package's side of every scenario, computed while the ranks
    run."""
    out = {}
    for s in SHARDS:
        b = jax_built[s]
        h, d = b["h"], DATA[s]
        sp = jax_ivf_pq.SearchParams(n_probes=8)
        out[s] = {
            "search": ranks.search_checks(JAX, h, b["pq"], d, s),
            "flat": ranks.flat_checks(JAX, h, b["flat"], d),
            "builds": {
                "pq": np.asarray(jax_ann.search(h, sp, b["pq"], d["q"],
                                                ranks.K)[1]),
                "flat": np.asarray(jax_ann.search_flat(
                    h, jax_ivf_flat.SearchParams(n_probes=8), b["flat"],
                    d["q"], ranks.K)[1])}}
    b = jax_built[2]
    out[2]["health"] = ranks.health_checks(JAX, b["h"], b["pq"], b["bad"], 2)
    h, d = b["h"], DATA[2]
    walk = jax_ann.build_cagra(h, jax_cagra.IndexParams(
        **ranks.CAGRA_PARAMS), d["x"])
    # the direct walk over the same graphs: the route a failed table gate
    # takes
    direct = dataclasses.replace(walk, use_walk=False)
    sp = jax_cagra.SearchParams(itopk_size=ranks.CAGRA_ITOPK)
    out[2]["cagra"] = {
        name: (ix.use_walk, np.asarray(jax_ann.search_cagra(
            h, sp, ix, d["q"], ranks.K)[1]))
        for name, ix in (("walk", walk), ("direct", direct))}
    return out


@pytest.fixture(scope="module")
def runs(spawned, jax_runs):
    return spawned.result(timeout=300)


def _ours(runs, shards, part):
    """Rank 0's results; every rank of the group returned the same
    search results."""
    return runs[0][shards][part]


def _close(a, b, tol):
    """Distances equal within ``tol``, infinities of one sign equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    with np.errstate(invalid="ignore"):
        return same_inf | (np.abs(a - b) <= tol)


def _assert_search(got, ref, shards, tol=None):
    """(distances, ids) within the tolerance, ids equal or at a tie: an
    id that differs from the reference's sits at the reference's distance
    for that id, or at the reference row's cut (its last distance)."""
    tol = ATOL * DATA[shards]["scale"] if tol is None else tol
    d, i = got[:2]
    jd, ji = ref[:2]
    assert d.shape == jd.shape and i.shape == ji.shape
    assert i.dtype == np.int32
    assert _close(d, jd, tol).all(), float(np.nanmax(np.abs(d - jd)))
    for r in range(i.shape[0]):
        for j in np.nonzero(i[r] != ji[r])[0]:
            at = np.nonzero(ji[r] == i[r, j])[0]
            ref_d = jd[r, at[0]] if at.size else jd[r, -1]
            assert _close(d[r, j], ref_d, tol), (r, j, i[r], ji[r])


def _stats_equal(got, ref, keys=("scanned_rows", "gather_shape",
                                 "n_probes")):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]))


CASES = [f"{m} {p}" for p in ranks.PROBES for m in ranks.MODES]
# the scan-mode table's two columns: (status, scan_mode) on the port (the
# TPU column) and in the JAX package on the CPU
TPU_COLUMN = {"auto": (1, "fused_recon"), "fused": (1, "fused_recon"),
              "recon": (1, "recon"), "lut": (1, "lut"),
              "codes": (2, "lut"), "recon8": (2, "recon")}
CPU_COLUMN = dict(TPU_COLUMN, auto=(1, "recon"), fused=(1, "grouped_recon"),
                  codes=(1, "lut"))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", CASES)
def test_search_matches_the_jax_package(runs, jax_runs, shards, case):
    """Every scan mode at 4 probes and at every list: ids and distances,
    ``scanned_rows``, ``gather_shape`` and ``n_probes``; the status
    vectors where the two columns agree."""
    got = _ours(runs, shards, "search")[case]
    ref = jax_runs[shards]["search"][case]
    _assert_search(got, ref, shards)
    _stats_equal(got[3], ref[3])
    mode = case.split()[0]
    if TPU_COLUMN[mode][0] == CPU_COLUMN[mode][0]:
        np.testing.assert_array_equal(got[2], ref[2])
    for r in range(shards):
        theirs = runs[r][shards]["search"][case]
        for a, b in zip(theirs[:3], got[:3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ranks.MODES)
def test_scan_mode_table_follows_the_tpu_column(runs, jax_runs, mode):
    """The port's status and ``scan_mode`` are the TPU column's; the JAX
    package on the CPU gives its CPU column (ROADMAP.md §3)."""
    for shards in SHARDS:
        for p in ranks.PROBES:
            case = f"{mode} {p}"
            got = _ours(runs, shards, "search")[case]
            ref = jax_runs[shards]["search"][case]
            assert (set(got[2].tolist()), got[3]["scan_mode"]) == (
                {TPU_COLUMN[mode][0]}, TPU_COLUMN[mode][1])
            assert (set(ref[2].tolist()), ref[3]["scan_mode"]) == (
                {CPU_COLUMN[mode][0]}, CPU_COLUMN[mode][1])


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", ["failed_shards", "fail_shards",
                                  "all failed", "tracked search"])
def test_degraded_searches_match_the_jax_package(runs, jax_runs, shards,
                                                 case):
    """A flagged shard, the fault plan's failed shard, every shard failed
    (ids all -1) and a shard the tracker failed: results and status
    vectors equal."""
    got = _ours(runs, shards, "search")[case]
    ref = jax_runs[shards]["search"][case]
    _assert_search(got, ref, shards)
    np.testing.assert_array_equal(got[2], ref[2])
    if case == "failed_shards":
        _stats_equal(got[3], ref[3])
    if case == "all failed":
        assert (got[1] == -1).all() and (got[2] == 0).all()


@pytest.mark.parametrize("shards", SHARDS)
def test_events_and_trace_match_the_jax_package(runs, jax_runs, shards):
    """``distributed.degraded_search`` (with the request's trace id), the
    trace's shard status, scan mode and probes, the straggler's delays
    and timeout, and the tracker the straggle fed."""
    got = _ours(runs, shards, "search")
    ref = jax_runs[shards]["search"]
    assert got["degraded events"] == ref["degraded events"]
    assert got["degraded events"][0][1]
    assert got["trace"] == dict(ref["trace"],
                                **{"distributed.scan_mode": "fused_recon"})
    assert ref["trace"]["distributed.scan_mode"] == "recon"
    for key in ("straggler events", "timeout events",
                "tracker after straggle"):
        assert got[key] == ref[key], key
    assert ref["timeout events"]
    _assert_search(got["straggled"], ref["straggled"], shards)


@pytest.mark.parametrize("shards", SHARDS)
def test_each_rank_waits_its_own_straggle(runs, jax_runs, shards):
    """The JAX process waits the slowest shard's delay once a search; each
    port rank waits its own shard's delay, so the allgather ends when the
    slowest shard answers."""
    delays = [e["delays_s"]
              for e in jax_runs[shards]["search"]["straggler events"]]
    assert len(delays) == 2
    assert jax_runs[shards]["search"]["slept"] == [max(d) for d in delays]
    for r in range(shards):
        assert runs[r][shards]["search"]["slept"] == [
            d[r] for d in delays if d[r] > 0]


@pytest.mark.parametrize("shards", SHARDS)
def test_retry_and_deadline_match_the_jax_package(runs, jax_runs, shards):
    """A transient fault at the entry is retried to the same answer with
    the JAX counters; a spent deadline gives up before any collective."""
    got = _ours(runs, shards, "search")
    ref = jax_runs[shards]["search"]
    _assert_search(got["retried"], ref["retried"], shards)
    np.testing.assert_array_equal(got["retried"][1], got["auto 4"][1])
    assert got["retried counters"] == ref["retried counters"]
    assert got["deadline type"] == ref["deadline type"] == (
        "DeadlineExceededError")


@pytest.mark.parametrize("shards", SHARDS)
def test_filtered_search_matches_the_jax_package(runs, jax_runs, shards):
    """A 30% filter over global ids: results, ``admitted_rows``, every id
    admitted."""
    got = _ours(runs, shards, "search")["filtered"]
    ref = jax_runs[shards]["search"]["filtered"]
    _assert_search(got, ref, shards)
    np.testing.assert_array_equal(got[2]["admitted_rows"],
                                  ref[2]["admitted_rows"])
    mask = DATA[shards]["mask"]
    ids = got[1]
    assert all(mask[r, i] for r in range(ids.shape[0]) for i in ids[r]
               if i >= 0)


@pytest.mark.parametrize("shards", SHARDS)
def test_delete_matches_the_jax_package(runs, jax_runs, shards):
    got = _ours(runs, shards, "search")
    ref = jax_runs[shards]["search"]
    _assert_search(got["delete"], ref["delete"], shards)
    doomed = set(DATA[shards]["doomed"].tolist())
    assert not doomed & set(got["delete"][1].reshape(-1).tolist())
    assert got["generations"] == ref["generations"] == (0, 1)
    assert got["parent after delete"] and ref["parent after delete"]
    _assert_search(got["ground truth params"], ref["ground truth params"],
                   shards)
    _stats_equal(got["ground truth params"][2],
                 ref["ground truth params"][2])


def test_health_check_matches_the_jax_package(runs, jax_runs):
    """Per-shard canary reports and the tracker fed by them; a scrambled
    shard 1: its reports, the canary events, the error naming the shard,
    the tracker's states.  Every rank returns the same."""
    got = _ours(runs, 2, "health")
    assert got == jax_runs[2]["health"]
    assert all(r is not None and r[4] for r in got["reports"])
    assert got["bad error"][0].startswith("shard 1: canary recall")
    assert got["bad error"][2] == (1,)
    assert got["tracker"]["states"] == ("HEALTHY", "FAILED")
    assert runs[1][2]["health"] == got


@pytest.mark.parametrize("shards", SHARDS)
def test_search_flat_matches_the_jax_package(runs, jax_runs, shards):
    got = _ours(runs, shards, "flat")
    ref = jax_runs[shards]["flat"]
    for key in (*ranks.PROBES, "failed"):
        _assert_search(got[key], ref[key], shards, tol=1e-5
                       * DATA[shards]["scale"])
    np.testing.assert_array_equal(got["failed"][2], ref["failed"][2])


def _recall(ids, truth):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                          for a, b in zip(ids, truth)])) / truth.shape[1]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("kind", ["pq spmd", "pq", "flat"])
def test_own_builds_reach_the_jax_recall(runs, jax_runs, shards, kind):
    """The port's own by-row builds (IVF-PQ by the SPMD build and by the
    per-shard build with canaries, IVF-Flat) at full probe: recall@10
    against the exact answer within 0.05 of the JAX builds' (the JAX
    package's per-shard IVF-PQ build; its SPMD build is not run here),
    each shard's ids global and its own rows'."""
    truth = DATA[shards]["truth"]
    ours = _recall(_ours(runs, shards, "builds")[kind], truth)
    theirs = _recall(jax_runs[shards]["builds"][kind.split()[0]], truth)
    assert ours >= theirs - RECALL_GAP, (ours, theirs)
    per = PER_SHARD
    for r in range(shards):
        lo, hi, count = runs[r][shards]["builds"][f"{kind} ids"]
        assert (lo, count) == (r * per, per) and hi == (r + 1) * per - 1
    if kind == "pq":
        assert all(rep[4] for rep in _ours(runs, shards,
                                           "builds")["pq canaries"])


@pytest.mark.parametrize("route", ["walk", "direct"])
def test_own_cagra_build_reaches_the_jax_recall(runs, jax_runs, route):
    """The port's by-row CAGRA at 2 shards: the walk, and the direct walk
    where the table gate refuses; recall@10 within 0.05 of the JAX
    build's on the same route."""
    use_walk, ids = _ours(runs, 2, "cagra")[route]
    j_walk, j_ids = jax_runs[2]["cagra"][route]
    assert use_walk == j_walk == (route == "walk")
    assert ids.min() >= 0 and ids.max() < DATA[2]["x"].shape[0]
    truth = DATA[2]["truth"]
    assert _recall(ids, truth) >= _recall(j_ids, truth) - RECALL_GAP


def _jax_error(case, h, x):
    params = jax_ivf_pq.IndexParams(**ranks.PQ_PARAMS)
    calls = {
        "uneven": lambda: jax_ann.build(h, params, x[:-1]),
        "uneven flat": lambda: jax_ann.build_flat(
            h, jax_ivf_flat.IndexParams(**ranks.FLAT_PARAMS), x[:-1]),
        "replication": lambda: jax_ann.build(h, params, x,
                                             replication_factor=2),
        "placement": lambda: jax_ann.build(h, params, x,
                                           placement="by_grid"),
        "by_list recon": lambda: jax_ann.build(
            h, jax_ivf_pq.IndexParams(cache_reconstructions=False,
                                      **ranks.PQ_PARAMS), x,
            placement="by_list"),
        "by_list lists": lambda: jax_ann.build(
            h, jax_ivf_pq.IndexParams(**dict(ranks.PQ_PARAMS, n_lists=1)),
            x, placement="by_list"),
    }
    return ranks._error(JAX, calls[case])


@pytest.mark.parametrize("case", ["uneven", "uneven flat", "replication",
                                  "placement", "by_list recon",
                                  "by_list lists"])
def test_build_errors_are_the_jax_errors(runs, jax_built, case):
    h = jax_built[4]["h"]
    expected = _jax_error(case, h, DATA[4]["x"])
    assert expected is not None
    assert [r[4]["builds"]["errors"][case] for r in runs] == \
        [expected] * WORLD


def test_by_list_names_item_7(runs):
    """``build(placement="by_list")`` is no longer a stand-in naming its
    ROADMAP item: every rank holds its part of one routed index, under
    the same placement, and answers alike."""
    first = _ours(runs, 4, "builds")["by_list"]
    assert first[:2] == ("RoutedIndex", 4)
    assert sorted(set(first[2].tolist())) == [0, 1, 2, 3]
    for r in runs:
        got = r[4]["builds"]["by_list"]
        np.testing.assert_array_equal(got[2], first[2])
        for a, b in zip(got[3], first[3]):
            np.testing.assert_array_equal(a, b)

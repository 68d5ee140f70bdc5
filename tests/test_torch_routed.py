"""``raft_tpu_torch.distributed.ann``'s routed placement (``by_list``) on
four gloo CPU ranks, against the JAX package's ``raft_tpu.distributed.ann``
on four devices of the virtual CPU mesh.

The JAX package builds one IVF-PQ base on ``TestRoutedAnn``'s data (2,048 x
32, 32 lists, pq_dim 8, 3 iterations, with canaries), shards it with
``shard_by_list`` at r = 1, 2 and 3 and writes each with
``serialize_routed``; the port's ranks read those streams.  Four ranks are
spawned once for the module, in a thread, so the JAX package runs the same
scenarios (``torch_dist_routed_ranks.scenarios``) meanwhile.

Tolerances: distances within 1e-4 of max ‖q‖² + max ‖x‖² (the bf16 recon
distances summed in another order, the port's kernels' plain versions
against XLA), ids equal or at a distance tie.  Failover, hedging and a
routing policy are held to the port's own healthy run bit for bit.

By design (ROADMAP.md §3) the port follows the routed rows of the JAX
scan-mode table's TPU column where the JAX package on the CPU takes its
CPU column: ``auto`` and ``fused`` run Kernel C (``scan_mode``
"fused_codes"; the JAX package: "recon" and "grouped_recon", ``fused``
counting a ``backend`` fallback).  Each rank waits its own straggle (a
hedged one the shard deadline) where the JAX process waits the slowest
once.  ``test_routed_scan_mode_table_follows_the_tpu_column`` and
``test_hedged_straggler_waits_the_deadline_on_its_rank`` pin both.
"""

import concurrent.futures
import dataclasses
import io
import itertools

import jax
import numpy as np
import pytest

from raft_tpu.comms import CommsSession as JaxSession
from raft_tpu.core import serialize as jax_ser
from raft_tpu.distributed import ann as jax_ann
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu_torch.comms import launch
from raft_tpu_torch.distributed import ann as port_ann

import torch_dist_routed_ranks as ranks

N, DIM, NQ = 2048, 32, 16
ATOL = 1e-4
JAX = ranks.package("raft_tpu")
CASES = [f"{m} {p}" for p in ranks.PROBES for m in ranks.MODES]
# the routed scan-mode table's two columns: (status, scan_mode) on the port
# (the TPU column, on an index with its code leaves) and in the JAX
# package on the CPU
TPU_COLUMN = {"auto": (1, "fused_codes"), "fused": (1, "fused_codes"),
              "recon": (1, "recon"), "lut": (2, "recon"),
              "codes": (2, "recon"), "recon8": (2, "recon")}
CPU_COLUMN = dict(TPU_COLUMN, auto=(1, "recon"), fused=(1, "grouped_recon"))


def _data():
    """``TestRoutedAnn``'s rows and queries; a 30% mask; the doomed ids of
    delete (the exact nearest row of 8 queries)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = rng.normal(size=(NQ, DIM)).astype(np.float32)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, 1, kind="stable")[:, :ranks.K]
    return dict(x=x, q=q, mask=rng.random((NQ, N)) < 0.3,
                doomed=np.unique(truth[:8, 0]).astype(np.int32),
                scale=float((q * q).sum(1).max() + (x * x).sum(1).max()))


DATA = _data()


def _legacy_stream(h, idx, version):
    """``idx`` written as a routed stream of ``version`` 1 (no code block)
    or 2 (the code block), its placement envelope at version 1: the JAX
    package's writer of those versions, which it no longer writes."""
    recon, rsq, li, sizes, code_leaves = jax_ann._gather_global(idx)[1:]
    buf = io.BytesIO()
    with jax_ser.enveloped_writer(buf) as body:
        for v in (np.int32(version), np.int32(idx.metric),
                  np.int64(idx.size), np.int64(0)):
            jax_ser.serialize_scalar(h, body, v)
        p = idx.placement
        with jax_ser.enveloped_writer(body) as pb:
            for v in (np.int32(1), np.int32(p.n_shards),
                      np.int32(p.n_local), np.int64(p.generation)):
                jax_ser.serialize_scalar(h, pb, v)
            jax_ser.serialize_mdspan(h, pb, p.owner)
            jax_ser.serialize_mdspan(h, pb, p.local_slot)
        jax_ser.serialize_mdspan(h, body, np.asarray(idx.coarse_centers))
        jax_ser.serialize_mdspan(h, body, np.asarray(recon).view(np.uint16))
        for a in (rsq, li, sizes, idx.rotation):
            jax_ser.serialize_mdspan(h, body, np.asarray(a))
        if version >= 2:
            jax_ser.serialize_scalar(h, body, np.int32(1))
            jax_ser.serialize_scalar(h, body, np.int32(idx.pq_bits))
            jax_ser.serialize_scalar(h, body, np.float64(idx.group_est))
            for a in code_leaves:
                jax_ser.serialize_mdspan(h, body, np.asarray(a))
        from raft_tpu.integrity import canary
        canary.to_stream(h, body, idx.canaries)
    return buf.getvalue()


def _bytes(h, idx):
    buf = io.BytesIO()
    jax_ann.serialize_routed(h, buf, idx)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """The JAX base, its routed indexes at r = 1-3 and a scrambled one,
    each written to a file; the legacy streams and their re-writes."""
    root = tmp_path_factory.mktemp("routed")
    h = JaxSession(devices=jax.devices("cpu")[:ranks.SHARDS],
                   axis_name="data").init().worker_handle(seed=0)
    base = jax_ivf_pq.build(h, jax_ivf_pq.IndexParams(**ranks.BASE_PARAMS),
                            DATA["x"])
    idxs = {r: jax_ann.shard_by_list(h, base, replication_factor=r)
            for r in ranks.FACTORS}
    li = np.asarray(base.list_indices).copy()
    live = li >= 0
    li[live] = np.random.default_rng(3).permutation(li[live])
    bad = jax_ann.shard_by_list(h, dataclasses.replace(
        base, list_indices=jax.numpy.asarray(li)), replication_factor=2)
    streams = {f"r{r}": _bytes(h, idxs[r]) for r in ranks.FACTORS}
    streams["bad"] = _bytes(h, bad)
    rewrites = dict(streams)
    for v in (1, 2):
        streams[f"v{v}"] = _legacy_stream(h, idxs[1], v)
        rewrites[f"v{v}"] = _bytes(h, jax_ann.deserialize_routed(
            h, io.BytesIO(streams[f"v{v}"])))
    files = {"data": DATA}
    for name, blob in streams.items():
        files[name] = str(root / name)
        with open(files[name], "wb") as f:
            f.write(blob)
    files["base"] = str(root / "base")
    with open(files["base"], "wb") as f:
        jax_ivf_pq.serialize(h, f, base)
    return dict(h=h, base=base, idxs=idxs, bad=bad, files=files,
                rewrites=rewrites)


@pytest.fixture(scope="module")
def spawned(jax_built, tmp_path_factory):
    """The ranks' run, started in a thread: a future of their results."""
    path = tmp_path_factory.mktemp("routed_ranks") / "rendezvous"
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.spawn, ranks.routed_checks, ranks.SHARDS,
                         str(path), args=(jax_built["files"],),
                         timeout_s=300, collective_s=120)
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def jax_runs(spawned, jax_built):
    """The JAX package's side of every scenario, computed while the ranks
    run."""
    b = jax_built
    out = ranks.scenarios(JAX, b["h"], b["idxs"], DATA, b["bad"])
    two = JaxSession(devices=jax.devices("cpu")[:2],
                     axis_name="data").init().worker_handle(seed=0)
    with open(b["files"]["r2"], "rb") as f:
        out["n_shards"] = ranks._error(JAX, lambda: jax_ann.
                                       deserialize_routed(two, f))
    return out


@pytest.fixture(scope="module")
def runs(spawned, jax_runs):
    return spawned.result(timeout=300)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    with np.errstate(invalid="ignore"):
        return same_inf | (np.abs(a - b) <= tol)


def _assert_search(got, ref, tol=ATOL * DATA["scale"]):
    """(distances, ids) within ``tol``, ids equal or at a tie: an id that
    differs sits at the reference's distance for it, or at the reference
    row's cut."""
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


def _bit_equal(got, ref):
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)


def _every_rank_equal(runs, pick):
    first = pick(runs[0])
    for r in range(1, ranks.SHARDS):
        for a, b in zip(pick(runs[r]), first):
            if isinstance(a, dict):
                continue
            np.testing.assert_array_equal(a, b)


def _stats_equal(got, ref, keys=("scanned_rows", "gather_shape",
                                 "n_probes")):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]))


# ---------------------------------------------------------------------------
# placement and streams


@pytest.mark.parametrize("r", ranks.FACTORS)
def test_compute_placement_and_its_stream_match_the_jax_package(jax_built, r):
    """LPT with anti-co-location on seeded sizes: the tables, and the
    placement stream byte for byte, read back by both packages."""
    h = jax_built["h"]
    sizes = np.random.default_rng(11 + r).integers(5, 200, ranks.NL)
    ours = port_ann.compute_placement(sizes, ranks.SHARDS,
                                      replication_factor=r, generation=r)
    ref = jax_ann.compute_placement(sizes, ranks.SHARDS,
                                    replication_factor=r, generation=r)
    for a, b in zip(ours.rank_tables(), ref.rank_tables()):
        np.testing.assert_array_equal(a, b)
    assert (ours.n_local, ours.generation, ours.replication_factor) == (
        ref.n_local, ref.generation, ref.replication_factor)
    mine, theirs = io.BytesIO(), io.BytesIO()
    port_ann.placement_to_stream(None, mine, ours)
    jax_ann.placement_to_stream(h, theirs, ref)
    assert mine.getvalue() == theirs.getvalue()
    back = port_ann.placement_from_stream(None, io.BytesIO(
        theirs.getvalue()))
    for a, b in zip(back.rank_tables(), ref.rank_tables()):
        np.testing.assert_array_equal(a, b)
    for s in range(ranks.SHARDS):
        np.testing.assert_array_equal(back.shard_lists(s),
                                      ref.shard_lists(s))
        np.testing.assert_array_equal(
            back.healthy_routing((s,))[0], ref.healthy_routing((s,))[0])


@pytest.mark.parametrize("name", ["r1", "r2", "r3", "v1", "v2"])
def test_streams_are_rewritten_byte_for_byte(runs, jax_built, name):
    """The port reads the JAX routed stream (v3 at r = 1-3; a v1 and a v2
    stream) and writes it back as the JAX package does, on every rank."""
    for r in range(ranks.SHARDS):
        assert runs[r]["port"]["rewritten"][name] == \
            jax_built["rewrites"][name]


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_streams_search(runs, jax_runs, version):
    """A v1 stream loads recon-only (no code leaves, ``auto`` takes Kernel
    B), a v2 stream with its code leaves (Kernel C)."""
    pq_bits, no_codes, got = runs[0]["port"]["legacy"][version]
    assert (pq_bits == 0) == no_codes == (version == 1)
    assert got[2]["scan_mode"] == ("fused_recon" if version == 1
                                   else "fused_codes")
    _assert_search(got, jax_runs[1][f"auto {ranks.PROBES[0]}"])


@pytest.mark.parametrize("r", ranks.FACTORS)
def test_own_shard_by_list_gives_the_jax_placement(runs, jax_built, r):
    """The port's ``shard_by_list`` of the base (read through the single-
    index stream) places the lists as the JAX package did, carries the
    code leaves, and searches as the JAX routed index."""
    owner, slot, owners, n_local, pq_bits, codes = \
        runs[0]["port"]["own placements"][r]
    p = jax_built["idxs"][r].placement
    np.testing.assert_array_equal(owner, p.owner)
    np.testing.assert_array_equal(slot, p.local_slot)
    if r > 1:
        np.testing.assert_array_equal(owners, p.owners)
    assert n_local == p.n_local and pq_bits == 8 and codes
    for m in ("auto", "recon"):
        # the base's own recon norms (not the stream's): within ATOL
        got = runs[0]["port"]["own search"][(r, m)]
        _assert_search(got, runs[0][r][f"{m} {ranks.PROBES[0]}"])
        np.testing.assert_array_equal(
            got[3]["scanned_rows"],
            runs[0][r][f"{m} {ranks.PROBES[0]}"][3]["scanned_rows"])
    _every_rank_equal(runs, lambda out: out["port"]["own placements"][r][:3])


def test_a_stream_of_four_shards_needs_four_ranks(runs, jax_runs):
    assert runs[0]["port"]["n_shards"] == runs[1]["port"]["n_shards"] == \
        jax_runs["n_shards"]
    assert "placement maps 4 shards" in jax_runs["n_shards"]


# ---------------------------------------------------------------------------
# search


@pytest.mark.parametrize("r", ranks.FACTORS)
@pytest.mark.parametrize("case", CASES)
def test_routed_search_matches_the_jax_package(runs, jax_runs, r, case):
    """Every scan mode at 8 probes and at every list: ids and distances,
    ``scanned_rows``, ``gather_shape`` and ``n_probes``; the status vectors
    where the two columns agree; every rank the same."""
    got = runs[0][r][case]
    ref = jax_runs[r][case]
    _assert_search(got, ref)
    _stats_equal(got[3], ref[3])
    mode = case.split()[0]
    if TPU_COLUMN[mode][0] == CPU_COLUMN[mode][0]:
        np.testing.assert_array_equal(got[2], ref[2])
    _every_rank_equal(runs, lambda out: out[r][case][:3])


@pytest.mark.parametrize("r", ranks.FACTORS)
@pytest.mark.parametrize("case", CASES)
def test_routed_search_equals_the_single_index_search(runs, r, case):
    """The routed answer against the port's own single-index search of the
    same base at the same form (C: ``fused``, B: ``auto``, G: ``recon``),
    ids equal or at a tie."""
    got = runs[0][r][case]
    form = got[3]["scan_mode"]
    single = runs[0]["port"]["singles"][f"{form} {case.split()[1]}"]
    _assert_search(got, single)


@pytest.mark.parametrize("mode", ranks.MODES)
def test_routed_scan_mode_table_follows_the_tpu_column(runs, jax_runs, mode):
    """The port's status and ``scan_mode`` are the TPU column's; the JAX
    package on the CPU gives its CPU column (ROADMAP.md §3)."""
    for r in ranks.FACTORS:
        for p in ranks.PROBES:
            got = runs[0][r][f"{mode} {p}"]
            ref = jax_runs[r][f"{mode} {p}"]
            assert (set(got[2].tolist()), got[3]["scan_mode"]) == (
                {TPU_COLUMN[mode][0]}, TPU_COLUMN[mode][1])
            assert (set(ref[2].tolist()), ref[3]["scan_mode"]) == (
                {CPU_COLUMN[mode][0]}, CPU_COLUMN[mode][1])


def test_scanned_rows_tripwire_and_probe_sets(runs):
    """At 8 probes the shards together scan every probe's list once
    (probes x capacity) and the most-scanned shard stays within 1.5 x the
    probed rows / 4, the JAX package's tripwire; every rank ranked the
    same probe set."""
    for r in ranks.FACTORS:
        scanned = runs[0][r][f"auto {ranks.PROBES[0]}"][3]["scanned_rows"]
        probed = NQ * ranks.PROBES[0] * runs[0]["port"]["capacity"]
        assert scanned.sum() == probed
        assert scanned.max() <= 1.5 * probed / ranks.SHARDS
    _every_rank_equal(runs, lambda out: (out["port"]["probes"],))


@pytest.mark.parametrize("mode", ["fused", "recon"])
def test_routed_search_past_kt_64_equals_the_single_index_search(runs,
                                                                  mode):
    """k 100 (C's and G's pair-group route on the card; here their plain
    versions with the unowned probes as sentinels): the single-index
    search of the base at the same form, ids equal or at a tie."""
    got = runs[0]["port"][f"k100 {mode}"]
    form = got[2]["scan_mode"]
    assert form == {"fused": "fused_codes", "recon": "recon"}[mode]
    _assert_search(got, runs[0]["port"]["singles"][f"{form} k100"])
    _every_rank_equal(runs, lambda out: out["port"][f"k100 {mode}"][:2])


# ---------------------------------------------------------------------------
# failover, kills, stragglers


@pytest.mark.parametrize("mode", ["recon", "fused"])
@pytest.mark.parametrize("dead", range(ranks.SHARDS))
def test_single_shard_failover_is_bit_identical(runs, jax_runs, mode, dead):
    """r = 2, any one shard failed at full probe: the healthy answer bit
    for bit, status 3 for the shard, the JAX events."""
    got = runs[0]["failover"]
    ref = jax_runs["failover"]
    key = f"r2 dead {dead} {mode}"
    _bit_equal(got[key], got[f"healthy {mode}"])
    np.testing.assert_array_equal(got[key][2], ref[key][2])
    assert got[key][2][dead] == port_ann.SHARD_REPLICA_SERVED
    assert got[key + " events"] == ref[key + " events"]
    assert got[key + " events"][0][0]["covered"] == [dead]
    _assert_search(got[key], ref[key])


@pytest.mark.parametrize("pair", list(itertools.combinations(
    range(ranks.SHARDS), 2)))
def test_pair_kills_at_r3_are_bit_identical(runs, jax_runs, pair):
    key = "r3 dead {} {}".format(*pair)
    got = runs[0]["failover"]
    _bit_equal(got[key], got["r3 healthy"])
    np.testing.assert_array_equal(got[key][2], jax_runs["failover"][key][2])
    assert all(got[key][2][s] == port_ann.SHARD_REPLICA_SERVED
               for s in pair)


@pytest.mark.parametrize("case", ["r1 dead 1", "r2 stranded"])
def test_uncovered_failures_degrade_as_the_jax_package(runs, jax_runs,
                                                       case):
    """r = 1 with a shard failed, and a pair at r = 2 that strands lists:
    the JAX degraded answers, statuses and ``degraded_search`` events."""
    got = runs[0]["failover"][case]
    ref = jax_runs["failover"][case]
    if case == "r2 stranded":
        assert got[0] == ref[0]
        got, ref = got[1], ref[1]
    _assert_search(got, ref)
    np.testing.assert_array_equal(got[2], ref[2])
    assert port_ann.SHARD_FAILED in got[2].tolist()
    assert runs[0]["failover"][case + " events"] == \
        jax_runs["failover"][case + " events"]
    _every_rank_equal(runs, lambda out: out["failover"][case][-1][:3]
                      if case == "r2 stranded" else out["failover"][case][:3])


@pytest.mark.parametrize("site", ["route", "distributed.scan",
                                  "distributed.gather", "readmission"])
def test_kills_at_the_lifecycle_boundaries(runs, jax_runs, site):
    """A kill at the route boundary fails over in the same search; at the
    scan and gather boundaries in the next one; during a readmission (the
    catch-up and swap boundaries) the published index still answers bit
    for bit."""
    got = runs[0]["kills"][site]
    ref = jax_runs["kills"][site]
    healthy = runs[0]["failover"]["healthy recon"]
    if site == "route":
        _bit_equal(got, healthy)
        np.testing.assert_array_equal(got[2], ref[2])
        assert got[2][3] == port_ann.SHARD_REPLICA_SERVED
    elif site == "readmission":
        assert got[:5] == ref[:5] and got[2] and got[4]
        assert got[1] == "CATCHING_UP" and got[3] == "HEALTHY"
        _bit_equal(got[5], runs[0]["failover"]["r3 healthy"])
        np.testing.assert_array_equal(got[5][2], ref[5][2])
    else:
        for a, b in zip(got, ref):
            _bit_equal(a, healthy)
            np.testing.assert_array_equal(a[2], b[2])
        assert got[0][2].tolist() == [1] * ranks.SHARDS
        assert got[1][2][1] == port_ann.SHARD_REPLICA_SERVED


def test_hedged_straggler_waits_the_deadline_on_its_rank(runs, jax_runs):
    """r = 2: the straggler's lists go to replicas, the answer stays bit
    for bit, the events are the JAX package's; the JAX process waits the
    deadline once, and here the straggler's rank waits it (the others
    wait nothing)."""
    got = runs[0]["stragglers"]
    ref = jax_runs["stragglers"]
    _bit_equal(got["hedged"], runs[0]["failover"]["healthy recon"])
    np.testing.assert_array_equal(got["hedged"][2], ref["hedged"][2])
    assert got["hedged"][2][ranks.HEDGE["shard"]] == \
        port_ann.SHARD_REPLICA_SERVED
    assert got["hedged events"] == ref["hedged events"]
    assert ref["hedged slept"] == [ranks.HEDGE["deadline"]]
    for r in range(ranks.SHARDS):
        assert runs[r]["stragglers"]["hedged slept"] == (
            [ranks.HEDGE["deadline"]] if r == ranks.HEDGE["shard"] else [])


def test_straggler_without_a_replica_waits_in_full(runs, jax_runs):
    ref = jax_runs["stragglers"]
    assert ref["unhedged slept"] == [ranks.SLOW["delay"]]
    for r in range(ranks.SHARDS):
        assert runs[r]["stragglers"]["unhedged slept"] == (
            [ranks.SLOW["delay"]] if r == ranks.SLOW["shard"] else [])
    _assert_search(runs[0]["stragglers"]["unhedged"], ref["unhedged"])


# ---------------------------------------------------------------------------
# the routing policy


@pytest.mark.parametrize("case", ["policy", "policy fused",
                                  "policy failover"])
def test_policy_routed_search_is_bit_identical(runs, jax_runs, case):
    """A policy at full probe, healthy (recon and fused) and with a shard
    failed: the healthy answer bit for bit, the JAX events."""
    got = runs[0]["policy"]
    ref = jax_runs["policy"]
    healthy = runs[0]["failover"]["healthy " + (
        "fused" if case == "policy fused" else "recon")]
    _bit_equal(got[case], healthy)
    _assert_search(got[case], ref[case])
    if case == "policy":
        assert got["policy choices"] == ref["policy choices"]
        assert got["policy choices"][0] == 1
        assert got["policy choices"][2][0]["reason"] == "load_spread"
        assert got["policy choices"][2][0]["per_rank_lists"][1] > 0
    if case == "policy failover":
        np.testing.assert_array_equal(got[case][2], ref[case][2])
        assert got["policy failover events"] == ref["policy failover events"]
        assert got["policy failover events"][0]["reason"] == "failover"


def test_policy_hedge_prefers_the_least_loaded_replica(runs, jax_runs):
    got = runs[0]["policy"]
    ref = jax_runs["policy"]
    _bit_equal(got["policy hedge"], got["r3 healthy"])
    np.testing.assert_array_equal(got["policy hedge"][2],
                                  ref["policy hedge"][2])
    s, pen_shard, _, events, hedged = got["policy hedge plan"]
    assert (s, pen_shard, events, hedged) == (
        ref["policy hedge plan"][0], ref["policy hedge plan"][1],
        ref["policy hedge plan"][3], ref["policy hedge plan"][4])
    assert events[-1]["reason"] == "hedge" and hedged == 1
    assert ref["policy hedge plan"][2] == [0.05]
    assert runs[s]["policy"]["policy hedge plan"][2] == [0.05]


def test_load_suspect_is_hedged_not_failed(runs, jax_runs):
    states, failed, got = runs[0]["policy"]["load suspect"]
    ref = jax_runs["policy"]["load suspect"]
    assert (states, failed) == ref[:2] and states[3] == "SUSPECT"
    _bit_equal(got, runs[0]["failover"]["healthy recon"])
    np.testing.assert_array_equal(got[2], ref[2][2])
    assert port_ann.SHARD_FAILED not in got[2].tolist()


def test_probe_histograms_reach_the_policy(runs, jax_runs):
    pending, refreshed, heat = runs[0]["policy"]["observed"]
    ref = jax_runs["policy"]["observed"]
    assert (pending, refreshed) == ref[:2] == (3, 3)
    np.testing.assert_allclose(heat, ref[2], rtol=1e-12)


def test_skewed_rank_plans_apart_but_every_rank_routes_alike(runs):
    """Rank 1's policy reads a skewed queue depth and a load penalty; only
    rank 0's policy plans, and every rank routes by its broadcast route,
    so answers, scanned rows and events are equal on every rank."""
    results, events, _ = runs[0]["port"]["skewed"]
    for r in range(ranks.SHARDS):
        theirs, their_events, _ = runs[r]["port"]["skewed"]
        assert their_events == events
        for a, b in zip(theirs, results):
            _bit_equal(a, b)
            np.testing.assert_array_equal(a[2]["scanned_rows"],
                                          b[2]["scanned_rows"])
    _bit_equal(results[0], runs[0]["failover"]["healthy recon"])
    assert runs[0]["port"]["skewed"][2] is not None
    assert all(runs[r]["port"]["skewed"][2] is None
               for r in range(1, ranks.SHARDS))


@pytest.mark.parametrize("case", ["stranded", "covered"])
def test_suspect_on_one_rank_routes_alike(runs, case):
    """A real tracker shared by the policy and ``health=``, one shard
    failed, another SUSPECT in one rank's tracker only (rank 0, where its
    hedge would strand a list and it plans twice; rank 1, where its lists
    are covered): every rank takes rank 0's route, with no hedge, and
    answers, statuses, stats and events agree; the answer is the healthy
    one with the failed shard replica-served."""
    (f, s, who), got, events, _ = runs[0]["port"]["suspect on one rank"][
        case]
    for r in range(ranks.SHARDS):
        shards, theirs, their_events, states = \
            runs[r]["port"]["suspect on one rank"][case]
        assert shards == (f, s, who)
        assert (states[s] == "SUSPECT") == (r == who)
        assert their_events == events
        _bit_equal(theirs, got)
        np.testing.assert_array_equal(theirs[2], got[2])
        np.testing.assert_array_equal(theirs[3]["scanned_rows"],
                                      got[3]["scanned_rows"])
    _bit_equal(got, runs[0]["failover"]["healthy recon"])
    want = np.full(ranks.SHARDS, port_ann.SHARD_OK, np.int8)
    want[f] = port_ann.SHARD_REPLICA_SERVED
    np.testing.assert_array_equal(got[2], want)
    assert events["hedged_read"] == []
    assert len(events["replica_choice"]) == 1
    assert events["replica_choice"][0]["reason"] == "failover"
    assert events["replica_failover"][0]["covered"] == [f]


# ---------------------------------------------------------------------------
# mutation, filters, health


@pytest.mark.parametrize("case", ["delete", "rebalance", "route_vectors",
                                  "filtered", "ground truth params"])
def test_mutation_and_filters_match_the_jax_package(runs, jax_runs, case):
    got = runs[0]["mutation"]
    ref = jax_runs["mutation"]
    if case == "delete":
        _assert_search(got["delete"], ref["delete"])
        doomed = set(DATA["doomed"].tolist())
        assert not doomed & set(got["delete"][1].reshape(-1).tolist())
        assert got["delete generations"] == ref["delete generations"]
        assert got["parent after delete"] and ref["parent after delete"]
    elif case == "rebalance":
        assert got["rebalance"][:2] == ref["rebalance"][:2] == (1, 1)
        np.testing.assert_array_equal(got["rebalance"][2],
                                      ref["rebalance"][2])
        _bit_equal(got["rebalance"][3], runs[0]["failover"]["healthy "
                                                            "recon"][:2])
    elif case == "route_vectors":
        np.testing.assert_array_equal(got[case], ref[case])
    elif case == "filtered":
        _assert_search(got[case], ref[case])
        np.testing.assert_array_equal(got[case][2]["admitted_rows"],
                                      ref[case][2]["admitted_rows"])
        ids = got[case][1]
        assert all(DATA["mask"][r, i] for r in range(NQ) for i in ids[r]
                   if i >= 0)
    else:
        _assert_search(got[case], ref[case])
        _stats_equal(got[case][2], ref[case][2])
    _every_rank_equal(runs, lambda out: out["mutation"][case][:2]
                      if case in ("delete", "filtered") else ())


def test_health_check_matches_the_jax_package(runs, jax_runs):
    """One global canary set: the sound report, a scrambled index's
    failure blamed on the suspect shard, the error, the tracker; a
    deleted index judged over every rank's tombstones.  Every rank
    returns the same."""
    got = runs[0]["health"]
    assert got == jax_runs["health"]
    assert got["reports"][0][4] and not got["bad reports"][0][4]
    assert got["bad error"][0].startswith("canary recall")
    assert got["tracker"]["states"][1] == "FAILED"
    assert got["deleted reports"][0][4]
    for r in range(1, ranks.SHARDS):
        assert runs[r]["health"] == got


def test_catch_up_and_readmit_match_the_jax_package(runs, jax_runs):
    got = runs[0]["readmit"]
    ref = jax_runs["readmit"]
    assert got["readmit"][:6] == ref["readmit"][:6]
    assert got["readmit"][:5] == (True, "HEALTHY", 1, 1, 1)
    _bit_equal(got["readmit"][6], runs[0]["failover"]["healthy recon"])
    assert got["blocked"] == ref["blocked"] == (False, "FAILED", 0)


def test_catch_up_with_ingest_names_item_7(runs):
    for r in range(ranks.SHARDS):
        err = runs[r]["port"]["ingest"]
        assert err.startswith("NotImplementedError")
        assert "distributed (item 7)" in err

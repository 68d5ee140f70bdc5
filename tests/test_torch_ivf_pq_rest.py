"""The rest of IVF-PQ in the port against the JAX package, on the CPU:
InnerProduct search, per-cluster codebooks, recon8 past Kernel E's gates,
the batched balanced loop, ``ivf_pq_helpers`` and
``calibrate_group_capacity``.

Indexes that ``raft_tpu`` built are carried into the port through
``serialize`` (or ``index_from_numpy``) and searched at the same exact
coarse ranking.  Tolerances: the InnerProduct recon composition against
the JAX package's XLA twin within 1e-4 (the bf16 products summed in
another order), ids equal except among ties at a row's edge; recon8 at kt
200 the same; the batched loop bit for bit against the one-problem loop;
helpers and the calibration equal to the JAX package's; a port-built
per-cluster index's recall@10 within 0.03 of a JAX-built one's on blobs
(threefry and Philox draw different samples).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.neighbors import grouped as jax_grouped
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu.neighbors import ivf_pq_helpers as jax_helpers
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors import ivf_pq_helpers as helpers

CPU = DeviceResources(device="cpu")
IP = DistanceType.InnerProduct
N_PROBES, K = 6, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(index, **load):
    buf = io.BytesIO()
    jax_ivf_pq.serialize(JaxResources(seed=0), buf, index)
    return ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()), **load)


def _assert_same(d, i, rd, ri, rtol=1e-4, largest=False):
    """Distances within ``rtol`` (relative, 1 absolute floor), the same
    exhausted ranks, the same ids strictly inside each row's last kept
    distance (less the tolerance)."""
    d, rd = (-d, -rd) if largest else (d, rd)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_array_equal(i == -1, ~fin)
    np.testing.assert_allclose(d[fin], rd[fin], rtol=rtol, atol=rtol)
    for prow, pids, rrow, rids in zip(d, i, rd, ri):
        f = np.isfinite(rrow)
        if f.any():
            cut = rrow[f][-1] - 2 * rtol * (1 + abs(rrow[f][-1]))
            assert (set(pids[np.isfinite(prow) & (prow < cut)])
                    == set(rids[f & (rrow < cut)]))


@pytest.fixture(scope="module")
def ip_data():
    X, _ = make_blobs(1500, 24, n_clusters=20, cluster_std=2.0, seed=4)
    X = np.asarray(X)
    X = X / np.linalg.norm(X, axis=1, keepdims=True)
    db, q = X[:1460], X[1460:]
    res = JaxResources(seed=5)
    index = jax_ivf_pq.build(res, jax_ivf_pq.IndexParams(
        n_lists=10, pq_dim=12, metric=IP, kmeans_n_iters=4), db)
    index = jax_ivf_pq.delete(res, index, np.arange(3, 1460, 50))
    return db, q, index, _carry(index)


def _ip_twin(index, q, probes, k, kt, mask=None):
    """The JAX package's InnerProduct recon scan off the TPU: its XLA
    twin (``_search_impl_recon_grouped``, use_pallas False)."""
    nq = q.shape[0]
    cap, rot = index.capacity, index.rot_dim
    ng, _ = jax_grouped.group_capacity(nq, probes.shape[1], index.n_lists)
    block = jax_grouped.block_size(ng, jax_grouped.GROUP * cap * 8,
                                   cap * rot * 2, jax_grouped.GROUP * rot * 4)
    fw = (None if mask is None else
          jax_bitset.query_filter_words(mask, nq, "test"))
    d, i = jax_ivf_pq._search_impl_recon_grouped(
        index.centers, index.list_recon, index.list_recon_sq,
        index.list_indices, index.rotation, jnp.asarray(q),
        jnp.asarray(probes), k, IP, ng, block, use_pallas=False, kt=kt,
        filter_words=fw)
    return np.asarray(d), np.asarray(i)


def _probes(port, q, n_probes=N_PROBES):
    return ivf_flat._select_clusters(
        port.centers, torch.from_numpy(q) @ port.rotation, n_probes,
        port.metric).numpy()


@pytest.mark.parametrize("mode,kt,filtered", [
    ("recon", 0, False), ("recon", 4, False), ("recon", 0, True),
    ("auto", 0, False), ("fused", 0, True), ("codes", 0, False),
    ("recon8", 0, False)],
    ids=["recon", "recon-kt4", "recon-filtered", "auto", "fused-filtered",
         "codes", "recon8"])
def test_ip_search_matches_the_xla_twin(ip_data, mode, kt, filtered):
    """InnerProduct recon (and fused / auto, which fall back to it with
    reason "dtype"; codes and recon8, which resolve to it) returns the
    JAX package's XLA twin's result within 1e-4, ids tie-aware, largest
    first, tombstones never returned, a filter honoured."""
    db, q, index, port = ip_data
    mask = (np.random.default_rng(1).random((q.shape[0], 1460)) < 0.5
            if filtered else None)
    before = ivf_pq.search.fused_fallbacks
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode=mode, per_probe_topk=kt), port, q, K,
        filter=mask)
    fused = mode in ("auto", "fused")
    assert ivf_pq.search.fused_fallbacks == before + int(fused)
    if fused:
        assert ivf_pq.search.last_fallback_reason == "dtype"
    rd, ri = _ip_twin(index, q, _probes(port, q), K, min(kt or K,
                                                          port.capacity),
                      mask)
    _assert_same(d.numpy(), i.numpy(), rd, ri, largest=True)
    found = i.numpy()
    assert not set(found[found >= 0].tolist()) & set(range(3, 1460, 50))
    if mask is not None:
        rows, cols = np.nonzero(found >= 0)
        assert mask[rows, found[rows, cols]].all()


def test_ip_without_a_recon_cache_runs_the_lut_scan(ip_data):
    """codes / auto on an InnerProduct index with no recon cache resolve
    to the LUT scan, as the JAX package's; auto counts reason "mode"."""
    db, q, index, _ = ip_data
    lean = _carry(index, cache_reconstructions=False)
    before = ivf_pq.search.fused_fallbacks
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=N_PROBES),
                         lean, q, K)
    assert ivf_pq.search.fused_fallbacks == before + 1
    assert ivf_pq.search.last_fallback_reason == "mode"
    rd, ri = jax_ivf_pq._search_impl(
        index.centers, index.codebooks, index.list_codes,
        index.list_indices, index.rotation, jnp.asarray(q), K, N_PROBES, IP,
        0, "float32", pq_bits=index.pq_bits, exact_coarse=True)
    _assert_same(d.numpy(), i.numpy(), np.asarray(rd), np.asarray(ri),
                 rtol=1e-5, largest=True)


def test_ip_full_probe_filter_contract_and_refine(ip_data):
    """At full probe a filtered InnerProduct search equals the unfiltered
    one with the rejected rows dropped, bit for bit; refine by inner
    product keeps the exact order."""
    db, q, _, port = ip_data
    mask = np.random.default_rng(3).random((q.shape[0], 1460)) < 0.5
    full = ivf_pq.SearchParams(n_probes=port.n_lists)
    d_u, i_u = ivf_pq.search(CPU, full, port, q, 64)
    d_f, i_f = ivf_pq.search(CPU, full, port, q, K, filter=mask)
    for row in range(q.shape[0]):
        keep = [j for j, v in enumerate(i_u[row].tolist())
                if v >= 0 and mask[row, v]][:K]
        assert len(keep) == K
        assert torch.equal(i_f[row], i_u[row, keep])
        assert torch.equal(d_f[row], d_u[row, keep])
    from raft_tpu_torch.neighbors import refine
    rd, ri = refine(CPU, db, q, i_u, K, metric=IP)
    td, ti = brute_force.knn(CPU, db, q, K, metric=IP)
    assert (ri == ti).float().mean() >= 0.9
    assert bool((rd[:, :-1] >= rd[:, 1:]).all())


def test_ip_build_with_canaries_checks_recall(ip_data):
    """An InnerProduct build with recall canaries measures them through
    the ported search."""
    db, _, _, _ = ip_data
    index = ivf_pq.build(DeviceResources(seed=1, device="cpu"),
                         ivf_pq.IndexParams(n_lists=10, pq_dim=12,
                                            metric=IP, kmeans_n_iters=3,
                                            canary_queries=8), db)
    assert index.canaries.build_recall >= 0.5


@pytest.fixture(scope="module")
def carried_l2():
    X, _ = make_blobs(3000, 32, n_clusters=40, cluster_std=1.0, seed=8)
    X = np.asarray(X)
    db, q = X[:2950], X[2950:]
    res = JaxResources(seed=9)
    index = jax_ivf_pq.build(res, jax_ivf_pq.IndexParams(
        n_lists=12, pq_dim=8, kmeans_n_iters=4), db)
    return db, q, index, _carry(index)


def test_recon8_past_kernel_e_matches_the_xla_twin(carried_l2):
    """recon8 at kt 200 (past Kernel E's 128) runs the composition of the
    XLA twin; the JAX package's recon8 search at kt 200 off the TPU runs
    the twin itself: within 1e-4, ids tie-aware."""
    db, q, index, port = carried_l2
    assert port.capacity >= 200
    sp = dict(n_probes=N_PROBES, scan_mode="recon8", per_probe_topk=200)
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(**sp), port, q, 200)
    rd, ri = jax_ivf_pq.search(JaxResources(seed=0), jax_ivf_pq.SearchParams(
        exact_coarse=True, **sp), index, q, 200)
    _assert_same(d.numpy(), i.numpy(), np.asarray(rd), np.asarray(ri))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_loop_equals_the_one_problem_loop(seed):
    """At B = 1, with the same generator state, the batched balanced loop
    is ``_balanced_loop`` bit for bit; at B = 3 each member is a fit of
    its own rows."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(3, 900, 2, generator=g)
    c0 = X[:, ::4][:, :200].contiguous()
    for b in range(3):
        g1 = torch.Generator().manual_seed(7)
        g2 = torch.Generator().manual_seed(7)
        c1, l1 = kmeans_balanced._balanced_loop(
            X[b], c0[b], g1, 200, 6, DistanceType.L2Expanded)
        c2, l2 = kmeans_balanced._balanced_loop_batched(
            X[b:b + 1], c0[b:b + 1], g2, 200, 6)
        assert torch.equal(c1, c2[0]) and torch.equal(l1, l2[0])
    cb, lb = kmeans_balanced._balanced_loop_batched(
        X, c0, torch.Generator().manual_seed(7), 200, 6)
    for b in range(3):
        d = ((X[b][:, None] - cb[b][None]) ** 2).sum(-1)
        assert torch.equal(lb[b], torch.argmin(d, 1))


def test_per_cluster_sampler_keeps_the_jax_contract():
    """Each cluster samples its own sub-rows only, without repeats where
    it has at least ``per``, cycling its members where fewer, and an
    empty cluster takes the row the JAX package's top_k of an all -inf
    row gives (row 0)."""
    import jax

    per = 8
    labels = torch.tensor([0] * 20 + [1] * 3 + [3] * 8)
    idx = ivf_pq._sample_per_cluster(labels, torch.Generator().manual_seed(
        0), 4, per)
    assert idx.shape == (4, per)
    assert set(idx[0].tolist()) <= set(range(20))
    assert len(set(idx[0].tolist())) == per               # no repeats
    assert set(idx[1].tolist()) == {20, 21, 22}           # cycled
    assert sorted(idx[1, :3].tolist()) == [20, 21, 22]
    assert idx[1].tolist() == idx[1, :3].tolist() * 2 + idx[1, :2].tolist()
    assert sorted(idx[3].tolist()) == list(range(23, 31))
    scores = jnp.full((1, labels.shape[0]), -jnp.inf)
    vals, top = jax.lax.top_k(scores, per)
    n_valid = int(jnp.sum(vals > -jnp.inf))
    assert n_valid == 0
    first = int(top[0, 0 % max(n_valid, 1)])
    assert ivf_pq._EMPTY_CLUSTER_ROW == first
    assert idx[2].tolist() == [first] * per


@pytest.fixture(scope="module")
def per_cluster_pair():
    X, _ = make_blobs(2600, 16, n_clusters=30, cluster_std=1.0, seed=21)
    X = np.asarray(X)
    db, q = X[:2500], X[2500:]
    params = dict(n_lists=10, pq_dim=8, pq_bits=5, kmeans_n_iters=5,
                  codebook_kind=1)
    jax_index = jax_ivf_pq.build(JaxResources(seed=2),
                                 jax_ivf_pq.IndexParams(**params), db)
    port = ivf_pq.build(DeviceResources(seed=2, device="cpu"),
                        ivf_pq.IndexParams(**params), db)
    return db, q, jax_index, port


def test_per_cluster_streams_are_byte_equal_both_ways(per_cluster_pair):
    """A per-cluster stream written by either package reads in the other
    and writes back the same bytes."""
    _, _, jax_index, port = per_cluster_pair
    ours = io.BytesIO()
    ivf_pq.serialize(CPU, ours, port)
    theirs = jax_ivf_pq.deserialize(JaxResources(seed=0),
                                    io.BytesIO(ours.getvalue()))
    back = io.BytesIO()
    jax_ivf_pq.serialize(JaxResources(seed=0), back, theirs)
    assert back.getvalue() == ours.getvalue()
    np.testing.assert_array_equal(
        np.asarray(theirs.list_recon).astype(np.float32),
        port.list_recon.float().numpy())
    buf = io.BytesIO()
    jax_ivf_pq.serialize(JaxResources(seed=0), buf, jax_index)
    loaded = ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()))
    again = io.BytesIO()
    ivf_pq.serialize(CPU, again, loaded)
    assert again.getvalue() == buf.getvalue()


def test_port_built_per_cluster_recall_is_within_the_margin(
        per_cluster_pair):
    db, q, jax_index, port = per_cluster_pair
    _, truth = brute_force.knn(CPU, db, q, K)
    recall = {}
    for name, index in (("jax", _carry(jax_index)), ("port", port)):
        _, found = ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=4),
                                 index, q, K)
        recall[name] = float((found[:, :, None] == truth[:, None, :]).any(
            2).float().mean())
    assert port.codebooks.shape == (10, 32, 2)
    assert recall["port"] >= recall["jax"] - 0.03, recall


def test_per_cluster_extend_upsert_compact_keep_the_caches(per_cluster_pair):
    """extend, upsert and compact of a per-cluster index decode with each
    row's list book: the recon cache equals a fresh decode."""
    db, q, _, port = per_cluster_pair
    res = DeviceResources(seed=4, device="cpu")
    out = ivf_pq.extend(res, port, db[:7] + 0.01)
    out = ivf_pq.upsert(res, out, np.arange(3), db[10:13])
    out = ivf_pq.compact(res, ivf_pq.delete(res, out, np.arange(5, 40)))
    fresh = ivf_pq._decode_lists(out.codebooks, out.list_codes, out.pq_dim,
                                 out.pq_bits, out.codebook_kind)
    live = out.list_indices >= 0
    assert torch.equal(out.list_recon[live], fresh[live])
    _, found = ivf_pq.search(res, ivf_pq.SearchParams(n_probes=10), out,
                             db[10:13], 1)
    assert found[:, 0].tolist() == [0, 1, 2]


def test_per_cluster_checkpointed_build_resumes_bit_equal(tmp_path):
    X = np.random.default_rng(0).normal(size=(500, 8)).astype(np.float32)
    params = ivf_pq.IndexParams(n_lists=4, pq_dim=4, pq_bits=4,
                                kmeans_n_iters=3, codebook_kind=1)
    a = ivf_pq.build(DeviceResources(seed=3, device="cpu"), params, X,
                     checkpoint=str(tmp_path))
    b = ivf_pq.build(DeviceResources(seed=3, device="cpu"), params, X,
                     checkpoint=str(tmp_path), resume=True)
    assert torch.equal(a.codebooks, b.codebooks)
    assert torch.equal(a.list_codes, b.list_codes)


def test_helpers_match_the_jax_package(carried_l2):
    """unpack / pack / reconstruct on a JAX-built index give the JAX
    package's codes, recon cache and vectors; pack drops the code-scan
    norms and the int8 cache (derived again) and bumps the generation."""
    _, q, index, port = carried_l2
    jres = JaxResources(seed=0)
    label = int(np.argmax(np.asarray(index.list_sizes)))
    codes = helpers.unpack_list_data(CPU, port, label, offset=2, n_rows=9)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        jax_helpers.unpack_list_data(jres, index, label, offset=2,
                                     n_rows=9)))
    new = (codes.int() + 1) % 256
    ivf_pq.search(CPU, ivf_pq.SearchParams(scan_mode="recon8"), port, q, 2)
    assert port.list_recon_i8 is not None
    packed = helpers.pack_list_data(CPU, port, label, new, offset=2)
    jpacked = jax_helpers.pack_list_data(jres, index, label,
                                         new.numpy().astype(np.uint8),
                                         offset=2)
    np.testing.assert_array_equal(packed.list_codes.numpy(),
                                  np.asarray(jpacked.list_codes))
    # the norms: fp32 sums of the same bf16 rows, in another order
    np.testing.assert_allclose(packed.list_recon_sq.numpy(),
                               np.asarray(jpacked.list_recon_sq), rtol=1e-6)
    np.testing.assert_array_equal(
        packed.list_recon.float().numpy(),
        np.asarray(jpacked.list_recon).astype(np.float32))
    assert packed.list_recon_i8 is None and packed.list_code_rsq is None
    assert packed.generation == port.generation + 1
    rec = helpers.reconstruct_list_data(CPU, packed, label)
    np.testing.assert_allclose(rec.numpy(), np.asarray(
        jax_helpers.reconstruct_list_data(jres, jpacked, label)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_probes", [1, 3, 12])
def test_calibrate_group_capacity_matches_the_jax_package(carried_l2,
                                                          n_probes):
    """The touched fraction, ratcheted up over calls, and carried by the
    v4 stream."""
    _, q, index, port = carried_l2
    jres = JaxResources(seed=0)
    index.group_est = port.group_est = 0.0
    for batch in (q[:5], q):
        ours = ivf_pq.calibrate_group_capacity(CPU, port, batch, n_probes)
        theirs = jax_ivf_pq.calibrate_group_capacity(jres, index, batch,
                                                     n_probes)
        assert ours == pytest.approx(theirs, abs=0.0)
    buf = io.BytesIO()
    ivf_pq.serialize(CPU, buf, port)
    assert ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue())).group_est \
        == port.group_est


def test_kernel_gates_against_the_pallas_gates():
    """Kernel E takes every int8 row width the Pallas recon8 gate admits
    (rows past 1,024 bytes on its shared-memory instantiation), and Kernel
    D every shape the Pallas codes gate admits: past its shared memory it
    reads the books from global memory (rot 256, pq_dim 128, 8 bits) and
    sums the LUT in chunks of ``LUT_STEP`` subspaces (pq_dim 256: 224 + 32)."""
    from raft_tpu.ops import pq_code_scan_pallas as pallas
    from raft_tpu_torch.ops import pq_code_scan as pcs

    for rot, kt in ((96, 100), (1100, 100), (1100, 128)):
        rot_pad = -(-rot // 16) * 16
        assert pallas.supported_recon8(True, 64, rot, kt, 1000)
        assert not pcs.recon8_reject_reason(64, rot_pad, kt)
    assert pallas.supported_codes(True, True, 416, 256, 100, 1000, 128, 8)
    assert not pcs.codes_reject_reason(416, 256, 128, 8, 100)
    assert pcs.codes_layout(416, 256, 128, 8)[1:] == (128, False)
    assert pcs.codes_layout(416, 256, 256, 8)[1:] == (224, False)
    assert pcs.codes_layout(416, 128, 64, 8)[1:] == (64, True)
    admitted = 0
    for cap in (16, 416, 2048, 6784):
        for rot in (64, 128, 256, 512, 1024, 2048):
            for pq_dim in (rot // 4, rot // 2, rot):
                for bits in (4, 8):
                    for kt in (1, 64, 100, 128):
                        if pallas.supported_codes(True, True, cap, rot, kt,
                                                  1000, pq_dim, bits):
                            admitted += 1
                            assert not pcs.codes_reject_reason(
                                cap, rot, pq_dim, bits, kt), (
                                cap, rot, pq_dim, bits, kt)
    assert admitted > 100

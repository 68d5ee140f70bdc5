"""raft_tpu_torch IVF-Flat (Kernel F) and the IVF-PQ per-pair recon scan
(Kernel G) against the JAX package, on the CPU.

Inputs are made with numpy from a seed (bench.py's SIFT-like generator at
dim 128, where the JAX package's Pallas scans take ``rot % 128 == 0``).
``raft_tpu``-built indexes are carried across with ``index_from_numpy`` so
both packages search the same lists; each kernel's plain version is held
to the JAX function that runs its Pallas kernel in interpret mode at the
port's exact probes (the XLA twin for InnerProduct, which the JAX package
never sends to Pallas), and the public searches to the JAX functions they
resolve to.  Tolerances: IVF-Flat distances are fp32 ``‖q‖² + ‖x‖² −
2q·x``, whose summation order moves them by ~1e-6 of ‖q‖² + ‖x‖², so they
are held to 1e-5 of that scale; recon distances to 1e-4 rel/abs (as
tests/test_torch_ivf_pq.py holds Kernel B).  Ids must agree at every rank
strictly below a row's k-th distance; past it, ties may break
differently."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.matrix import ops as jax_matrix_ops
from raft_tpu.neighbors import grouped
from raft_tpu.neighbors import ivf_flat as jax_ivf_flat
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.matrix.ops import row_duplicate_mask
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_group_scan as pgs

K, DIM, N_LISTS, N_PROBES = 10, 128, 16, 4
L2, IP = DistanceType.L2Expanded, DistanceType.InnerProduct
CPU = DeviceResources(device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: in a parallel test run (several
    workers on few cores) torch's default pool oversubscribes the cores,
    and a loop of small ops then spends its time waiting on its own
    threads (a k-means fit of well under a second took tens of seconds
    so).  The results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sift_like(n, seed=0):
    """bench.py's generator: a 16-d latent mapped to DIM plus 5% noise."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 16)).astype(np.float32)
    a = rng.normal(size=(16, DIM)).astype(np.float32) / np.float32(4.0)
    x = z @ a
    return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)


def _carry(index, **over):
    arrays = {n: np.asarray(getattr(index, n)) for n in (
        "centers", "list_data", "list_indices", "list_sizes")}
    return ivf_flat.index_from_numpy(
        arrays, metric=over.get("metric", index.metric),
        adaptive_centers=index.adaptive_centers, device="cpu")


def _assert_same_results(pd, pi, rd, ri, atol, select_min=True):
    """Same exhausted ranks (and -1 ids there), distances within ``atol``
    at every rank, the same ids at every rank strictly inside the k-th
    distance."""
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    np.testing.assert_array_equal(pi == -1, ~np.isfinite(pd))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(pd[fin], rd[fin], rtol=1e-4, atol=atol)
    for prow, pids, rrow, rids in zip(pd, pi, rd, ri):
        live = np.isfinite(rrow)
        if live.any():
            edge = rrow[live][-1]
            inside = (rrow < edge - atol) if select_min else \
                (rrow > edge + atol)
            pin = (prow < edge - atol) if select_min else \
                (prow > edge + atol)
            assert set(pids[pin]) == set(rids[inside])


@pytest.fixture(scope="module")
def data():
    x = _sift_like(3048, seed=1)
    return x[:3000], x[3000:]


@pytest.fixture(scope="module")
def jax_flat(data):
    """One JAX-built IVF-Flat index per metric (16 lists: capacity ~256,
    so n_probes 4 scans super-tiles of F = 2)."""
    db, _ = data
    res = JaxResources(seed=3)
    out = {m: jax_ivf_flat.build(res, jax_ivf_flat.IndexParams(
        n_lists=N_LISTS, metric=m, kmeans_n_iters=5), db) for m in (L2, IP)}
    for index in out.values():
        assert jax_ivf_flat.super_tile_factor(index.capacity, N_LISTS,
                                              N_PROBES)[0] == 2
    return out


def _scale(q, index):
    """‖q‖² + max ‖x‖²: the size of the fp32 cancellation error."""
    return float((q * q).sum(1).max()
                 + (np.asarray(index.list_data) ** 2).sum(-1).max())


def _flat_inputs(port, q, n_probes, F, zapped=False):
    """What ivf_flat.search hands Kernel F at super-tile factor F."""
    cap, n_eff = port.capacity, port.n_lists // F
    probes = ivf_flat._select_clusters(port.centers, torch.from_numpy(q),
                                       n_probes, port.metric)
    if F > 1:
        probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
    ids = port.list_indices
    if zapped:
        ids = torch.where(torch.arange(port.capacity)[None, :] % 2 == 0, ids,
                          torch.full_like(ids, -1))
    data = port.list_data.reshape(n_eff, F * cap, DIM)
    dsq = (data * data).sum(-1)
    return probes, data, dsq, ids.reshape(n_eff, F * cap)


@pytest.mark.parametrize("metric,F,zapped", [
    (L2, 1, False), (L2, 2, False), (L2, 2, True), (IP, 1, False),
    (IP, 2, False)], ids=["l2", "l2-F2", "l2-F2-zapped", "ip", "ip-F2"])
def test_kernel_f_plain_matches_jax_grouped_flat_scan(data, jax_flat, metric,
                                                      F, zapped):
    """Kernel F's plain version + finalize against
    ``_search_impl_grouped`` (``grouped_flat_l2_scan`` interpreted for
    L2; the XLA scan for InnerProduct) on the same (super-tile) lists and
    probes."""
    _, q = data
    index = jax_flat[metric]
    port = _carry(index)
    probes, data_eff, dsq, ids = _flat_inputs(port, q, N_PROBES, F, zapped)
    n_eff, tile = ids.shape
    ng, _ = grouped.group_capacity(q.shape[0], N_PROBES, n_eff)
    block = grouped.block_size(ng, grouped.GROUP * tile * 8,
                               (tile + grouped.GROUP) * DIM * 4)
    rd, ri = jax_ivf_flat._search_impl_grouped(
        np.asarray(index.centers)[::F], data_eff.numpy(), ids.numpy(),
        jnp.asarray(q), jnp.asarray(probes.numpy()), K, metric, ng, block,
        list_data_sq=dsq.numpy(), use_pallas=metric == L2,
        pallas_interpret=True)
    vals, found = ps.ivf_flat_scan(torch.from_numpy(q), probes, data_eff,
                                   dsq, ids, min(K, tile), metric == IP)
    pd, pi = ivf_flat._finalize_topk(vals, found, K, metric)
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri), 1e-5 * _scale(q, index),
                         select_min=metric == L2)
    if zapped:
        live = set(ids[ids >= 0].tolist())
        assert all(int(i) in live for i in found[found >= 0])


def test_kernel_f_per_pair_outputs(data, jax_flat):
    """A pair keeps its live rows in order, then (+inf, -1) — (-inf, -1)
    and descending products in the InnerProduct form; a probe outside
    [0, n_lists) (a dedupe sentinel) gives a whole empty row."""
    _, q = data
    port = _carry(jax_flat[L2])
    cap = port.capacity
    probes = torch.tensor([[0, N_LISTS, 3], [-1, 5, 5]], dtype=torch.int32)
    dsq = (port.list_data ** 2).sum(-1)
    for ip in (False, True):
        vals, found = ps.ivf_flat_scan(torch.from_numpy(q[:2]), probes,
                                       port.list_data, dsq,
                                       port.list_indices, cap, ip)
        worst = float("-inf") if ip else float("inf")
        assert vals.shape == (2, 3, cap)
        for qi, p in ((0, 1), (1, 0)):
            assert (vals[qi, p] == worst).all() and (found[qi, p] == -1).all()
        n_live = int((port.list_indices[3] >= 0).sum())
        kept = vals[0, 2, :n_live]
        assert torch.isfinite(kept).all()
        assert (vals[0, 2, n_live:] == worst).all()
        assert bool(((kept[:-1] >= kept[1:]) if ip else
                     (kept[1:] >= kept[:-1])).all())


@pytest.fixture(scope="module")
def jax_pq(data):
    """A JAX-built IVF-PQ index at rot 128 with its recon cache."""
    db, _ = data
    return jax_ivf_pq.build(JaxResources(seed=4), jax_ivf_pq.IndexParams(
        n_lists=N_LISTS, pq_dim=32, kmeans_n_iters=5), db)


def _carry_pq(index, **drop):
    names = ("centers", "codebooks", "list_codes", "list_indices",
             "list_sizes", "rotation", "list_recon", "list_recon_sq")
    return ivf_pq.index_from_numpy(
        {n: None if n in drop else np.asarray(getattr(index, n))
         for n in names}, metric=index.metric, pq_bits=index.pq_bits,
        device="cpu")


def _jax_recon(index, q, probes, kt, list_indices=None, k=K):
    """``_search_impl_recon_grouped`` with ``grouped_l2_scan``
    interpreted, at the port's probes."""
    nq, n_probes = probes.shape
    cap, rot = index.capacity, index.rot_dim
    ng, _ = grouped.group_capacity(nq, n_probes, index.n_lists)
    block = grouped.block_size(ng, grouped.GROUP * cap * 8, cap * rot * 2,
                               grouped.GROUP * rot * 4)
    ids = index.list_indices if list_indices is None else list_indices
    return jax_ivf_pq._search_impl_recon_grouped(
        index.centers, index.list_recon, index.list_recon_sq,
        jnp.asarray(ids), index.rotation, jnp.asarray(q),
        jnp.asarray(probes.numpy()), k, index.metric, ng, block,
        use_pallas=True, pallas_interpret=True, kt=kt)


def _pq_probes(port, q, n_probes=N_PROBES):
    qrot = torch.from_numpy(q) @ port.rotation
    return qrot, ivf_flat._select_clusters(port.centers, qrot, n_probes,
                                           port.metric)


@pytest.mark.parametrize("kt,zapped", [(0, False), (4, False), (4, True)],
                         ids=["kt0", "kt4", "kt4-zapped"])
def test_kernel_g_plain_matches_jax_grouped_l2_scan(data, jax_pq, kt,
                                                    zapped):
    _, q = data
    port = _carry_pq(jax_pq)
    qrot, probes = _pq_probes(port, q)
    ids = port.list_indices
    if zapped:
        ids = torch.where(torch.arange(port.capacity)[None, :] % 2 == 0, ids,
                          torch.full_like(ids, -1))
    rd, ri = _jax_recon(jax_pq, q, probes, kt, ids.numpy())
    vals, found = ps.ivf_pq_scan_recon(
        qrot, port.centers, probes, port.list_recon, port.list_recon_sq, ids,
        min(kt or K, port.capacity))
    assert vals.shape == (q.shape[0], N_PROBES, min(kt or K, port.capacity))
    pd, pi = ivf_pq._finalize_topk(vals, found, K, port.metric)
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri), 1e-4)


@pytest.mark.parametrize("change", [dict(scan_mode="recon"),
                                    dict(use_reconstruction=True),
                                    dict(scan_mode="recon", per_probe_topk=4)],
                         ids=["recon", "use_reconstruction", "recon-kt4"])
def test_public_recon_search_matches_the_jax_function(data, jax_pq, change):
    _, q = data
    port = _carry_pq(jax_pq)
    _, probes = _pq_probes(port, q)
    pd, pi = ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=N_PROBES,
                                                    **change), port, q, K)
    rd, ri = _jax_recon(jax_pq, q, probes, change.get("per_probe_topk", 0))
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri), 1e-4)


def test_recon_search_without_a_cache_warns_and_builds_it(data, jax_pq):
    """As the JAX package: one warning, the cache built and kept, the same
    results as with the cache."""
    _, q = data
    bare = _carry_pq(jax_pq, list_recon=1, list_recon_sq=1)
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="recon")
    with pytest.warns(UserWarning, match="reconstruction cache"):
        d, i = ivf_pq.search(CPU, sp, bare, q, K)
    assert bare.list_recon is not None
    cd, ci = ivf_pq.search(CPU, sp, _carry_pq(jax_pq), q, K)
    torch.testing.assert_close(d, cd, rtol=1e-5, atol=1e-5)
    assert float((i == ci).float().mean()) >= 0.99


@pytest.mark.parametrize("refused", ["capacity", "k"])
def test_fused_recon_fallback_runs_kernel_g_and_counts(data, jax_pq,
                                                       monkeypatch, refused):
    """Where Kernel B's gate refuses the shape (a capacity past a
    shared-memory limit lowered below its three routes, or k past 256), an
    ``auto`` search runs Kernel G + finalize: one count, the gate's
    reason, the results of ``scan_mode="recon"``."""
    _, q = data
    port = _carry_pq(jax_pq)
    k, word = K, "shared memory"
    if refused == "capacity":
        limit = pgs.scan_smem_bytes(port.capacity, port.rot_dim) - 1
        monkeypatch.setattr(pgs, "_SMEM_LIMIT", limit)
        monkeypatch.setattr(ps, "_SMEM_LIMIT", limit)
    else:
        k, word = 300, "k=300"
    before = ivf_pq.search.fused_fallbacks
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=N_PROBES), port,
                         q, k)
    assert ivf_pq.search.fused_fallbacks == before + 1
    assert word in ivf_pq.search.last_fallback_reason
    rd, ri = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="recon"), port, q, k)
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.parametrize("metric", [L2, DistanceType.L2SqrtExpanded, IP],
                         ids=["l2", "l2sqrt", "ip"])
@pytest.mark.parametrize("n_probes", [N_PROBES, N_LISTS])
def test_public_search_matches_jax_search(data, jax_flat, metric, n_probes):
    """On a carried-across index at exact_coarse=True (the JAX package's
    CPU search: super-tiles, its XLA grouped scan, finalize, sqrt)."""
    _, q = data
    index = jax_flat[IP if metric == IP else L2]
    if metric != index.metric:
        index = dataclasses.replace(index, metric=metric)
    sp = dict(n_probes=n_probes, exact_coarse=True)
    rd, ri = jax_ivf_flat.search(JaxResources(seed=0),
                                 jax_ivf_flat.SearchParams(**sp), index,
                                 jnp.asarray(q), K)
    pd, pi = ivf_flat.search(CPU, ivf_flat.SearchParams(**sp),
                             _carry(index, metric=metric), q, K)
    atol = 1e-5 * _scale(q, index)
    if metric == DistanceType.L2SqrtExpanded:
        pd, rd, atol = pd ** 2, np.asarray(rd) ** 2, 2 * atol
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri), atol, select_min=metric != IP)


def test_supertile_exact_vs_tile_union():
    """F > 1 (tests/test_ivf_flat.py's case): the search equals brute force
    over the union of the probed tiles' rows, ids differing only at
    distance ties."""
    rng = np.random.default_rng(19)
    n, dim, n_probes = 4000, 16, 16
    X = rng.normal(size=(n, dim)).astype(np.float32)
    Q = rng.normal(size=(24, dim)).astype(np.float32)
    index = ivf_flat.build(DeviceResources(seed=0, device="cpu"),
                           ivf_flat.IndexParams(n_lists=64, kmeans_n_iters=5),
                           X)
    F, n_eff = ivf_flat.super_tile_factor(index.capacity, index.n_lists,
                                          n_probes)
    assert F >= 2, (index.capacity, F)
    d1, i1 = ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=n_probes),
                             index, Q, K)
    probes = ivf_flat._select_clusters(index.centers, torch.from_numpy(Q),
                                       n_probes, index.metric).numpy()
    ids_by_tile = index.list_indices.numpy().reshape(n_eff, -1)
    for q in range(Q.shape[0]):
        cand = ids_by_tile[np.unique(probes[q] // F)].ravel()
        cand = cand[cand >= 0]
        d = np.sum((X[cand] - Q[q]) ** 2, axis=1)
        order = np.argsort(d, kind="stable")[:K]
        np.testing.assert_allclose(d1[q].numpy(), d[order], rtol=1e-4,
                                   atol=1e-4)
        tie_ok = np.abs(d1[q].numpy() - d[order]) < 1e-4
        assert ((i1[q].numpy() == cand[order]) | tie_ok).all()


@pytest.mark.parametrize("n_new,adaptive,metric", [
    (5, False, L2), (5, True, L2), (2000, False, L2), (2000, True, L2),
    (5, True, IP), (2000, True, IP)],
    ids=["fast", "fast-adaptive", "repack", "repack-adaptive",
         "fast-adaptive-ip", "repack-adaptive-ip"])
def test_extend_matches_jax(data, jax_flat, n_new, adaptive, metric):
    """Both paths of extend against the JAX package's on the same index
    and rows: the same capacity, lists, ids and rows; centers (adaptive,
    unit norm for InnerProduct) within fp32 summation order; row norms
    appended on the fast path when the index carries them."""
    db, _ = data
    new = _sift_like(n_new, seed=9)
    index = dataclasses.replace(jax_flat[metric], adaptive_centers=adaptive)
    if n_new < 100:
        index.list_data_sq = jnp.sum(index.list_data ** 2, axis=-1)
    ref = jax_ivf_flat.extend(JaxResources(seed=0), index, new)
    port = _carry(index)
    port.list_data_sq = (None if index.list_data_sq is None
                         else torch.from_numpy(np.array(index.list_data_sq)))
    out = ivf_flat.extend(CPU, port, new)
    assert out.generation == port.generation + 1
    assert out.capacity == ref.capacity
    assert (out.capacity == index.capacity) == (n_new < 100)
    np.testing.assert_array_equal(out.list_sizes.numpy(),
                                  np.asarray(ref.list_sizes))
    np.testing.assert_array_equal(out.list_indices.numpy(),
                                  np.asarray(ref.list_indices))
    np.testing.assert_array_equal(out.list_data.numpy(),
                                  np.asarray(ref.list_data))
    np.testing.assert_allclose(out.centers.numpy(), np.asarray(ref.centers),
                               rtol=1e-5, atol=1e-5)
    if n_new < 100:
        np.testing.assert_allclose(out.list_data_sq.numpy(),
                                   np.asarray(ref.list_data_sq), rtol=1e-6)
    else:
        assert out.list_data_sq is None


def test_build_recall_within_margin_of_the_jax_build(data, jax_flat):
    """The port's own build (its k-means draws differ from the JAX
    package's) against the JAX build's recall@10 at n_probes 4."""
    db, q = data
    port = ivf_flat.build(DeviceResources(seed=0, device="cpu"),
                          ivf_flat.IndexParams(n_lists=N_LISTS,
                                               kmeans_n_iters=5), db)
    ids = port.list_indices.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(db.shape[0]))
    assert port.capacity % 32 == 0 and port.capacity > int(
        port.list_sizes.max())
    _, truth = brute_force.knn(CPU, db, q, K)
    sp = dict(n_probes=N_PROBES)
    _, pi = ivf_flat.search(CPU, ivf_flat.SearchParams(**sp), port, q, K)
    _, ri = jax_ivf_flat.search(JaxResources(seed=0),
                                jax_ivf_flat.SearchParams(**sp),
                                jax_flat[L2], jnp.asarray(q), K)

    def recall(found):
        return np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(np.asarray(found), truth.numpy())])

    assert recall(pi) >= recall(ri) - 0.03, (recall(pi), recall(ri))


def test_index_from_numpy_is_exact(jax_flat):
    index = jax_flat[L2]
    port = _carry(index)
    for name in ("centers", "list_data", "list_indices", "list_sizes"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(index, name)))
    assert port.capacity == index.capacity and port.size == index.size


def test_params_match_the_reference_fields_and_defaults():
    for ours, theirs in ((ivf_flat.IndexParams, jax_ivf_flat.IndexParams),
                         (ivf_flat.SearchParams, jax_ivf_flat.SearchParams)):
        assert ({f.name: f.default for f in dataclasses.fields(ours)}
                == {f.name: f.default for f in dataclasses.fields(theirs)})
    assert issubclass(ivf_pq.SearchParams, ivf_flat.SearchParams)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_duplicate_mask_and_super_probes_match_jax(seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 6, size=(9, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        row_duplicate_mask(torch.from_numpy(m)).numpy(),
        np.asarray(jax_matrix_ops.row_duplicate_mask(jnp.asarray(m))))
    probes = rng.integers(0, 64, size=(9, 12)).astype(np.int32)
    for F in (2, 4, 8):
        np.testing.assert_array_equal(
            ivf_flat.dedup_super_probes(torch.from_numpy(probes), F,
                                        64 // F).numpy(),
            np.asarray(grouped.dedup_super_probes(jnp.asarray(probes), F,
                                                  64 // F)))


def test_super_tile_factor_matches_jax():
    for cap in (32, 64, 96, 128, 256, 416, 1024):
        for n_lists in (16, 64, 4096, 16384, 15):
            for n_probes in (4, 64, 128, 4096):
                assert (ivf_flat.super_tile_factor(cap, n_lists, n_probes)
                        == jax_ivf_flat.super_tile_factor(cap, n_lists,
                                                          n_probes))


def test_pair_scan_gates_name_their_reason():
    """fp32 rows (Kernel F's query-major route) of any width from 1 to
    1024 are taken, off a multiple of 4 a value at a time; bf16 rows
    (Kernel G's) need a multiple of 8; each refusal names its reason."""
    for width in (1, 3, 10, 25, 50, 1024):
        assert not ps.pair_scan_reject_reason(64, width, 4, 4)
    assert "outside 1..1024" in ps.pair_scan_reject_reason(64, 0, 4, 4)
    assert "outside 1..1024" in ps.pair_scan_reject_reason(64, 1025, 4, 4)
    assert "multiple of 8" in ps.pair_scan_reject_reason(64, 100, 4, 8)
    assert "shared memory" in ps.pair_scan_reject_reason(60_000, 128, 4, 4)
    assert "kt=0" in ps.pair_scan_reject_reason(64, 128, 0, 4)
    assert not ps.pair_scan_reject_reason(16_384, 1024, 16_384, 4)

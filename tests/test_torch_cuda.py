"""raft_tpu_torch kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: each is marked ``cuda`` and skips,
with its reason, when there is none (the check runs inside the fixture,
never at import).  This file imports neither jax nor raft_tpu, so it runs
where only the port is installed::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch import DeviceResources, LogicError
from raft_tpu_torch.neighbors import cagra, grouped
from raft_tpu_torch.ops import cagra_hop as chop
from raft_tpu_torch.ops import cagra_walk as cw
from raft_tpu_torch.ops import fused_l2_nn as fnn
from raft_tpu_torch.ops import kmeans_update as ku
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops import pq_group_scan as pgs
from raft_tpu_torch.ops import row_gather as rg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,dim,k", [(1000, 50, 37), (4096, 128, 300),
                                     (333, 32, 1), (2912, 96, 91),
                                     (20000, 96, 8192), (129, 100, 91),
                                     (1, 96, 4097), (3000, 100, 4097),
                                     (129, 128, 1), (5000, 200, 300)])
@pytest.mark.parametrize("duplicates", [False, True])
def test_kmeans_assign_update_kernel_matches_plain(dev, n, dim, k,
                                                   duplicates):
    """Tie-aware (the tensor core sums the exact bf16 products in its own
    order): dmin within τ, each label the plain one or at a tie; counts
    exact and sums to fp32 summation order against the plain update from
    the kernel's own labels.  A duplicated centroid (the same bf16 row,
    so the same d to the bit) resolves to its first copy."""
    rng = np.random.default_rng(n + dim + k)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.choice([0.0, 0.25, 0.5, 1.0, 2.0], n).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(k, dim)).astype(np.float32)).to(dev)
    if duplicates and k > 2:
        c[k - 1] = c[1]                # a later copy, in another tile at 4097
        c[2] = c[1]
        x[0] = c[1] + 1e-3
    before = ku.kmeans_assign_update.launches
    sums, counts, dmin, labels = ku.kmeans_assign_update_labelled(x, w, c)
    torch.cuda.synchronize()
    assert ku.kmeans_assign_update.launches == before + 1
    _, _, p_dmin, p_labels = ku.kmeans_assign_update_labelled_plain(x, w, c)
    check = ku.check_assignment(x, c, dmin, labels, p_dmin, p_labels)
    assert check.ok, check
    p_sums, p_counts = ku.update_plain(x, w, labels, k)
    assert torch.equal(counts, p_counts)
    torch.testing.assert_close(sums, p_sums, rtol=1e-5, atol=1e-4)
    if duplicates and k > 2:
        assert int(labels[0]) == 1
        assert not bool(((labels == 2) | (labels == k - 1)).any())


def _random_index(dev, n_lists, cap, rot, seed):
    rng = np.random.default_rng(seed)
    recon = torch.from_numpy(rng.normal(size=(n_lists, cap, rot)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    rsq = (recon.float() ** 2).sum(-1)
    sizes = rng.integers(cap // 3, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 1::7] = np.where(ids[:, 1::7] >= 0, -(ids[:, 1::7] + 2), -1)
    centers = torch.from_numpy(rng.normal(size=(n_lists, rot)).astype(
        np.float32)).to(dev)
    return centers, recon, rsq, torch.from_numpy(ids).to(dev)


def _route_launches():
    """Launches of Kernel B's list-major pass 1, of pass 2, of its
    query-major route and of Kernel G's pair-group pass (B's pass 1 past
    kt 64)."""
    return np.array([pgs.list_scan.launches, pgs.merge_pairs.launches,
                     pgs.scan_query_major.launches,
                     ps.recon_pair_list_scan.launches])


# the launches _route_launches counts on each of Kernel B's routes
B_ROUTE = {"list": (1, 1, 0, 0), "pair": (0, 1, 0, 1),
           "query": (0, 0, 1, 0)}


@pytest.mark.parametrize("cap,rot,k,kt", [(96, 128, 10, 10), (96, 128, 10, 4),
                                          (700, 128, 20, 20),
                                          (2368, 96, 20, 20),
                                          (64, 32, 256, 256), (40, 24, 5, 3),
                                          (300, 1024, 64, 64),
                                          (200, 64, 100, 100)])
def test_ivf_pq_scan_kernel_matches_plain(dev, cap, rot, k, kt):
    """Distances within 1e-4 at every rank, the same exhausted ranks, no
    padding or tombstone id, ids consistent with their distances.  kt' =
    min(kt, cap, k) up to KT_LIST_MAX runs the list-major passes, above it
    G's pair-group pass and the merge (``scan_route``): each route's
    counters move, the others' not."""
    _check_scan_fused(dev, cap, rot, k, kt, 64, 12)


@pytest.mark.parametrize("cap,rot,k,kt", [(200, 64, 100, 100),
                                          (300, 128, 256, 256),
                                          (300, 128, 200, 65),
                                          (600, 1024, 129, 256)])
def test_fused_query_major_kernel_matches_plain(dev, cap, rot, k, kt):
    """Kernel B's query-major kernel (``scan_query_major``) past kt 64,
    called as itself: at the card's shared memory ``scan_route`` gives
    every such shape to G's pair-group pass and the merge, so the kernel
    serves as their yardstick; held to the plain version as the route is
    (``_check_scan_fused``), its own counter moving alone."""
    assert pgs.scan_route(cap, rot, k, kt)[0] == "pair"
    _check_scan_fused(dev, cap, rot, k, kt, 64, 12, walked=True)


@pytest.mark.parametrize("cap,rot,k,kt,n_lists,n_probes", [
    (300, 128, 100, 20, 256, 128), (64, 32, 40, 10, 256, 204),
    (40, 24, 224, 7, 300, 289)])
def test_ivf_pq_scan_kernel_chunked_merge_matches_plain(dev, cap, rot, k, kt,
                                                        n_lists, n_probes):
    """As above where pass 2 merges more than one chunk of n_probes x kt
    candidates and its tree has levels of an odd list count with kt < k /
    2, so a level writes more entries than the chunk read."""
    _check_scan_fused(dev, cap, rot, k, kt, n_lists, n_probes)


def _check_scan_fused(dev, cap, rot, k, kt, n_lists, n_probes,
                      walked=False):
    nq = 40
    centers, recon, rsq, ids = _random_index(dev, n_lists, cap, rot, cap + k)
    rng = np.random.default_rng(7)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(
        np.float32)).to(dev)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    probes[0, -1] = -1                 # skipped by both versions
    probes = torch.from_numpy(probes).to(dev)
    before = _route_launches()
    vk, ik = (pgs.scan_query_major if walked else pgs.ivf_pq_scan_fused)(
        qrot, centers, probes, recon, rsq, ids, k, kt)
    torch.cuda.synchronize()
    route = "query" if walked else pgs.scan_route(cap, rot, k, kt)[0]
    assert tuple(_route_launches() - before) == B_ROUTE[route]
    vp, ip = pgs.ivf_pq_scan_fused_plain(qrot, centers, probes, recon, rsq,
                                         ids, k, kt)
    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk))
    assert torch.equal(ik < 0, ~fin)
    torch.testing.assert_close(vk[fin], vp[fin], rtol=1e-4, atol=1e-4)
    # every returned (id, distance) is consistent with the index, and the
    # ids agree with the plain version's except at distance ties
    torch.testing.assert_close(_distance_of(qrot, centers, recon, rsq, ids,
                                            ik, fin), vk[fin],
                               rtol=1e-4, atol=1e-4)
    same = float((ik == ip).float().mean())
    assert same >= 0.99, same


@pytest.mark.parametrize("n_probes,kt,k", [
    (128, 20, 100), (204, 10, 40), (170, 12, 48), (700, 3, 12),
    (289, 7, 224), (2100, 1, 256), (100, 64, 256), (96, 20, 20), (1, 5, 5),
    (96, 128, 128), (96, 200, 200), (96, 256, 256), (95, 100, 128)])
def test_merge_pairs_kernel_is_bit_equal_to_a_stable_sort(dev, n_probes, kt,
                                                          k):
    """Pass 2 alone on sorted pair lists with ties across probes and
    exhausted tails: each query's top k equals a stable sort of its
    candidates in probe order (ties to the earlier probe, then the pair's
    own rank), (+inf, -1) on exhausted ranks, to the bit.  The shapes take
    one and several chunks and tree levels of an odd list count, and the
    pair-group routes' 96 probes x kt 128-256 (up to 24,576 candidates a
    query)."""
    nq = 6
    rng = np.random.default_rng(n_probes * kt + k)
    v = np.sort(rng.integers(0, 40, (nq, n_probes, kt)).astype(np.float32)
                / 4, axis=-1)
    live = rng.integers(0, kt + 1, (nq, n_probes))
    dead = np.arange(kt)[None, None, :] >= live[..., None]
    v[dead] = np.inf
    i = rng.permutation(nq * n_probes * kt).reshape(v.shape).astype(np.int32)
    i[dead] = -1
    vals, ids = torch.from_numpy(v).to(dev), torch.from_numpy(i).to(dev)
    before = pgs.merge_pairs.launches
    mv, mi = pgs.merge_pairs(vals, ids, k)
    torch.cuda.synchronize()
    assert pgs.merge_pairs.launches == before + 1
    flat_v, pos = torch.sort(vals.reshape(nq, -1), dim=1, stable=True)
    flat_i = torch.gather(ids.reshape(nq, -1), 1, pos)
    rv = torch.full((nq, k), float("inf"), device=dev)
    ri = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    kk = min(k, flat_v.shape[1])
    rv[:, :kk], ri[:, :kk] = flat_v[:, :kk], flat_i[:, :kk]
    ri[torch.isinf(rv)] = -1
    assert torch.equal(mv, rv) and torch.equal(mi, ri)


def _distance_of(qrot, centers, recon, rsq, ids, found, fin):
    """The scan's distance for each returned (query, id), recomputed."""
    cap = ids.shape[1]
    flat = ids.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    slot_of[flat[flat >= 0].long()] = torch.nonzero(flat >= 0)[:, 0]
    slot = slot_of[found[fin].long()]
    assert bool((slot >= 0).all())
    sub = qrot[torch.nonzero(fin)[:, 0]] - centers[slot // cap]
    rec = recon.reshape(-1, recon.shape[-1])[slot].float()
    ip = (sub.to(torch.bfloat16).float() * rec).sum(1)
    return torch.clamp_min((sub * sub).sum(1) + rsq.reshape(-1)[slot]
                           - 2.0 * ip, 0.0)


def test_ivf_pq_scan_rejects_what_it_cannot_hold(dev):
    centers, recon, rsq, ids = _random_index(dev, 4, 32, 128, 0)
    q = torch.zeros(2, 128, device=dev)
    probes = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(LogicError, match="outside 1..256"):
        pgs.ivf_pq_scan_fused(q, centers, probes, recon, rsq, ids, 300, 10)


def _random_code_index(dev, n_lists, cap, pq_dim, pq_len, pq_bits, seed):
    """Random packed codes and books, norms of the bf16 reconstructions,
    ids with padding (-1) and tombstones (<= -2), and an int8 cache."""
    rng = np.random.default_rng(seed)
    width = -(-pq_dim * pq_bits // 8)
    codes = torch.from_numpy(rng.integers(0, 256, (n_lists, cap, width))
                             .astype(np.uint8)).to(dev)
    books = torch.from_numpy(rng.normal(
        size=(pq_dim, 1 << pq_bits, pq_len)).astype(np.float32)).to(dev)
    recon = pcs.decode_codes(codes, books, pq_bits).float()
    rsq = (recon ** 2).sum(-1)
    ids = _random_index(dev, n_lists, cap, 8, seed)[3]
    rot = pq_dim * pq_len
    rot_pad = -(-rot // 16) * 16
    i8 = torch.from_numpy(rng.integers(-127, 128, (n_lists, cap, rot_pad))
                          .astype(np.int8)).to(dev)
    i8[:, :, rot:] = 0
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, n_lists).astype(
        np.float32)).to(dev)
    rsq8 = scales[:, None] ** 2 * (i8.float() ** 2).sum(-1)
    centers = torch.from_numpy(rng.normal(size=(n_lists, rot)).astype(
        np.float32)).to(dev)
    return centers, codes, books, rsq, ids, i8, scales, rsq8


def _queries(dev, nq, rot, n_lists, n_probes):
    rng = np.random.default_rng(7)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(
        np.float32)).to(dev)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    probes[0, -1] = -1                 # skipped by every version
    return qrot, torch.from_numpy(probes).to(dev)


def _assert_kernel_matches_plain(vk, ik, vp, ip):
    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk))
    assert torch.equal(ik < 0, ~fin)
    torch.testing.assert_close(vk[fin], vp[fin], rtol=1e-4, atol=1e-4)
    same = float((ik == ip).float().mean())
    assert same >= 0.99, same


CODE_SHAPES = [  # cap, pq_dim, pq_len, pq_bits, k, kt
    (96, 16, 8, 8, 10, 10), (700, 48, 2, 8, 20, 4), (300, 32, 2, 4, 10, 3),
    (64, 7, 4, 4, 256, 256), (40, 24, 1, 8, 5, 40),
    (2368, 48, 2, 8, 20, 20), (2368, 48, 2, 8, 20, 4),
    # the list-major pass: rot 36 (off a multiple of 8) at pq_len 1 and 3,
    # kt 1 / 64, the flagship's rot 128 at 8 bits, rot 256 at 4 bits (its
    # residuals in two 128-dim stages) and at 8 bits (the books do not
    # fit: query-major), k up to 256
    (96, 36, 1, 8, 10, 1), (300, 12, 3, 4, 20, 20), (200, 12, 3, 8, 64, 64),
    (416, 64, 2, 8, 20, 20), (416, 64, 2, 8, 20, 4), (200, 32, 4, 4, 256, 64),
    (160, 128, 2, 4, 100, 64), (160, 64, 4, 8, 20, 20),
    (500, 24, 4, 8, 256, 100)]


def _code_routes():
    """Launches of the list-major codes pass, pass 2, Kernels C's and D's
    query-major routes, and D's pair-group pass (C's pass 1 past kt 64)."""
    return np.array([pcs.code_list_scan.launches, pgs.merge_pairs.launches,
                     pcs.codes_fused_query_major.launches,
                     pcs.codes_scan_query_major.launches,
                     pcs.code_pair_list_scan.launches])


# the launches _code_routes counts on each of Kernel D's routes
D_ROUTE = {"list": (1, 0, 0, 0, 0), "pair": (0, 0, 0, 0, 1),
           "query": (0, 0, 0, 1, 0)}
# and on each of Kernel C's
C_ROUTE = {"list": (1, 1, 0, 0, 0), "pair": (0, 1, 0, 0, 1),
           "query": (0, 0, 1, 0, 0)}


# Kernel C past the pair-group pass's kt 128: its query-major kernel
C_QUERY_SHAPES = [(400, 64, 2, 8, 200, 200), (300, 48, 2, 8, 256, 129),
                  (300, 32, 2, 4, 130, 256)]


@pytest.mark.parametrize("cap,pq_dim,pq_len,pq_bits,k,kt",
                         CODE_SHAPES + C_QUERY_SHAPES)
def test_codes_fused_kernel_matches_plain(dev, cap, pq_dim, pq_len, pq_bits,
                                          k, kt):
    """Kernel C: distances within 1e-4 at every rank (the tensor core or
    the LUT sums the plain version's exact products in another order), the
    same exhausted ranks, no padding or tombstone id, ids equal but at
    ties.  A pair kt min(kt, cap, k) up to 64 runs the list-major pass and
    the merge, up to 128 (or where the list-major books do not fit) D's
    pair-group pass and the merge, above it the query-major kernel
    (``codes_fused_route``): the launch counters say which."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, cap + k)
    qrot, probes = _queries(dev, nq, pq_dim * pq_len, n_lists, n_probes)
    before = _code_routes()
    vk, ik = pcs.ivf_pq_scan_codes_fused(qrot, centers, probes, codes,
                                         books, rsq, ids, pq_bits, k, kt)
    torch.cuda.synchronize()
    route = pcs.codes_fused_route(cap, pq_dim * pq_len, pq_dim, pq_bits, k,
                                  kt)[0]
    assert tuple(_code_routes() - before) == C_ROUTE[route]
    vp, ip = pcs.ivf_pq_scan_codes_fused_plain(qrot, centers, probes, codes,
                                               books, rsq, ids, pq_bits, k,
                                               kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("cap,pq_dim,pq_len,pq_bits,k,kt", CODE_SHAPES)
def test_codes_pair_kernel_matches_plain(dev, cap, pq_dim, pq_len, pq_bits,
                                         k, kt):
    """Kernel D: each pair's top kt, (+inf, -1) past its live rows and on
    the skipped probe; kt up to 64 on the list-major pass, up to 128 the
    pair-group pass where its shared memory holds the shape, else the
    query-major kernel (``codes_scan_route``)."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, cap + kt)
    qrot, probes = _queries(dev, nq, pq_dim * pq_len, n_lists, n_probes)
    kt = min(kt, 128)
    before = _code_routes()
    vk, ik = pcs.ivf_pq_scan_codes(qrot, centers, probes, codes, books, rsq,
                                   ids, pq_bits, kt)
    torch.cuda.synchronize()
    route = pcs.codes_scan_route(cap, pq_dim * pq_len, pq_dim, pq_bits,
                                 min(kt, cap))[0]
    assert tuple(_code_routes() - before) == D_ROUTE[route]
    assert vk.shape == (nq, n_probes, min(kt, cap))
    assert bool(torch.isinf(vk[0, -1]).all())
    vp, ip = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes, books,
                                         rsq, ids, pq_bits, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("kt", [64, 65])
@pytest.mark.parametrize("fused", [True, False], ids=["C", "D"])
def test_code_scans_route_by_kt(dev, kt, fused):
    """A pair kt of 64 takes the list-major codes pass, 65 D's pair-group
    pass (for C at k = kt, then the merge), each held to its plain
    version."""
    n_lists, cap, pq_dim, pq_len, pq_bits = 32, 300, 48, 2, 8
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, kt)
    qrot, probes = _queries(dev, 30, pq_dim * pq_len, n_lists, 6)
    before = _code_routes()
    if fused:
        vk, ik = pcs.ivf_pq_scan_codes_fused(qrot, centers, probes, codes,
                                             books, rsq, ids, pq_bits, kt,
                                             kt)
        vp, ip = pcs.ivf_pq_scan_codes_fused_plain(
            qrot, centers, probes, codes, books, rsq, ids, pq_bits, kt, kt)
        want = C_ROUTE["list" if kt <= 64 else "pair"]
    else:
        vk, ik = pcs.ivf_pq_scan_codes(qrot, centers, probes, codes, books,
                                       rsq, ids, pq_bits, kt)
        vp, ip = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes,
                                             books, rsq, ids, pq_bits, kt)
        want = D_ROUTE["list" if kt <= 64 else "pair"]
    torch.cuda.synchronize()
    assert tuple(_code_routes() - before) == want
    _assert_kernel_matches_plain(vk, ik, vp, ip)


def _fused_pair_case(dev, kernel, cap, seed):
    """A random index for Kernel C (48 8-bit subspaces of 2 dims) or B
    (rot 128) with queries, its data scaled by 1/8 (distances about 4, so
    a change of summation order moves one by ~1e-6): ``(fused wrapper,
    query-major kernel, its arguments before k and kt, the pass of its
    pair-group route, tolerance)``."""
    n_lists, nq, n_probes, s = 64, 40, 12, 0.125
    if kernel == "C":
        centers, codes, books, _, ids, *_ = _random_code_index(
            dev, n_lists, cap, 48, 2, 8, seed)
        books, centers = books * s, centers * s
        rsq = (pcs.decode_codes(codes, books, 8).float() ** 2).sum(-1)
        qrot, probes = _queries(dev, nq, 96, n_lists, n_probes)
        return (pcs.ivf_pq_scan_codes_fused, pcs.codes_fused_query_major,
                (qrot * s, centers, probes, codes, books, rsq, ids, 8),
                pcs.code_pair_list_scan, 4.6e-5)
    centers, recon, _, ids = _random_index(dev, n_lists, cap, 128, seed)
    recon = (recon.float() * s).to(torch.bfloat16)
    rsq = (recon.float() ** 2).sum(-1)
    qrot, probes = _queries(dev, nq, 128, n_lists, n_probes)
    return (pgs.ivf_pq_scan_fused, pgs.scan_query_major,
            (qrot * s, centers * s, probes, recon, rsq, ids),
            ps.recon_pair_list_scan, 6.1e-5)


def _assert_topk_match(vk, ik, vr, ir, tol):
    """Each query's top k: the same exhausted ranks (-1 exactly there),
    values within ``tol`` at every rank, the same ids below the row's
    last kept value less 2 ``tol`` (a tie there may keep another id)."""
    fin = torch.isfinite(vr)
    assert torch.equal(fin, torch.isfinite(vk))
    assert torch.equal(ik < 0, ~fin)
    torch.testing.assert_close(vk[fin], vr[fin], rtol=0, atol=tol)
    for prow, pids, rrow, rids, f in zip(vk.cpu(), ik.cpu(), vr.cpu(),
                                         ir.cpu(), fin.cpu()):
        if bool(f.any()):
            cut = float(rrow[f][-1]) - 2 * tol
            assert (set(pids[prow < cut].tolist())
                    == set(rids[rrow < cut].tolist()))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("kernel,cap,k", [
    ("C", 300, 65), ("C", 300, 100), ("C", 700, 128), ("B", 300, 65),
    ("B", 416, 128), ("B", 416, 200), ("B", 416, 256)])
def test_fused_scans_past_kt_64_take_the_pair_group_pass(dev, kernel, cap, k,
                                                         filtered):
    """Kernel C at k = kt 65-128 and B at 65-256 run their pair-group
    route: D's or G's pass (groups of 64, 32 past kt 128) and
    ``merge_pairs`` once each, and not their query-major kernel; with and
    without a per-query filter their top k equals the query-major
    kernel's, the same-run yardstick, within 4.6e-5 (C) / 6.1e-5 (B), ids
    but at ties, and every id is admitted.  The merge of the pass's pairs
    equals ``torch.topk`` of them: the same values, ids but at ties."""
    fused, walked, args, pass1, tol = _fused_pair_case(dev, kernel, cap,
                                                       cap + k)
    qrot, centers, probes, *lists = args
    n_lists, nq = centers.shape[0], qrot.shape[0]
    ids = lists[-2] if kernel == "C" else lists[-1]
    fw = (_filter_words(dev, nq, int(ids.max()) + 1, 0.5, False, k)
          if filtered else None)
    route = (pcs.codes_fused_route(cap, 96, 48, 8, k, k) if kernel == "C"
             else pgs.scan_route(cap, 128, k, k))
    assert route[0] == "pair"
    counters = (pass1, pgs.merge_pairs, walked)
    before = [c.launches for c in counters]
    vk, ik = fused(*args, k, k, filter_words=fw)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0]
    vr, ir = walked(*args, k, k, filter_words=fw)
    torch.cuda.synchronize()
    _assert_topk_match(vk, ik, vr, ir, tol)
    if fw is not None:
        _assert_admitted(ik, fw)
    # pass 2 alone against torch.topk over the same pairs
    group = (pcs.code_pair_list_layout(96, 48, 8, k).group if kernel == "C"
             else ps.pair_list_layout(128, k, False).group)
    assert group == (64 if k <= 128 else 32)
    pv, pi = pass1(qrot, centers, probes,
                   *grouped.build_groups(probes, n_lists, group), *lists, k,
                   filter_words=fw)
    mv, mi = pgs.merge_pairs(pv, pi, k)
    tv, pos = torch.topk(pv.reshape(nq, -1), k, dim=1, largest=False)
    ti = torch.gather(pi.reshape(nq, -1), 1, pos)
    ti[torch.isinf(tv)] = -1
    assert torch.equal(mv, tv)
    _assert_topk_match(mv, mi, tv, ti, 0.0)
    assert torch.equal(mv, vk) and torch.equal(mi, ik)


@pytest.mark.parametrize("cap,pq_dim,pq_len,pq_bits,kt,chunks,filtered", [
    (416, 128, 2, 8, 100, 1, False),    # the books read from L2
    (416, 128, 2, 8, 128, 1, True),
    (416, 256, 1, 8, 100, 2, False),    # the LUT in chunks of 224 + 32
    (416, 232, 1, 8, 100, 2, True),     # byte loads (W 232): 224 + 8
    (64, 4096, 1, 4, 100, 2, False)])   # 4 bits, chunks of 3,360 + 736
def test_codes_pair_kernel_past_its_shared_memory_matches_plain(
        dev, cap, pq_dim, pq_len, pq_bits, kt, chunks, filtered):
    """Kernel D's query-major route where its books and whole LUT do not
    fit in shared memory together (shapes the Pallas codes gate admits):
    the books read from global memory, the LUT summed in chunks of
    ``LUT_STEP`` subspaces, held to the plain version as at the other
    shapes; with a filter, every id admitted.  Up to rot 1,024 the
    pair-group pass (its books in global memory) is D's route at these
    shapes, so the query-major kernel is called as itself there; past it
    (rot 4,096) ``ivf_pq_scan_codes`` takes the query-major kernel, the
    pass's refusal named."""
    smem, lut_sub, staged = pcs.codes_layout(cap, pq_dim * pq_len, pq_dim,
                                             pq_bits)
    assert not staged and -(-pq_dim // lut_sub) == chunks
    n_lists, nq, n_probes = 16, 40, 8
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, pq_dim + kt)
    qrot, probes = _queries(dev, nq, pq_dim * pq_len, n_lists, n_probes)
    fw = (_filter_words(dev, nq, n_lists * cap, 0.5, False, kt)
          if filtered else None)
    route, why = pcs.codes_scan_route(cap, pq_dim * pq_len, pq_dim, pq_bits,
                                      kt)
    assert route == ("pair" if pq_dim * pq_len <= 1024 else "query")
    before = _code_routes()
    if route == "query":
        assert "pair-group route: rot_dim 4096 past 1024" in why
        vk, ik = pcs.ivf_pq_scan_codes(qrot, centers, probes, codes, books,
                                       rsq, ids, pq_bits, kt, fw)
    else:
        vk, ik = pcs.codes_scan_query_major(qrot, centers, probes, codes,
                                            books, rsq, ids, pq_bits, kt, fw)
    torch.cuda.synchronize()
    assert tuple(_code_routes() - before) == D_ROUTE["query"]
    vp, ip = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes, books,
                                         rsq, ids, pq_bits, kt, fw)
    _assert_kernel_matches_plain(vk, ik, vp, ip)
    if filtered:
        _assert_admitted(ik, fw)


# (rot, pq_dim, pq_bits, kt) the list-major codes pass takes (the
# flagship's 8-bit books do not fit beside kt 64's top rows)
BIT_EQUAL_SHAPES = [
    (rot, pq_dim, bits, kt)
    for rot, pq_dim, bits in ((96, 48, 8), (128, 64, 8), (128, 32, 4),
                              (256, 128, 4), (48, 48, 8))
    for kt in (1, 4, 20, 64)
    if not pcs.code_list_scan_reject_reason(rot, pq_dim, bits, kt)]


@pytest.mark.parametrize("rot,pq_dim,pq_bits,kt", BIT_EQUAL_SHAPES)
def test_code_list_scan_is_bit_equal_to_list_scan_on_the_decoded_cache(
        dev, rot, pq_dim, pq_bits, kt):
    """The codes pass decodes each row to the bf16 recon cache's bits and
    multiplies them on the same tiles in the same order as the recon pass
    1, so on the same norms the two give the same values and ids
    (``torch.equal``), empty pairs included."""
    n_lists, cap = 40, 700
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, rot // pq_dim, pq_bits, rot + kt)
    qrot, probes = _queries(dev, 200, rot, n_lists, 10)
    groups = grouped.build_groups(probes, n_lists)
    cv, ci = pcs.code_list_scan(qrot, centers, probes, *groups, codes, books,
                                rsq, ids, pq_bits, kt)
    recon = pcs.decode_codes(codes, books, pq_bits)
    rv, ri = pgs.list_scan(qrot, centers, probes, *groups, recon, rsq, ids,
                           kt)
    torch.cuda.synchronize()
    assert torch.equal(cv, rv) and torch.equal(ci, ri)
    assert bool(torch.isinf(cv[0, -1]).all() and (ci[0, -1] == -1).all())


def _int8_index(dev, n_lists, cap, rot, seed, scale=None):
    """An int8 cache (zeros past rot in rows of round16(rot) bytes), the
    lists' scales (``scale`` for all of them where given), the dequantized
    row norms, centers and ids with padding (-1) and tombstones (<= -2)."""
    rng = np.random.default_rng(seed)
    rot_pad = -(-rot // 16) * 16
    i8 = torch.from_numpy(rng.integers(-127, 128, (n_lists, cap, rot_pad))
                          .astype(np.int8)).to(dev)
    i8[:, :, rot:] = 0
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, n_lists).astype(
        np.float32)).to(dev)
    if scale is not None:
        scales.fill_(scale)
    rsq8 = scales[:, None] ** 2 * (i8.float() ** 2).sum(-1)
    centers, _, _, ids = _random_index(dev, n_lists, cap, rot, cap)
    ids[:, 1::9] = torch.where(ids[:, 1::9] >= 0, -(ids[:, 1::9] + 2), -1)
    return i8, scales, rsq8, centers, ids


def _recon8_routes():
    """Launches of Kernel E's list-major pass, of its query-major kernel
    and of its pair-group pass."""
    return (pcs.recon8_list_scan.launches,
            pcs.recon8_scan_query_major.launches,
            pcs.recon8_pair_list_scan.launches)


# the launches _recon8_routes counts on each of Kernel E's routes
E_ROUTE = {"list": (1, 0, 0), "pair": (0, 0, 1), "query": (0, 1, 0)}


@pytest.mark.parametrize("cap,rot,kt", [(96, 128, 10), (700, 96, 4),
                                        (2368, 96, 4), (300, 24, 3),
                                        (64, 1000, 64)])
def test_recon8_kernel_matches_plain(dev, cap, rot, kt):
    """Kernel E through its dispatch, on the route its gate picks (its
    counter moves, the others' do not): the list-major pass
    (``recon8_list_scan``) at kt <= 64 where its shared memory holds the
    shape, else the pair-group pass (rot 1000 at kt 64); the dot scaled
    after it is summed, as the plain version does; each pair's top kt."""
    n_lists, nq, n_probes = 64, 40, 12
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot,
                                                 cap + rot)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    before = _recon8_routes()
    vk, ik = pcs.ivf_pq_scan_recon8(qrot, centers, probes, i8, scales, rsq8,
                                    ids, kt)
    torch.cuda.synchronize()
    route = pcs.recon8_scan_route(cap, i8.shape[2], kt)[0]
    assert route == ("list" if rot <= 128 else "pair")
    assert tuple(np.subtract(_recon8_routes(), before)) == E_ROUTE[route]
    vp, ip = pcs.ivf_pq_scan_recon8_plain(qrot, centers, probes, i8, scales,
                                          rsq8, ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


RECON8_LIST_SHAPES = [  # cap, rot, kt
    (300, 24, 1), (300, 24, 4), (300, 24, 64), (2100, 96, 4),
    (2100, 96, 64), (129, 96, 1), (416, 128, 20), (200, 256, 56),
    (1000, 1000, 8), (40, 96, 64)]


@pytest.mark.parametrize("cap,rot,kt", RECON8_LIST_SHAPES)
def test_recon8_list_scan_matches_its_plain_twin(dev, cap, rot, kt):
    """The list-major pass over the int8 rows against its plain twin on
    the same groups: capacities off a multiple of 128, rot 24 (rows of
    32 bytes), rot 256 and 1000 (residuals in 128-dim stages), kt 1 to
    64; values within 1e-4, ids but at ties, the skipped probe empty."""
    n_lists, nq, n_probes = 48, 60, 10
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot,
                                                 cap + kt)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    groups = grouped.build_groups(probes, n_lists)
    before = _recon8_routes()
    vk, ik = pcs.recon8_list_scan(qrot, centers, probes, *groups, i8, scales,
                                  rsq8, ids, kt)
    torch.cuda.synchronize()
    assert tuple(np.subtract(_recon8_routes(), before)) == E_ROUTE["list"]
    assert vk.shape == (nq, n_probes, min(kt, cap))
    assert bool(torch.isinf(vk[0, -1]).all() and (ik[0, -1] == -1).all())
    vp, ip = pcs.recon8_list_scan_plain(qrot, centers, probes, *groups, i8,
                                        scales, rsq8, ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("rot,kt", [(24, 1), (24, 64), (96, 4), (96, 20),
                                    (96, 64), (128, 4), (256, 20)])
def test_recon8_list_scan_at_scale_one_is_bit_equal_to_list_scan(dev, rot,
                                                                 kt):
    """With every scale 1 the int8 pass is Kernel G's pass 1 over the
    same rows as bf16 (``q8[..., :rot]``, exact in bf16) on the same
    norms: the same tiles, exact products, the same summation order and
    fold, so the same values and ids (``torch.equal``)."""
    n_lists, cap = 40, 700
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot,
                                                 rot + kt, scale=1.0)
    qrot, probes = _queries(dev, 200, rot, n_lists, 10)
    groups = grouped.build_groups(probes, n_lists)
    ev, ei = pcs.recon8_list_scan(qrot, centers, probes, *groups, i8, scales,
                                  rsq8, ids, kt)
    recon = i8[..., :rot].to(torch.bfloat16)
    gv, gi = pgs.list_scan(qrot, centers, probes, *groups, recon, rsq8, ids,
                           kt)
    torch.cuda.synchronize()
    assert torch.equal(ev, gv) and torch.equal(ei, gi)


@pytest.mark.parametrize("kt", [64, 65])
def test_recon8_scan_routes_by_kt(dev, kt):
    """A pair kt of 64 takes E's list-major pass, 65 its pair-group pass,
    each held to the plain version."""
    n_lists, cap, rot = 32, 300, 96
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot, kt)
    qrot, probes = _queries(dev, 30, rot, n_lists, 6)
    before = _recon8_routes()
    vk, ik = pcs.ivf_pq_scan_recon8(qrot, centers, probes, i8, scales, rsq8,
                                    ids, kt)
    torch.cuda.synchronize()
    assert tuple(np.subtract(_recon8_routes(), before)) == E_ROUTE[
        "list" if kt <= 64 else "pair"]
    vp, ip = pcs.ivf_pq_scan_recon8_plain(qrot, centers, probes, i8, scales,
                                          rsq8, ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


# Kernels D and E past kt 64: the pair-group pass (csrc/pair_list_scan.cu)
# with the packed codes decoded and the int8 rows converted in shared
# memory

PAIR_CODE_SHAPES = [  # cap, pq_dim, pq_len, pq_bits, kt
    (300, 48, 2, 8, 65), (300, 48, 2, 8, 100), (2368, 48, 2, 8, 128),
    (416, 64, 2, 8, 128), (300, 32, 4, 4, 100), (200, 12, 3, 4, 65),
    (160, 36, 1, 8, 128), (200, 128, 2, 4, 100), (90, 16, 8, 8, 128),
    (200, 128, 2, 8, 100), (120, 232, 1, 8, 70)]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("cap,pq_dim,pq_len,pq_bits,kt", PAIR_CODE_SHAPES)
def test_code_pair_list_scan_matches_plain(dev, cap, pq_dim, pq_len, pq_bits,
                                           kt, filtered):
    """Kernel D's pair-group pass through ``ivf_pq_scan_codes`` at kt 65
    to 128, 4 and 8 bits, rot off a multiple of 8 (36, 232) and past 128
    (256: residuals in 128-dim stages; at 8 bits books of 128 KB, in
    global memory), the deep and flagship shapes, a hot list over several
    groups: its counter moves and no other route's; values within 1e-4,
    ids but at ties, the skipped probe empty; with a 50% filter, every id
    admitted."""
    n_lists, nq, n_probes = 48, 200, 8
    rot = pq_dim * pq_len
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, cap + kt)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    probes[:, 1] = torch.where(probes[:, 0] == 5, probes[:, 1],
                               torch.full_like(probes[:, 1], 5))
    probes[probes[:, 0] == 5, 0] = 6
    fw = (_filter_words(dev, nq, n_lists * cap, 0.5, False, kt)
          if filtered else None)
    assert pcs.codes_scan_route(cap, rot, pq_dim, pq_bits, kt)[0] == "pair"
    before = _code_routes()
    vk, ik = pcs.ivf_pq_scan_codes(qrot, centers, probes, codes, books, rsq,
                                   ids, pq_bits, kt, fw)
    torch.cuda.synchronize()
    assert tuple(_code_routes() - before) == D_ROUTE["pair"]
    assert vk.shape == (nq, n_probes, min(kt, cap))
    assert bool(torch.isinf(vk[0, -1]).all() and (ik[0, -1] == -1).all())
    vp, ip = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes, books,
                                         rsq, ids, pq_bits, kt, fw)
    _assert_kernel_matches_plain(vk, ik, vp, ip)
    if filtered:
        _assert_admitted(ik, fw)


PAIR_RECON8_SHAPES = [  # cap, rot, kt
    (300, 96, 65), (2368, 96, 128), (300, 24, 100), (416, 128, 128),
    (200, 256, 100), (100, 1000, 65), (90, 36, 128)]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("cap,rot,kt", PAIR_RECON8_SHAPES)
def test_recon8_pair_list_scan_matches_plain(dev, cap, rot, kt, filtered):
    """Kernel E's pair-group pass through ``ivf_pq_scan_recon8`` at kt 65,
    100 and 128, rows of 32 to 1,008 bytes (rot 256 and 1000: 128-dim
    stages), per-list scales applied to the summed dot: its counter moves
    and no other route's; values within 1e-4, ids but at ties; with a 50%
    filter, every id admitted."""
    n_lists, nq, n_probes = 48, 200, 8
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot,
                                                 cap + kt)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    fw = (_filter_words(dev, nq, int(ids.max()) + 1, 0.5, False, kt)
          if filtered else None)
    assert pcs.recon8_scan_route(cap, i8.shape[2], kt)[0] == "pair"
    before = _recon8_routes()
    vk, ik = pcs.ivf_pq_scan_recon8(qrot, centers, probes, i8, scales, rsq8,
                                    ids, kt, fw)
    torch.cuda.synchronize()
    assert tuple(np.subtract(_recon8_routes(), before)) == E_ROUTE["pair"]
    assert bool(torch.isinf(vk[0, -1]).all() and (ik[0, -1] == -1).all())
    vp, ip = pcs.ivf_pq_scan_recon8_plain(qrot, centers, probes, i8, scales,
                                          rsq8, ids, kt, fw)
    _assert_kernel_matches_plain(vk, ik, vp, ip)
    if filtered:
        _assert_admitted(ik, fw)


@pytest.mark.parametrize("kt", [100, 128])
@pytest.mark.parametrize("kernel", ["D8", "D4", "E"])
def test_code_pair_list_scans_group_size_leaves_the_result_bit_equal(
        dev, kernel, kt):
    """D and E's pair-group pass at 64, 32 and 16 pairs a group: the same
    values and ids bit for bit."""
    n_lists, nq, n_probes, cap = 32, 200, 8, 300
    if kernel == "E":
        i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, 96,
                                                     11)
        q, probes = _queries(dev, nq, 96, n_lists, n_probes)
        runs = [lambda g=g: pcs.recon8_pair_list_scan(
            q, centers, probes, *grouped.build_groups(probes, n_lists, g),
            i8, scales, rsq8, ids, kt, group=g) for g in (64, 32, 16)]
    else:
        bits = int(kernel[1])
        centers, codes, books, rsq, ids, *_ = _random_code_index(
            dev, n_lists, cap, 48, 2, bits, 11)
        q, probes = _queries(dev, nq, 96, n_lists, n_probes)
        runs = [lambda g=g: pcs.code_pair_list_scan(
            q, centers, probes, *grouped.build_groups(probes, n_lists, g),
            codes, books, rsq, ids, bits, kt, group=g) for g in (64, 32, 16)]
    outs = [run() for run in runs]
    torch.cuda.synchronize()
    for v, i in outs[1:]:
        assert torch.equal(v, outs[0][0]) and torch.equal(i, outs[0][1])


@pytest.mark.parametrize("rot,pq_dim,pq_bits,kt", [
    (96, 48, 8, 65), (96, 48, 8, 128), (128, 64, 8, 100), (128, 32, 4, 128),
    (256, 128, 4, 100)])
def test_code_pair_list_scan_is_bit_equal_to_the_recon_pass_on_the_decoded_cache(
        dev, rot, pq_dim, pq_bits, kt):
    """D's pass decodes each row to the bf16 recon cache's bits and runs
    G's pass on them, so on the same norms and groups it gives Kernel G's
    pair-group pass over ``decode_codes`` the same values and ids
    (``torch.equal``), at the group the layout picks and at 32."""
    n_lists, cap = 40, 700
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, rot // pq_dim, pq_bits, rot + kt)
    qrot, probes = _queries(dev, 200, rot, n_lists, 10)
    recon = pcs.decode_codes(codes, books, pq_bits)
    picked = pcs.code_pair_list_layout(rot, pq_dim, pq_bits, kt).group
    for group in sorted({picked, 32}):
        groups = grouped.build_groups(probes, n_lists, group)
        cv, ci = pcs.code_pair_list_scan(qrot, centers, probes, *groups,
                                         codes, books, rsq, ids, pq_bits, kt,
                                         group=group)
        rv, ri = ps.recon_pair_list_scan(qrot, centers, probes, *groups,
                                         recon, rsq, ids, kt, group=group)
        torch.cuda.synchronize()
        assert torch.equal(cv, rv) and torch.equal(ci, ri)


@pytest.mark.parametrize("rot,kt", [(24, 65), (96, 100), (96, 128),
                                    (128, 128), (256, 100)])
def test_recon8_pair_list_scan_at_scale_one_is_bit_equal_to_the_recon_pass(
        dev, rot, kt):
    """With every scale 1 and rows of round16(rot) bytes, E's pass is
    Kernel G's pair-group pass over ``q8[..., :rot]`` as bf16 rows (exact)
    on the same norms and groups: the same values and ids."""
    n_lists, cap = 40, 700
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot,
                                                 rot + kt, scale=1.0)
    qrot, probes = _queries(dev, 200, rot, n_lists, 10)
    group = pcs.recon8_pair_list_layout(i8.shape[2], kt).group
    groups = grouped.build_groups(probes, n_lists, group)
    ev, ei = pcs.recon8_pair_list_scan(qrot, centers, probes, *groups, i8,
                                       scales, rsq8, ids, kt, group=group)
    recon = i8[..., :rot].to(torch.bfloat16)
    gv, gi = ps.recon_pair_list_scan(qrot, centers, probes, *groups, recon,
                                     rsq8, ids, kt, group=group)
    torch.cuda.synchronize()
    assert torch.equal(ev, gv) and torch.equal(ei, gi)


@pytest.mark.parametrize("filtered", [False, True])
def test_recon8_rows_past_the_pair_group_pass_take_the_query_major_kernel(
        dev, filtered):
    """Int8 rows past 1,024 bytes (rot_pad 1,104): the pair-group pass
    refuses them by name and the query-major kernel (``kWide``) runs,
    held to the plain version, unfiltered and under a filter admitting
    half the ids (every kept id admitted)."""
    n_lists, cap, rot, kt, nq = 32, 120, 1100, 100, 30
    i8, scales, rsq8, centers, ids = _int8_index(dev, n_lists, cap, rot, 5)
    qrot, probes = _queries(dev, nq, rot, n_lists, 6)
    fw = (_filter_words(dev, nq, n_lists * cap, 0.5, False, kt)
          if filtered else None)
    route, why = pcs.recon8_scan_route(cap, i8.shape[2], kt)
    assert route == "query" and "past 1024" in why
    before = _recon8_routes()
    vk, ik = pcs.ivf_pq_scan_recon8(qrot, centers, probes, i8, scales, rsq8,
                                    ids, kt, fw)
    torch.cuda.synchronize()
    assert tuple(np.subtract(_recon8_routes(), before)) == E_ROUTE["query"]
    vp, ip = pcs.ivf_pq_scan_recon8_plain(qrot, centers, probes, i8, scales,
                                          rsq8, ids, kt, fw)
    _assert_kernel_matches_plain(vk, ik, vp, ip)
    if filtered:
        _assert_admitted(ik, fw)


def test_code_scans_reject_what_they_cannot_hold(dev):
    centers, codes, books, rsq, ids, i8, scales, rsq8 = _random_code_index(
        dev, 4, 32, 8, 2, 8, 0)
    q = torch.zeros(2, 16, device=dev)
    probes = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(LogicError, match="outside 1..256"):
        pcs.ivf_pq_scan_codes_fused(q, centers, probes, codes, books, rsq,
                                    ids, 8, 300, 4)
    with pytest.raises(LogicError, match="kt=0"):
        pcs.ivf_pq_scan_codes(q, centers, probes, codes, books, rsq, ids, 8,
                              0)
    with pytest.raises(LogicError, match="kt=0"):
        pcs.ivf_pq_scan_recon8(q, centers, probes, i8, scales, rsq8, ids, 0)


def _flat_lists(dev, n_lists, cap, dim, seed):
    """Random fp32 list rows, their squared norms, and ids with padding
    (-1) and tombstones (<= -2)."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.normal(size=(n_lists, cap, dim)).astype(
        np.float32)).to(dev)
    ids = _random_index(dev, n_lists, cap, 8, seed)[3]
    return data, (data * data).sum(-1), ids


def _flat_routes():
    """Launches of Kernel F's list-major pass, of its pair-group pass and
    of its query-major route."""
    return np.array([ps.flat_list_scan.launches,
                     ps.flat_pair_list_scan.launches,
                     ps.flat_scan_query_major.launches])


# each route's launch vector, as _flat_routes and _recon_routes count them
ROUTE = {"list": (1, 0, 0), "pair": (0, 1, 0), "query": (0, 0, 1)}


def _check_flat_scan(q, probes, data, dsq, ids, kt, ip, sub_lists=1):
    """Kernel F through ``ivf_flat_scan`` against its plain version: the
    route ``flat_scan_route`` picks launched once (kt' = min(kt, tile) up
    to KT_LIST_MAX: list-major; up to PAIR_KT_MAX: the pair-group pass;
    else query-major); values within 1e-5 of the scale ‖q‖² + max ‖x‖² that
    fp32 cancellation (and 3xTF32's dropped terms, ~1.5·2⁻²⁰ of it) moves
    them by; ids equal but at ties; every returned id in its pair's tile,
    its distance recomputed within the same tolerance."""
    rows = data.shape[1]
    before = _flat_routes()
    vk, ik = ps.ivf_flat_scan(q, probes, data, dsq, ids, kt, ip,
                              sub_lists=sub_lists)
    torch.cuda.synchronize()
    route = ps.flat_scan_route(rows, data.shape[2], min(kt, rows),
                               sub_lists)[0]
    assert tuple(_flat_routes() - before) == ROUTE[route]
    assert vk.shape == (*probes.shape, min(kt, rows))
    vp, ip_ = ps.ivf_flat_scan_plain(q, probes, data, dsq, ids, kt, ip)
    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)) and torch.equal(ik < 0, ~fin)
    scale = float((q * q).sum(1).max() + dsq.max())
    torch.testing.assert_close(vk[fin], vp[fin], rtol=0, atol=1e-5 * scale)
    assert float((ik == ip_).float().mean()) >= 0.99
    flat = ids.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    slot_of[flat[flat >= 0].long()] = torch.nonzero(flat >= 0)[:, 0]
    slot = slot_of[ik[fin].long()]
    pair = torch.nonzero(fin)
    assert bool((slot // rows == probes.long()[pair[:, 0], pair[:, 1]]).all())
    qv = q[pair[:, 0]]
    dot = (qv * data.reshape(-1, data.shape[2])[slot]).sum(1)
    d = -dot if ip else torch.clamp_min(
        (qv * qv).sum(1) + dsq.reshape(-1)[slot] - 2.0 * dot, 0.0)
    torch.testing.assert_close(-d if ip else d, vk[fin], rtol=0,
                               atol=1e-5 * scale)
    return vk, ik


@pytest.mark.parametrize("cap,dim,kt,ip", [
    (96, 128, 10, False), (96, 128, 10, True), (832, 128, 10, False),
    (768, 128, 10, False), (300, 96, 40, False), (64, 1024, 64, True),
    (40, 12, 3, False)])
def test_ivf_flat_scan_kernel_matches_plain(dev, cap, dim, kt, ip):
    """Kernel F: each pair's top kt, (+inf, -1) -- (-inf, -1) for
    InnerProduct -- past its live rows and on the skipped probes; values
    within 1e-5 of the scale ‖q‖² + max ‖x‖² that fp32 cancellation moves
    them by; ids equal but at ties.  Every shape here runs the list-major
    pass (the launch counters say so)."""
    n_lists, nq, n_probes = 64, 40, 12
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, cap + dim)
    q, probes = _queries(dev, nq, dim, n_lists, n_probes)
    probes[1, 2] = n_lists             # a super-tile dedupe sentinel
    before = _flat_routes()
    vk, _ = _check_flat_scan(q, probes, data, dsq, ids, kt, ip)
    assert tuple(_flat_routes() - before) == ROUTE["list"]
    assert vk.shape == (nq, n_probes, min(kt, cap))
    assert bool(torch.isinf(vk[0, -1]).all() and torch.isinf(vk[1, 2]).all())


@pytest.mark.parametrize("cap,dim,kt,ip", [
    (300, 128, 64, False), (300, 128, 65, False), (300, 128, 64, True),
    (300, 128, 65, True), (200, 1024, 10, True), (200, 1024, 33, True),
    (416, 128, 20, False), (96, 20, 5, False), (2368, 96, 10, False),
    (200, 1, 10, False), (200, 3, 10, True), (200, 25, 10, False),
    (200, 50, 64, True), (200, 97, 33, False), (200, 25, 100, False),
    (200, 50, 100, True), (200, 3, 65, False), (416, 128, 300, False),
    (416, 128, 300, True), (416, 25, 257, False), (416, 50, 300, True)],
    ids=["kt64-list", "kt65-pair", "ip-kt64-list", "ip-kt65-pair",
         "ip-dim1024", "ip-dim1024-kt33", "kt20", "dim20", "cap2368",
         "dim1", "ip-dim3", "dim25", "ip-dim50-kt64", "dim97-kt33",
         "dim25-kt100-pair", "ip-dim50-kt100-pair", "dim3-kt65-pair",
         "kt300-query", "ip-kt300-query", "dim25-kt257-query",
         "ip-dim50-kt300-query"])
def test_ivf_flat_scan_routes_by_kt(dev, cap, dim, kt, ip):
    """Kt 64 takes the list-major pass, kt 65 to 256 the pair-group pass,
    past 256 the query-major kernel (``pair_scan.cu``), each held to the
    plain version (``_check_flat_scan`` asserts the route by the launch
    counters, and the case's id names it); dim 1024 streams the queries
    with the rows (the layout cannot keep them resident), dim 20 pads its
    last k-step with zeros, a capacity of 2,368 takes 19 row windows; a
    row width off a multiple of 4 (GloVe's 25 and 50 among them) takes
    every route, its rows loaded a value at a time."""
    route = ("list" if kt <= ps.KT_LIST_MAX else
             "pair" if kt <= ps.PAIR_KT_MAX else "query")
    assert ps.flat_scan_route(cap, dim, kt)[0] == route
    data, dsq, ids = _flat_lists(dev, 48, cap, dim, cap + dim + kt)
    q, probes = _queries(dev, 40, dim, 48, 10)
    before = _flat_routes()
    _check_flat_scan(q, probes, data, dsq, ids, kt, ip)
    assert tuple(_flat_routes() - before) == ROUTE[route]


@pytest.mark.parametrize("F", [2, 4, 8])
@pytest.mark.parametrize("ip", [False, True])
def test_ivf_flat_scan_super_tiles_skip_dead_slots(dev, F, ip):
    """A super-tile of F lists (the (L/F, F·cap, dim) view with dedupe
    sentinels, as ivf_flat.search gives it): each sub-list streamed up to
    its last live row, the padding between sub-lists never entering; a
    list with no live row, and a tile with none."""
    n_lists, cap, dim, nq, n_probes = 64, 96, 128, 60, 16
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, 7 * F)
    ids[3] = -1                        # a dead sub-list
    ids[2 * F:3 * F] = -1              # a dead tile
    q, probes = _queries(dev, nq, dim, n_lists, n_probes)
    n_eff = n_lists // F
    sp = probes // F
    dup = torch.zeros_like(sp, dtype=torch.bool)
    for j in range(1, n_probes):
        dup[:, j] = (sp[:, j:j + 1] == sp[:, :j]).any(1)
    sp = torch.where(dup | (probes < 0), torch.full_like(sp, n_eff), sp)
    _check_flat_scan(q, sp, data.reshape(n_eff, F * cap, dim),
                     dsq.reshape(n_eff, F * cap), ids.reshape(n_eff, F * cap),
                     10, ip, sub_lists=F)


@pytest.mark.parametrize("ip", [False, True])
def test_ivf_flat_scan_splits_a_hot_tile_across_groups(dev, ip):
    """300 queries all probe list 5 (three groups of one tile) besides
    their own probes; one probe negative, one a sentinel past the lists."""
    n_lists, nq, n_probes, cap, dim = 32, 300, 6, 416, 128
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, 3)
    q, probes = _queries(dev, nq, dim, n_lists, n_probes)
    probes[:, 1] = torch.where(probes[:, 0] == 5, probes[:, 1],
                               torch.full_like(probes[:, 1], 5))
    probes[probes[:, 0] == 5, 0] = (5 + 1) % n_lists
    probes[3, 2] = n_lists
    assert int((grouped.build_groups(probes, n_lists)[0] == 5).sum()) >= 3
    vk, ik = _check_flat_scan(q, probes, data, dsq, ids, 20, ip)
    worst = float("-inf") if ip else float("inf")
    assert bool((vk[3, 2] == worst).all() and (ik[3, 2] == -1).all())


def test_ivf_flat_scan_misaligned_operands_load_a_value_at_a_time(dev):
    """Queries and rows that start off a 16-byte boundary (views one float
    into their storage) at dim 128 take the one-value loads: same result
    as the plain version, list-major (kt 10) and the pair-group pass (kt
    80)."""
    cap, n_lists, dim, nq = 96, 32, 128, 40
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, 5)
    q, probes = _queries(dev, nq, dim, n_lists, 8)
    qs = torch.empty(nq * dim + 1, device=dev)[1:].view(nq, dim)
    qs.copy_(q)
    ds = torch.empty(data.numel() + 1, device=dev)[1:].view(data.shape)
    ds.copy_(data)
    assert qs.data_ptr() % 16 and ds.data_ptr() % 16
    before = _flat_routes()
    _check_flat_scan(qs, probes, ds, dsq, ids, 10, False)
    assert tuple(_flat_routes() - before) == (1, 0, 0)
    _check_flat_scan(qs, probes, ds, dsq, ids, 80, False)
    assert tuple(_flat_routes() - before) == (1, 1, 0)


@pytest.mark.parametrize("k", [10, 100])
def test_ivf_flat_search_at_dim_25_is_exact_with_every_list_probed(dev, k):
    """``ivf_flat.search`` on a dim-25 index runs the list-major pass at k
    10 and the pair-group pass at k 100 (one-value row loads); with every list probed its distances are
    brute force's, within 1e-5 of ‖q‖² + max ‖x‖²."""
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_flat

    rng = np.random.default_rng(25)
    db = torch.from_numpy(rng.normal(size=(3000, 25)).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(50, 25)).astype(np.float32)).to(
        dev)
    res = DeviceResources(seed=0, device=dev)
    index = ivf_flat.build(res, ivf_flat.IndexParams(n_lists=16), db)
    before = _flat_routes()
    dist, found = ivf_flat.search(res, ivf_flat.SearchParams(n_probes=16),
                                  index, q, k)
    torch.cuda.synchronize()
    assert tuple(_flat_routes() - before) == ROUTE["list" if k <= 64
                                                   else "pair"]
    ref = torch.cdist(q.double(), db.double()).square().float()
    ref_d = torch.topk(ref, k, largest=False).values
    scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
    torch.testing.assert_close(dist, ref_d, rtol=0, atol=1e-5 * scale)
    got = ref.gather(1, found.long())
    torch.testing.assert_close(got, dist, rtol=0, atol=1e-5 * scale)


def _super_view(data, dsq, ids, probes, F):
    """The (L/F, F·cap) super-tile view of F adjacent lists and the
    deduplicated super-probes (sentinel L/F), as ivf_flat.search makes
    them."""
    n_lists, cap, dim = data.shape
    n_eff = n_lists // F
    sp = probes // F
    dup = torch.zeros_like(sp, dtype=torch.bool)
    for j in range(1, probes.shape[1]):
        dup[:, j] = (sp[:, j:j + 1] == sp[:, :j]).any(1)
    sp = torch.where(dup | (probes < 0), torch.full_like(sp, n_eff), sp)
    return (sp, data.reshape(n_eff, F * cap, dim),
            dsq.reshape(n_eff, F * cap), ids.reshape(n_eff, F * cap))


@pytest.mark.parametrize("cap,dim,kt,ip,F", [
    (300, 128, 100, False, 1), (300, 128, 100, True, 1),
    (416, 128, 128, False, 1), (416, 128, 256, False, 1),
    (416, 128, 256, True, 1), (300, 128, 65, False, 1),
    (200, 25, 100, False, 1), (200, 25, 256, True, 1),
    (200, 1024, 100, True, 1), (200, 1024, 256, False, 1),
    (96, 128, 100, False, 4), (96, 128, 200, True, 8),
    (2368, 96, 200, False, 1), (200, 3, 65, False, 1),
    (200, 50, 129, True, 2)])
def test_flat_pair_list_scan_matches_plain(dev, cap, dim, kt, ip, F):
    """Kernel F's pair-group pass (kt 65-256, groups of 64 or 32 pairs):
    every width from 3 to 1,024 (queries resident or streamed, one-value
    loads off a multiple of 4), InnerProduct, super-tiles of F lists with
    a dead sub-list and a dead tile, a capacity of 2,368 (19 windows),
    held to the plain version by ``_check_flat_scan`` (the route by the
    launch counters)."""
    n_lists, nq, n_probes = 64, 40, 12
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, cap + dim + kt)
    ids[3] = -1                        # a dead list (a dead sub-list)
    if F > 1:
        ids[2 * F:3 * F] = -1          # a dead tile
    q, probes = _queries(dev, nq, dim, n_lists, n_probes)
    if F > 1:
        probes, data, dsq, ids = _super_view(data, dsq, ids, probes, F)
    before = _flat_routes()
    vk, ik = _check_flat_scan(q, probes, data, dsq, ids, kt, ip,
                              sub_lists=F)
    assert tuple(_flat_routes() - before) == ROUTE["pair"]
    worst = float("-inf") if ip else float("inf")
    assert bool((vk[0, -1] == worst).all() and (ik[0, -1] == -1).all())


@pytest.mark.parametrize("ip", [False, True])
def test_flat_pair_list_scan_splits_a_hot_tile_across_groups(dev, ip):
    """300 queries all probe list 5 (five groups of one tile) at kt 100;
    one probe negative, one a sentinel past the lists."""
    n_lists, nq, n_probes, cap, dim = 32, 300, 6, 416, 128
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, 3)
    q, probes = _queries(dev, nq, dim, n_lists, n_probes)
    probes[:, 1] = torch.where(probes[:, 0] == 5, probes[:, 1],
                               torch.full_like(probes[:, 1], 5))
    probes[probes[:, 0] == 5, 0] = (5 + 1) % n_lists
    probes[3, 2] = n_lists
    group = ps.pair_list_layout(dim, 100, True).group
    assert int((grouped.build_groups(probes, n_lists, group)[0] == 5).sum()
               ) >= 5
    before = _flat_routes()
    vk, ik = _check_flat_scan(q, probes, data, dsq, ids, 100, ip)
    assert tuple(_flat_routes() - before) == ROUTE["pair"]
    worst = float("-inf") if ip else float("inf")
    assert bool((vk[3, 2] == worst).all() and (ik[3, 2] == -1).all())


@pytest.mark.parametrize("kernel", ["F", "G"])
@pytest.mark.parametrize("kt", [100, 256])
def test_pair_list_scan_group_size_leaves_the_result_bit_equal(dev, kernel,
                                                               kt):
    """The pair-group pass at 64, 32 and 16 pairs a group (``group`` given;
    64 only where it fits, kt up to 128): the same values and ids bit for
    bit, as a pair's products do not depend on its row of the tile (what
    the full-probe contracts, a filtered k 100 against an unfiltered k 256
    at another group size, rely on)."""
    n_lists, nq, n_probes, cap = 32, 200, 8, 300
    if kernel == "F":
        data, dsq, ids = _flat_lists(dev, n_lists, cap, 128, 11)
        q, probes = _queries(dev, nq, 128, n_lists, n_probes)

        def run(group):
            return ps.flat_pair_list_scan(
                q, probes, *grouped.build_groups(probes, n_lists, group),
                data, dsq, ids, kt, group=group)
    else:
        centers, recon, rsq, ids = _random_index(dev, n_lists, cap, 128, 11)
        q, probes = _queries(dev, nq, 128, n_lists, n_probes)

        def run(group):
            return ps.recon_pair_list_scan(
                q, centers, probes,
                *grouped.build_groups(probes, n_lists, group), recon, rsq,
                ids, kt, group=group)
    groups = (64, 32, 16) if kt <= 128 else (32, 16)
    outs = [run(group) for group in groups]
    torch.cuda.synchronize()
    for v, i in outs[1:]:
        assert torch.equal(v, outs[0][0]) and torch.equal(i, outs[0][1])


@pytest.mark.parametrize("cap,rot,kt", [(300, 128, 100), (416, 128, 128),
                                        (416, 128, 256), (300, 96, 65),
                                        (128, 1024, 100), (200, 256, 200),
                                        (2368, 96, 200), (80, 24, 70)])
def test_recon_pair_list_scan_matches_plain(dev, cap, rot, kt):
    """Kernel G's pair-group pass (kt 65-256; rot past 128 in 128-dim
    residual stages) against its plain version, the route by the launch
    counters; a hot list split across five groups at the first shape."""
    n_lists, nq, n_probes = 64, 300, 6
    centers, recon, rsq, ids = _random_index(dev, n_lists, cap, rot, cap + kt)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    probes[:, 1] = torch.where(probes[:, 0] == 5, probes[:, 1],
                               torch.full_like(probes[:, 1], 5))
    probes[probes[:, 0] == 5, 0] = 6
    probes[3, 2] = n_lists
    before = _recon_routes()
    vk, ik = ps.ivf_pq_scan_recon(qrot, centers, probes, recon, rsq, ids, kt)
    torch.cuda.synchronize()
    assert tuple(_recon_routes() - before) == ROUTE["pair"]
    assert vk.shape == (nq, n_probes, min(kt, cap))
    vp, ip = ps.ivf_pq_scan_recon_plain(qrot, centers, probes, recon, rsq,
                                        ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)
    assert bool(torch.isinf(vk[3, 2]).all() and (ik[3, 2] == -1).all())


def _recon_routes():
    """Launches of Kernel G's list-major pass 1, of its pair-group pass and
    of its query-major route."""
    return np.array([pgs.list_scan.launches,
                     ps.recon_pair_list_scan.launches,
                     ps.recon_scan_query_major.launches])


@pytest.mark.parametrize("cap,rot,kt", [(96, 128, 10), (416, 128, 20),
                                        (2368, 96, 4), (40, 24, 40),
                                        (64, 1024, 64), (300, 96, 100),
                                        (300, 128, 300)])
def test_ivf_pq_scan_recon_kernel_matches_plain(dev, cap, rot, kt):
    """Kernel G: Kernel B's distances with each pair's top kt; kt up to
    KT_LIST_MAX on the list-major pass 1, up to PAIR_KT_MAX the pair-group
    pass, above it the query-major kernel."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, recon, rsq, ids = _random_index(dev, n_lists, cap, rot, cap + kt)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    before = _recon_routes()
    vk, ik = ps.ivf_pq_scan_recon(qrot, centers, probes, recon, rsq, ids, kt)
    torch.cuda.synchronize()
    route = ps.recon_scan_route(rot, min(kt, cap))[0]
    assert tuple(_recon_routes() - before) == ROUTE[route]
    assert vk.shape == (nq, n_probes, min(kt, cap))
    vp, ip = ps.ivf_pq_scan_recon_plain(qrot, centers, probes, recon, rsq,
                                        ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("kernel", ["B", "G", "C", "D", "E"])
def test_list_major_scans_split_a_hot_list_across_groups(dev, kernel):
    """300 queries all probe list 5 (three groups of one list) besides
    their own probes, one probe is negative and one a sentinel past the
    lists: Kernels B and G, C and D over the codes, and E over the int8
    rows, against their plain versions."""
    n_lists, nq, n_probes, cap, rot, k, kt = 32, 300, 6, 416, 128, 20, 20
    if kernel in "CDE":
        centers, codes, books, rsq, ids, i8, scales, rsq8 = \
            _random_code_index(dev, n_lists, cap, 64, 2, 8, 3)
    else:
        centers, recon, rsq, ids = _random_index(dev, n_lists, cap, rot, 3)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    probes[:, 1] = torch.where(probes[:, 0] == 5, probes[:, 1],
                               torch.full_like(probes[:, 1], 5))
    probes[probes[:, 0] == 5, 0] = (5 + 1) % n_lists
    probes[3, 2] = n_lists
    groups = grouped.build_groups(probes, n_lists)
    assert int((groups[0] == 5).sum()) >= 3
    if kernel == "B":
        vk, ik = pgs.ivf_pq_scan_fused(qrot, centers, probes, recon, rsq, ids,
                                       k, kt)
        vp, ip = pgs.ivf_pq_scan_fused_plain(qrot, centers, probes, recon,
                                             rsq, ids, k, kt)
    elif kernel == "C":
        vk, ik = pcs.ivf_pq_scan_codes_fused(qrot, centers, probes, codes,
                                             books, rsq, ids, 8, k, kt)
        vp, ip = pcs.ivf_pq_scan_codes_fused_plain(
            qrot, centers, probes, codes, books, rsq, ids, 8, k, kt)
    elif kernel == "D":
        vk, ik = pcs.ivf_pq_scan_codes(qrot, centers, probes, codes, books,
                                       rsq, ids, 8, kt)
        vp, ip = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes,
                                             books, rsq, ids, 8, kt)
        assert bool(torch.isinf(vk[3, 2]).all() and (ik[3, 2] == -1).all())
    elif kernel == "E":
        vk, ik = pcs.ivf_pq_scan_recon8(qrot, centers, probes, i8, scales,
                                        rsq8, ids, kt)
        vp, ip = pcs.ivf_pq_scan_recon8_plain(qrot, centers, probes, i8,
                                              scales, rsq8, ids, kt)
        assert bool(torch.isinf(vk[3, 2]).all() and (ik[3, 2] == -1).all())
    else:
        vk, ik = ps.ivf_pq_scan_recon(qrot, centers, probes, recon, rsq, ids,
                                      kt)
        vp, ip = ps.ivf_pq_scan_recon_plain(qrot, centers, probes, recon, rsq,
                                            ids, kt)
        assert bool(torch.isinf(vk[3, 2]).all() and (ik[3, 2] == -1).all())
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(vk, ik, vp, ip)


def _assert_nn_matches_plain(x, y, dk, ik, sqrt=False):
    """Kernel H's tensor-core pass against the plain version: dmin within
    1e-5 of ‖x‖² + max ‖y‖² (3xTF32 products summed in the tensor core's
    order), each index equal to the plain version's or at a distance tie
    with it (both recomputed directly)."""
    dp, ip = fnn.fused_l2_nn_plain(x, y, sqrt)
    d2k, d2p = (dk ** 2, dp ** 2) if sqrt else (dk, dp)
    if x.shape[0] == 0:
        assert dk.shape == ik.shape == (0,)
        return
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    torch.testing.assert_close(d2k, d2p, rtol=0, atol=1e-5 * scale)
    dist_k = ((x - y[ik.long()]) ** 2).sum(1)
    dist_p = ((x - y[ip.long()]) ** 2).sum(1)
    assert bool(((ik == ip) | ((dist_k - dist_p).abs() <= 1e-5 * scale))
                .all())


def _nn_inputs(dev, m, n, k, dup):
    """x (m, k), y (n, k) from a seed; with ``dup``, y[1] repeated as the
    last row and x[0] = y[1] + 1e-3, so index 1 must win."""
    rng = np.random.default_rng(m + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(dev)
    if dup and n > 5 and m > 0:
        y[n - 1] = y[1]
        x[0] = y[1] + 1e-3
    return x, y


@pytest.mark.parametrize("m,n,k,sqrt", [(1000, 1024, 128, False),
                                        (333, 37, 50, True),
                                        (4096, 8192, 96, False),
                                        (70, 3, 2, False), (5, 300, 1000, True),
                                        (257, 129, 17, False),
                                        (129, 200, 25, True),
                                        (1000, 130, 129, True),
                                        (300, 1, 129, False),
                                        (0, 50, 128, False),
                                        (3001, 4095, 128, False),
                                        (200, 300, 1000, False)])
def test_fused_l2_nn_kernel_matches_plain(dev, m, n, k, sqrt):
    """Kernel H: at k > 16 the tensor-core pass (and not the small-dim
    kernel) launches once, dmin within 1e-5 of ‖x‖² + max ‖y‖², the index
    equal to the plain version's or at a distance tie with it; a
    duplicated y row resolves to its first copy.  Dims 17-1000 (x resident
    up to 160, streamed above), m and n off multiples of 128, n = 1 and m
    = 0."""
    x, y = _nn_inputs(dev, m, n, k, True)
    before = fnn.fused_l2_nn.launches
    small = fnn.fused_l2_nn.small_dim_launches
    dk, ik = fnn.fused_l2_nn(x, y, sqrt)
    torch.cuda.synchronize()
    assert fnn.fused_l2_nn.launches == before + 1
    assert fnn.fused_l2_nn.small_dim_launches == small + (
        k <= fnn.SMALL_DIM)
    _assert_nn_matches_plain(x, y, dk, ik, sqrt)
    if n > 5 and m > 0:
        assert int(ik[0]) == 1
    if n == 1:
        assert bool((ik == 0).all())


@pytest.mark.parametrize("variant", ["tf32 2 warpgroups",
                                     "tf32 4 warpgroups"])
@pytest.mark.parametrize("m,n,k", [(1000, 1024, 128), (333, 37, 50),
                                   (700, 300, 161), (129, 7, 17)])
def test_fused_l2_nn_tf32_block_sizes_match_plain(dev, variant, m, n, k):
    """The tensor-core pass at both block sizes (64 rows a warpgroup; at
    4 warpgroups x streams past dim 32) against the plain version, as the
    entry point's pass; its launches count apart."""
    x, y = _nn_inputs(dev, m, n, k, True)
    before, main = fnn.fused_l2_nn_variant.launches, fnn.fused_l2_nn.launches
    dk, ik = fnn.fused_l2_nn_variant(x, y, variant)
    torch.cuda.synchronize()
    assert fnn.fused_l2_nn_variant.launches == before + 1
    assert fnn.fused_l2_nn.launches == main
    _assert_nn_matches_plain(x, y, dk, ik)
    assert int(ik[0]) == 1


@pytest.mark.parametrize("m,n,k,exact", [(3000, 1000, 17, True),
                                         (3000, 256, 17, True),
                                         (1000, 1024, 128, True),
                                         (333, 37, 50, False),
                                         (5, 300, 1000, False)])
def test_fused_l2_nn_simt_yardstick_is_bit_equal_to_plain(dev, m, n, k,
                                                          exact):
    """The SIMT tile (raft_fused_l2_nn_simt, the yardstick no entry point
    takes) sums in dimension order.  Where the plain version's fp32
    ``matmul`` does too (the shapes marked exact: dim 17, and dim 128 at
    1,000 x 1,024 as at chip_smoke's shapes) dmin and the indices are
    equal to the bit; where cuBLAS splits the sum another way (333 x 37 x
    50, 5 x 300 x 1000) they agree tie-aware."""
    x, y = _nn_inputs(dev, m, n, k, True)
    dk, ik = fnn.fused_l2_nn_variant(x, y, "simt")
    torch.cuda.synchronize()
    if exact:
        dp, ip = fnn.fused_l2_nn_plain(x, y)
        assert torch.equal(dk, dp)
        assert torch.equal(ik, ip)
    else:
        _assert_nn_matches_plain(x, y, dk, ik)
    assert int(ik[0]) == 1


@pytest.mark.parametrize("dim", [1, 2, 3, 16, 17])
@pytest.mark.parametrize("n", [256, 1000])
def test_fused_l2_nn_small_dim_kernel_is_bit_equal_to_plain(dev, dim, n):
    """Kernel H on both sides of its small-dim threshold: at k <= 16 the
    small-dim kernel computes the same fp32 expression in the same order
    as the plain version, so dmin and the indices are equal to the bit;
    at 17 the tensor-core pass launches, held tie-aware
    (``_assert_nn_matches_plain``).  A duplicated y row resolves to its
    first copy on both sides."""
    m = 3000
    rng = np.random.default_rng(m + n + dim)
    x = torch.from_numpy(rng.normal(size=(m, dim)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
    y[n - 1] = y[5]
    y[300 % n] = y[5]
    x[0] = y[5] + 1e-3
    before = fnn.fused_l2_nn.launches
    small = fnn.fused_l2_nn.small_dim_launches
    dk, ik = fnn.fused_l2_nn(x, y)
    torch.cuda.synchronize()
    assert fnn.fused_l2_nn.launches == before + 1
    assert fnn.fused_l2_nn.small_dim_launches == small + (
        dim <= fnn.SMALL_DIM)
    if dim <= fnn.SMALL_DIM:
        dp, ip = fnn.fused_l2_nn_plain(x, y)
        assert torch.equal(dk, dp)
        assert torch.equal(ik, ip)
    else:
        _assert_nn_matches_plain(x, y, dk, ik)
    assert int(ik[0]) == 5


@pytest.mark.parametrize("B,m,n,dim", [(1, 3000, 256, 2), (64, 4096, 256, 2),
                                       (300, 1024, 256, 2), (7, 999, 33, 5),
                                       (3, 100, 1000, 16)])
def test_fused_l2_nn_batched_kernel_matches_plain(dev, B, m, n,
                                                   dim):
    """Kernel H's small-dim kernel with a batch axis: ONE launch for all
    members, each member's rows seeing only its own centres.  Each member
    equals the one-member kernel (``fused_l2_nn`` on that member) bit for
    bit, so no member reads another's offsets; against the plain loop
    over the members it is held tie-aware, within 1e-5 of ‖x‖² + max
    ‖y‖² (the plain version's fp32 product is cuBLAS's, whose summation
    order need not be the kernel's dimension order); a duplicated centre
    resolves to its first copy."""
    rng = np.random.default_rng(B + m + n + dim)
    x = torch.from_numpy(rng.normal(size=(B, m, dim)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(B, n, dim)).astype(
        np.float32)).to(dev)
    y[:, n - 1] = y[:, 5]
    x[:, 0] = y[:, 5] + 1e-3
    before = fnn.fused_l2_nn_batched.launches
    dk, ik = fnn.fused_l2_nn_batched(x, y)
    torch.cuda.synchronize()
    assert fnn.fused_l2_nn_batched.launches == before + 1
    small = fnn.fused_l2_nn.small_dim_launches
    for b in range(B):
        d1, i1 = fnn.fused_l2_nn(x[b], y[b])
        assert torch.equal(dk[b], d1) and torch.equal(ik[b], i1), b
        _assert_nn_matches_plain(x[b], y[b], dk[b], ik[b])
    assert fnn.fused_l2_nn.small_dim_launches == small + B
    assert bool((ik[:, 0] == 5).all())


def test_numpy_input_lands_on_the_card(dev):
    """The entry points without a handle (``matrix.ops``,
    ``knn_merge_parts``, ``random.permute``) put numpy input on the card,
    and compute what they compute on the CPU."""
    from raft_tpu_torch import random as rnd
    from raft_tpu_torch.matrix import ops
    from raft_tpu_torch.neighbors import brute_force

    rng = np.random.default_rng(0)
    m = rng.normal(size=(7, 5)).astype(np.float32)
    idx = np.array([4, 0, 4, 6], np.int32)
    for got, want in (
            (ops.argmax(m), ops.argmax(torch.from_numpy(m))),
            (ops.gather(m, idx), ops.gather(torch.from_numpy(m), idx)),
            (ops.reverse(m), ops.reverse(torch.from_numpy(m)))):
        assert got.is_cuda
        assert torch.equal(got.cpu(), want)
    keys = np.sort(rng.normal(size=(3, 6, 4)).astype(np.float32), axis=2)
    vals = rng.integers(0, 50, size=(3, 6, 4)).astype(np.int32)
    d, i = brute_force.knn_merge_parts(keys, vals, n_samples=50)
    dc, ic = brute_force.knn_merge_parts(torch.from_numpy(keys),
                                         torch.from_numpy(vals), n_samples=50)
    assert d.is_cuda and i.is_cuda
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)
    out, perm = rnd.permute(5, m)
    assert out.is_cuda and perm.is_cuda
    assert torch.equal(out.cpu(), torch.from_numpy(m)[perm.cpu().long()])


def test_pair_scans_and_fused_l2_nn_reject_what_they_cannot_hold(dev):
    """Kernel F's routes take a row width off a multiple of 4 (kt 65 at
    dim 10 runs the pair-group pass; its plain version agrees);
    Kernel G's query-major route still needs bf16 rows a multiple of 8
    wide, and fused_l2_nn an empty y, raise."""
    data, dsq, ids = _flat_lists(dev, 4, 96, 10, 0)
    q = torch.zeros(2, 10, device=dev)
    probes = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    before = _flat_routes()
    vk, ik = ps.ivf_flat_scan(q, probes, data, dsq, ids, 65)
    torch.cuda.synchronize()
    assert tuple(_flat_routes() - before) == ROUTE["pair"]
    vp, ip = ps.ivf_flat_scan_plain(q, probes, data, dsq, ids, 65)
    _assert_kernel_matches_plain(vk, ik, vp, ip)
    centers, recon, rsq, rids = _random_index(dev, 4, 32, 12, 0)
    with pytest.raises(LogicError, match="multiple of 8"):
        ps.recon_scan_query_major(torch.zeros(2, 12, device=dev), centers,
                                  probes, recon, rsq, rids, 100)
    with pytest.raises(LogicError, match="fused_l2_nn"):
        fnn.fused_l2_nn(q, torch.zeros(0, 10, device=dev))


def _hop_inputs(dev, nq, itopk, wd, pdim, seed, id_hi=None, all_visited=False):
    """Walk-shaped hop inputs: a sorted buffer with a dead (+inf, -1) tail
    and random visited flags, candidates with masked parents, repeated ids
    (same payload, as two parents' rows give) and ids already buffered."""
    rng = np.random.default_rng(seed)
    id_hi = id_hi or 4 * (itopk + wd)
    qp = rng.normal(size=(nq, pdim)).astype(np.float32)
    q_sq = (rng.random(nq) * 3).astype(np.float32)
    nb_id = rng.integers(0, id_hi, size=(nq, wd)).astype(np.int32)
    nb_id[:, : max(wd // 16, 1)] = -1
    nb_p = rng.normal(size=(id_hi, pdim)).astype(np.float32)[
        np.maximum(nb_id, 0)]
    nb_sq = (rng.random(id_hi) * 3).astype(np.float32)[np.maximum(nb_id, 0)]
    buf_d = np.sort(rng.random((nq, itopk)).astype(np.float32) * 2, axis=1)
    buf_d[:, itopk - max(itopk // 8, 1):] = np.inf
    buf_i = rng.integers(0, id_hi, size=(nq, itopk)).astype(np.int32)
    buf_i[:, 0] = nb_id[:, -1]          # a candidate already buffered
    for r in range(nq):                 # buffered ids are distinct
        _, first = np.unique(buf_i[r], return_index=True)
        dup = np.ones(itopk, bool)
        dup[first] = False
        buf_i[r, dup] = -1
    buf_i[np.isinf(buf_d)] = -1
    vis = rng.random((nq, itopk)) < 0.3
    if all_visited:
        vis[:] = True
        nb_id[:] = -1

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x if dt is None else x.to(dt)

    return (t(qp, torch.bfloat16), t(q_sq), t(nb_p, torch.bfloat16),
            t(nb_sq), t(nb_id), t(buf_d), t(buf_i), t(vis))


@pytest.mark.parametrize("nq,itopk,wd,pdim,ip", [
    (5000, 64, 64, 16, False),      # search, itopk 64, width 2, degree 32
    (64, 32, 32, 16, False),        # a serving bucket, width 1
    (8192, 96, 64, 16, False),      # the build's self-walk round
    (1024, 65, 96, 128, False),     # the build's exact merge (full rows)
    (1, 128, 64, 16, False),        # a single query, itopk 128
    (300, 256, 256, 24, True),      # the gate's edge, InnerProduct
    (77, 24, 32, 13, False)])       # pdim off 16-byte loads
def test_cagra_hop_kernel_matches_plain(dev, nq, itopk, wd, pdim, ip):
    """Kernel I: the same exact products summed in the same order, the
    same dedupe and the same merge network as its plain version, so keys,
    ids and visited flags are equal bit for bit."""
    args = _hop_inputs(dev, nq, itopk, wd, pdim, nq + itopk + wd)
    before = chop.cagra_hop.launches
    kd, ki, kv = chop.cagra_hop(*args, ip_metric=ip)
    torch.cuda.synchronize()
    assert chop.cagra_hop.launches == before + 1
    pd, pi, pv = chop.cagra_hop_plain(*args, ip_metric=ip)
    assert torch.equal(kd, pd)
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)
    fin = torch.isfinite(kd)
    assert bool((torch.diff(kd, dim=1)[fin[:, 1:]] >= 0).all())
    live = ki[ki >= 0].reshape(-1)
    assert live.numel() > 0


def test_cagra_hop_all_visited_is_a_fixed_point(dev):
    """A fully visited buffer with only masked parents comes back as it
    went in (why the walk may skip its per-hop exit check)."""
    args = _hop_inputs(dev, 200, 64, 64, 16, 5, all_visited=True)
    kd, ki, kv = chop.cagra_hop(*args, ip_metric=False)
    assert torch.equal(kd, args[5]) and torch.equal(ki, args[6])
    assert torch.equal(kv, args[7])


def test_cagra_hop_rejects_what_it_cannot_hold(dev):
    """Past its opt-in shared memory (itopk 8,192 with wd 8,192) the hop
    kernel refuses before any launch: the call raises, naming shared
    memory."""
    args = _hop_inputs(dev, 2, 8192, 8192, 16, 0)
    assert chop.hop_smem_bytes(8192, 8192, 16) > chop.SMEM_MAX
    before = chop.cagra_hop.launches
    with pytest.raises(LogicError, match="shared memory"):
        chop.cagra_hop(*args, ip_metric=False)
    assert chop.cagra_hop.launches == before


@pytest.mark.parametrize("nq,itopk,wd,pdim,ip", [
    (300, 291, 320, 96, False),     # the kg-291 build merge (wd 256 + 64)
    (100, 512, 512, 16, False),     # itopk 512 / wd 512
    (60, 512, 512, 24, True),       # InnerProduct, pdim off 16-byte loads
    (40, 1024, 1024, 16, False),    # 1,024 threads, S 2,048
    (20, 300, 2048, 16, False)])    # two candidates and pairs a thread
def test_cagra_hop_kernel_past_256_matches_plain(dev, nq, itopk, wd, pdim,
                                                 ip):
    """Kernel I's hop past 256: the network loops over its slots where they
    outnumber the block's threads (at most 1,024), and the block opts in
    past 48 KB, bit for bit the plain hop."""
    args = _hop_inputs(dev, nq, itopk, wd, pdim, nq + itopk + wd)
    before = chop.cagra_hop.launches
    kd, ki, kv = chop.cagra_hop(*args, ip_metric=ip)
    torch.cuda.synchronize()
    assert chop.cagra_hop.launches == before + 1
    pd, pi, pv = chop.cagra_hop_plain(*args, ip_metric=ip)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def _walk_inputs(dev, nq, itopk, width, deg, pdim, quant, ip, seed,
                 n=4096, all_visited=False):
    """A seeded walk over a random graph: the packed table (bf16 or int8)
    of n random rows, some graph edges masked (-1), the queries' table-side
    projections and the buffer seeded from 512 random entry points, as
    ``cagra._search_impl_walk`` seeds it.  (args, keyword args) of
    ``cagra_walk``."""
    rng = np.random.default_rng(seed)
    dim = max(pdim, 16)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
    graph = rng.integers(0, n, size=(n, deg)).astype(np.int32)
    graph[rng.random((n, deg)) < 0.02] = -1
    graph = torch.from_numpy(graph).to(dev)
    proj = torch.from_numpy((rng.normal(size=(dim, pdim)) / np.sqrt(dim))
                            .astype(np.float32)).to(dev)
    scales = None
    if quant:
        table, _, scales = cagra._build_walk_table_q(x, graph, pdim,
                                                     proj=proj)
    else:
        table, _ = cagra._build_walk_table(x, graph, pdim, proj=proj)
    q = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32)).to(
        dev)
    q_sq, qp, qp_t = cagra._query_side(q, proj, quant, scales)
    eids = torch.from_numpy(rng.permutation(n)[:512].astype(np.int32)).to(dev)
    eproj, esq, eids = cagra._entry_set_of(x, proj, eids)
    buf_d, buf_i, vis = cagra._seed_walk(qp, q_sq, eproj, esq, eids, itopk,
                                         ip)
    if all_visited:
        vis[:] = True
    kw = dict(deg=deg, search_width=width,
              max_iterations=10 + itopk // width, ip_metric=ip, quant=quant,
              scales=scales)
    return (qp_t, q_sq, table, buf_d, buf_i, vis), kw


@pytest.mark.parametrize("nq,itopk,width,deg,pdim,quant,ip", [
    (5000, 64, 2, 32, 16, False, False),    # search, itopk 64, width 2
    (1, 32, 1, 32, 16, False, False),       # a serving bucket of 1
    (64, 32, 1, 32, 16, False, False),      # a serving bucket of 64
    (8192, 96, 1, 64, 16, False, False),    # the build's self-walk chunk
    (500, 64, 2, 32, 16, True, False),      # the int8 format
    (300, 64, 2, 32, 16, False, True),      # InnerProduct
    (300, 32, 1, 32, 16, True, True),       # int8, InnerProduct
    (77, 24, 1, 32, 13, False, False),      # pdim 13: unaligned neighbors
    (40, 256, 4, 64, 24, False, False),     # itopk 256 with wd 256
    (30, 128, 4, 64, 128, False, False),    # staged rows above 48 KB
    (20, 64, 4, 64, 1024, False, False)])   # rows scored from the table
def test_cagra_walk_kernel_matches_plain(dev, nq, itopk, width, deg, pdim,
                                         quant, ip):
    """The walk kernel: the plain walk's parents, decode, keys, dedupe and
    merge hop for hop, so keys, ids, visited flags and each query's hop
    count are equal bit for bit, in one launch."""
    args, kw = _walk_inputs(dev, nq, itopk, width, deg, pdim, quant, ip,
                            nq + itopk + pdim)
    assert cw.walk_staged(itopk, width, deg, pdim, quant) == (pdim < 1024)
    before = cw.cagra_walk.launches
    kd, ki, kv, kh = cw.cagra_walk(*args, return_hops=True, **kw)
    torch.cuda.synchronize()
    assert cw.cagra_walk.launches == before + 1
    pd, pi, pv, ph = cw.cagra_walk_plain(*args, return_hops=True, **kw)
    assert torch.equal(kd, pd)
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)
    assert torch.equal(kh, ph)
    assert bool((kh > 0).all()) and int(kh.max()) <= kw["max_iterations"]
    fin = torch.isfinite(kd)
    assert bool((torch.diff(kd, dim=1)[fin[:, 1:]] >= 0).all())


def test_cagra_walk_reads_a_table_of_any_width(dev):
    """Rows of a width off a multiple of 8 lanes have no 16-byte loads: the
    kernel stages them lane by lane, with the same result."""
    args, kw = _walk_inputs(dev, 100, 32, 1, 32, 13, False, False, 11)
    table = args[2][:, :32 * cw.walk_unit(13, False) + 3].contiguous()
    assert table.shape[1] % 8
    args = args[:2] + (table,) + args[3:]
    ours = cw.cagra_walk(*args, return_hops=True, **kw)
    ref = cw.cagra_walk_plain(*args, return_hops=True, **kw)
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def test_cagra_walk_all_visited_is_a_fixed_point(dev):
    """A fully visited buffer comes back as it went in, after 0 hops."""
    args, kw = _walk_inputs(dev, 200, 64, 2, 32, 16, False, False, 3,
                            all_visited=True)
    kd, ki, kv, kh = cw.cagra_walk(*args, return_hops=True, **kw)
    assert torch.equal(kd, args[3]) and torch.equal(ki, args[4])
    assert torch.equal(kv, args[5]) and int(kh.abs().sum()) == 0


def test_cagra_search_is_one_walk_launch(dev):
    """``cagra.search`` launches the walk kernel once and no hop kernel."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    graph = rng.integers(0, 3000, size=(3000, 16)).astype(np.int32)
    idx = cagra.index_from_numpy(x, graph, device=dev)
    sp = cagra.SearchParams(itopk_size=32, search_width=2, walk_pdim=16,
                            entry_points=256)
    res = DeviceResources(seed=0)
    walks, hops = cw.cagra_walk.launches, chop.cagra_hop.launches
    d, i = cagra.search(res, sp, idx, x[:100], 10)
    torch.cuda.synchronize()
    assert cw.cagra_walk.launches == walks + 1
    assert chop.cagra_hop.launches == hops
    assert d.shape == (100, 10) and bool((i >= 0).all())


def test_cagra_walk_rejects_what_it_cannot_hold(dev):
    """Past its opt-in shared memory the walk kernel (and its exact-row
    source) refuses before any launch: the call raises, naming shared
    memory."""
    args, kw = _walk_inputs(dev, 2, 8192, 16, 512, 16, False, False, 0)
    assert cw.walk_reject_reason(2, 8192, 16, 512, 16).startswith(
        "shared memory")
    before = cw.cagra_walk.launches
    with pytest.raises(LogicError, match="shared memory"):
        cw.cagra_walk(*args, **kw)
    assert cw.cagra_walk.launches == before
    args, kw = _exact_walk_inputs(dev, 2, 64, 1, 16, 60000, False, 0, n=64)
    with pytest.raises(LogicError, match="shared memory"):
        cw.cagra_walk_exact(*args, **kw)


@pytest.mark.parametrize("nq,itopk,width,deg", [
    (60, 512, 1, 32),       # itopk 512 w1 on a degree-32 graph
    (40, 256, 8, 64),       # search_width 8 on a degree-64 graph
    (20, 1024, 16, 64)])    # wd 1,024: 1,024 threads, S 2,048
@pytest.mark.parametrize("filtered", [False, True])
def test_cagra_walk_kernel_past_256_matches_plain(dev, nq, itopk, width, deg,
                                                  filtered):
    """The walk kernel past 256 (itopk or search_width x degree), with and
    without a 50% filter: bit for bit the plain walk, one launch."""
    args, kw = _walk_inputs(dev, nq, itopk, width, deg, 16, False, False,
                            nq + itopk + deg)
    fw = (_filter_words(dev, nq, 4096, 0.5, False, itopk) if filtered
          else None)
    before = cw.cagra_walk.launches
    kd, ki, kv, kh = cw.cagra_walk(*args, return_hops=True, filter_words=fw,
                                   **kw)
    torch.cuda.synchronize()
    assert cw.cagra_walk.launches == before + 1
    pd, pi, pv, ph = cw.cagra_walk_plain(*args, return_hops=True,
                                         filter_words=fw, **kw)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)
    assert bool((kh > 0).all())


def _exact_walk_inputs(dev, nq, itopk, width, deg, dim, ip, seed, n=4096,
                       filter_words=None):
    """A direct walk over a random graph (some edges -1) of n random fp32
    rows, the buffer seeded from 4 x itopk random draws as
    ``cagra._search_impl`` seeds it.  (args, keyword args) of
    ``cagra_walk_exact``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
    graph = rng.integers(0, n, size=(n, deg)).astype(np.int32)
    graph[rng.random((n, deg)) < 0.02] = -1
    graph = torch.from_numpy(graph).to(dev)
    q = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32)).to(
        dev)
    q_sq = (q * q).sum(1)
    x_sq = (x * x).sum(1)
    seeds = torch.from_numpy(rng.integers(0, n, size=(nq, 4 * itopk)).astype(
        np.int32)).to(dev)
    buf_d, buf_i, vis = cagra._seed_direct(q, q_sq, x, x_sq, seeds, itopk, ip,
                                           filter_words)
    kw = dict(search_width=width, max_iterations=10 + itopk // width,
              ip_metric=ip, filter_words=filter_words)
    return (q, q_sq, graph, x, x_sq, buf_d, buf_i, vis), kw


@pytest.mark.parametrize("nq,itopk,width,dim,ip", [
    (500, 64, 2, 96, False),    # the 1M search's shape, deep-like width
    (300, 64, 1, 96, True),     # InnerProduct, width 1
    (200, 32, 2, 128, False),   # dim 128 (sift-like)
    (200, 48, 2, 128, True),
    (150, 32, 1, 13, False),    # dim 13: one-value row loads
    (100, 512, 1, 96, False)])  # itopk 512
@pytest.mark.parametrize("filtered", [False, True])
def test_cagra_walk_exact_kernel_matches_plain(dev, nq, itopk, width, dim,
                                               ip, filtered):
    """The walk kernel's exact-row source against the plain direct walk:
    the same fp32 products and sums, rounded one by one in dimension
    order, so keys, ids, visited flags and hop counts are equal bit for
    bit, in one launch; a hop adds no id the filter rejects."""
    fw = (_filter_words(dev, nq, 4096, 0.5, False, dim) if filtered
          else None)
    args, kw = _exact_walk_inputs(dev, nq, itopk, width, 32, dim, ip,
                                  nq + itopk + dim, filter_words=fw)
    before = cw.cagra_walk_exact.launches
    kd, ki, kv, kh = cw.cagra_walk_exact(*args, return_hops=True, **kw)
    torch.cuda.synchronize()
    assert cw.cagra_walk_exact.launches == before + 1
    pd, pi, pv, ph = cw.cagra_walk_exact_plain(*args, return_hops=True, **kw)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert torch.equal(kv, pv) and torch.equal(kh, ph)
    fin = torch.isfinite(kd)
    assert bool((torch.diff(kd, dim=1)[fin[:, 1:]] >= 0).all())
    if filtered:
        _assert_admitted(ki, fw)


def test_cagra_search_direct_walk_is_one_launch(dev):
    """``cagra.search(walk_pdim=0)`` and a search with no table format that
    fits run the direct walk on an exact 16-NN graph of low-rank rows: one
    launch of the exact-row source, no table built, sorted exact
    distances of the ids returned, and recall@10 against brute force of
    at least 0.95 at itopk 32 width 2 and 0.99 at itopk 512 (0.981-0.987
    and 0.999-1.0 on the CPU over three data and three search seeds);
    past shared memory the search raises."""
    rng = np.random.default_rng(9)
    z = rng.normal(size=(3100, 8)).astype(np.float32)
    a = rng.normal(size=(8, 32)).astype(np.float32) / np.sqrt(8)
    x = (z @ a + 0.05 * rng.normal(size=(3100, 32))).astype(np.float32)
    x, q = x[:3000], x[3000:]

    def knn(a, b, k):
        d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T
        return np.argsort(d, axis=1, kind="stable")[:, :k]

    idx = cagra.index_from_numpy(x, knn(x, x, 17)[:, 1:].astype(np.int32),
                                 device=dev)
    gt = torch.from_numpy(knn(q, x, 10)).to(dev)
    res = DeviceResources(seed=0)
    for sp, floor in (
            (cagra.SearchParams(itopk_size=32, search_width=2, walk_pdim=0),
             0.95),
            (cagra.SearchParams(itopk_size=512), 0.99)):
        before = cw.cagra_walk_exact.launches, cw.cagra_walk.launches
        if sp.walk_pdim is None:
            old = cagra._WALK_TABLE_MAX_BYTES
            cagra._WALK_TABLE_MAX_BYTES = 1
        try:
            d, i = cagra.search(res, sp, idx, q, 10)
        finally:
            if sp.walk_pdim is None:
                cagra._WALK_TABLE_MAX_BYTES = old
        torch.cuda.synchronize()
        assert (cw.cagra_walk_exact.launches, cw.cagra_walk.launches) == (
            before[0] + 1, before[1])
        assert d.shape == i.shape == (100, 10) and bool((i >= 0).all())
        assert bool((torch.diff(d, dim=1) >= 0).all())
        xd = idx.dataset[i.long()] - torch.from_numpy(q).to(dev)[:, None, :]
        torch.testing.assert_close(d, (xd * xd).sum(-1), rtol=1e-5,
                                   atol=1e-4)
        hits = (i[:, :, None].long() == gt[:, None, :]).any(2).float()
        assert float(hits.mean()) >= floor, (sp.itopk_size,
                                             float(hits.mean()))
    assert not getattr(idx, "_walk_tables", {})
    # past the exact-row source's shared memory (a 32,768-row merge) the
    # search raises on the card, before any launch
    before = cw.cagra_walk_exact.launches
    with pytest.raises(LogicError, match="shared memory"):
        cagra.search(res, cagra.SearchParams(itopk_size=16384, walk_pdim=0),
                     idx, q[:2], 10)
    assert cw.cagra_walk_exact.launches == before


# ---------------------------------------------------------------------------
# the profile variants: F / G raw and pre-gathered, Kernel J, Kernel A cuts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16,cap,width,kt", [
    (False, 160, 128, 10), (False, 416, 128, 10), (False, 40, 12, 3),
    (True, 96, 128, 20), (True, 300, 96, 4)])
@pytest.mark.parametrize("gather,extract", [(True, False), (False, True),
                                            (False, False)])
def test_pair_scan_variant_kernel_matches_plain(dev, bf16, cap, width, kt,
                                                gather, extract):
    """Raw blocks: the formula at every slot, padded ones too, +inf on the
    skipped probe, within 1e-5 of ‖q‖² + max ‖x‖² (F) or 1e-4 (G);
    selections as Kernels F and G hold them.  A pre-gathered query row
    gives the gathering kernel's result bit for bit."""
    n_lists, nq, n_probes = 64, 40, 12
    if bf16:
        centers, data, dsq, ids = _random_index(dev, n_lists, cap, width,
                                                cap + kt)
    else:
        centers = None
        data, dsq, ids = _flat_lists(dev, n_lists, cap, width, cap + width)
    q, probes = _queries(dev, nq, width, n_lists, n_probes)
    q_in = q.repeat_interleave(n_probes, 0) if not gather else q
    before = ps.pair_scan_variant.launches
    out = ps.pair_scan_variant(q_in, probes, data, dsq, ids, kt,
                               gather=gather, extract=extract,
                               centers=centers)
    torch.cuda.synchronize()
    assert ps.pair_scan_variant.launches == before + 1
    ref = ps.pair_scan_variant_plain(q_in, probes, data, dsq, ids, kt,
                                     gather=gather, extract=extract,
                                     centers=centers)
    same = ps.pair_scan_variant(q, probes, data, dsq, ids, kt, gather=True,
                                extract=extract, centers=centers)
    if extract:
        assert torch.equal(out[0], same[0]) and torch.equal(out[1], same[1])
        _assert_kernel_matches_plain(*out, *ref)
        return
    assert torch.equal(out, same)
    assert out.shape == (nq, n_probes, cap)
    assert bool(torch.isinf(out[0, -1]).all())
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(out))
    scale = float((q * q).sum(1).max() + dsq.max())
    atol = 1e-4 * max(scale, 1.0) if bf16 else 1e-5 * scale
    torch.testing.assert_close(out[fin], ref[fin], rtol=0, atol=atol)


def test_pair_scan_variant_gather_extract_is_kernel_f(dev):
    """The (gather, extract) variant is the instantiation of Kernel F's
    pair-group pass (on its groups at the same kt), and the query-major
    variant that of its query-major route: the same values and ids bit for
    bit; every variant of the query-major yardstick is held to the plain
    version as the pair-group pass is."""
    data, dsq, ids = _flat_lists(dev, 64, 160, 128, 3)
    q, probes = _queries(dev, 40, 128, 64, 12)
    group = ps.pair_list_layout(128, 10, True).group
    vk, ik = ps.flat_pair_list_scan(q, probes, *grouped.build_groups(
        probes, 64, group), data, dsq, ids, 10)
    vv, iv = ps.pair_scan_variant(q, probes, data, dsq, ids, 10)
    assert torch.equal(vk, vv) and torch.equal(ik, iv)
    vk, ik = ps.flat_scan_query_major(q, probes, data, dsq, ids, 10)
    before = ps.pair_scan_variant_query_major.launches
    vv, iv = ps.pair_scan_variant_query_major(q, probes, data, dsq, ids, 10)
    assert torch.equal(vk, vv) and torch.equal(ik, iv)
    qg = q.repeat_interleave(12, 0)
    raw = ps.pair_scan_variant_query_major(qg, probes, data, dsq, ids, 10,
                                           gather=False, extract=False)
    torch.cuda.synchronize()
    assert ps.pair_scan_variant_query_major.launches == before + 2
    ref = ps.pair_scan_variant_plain(qg, probes, data, dsq, ids, 10,
                                     gather=False, extract=False)
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(raw))
    scale = float((q * q).sum(1).max() + dsq.max())
    torch.testing.assert_close(raw[fin], ref[fin], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,m,rows", [(128, 320, 512), (128, 5000, 1024),
                                          (8, 777, 1), (1024, 300, 64),
                                          (16, 4096, 2048)])
def test_row_gather_kernel_matches_plain(dev, dtype, width, m, rows):
    """Kernel J copies rows: bit-equal to index_select at any row width
    that is a multiple of 16 bytes and any block height."""
    rng = np.random.default_rng(width + m)
    table = torch.from_numpy(rng.normal(size=(2000, width)).astype(
        np.float32)).to(dev).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 2000, m).astype(np.int32)).to(dev)
    before = rg.row_gather.launches
    out = rg.row_gather(table, ids, rows)
    torch.cuda.synchronize()
    assert rg.row_gather.launches == before + 1
    assert torch.equal(out, rg.row_gather_plain(table, ids, rows))


def test_row_gather_rejects_what_it_cannot_hold(dev):
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(LogicError, match="multiple of"):
        rg.row_gather(torch.zeros(8, 3, device=dev), ids)
    with pytest.raises(LogicError, match="int32"):
        rg.row_gather(torch.zeros(8, 4, device=dev), ids.long())


@pytest.mark.parametrize("cut", ku.PASS_CUTS)
@pytest.mark.parametrize("n,dim,k", [(1000, 50, 37), (4096, 128, 300),
                                     (333, 32, 1), (20000, 96, 1024)])
def test_kmeans_pass_cut_kernel_matches_plain(dev, cut, n, dim, k):
    """Each cut, tie-aware as Kernel A: dmin within τ, each label the
    plain one or at a tie; label sums and row counts exact and sums to
    fp32 summation order from the kernel's own labels; column sums to the
    order of their fp32 additions."""
    rng = np.random.default_rng(n + dim + k)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(k, dim)).astype(np.float32)).to(dev)
    before = ku.kmeans_pass_cut.launches
    sums, counts, dmin, labels = ku.kmeans_pass_cut(x, c, cut)
    torch.cuda.synchronize()
    assert ku.kmeans_pass_cut.launches == before + 1
    p_sums, p_counts, p_dmin, p_labels = ku.kmeans_pass_cut_plain(x, c, cut)
    assert (labels is None) == (p_labels is None)
    check = ku.check_assignment(x, c, dmin, labels, p_dmin, p_labels)
    assert check.ok, check
    if labels is not None:
        p_sums, p_counts = ku.pass_cut_update_plain(x, cut, labels, k)
    if cut == "mxuonly":
        torch.testing.assert_close(counts, p_counts, rtol=1e-4,
                                   atol=1e-4 * float(p_counts.abs().max()))
    else:
        assert torch.equal(counts, p_counts)
    torch.testing.assert_close(sums, p_sums, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# filters: the admission test of the list-major passes, of the query-major
# kernels and of the walk


def _filter_words(dev, nq, n_ids, selectivity, broadcast, seed):
    """Packed admission words (nq, ceil(n_ids / 32)) int32 admitting each
    id with probability ``selectivity``; ``broadcast``: one row expanded
    to nq (query stride 0), as a one-row filter reaches the kernels."""
    from raft_tpu_torch.filters import bitset

    rng = np.random.default_rng(seed)
    rows = 1 if broadcast else nq
    mask = torch.from_numpy(rng.random((rows, n_ids)) < selectivity)
    words = bitset.pack_mask(mask).to(dev)
    return words.expand(nq, -1) if broadcast else words


def _assert_admitted(ids, words):
    from raft_tpu_torch.filters import bitset

    flat = ids.reshape(ids.shape[0], -1)
    keep = flat >= 0
    bits = bitset.query_bits(words, torch.arange(flat.shape[0],
                                                 device=flat.device), flat)
    assert bool((bits[keep] == 1).all())


FILTERED_SCANS = ["B", "G", "C", "D", "E", "F", "F-IP"]


# each scan's pass past kt 64: the pair-group passes of B-G (for B and C
# those of G and D, then merge_pairs)
LARGE_KT = {"B": ps.recon_pair_list_scan, "G": ps.recon_pair_list_scan,
            "C": pcs.code_pair_list_scan,
            "D": pcs.code_pair_list_scan,
            "E": pcs.recon8_pair_list_scan,
            "F": ps.flat_pair_list_scan,
            "F-IP": ps.flat_pair_list_scan}
# F and G past the pair-group pass (kt 300 of 600 slots): the query-major
# kernels of csrc/pair_scan.cu
PAST_PAIR_KT = {"G": ps.recon_scan_query_major,
                "F": ps.flat_scan_query_major,
                "F-IP": ps.flat_scan_query_major}


def _filtered_scan(dev, kernel, fw_of, seed, k=20, kt=16, cap=300):
    """(kernel result, plain result, filter words, value tolerance) of one
    scan through its dispatcher, on the route its shape takes (list-major
    at the default k 20, kt 16; past 64, the pair-group passes of B-G
    (B and C through G's and D's, then the merge), which take kt up to
    128 (C, D, E) or 256 (B, F, G) and leave F and G's query-major kernels
    the kt past it), on a random
    index of ``cap`` slots a list with padding and tombstones, 40 queries
    of 12 probes over 64 lists; the tolerance is the unfiltered check's
    (1e-4; F: 1e-5 of ‖q‖² + max ‖x‖²).  ``B-query``: Kernel B's
    query-major kernel called as itself."""
    atol = 1e-4
    n_lists, nq, n_probes = 64, 40, 12
    if kernel in ("B", "B-query", "G"):
        centers, recon, rsq, ids = _random_index(dev, n_lists, cap, 128,
                                                 seed)
        qrot, probes = _queries(dev, nq, 128, n_lists, n_probes)
        fw = fw_of(nq, int(ids.max()) + 1)
        if kernel in ("B", "B-query"):
            args = (qrot, centers, probes, recon, rsq, ids, k, kt)
            fns = ({"B": pgs.ivf_pq_scan_fused,
                    "B-query": pgs.scan_query_major}[kernel],
                   pgs.ivf_pq_scan_fused_plain)
        else:
            args = (qrot, centers, probes, recon, rsq, ids, kt)
            fns = (ps.ivf_pq_scan_recon, ps.ivf_pq_scan_recon_plain)
    elif kernel in ("C", "D", "E"):
        pq_dim, pq_len, bits = 64, 2, 8
        centers, codes, books, rsq, ids, i8, scales, rsq8 = \
            _random_code_index(dev, n_lists, cap, pq_dim, pq_len, bits, seed)
        qrot, probes = _queries(dev, nq, pq_dim * pq_len, n_lists, n_probes)
        fw = fw_of(nq, int(ids.max()) + 1)
        if kernel == "C":
            args = (qrot, centers, probes, codes, books, rsq, ids, bits, k,
                    kt)
            fns = (pcs.ivf_pq_scan_codes_fused,
                   pcs.ivf_pq_scan_codes_fused_plain)
        elif kernel == "D":
            args = (qrot, centers, probes, codes, books, rsq, ids, bits, kt)
            fns = (pcs.ivf_pq_scan_codes, pcs.ivf_pq_scan_codes_plain)
        else:
            args = (qrot, centers, probes, i8, scales, rsq8, ids, kt)
            fns = (pcs.ivf_pq_scan_recon8, pcs.ivf_pq_scan_recon8_plain)
    else:
        data, dsq, ids = _flat_lists(dev, n_lists, cap, 128, seed)
        q, probes = _queries(dev, nq, 128, n_lists, n_probes)
        fw = fw_of(nq, int(ids.max()) + 1)
        args = (q, probes, data, dsq, ids, kt, kernel == "F-IP")
        fns = (ps.ivf_flat_scan, ps.ivf_flat_scan_plain)
        atol = 1e-5 * float((q * q).sum(1).max() + dsq.max())
    out = fns[0](*args, filter_words=fw)
    torch.cuda.synchronize()
    return out, fns[1](*args, filter_words=fw), fw, atol


def _check_filtered_scans(dev, kernel, k, kt, route=None, cap=300):
    """Hypothesis draws a filter (selectivity 0 to 1, a per-query filter
    or one row broadcast at query stride 0) for the scan at (k, kt) and
    holds it to its plain version at the unfiltered check's tolerance
    (values within 1e-4, F within 1e-5 of ‖q‖² + max ‖x‖²; the same
    exhausted ranks, -1 exactly there; ids but at ties); every returned id
    admitted by its query; at selectivity 0 every slot exhausted; with
    ``route``, that wrapper launched once a scan."""
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=6, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(selectivity=st.sampled_from([0.0, 0.001, 0.1, 0.5, 0.9, 1.0]),
           broadcast=st.booleans(), seed=st.integers(0, 1000))
    def check(selectivity, broadcast, seed):
        before = None if route is None else route.launches
        (vk, ik), (vp, ip), fw, atol = _filtered_scan(
            dev, kernel,
            lambda nq, n: _filter_words(dev, nq, n, selectivity, broadcast,
                                        seed), seed, k, kt, cap)
        if route is not None:
            assert route.launches == before + 1
        fin = torch.isfinite(vp)
        assert torch.equal(fin, torch.isfinite(vk))
        assert torch.equal(ik < 0, ~fin)
        torch.testing.assert_close(vk[fin], vp[fin], rtol=1e-4, atol=atol)
        assert float((ik == ip).float().mean()) >= 0.99
        _assert_admitted(ik, fw)
        if selectivity == 0.0:
            assert bool((ik == -1).all()) and not bool(fin.any())

    check()


@pytest.mark.parametrize("kernel", FILTERED_SCANS)
def test_filtered_list_major_scans_match_plain(dev, kernel):
    """Each list-major pass with a filter (k 20, kt 16) against its plain
    version (``_check_filtered_scans``)."""
    _check_filtered_scans(dev, kernel, 20, 16)


@pytest.mark.parametrize("kernel", FILTERED_SCANS)
def test_filtered_query_major_scans_match_plain(dev, kernel):
    """Each scan past kt 64 with a filter (the pair-group passes of B-G,
    for B and C then the merge), k = kt = 100 (G at kt 80), against its
    plain version (``_check_filtered_scans``), its route's launch counter
    moving once a scan."""
    kt = 80 if kernel == "G" else 100
    _check_filtered_scans(dev, kernel, 100, kt, LARGE_KT[kernel])


@pytest.mark.parametrize("kernel", sorted(PAST_PAIR_KT))
def test_filtered_scans_past_the_pair_group_pass_match_plain(dev, kernel):
    """F, F's InnerProduct form and G with a filter at k = kt = 300 of 600
    slots, past the pair-group pass: their query-major kernels
    (``csrc/pair_scan.cu``), against the plain version
    (``_check_filtered_scans``), that kernel's launch counter moving once
    a scan."""
    _check_filtered_scans(dev, kernel, 300, 300, PAST_PAIR_KT[kernel], 600)


# B and C's query-major kernels past kt 64: (k, kt) -- B's called as
# itself (the pair-group pass takes every such shape), C's through its
# dispatcher past the pass's kt 128
FUSED_QUERY_MAJOR = {"B-query": (256, 256), "C": (200, 200)}


@pytest.mark.parametrize("kernel", sorted(FUSED_QUERY_MAJOR))
def test_filtered_fused_query_major_scans_match_plain(dev, kernel):
    """Kernels B and C's query-major kernels with a filter: B's
    (``scan_query_major``, the pair-group route's yardstick) at k = kt =
    256, C's at k = kt = 200, where ``codes_fused_route`` gives it the
    search; against the plain version (``_check_filtered_scans``), that
    kernel's launch counter moving once a scan."""
    k, kt = FUSED_QUERY_MAJOR[kernel]
    if kernel == "B-query":
        route = pgs.scan_query_major
    else:
        assert pcs.codes_fused_route(300, 128, 64, 8, k, kt)[0] == "query"
        route = pcs.codes_fused_query_major
    _check_filtered_scans(dev, kernel, k, kt, route)


@pytest.mark.parametrize("nq,itopk,width,deg,pdim,quant,ip", [
    (500, 64, 2, 32, 16, False, False), (300, 64, 2, 32, 16, True, False),
    (200, 32, 1, 32, 16, False, True), (20, 64, 4, 64, 1024, False, False)])
def test_filtered_walk_matches_plain(dev, nq, itopk, width, deg, pdim,
                                     quant, ip):
    """Kernel I's walk with a filter (hypothesis: selectivity 0 to 1,
    per-query or one broadcast row): keys, ids, visited flags and hop
    counts equal to the plain walk's bit for bit, one launch, and no
    rejected id kept by a hop."""
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    args, kw = _walk_inputs(dev, nq, itopk, width, deg, pdim, quant, ip,
                            nq + itopk + pdim)

    @settings(max_examples=4, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(selectivity=st.sampled_from([0.0, 0.05, 0.5, 1.0]),
           broadcast=st.booleans(), seed=st.integers(0, 1000))
    def check(selectivity, broadcast, seed):
        fw = _filter_words(dev, nq, 4096, selectivity, broadcast, seed)
        before = cw.cagra_walk.launches
        kd, ki, kv, kh = cw.cagra_walk(*args, return_hops=True,
                                       filter_words=fw, **kw)
        torch.cuda.synchronize()
        assert cw.cagra_walk.launches == before + 1
        pd, pi, pv, ph = cw.cagra_walk_plain(*args, return_hops=True,
                                             filter_words=fw, **kw)
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
        assert torch.equal(kv, pv) and torch.equal(kh, ph)
        # a seed the filter rejects may stay in the buffer (the search
        # scores such seeds +inf before the walk); no hop adds one
        seeds = args[4]
        added = (ki >= 0) & ~torch.isin(ki, seeds)
        _assert_admitted(torch.where(added, ki, torch.full_like(ki, -1)), fw)

    check()

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

from raft_tpu_torch import LogicError
from raft_tpu_torch.ops import cagra_hop as chop
from raft_tpu_torch.ops import fused_l2_nn as fnn
from raft_tpu_torch.ops import kmeans_update as ku
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops import pq_group_scan as pgs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,dim,k", [(1000, 50, 37), (4096, 128, 300),
                                     (333, 32, 1), (2912, 96, 91),
                                     (20000, 96, 8192)])
def test_kmeans_assign_update_kernel_matches_plain(dev, n, dim, k):
    """Counts exact (dyadic weights sum exactly in any order), dmin equal
    (same products in the same order), sums to fp32 summation order."""
    rng = np.random.default_rng(n + dim + k)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.choice([0.0, 0.25, 0.5, 1.0, 2.0], n).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(k, dim)).astype(np.float32)).to(dev)
    before = ku.kmeans_assign_update.launches
    sums, counts, dmin = ku.kmeans_assign_update(x, w, c)
    torch.cuda.synchronize()
    assert ku.kmeans_assign_update.launches == before + 1
    p_sums, p_counts, p_dmin = ku.kmeans_assign_update_plain(x, w, c)
    assert torch.equal(counts, p_counts)
    torch.testing.assert_close(dmin, p_dmin, rtol=0, atol=1e-5)
    torch.testing.assert_close(sums, p_sums, rtol=1e-5, atol=1e-4)


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


@pytest.mark.parametrize("cap,rot,k,kt", [(96, 128, 10, 10), (96, 128, 10, 4),
                                          (700, 128, 20, 20),
                                          (2368, 96, 20, 20),
                                          (64, 32, 256, 256), (40, 24, 5, 3)])
def test_ivf_pq_scan_kernel_matches_plain(dev, cap, rot, k, kt):
    """Distances within 1e-4 at every rank, the same exhausted ranks, no
    padding or tombstone id, ids consistent with their distances."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, recon, rsq, ids = _random_index(dev, n_lists, cap, rot, cap + k)
    rng = np.random.default_rng(7)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(
        np.float32)).to(dev)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    probes[0, -1] = -1                 # skipped by both versions
    probes = torch.from_numpy(probes).to(dev)
    before = pgs.ivf_pq_scan_fused.launches
    vk, ik = pgs.ivf_pq_scan_fused(qrot, centers, probes, recon, rsq, ids,
                                   k, kt)
    torch.cuda.synchronize()
    assert pgs.ivf_pq_scan_fused.launches == before + 1
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
    (2368, 48, 2, 8, 20, 20), (2368, 48, 2, 8, 20, 4)]


@pytest.mark.parametrize("cap,pq_dim,pq_len,pq_bits,k,kt", CODE_SHAPES)
def test_codes_fused_kernel_matches_plain(dev, cap, pq_dim, pq_len, pq_bits,
                                          k, kt):
    """Kernel C: distances within 1e-4 at every rank (the LUT sums the
    plain version's exact products in another order), the same exhausted
    ranks, no padding or tombstone id, ids equal but at ties."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, cap + k)
    qrot, probes = _queries(dev, nq, pq_dim * pq_len, n_lists, n_probes)
    before = pcs.ivf_pq_scan_codes_fused.launches
    vk, ik = pcs.ivf_pq_scan_codes_fused(qrot, centers, probes, codes,
                                         books, rsq, ids, pq_bits, k, kt)
    torch.cuda.synchronize()
    assert pcs.ivf_pq_scan_codes_fused.launches == before + 1
    vp, ip = pcs.ivf_pq_scan_codes_fused_plain(qrot, centers, probes, codes,
                                               books, rsq, ids, pq_bits, k,
                                               kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("cap,pq_dim,pq_len,pq_bits,k,kt", CODE_SHAPES)
def test_codes_pair_kernel_matches_plain(dev, cap, pq_dim, pq_len, pq_bits,
                                         k, kt):
    """Kernel D: each pair's top kt, (+inf, -1) past its live rows and on
    the skipped probe."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, codes, books, rsq, ids, *_ = _random_code_index(
        dev, n_lists, cap, pq_dim, pq_len, pq_bits, cap + kt)
    qrot, probes = _queries(dev, nq, pq_dim * pq_len, n_lists, n_probes)
    kt = min(kt, 128)
    before = pcs.ivf_pq_scan_codes.launches
    vk, ik = pcs.ivf_pq_scan_codes(qrot, centers, probes, codes, books, rsq,
                                   ids, pq_bits, kt)
    torch.cuda.synchronize()
    assert pcs.ivf_pq_scan_codes.launches == before + 1
    assert vk.shape == (nq, n_probes, min(kt, cap))
    assert bool(torch.isinf(vk[0, -1]).all())
    vp, ip = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes, books,
                                         rsq, ids, pq_bits, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("cap,rot,kt", [(96, 128, 10), (700, 96, 4),
                                        (2368, 96, 4), (300, 24, 3),
                                        (64, 1000, 64)])
def test_recon8_kernel_matches_plain(dev, cap, rot, kt):
    """Kernel E: the dot scaled after it is summed, as the plain version
    does; each pair's top kt."""
    n_lists, nq, n_probes = 64, 40, 12
    rng = np.random.default_rng(cap + rot)
    rot_pad = -(-rot // 16) * 16
    i8 = torch.from_numpy(rng.integers(-127, 128, (n_lists, cap, rot_pad))
                          .astype(np.int8)).to(dev)
    i8[:, :, rot:] = 0
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, n_lists).astype(
        np.float32)).to(dev)
    rsq8 = scales[:, None] ** 2 * (i8.float() ** 2).sum(-1)
    centers, _, _, ids = _random_index(dev, n_lists, cap, rot, cap)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    before = pcs.ivf_pq_scan_recon8.launches
    vk, ik = pcs.ivf_pq_scan_recon8(qrot, centers, probes, i8, scales, rsq8,
                                    ids, kt)
    torch.cuda.synchronize()
    assert pcs.ivf_pq_scan_recon8.launches == before + 1
    vp, ip = pcs.ivf_pq_scan_recon8_plain(qrot, centers, probes, i8, scales,
                                          rsq8, ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


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


@pytest.mark.parametrize("cap,dim,kt,ip", [
    (96, 128, 10, False), (96, 128, 10, True), (832, 128, 10, False),
    (768, 128, 10, False), (300, 96, 40, False), (64, 1024, 64, True),
    (40, 12, 3, False)])
def test_ivf_flat_scan_kernel_matches_plain(dev, cap, dim, kt, ip):
    """Kernel F: each pair's top kt, (+inf, -1) -- (-inf, -1) for
    InnerProduct -- past its live rows and on the skipped probes; values
    within 1e-5 of the scale ‖q‖² + max ‖x‖² that fp32 cancellation moves
    them by; ids equal but at ties."""
    n_lists, nq, n_probes = 64, 40, 12
    data, dsq, ids = _flat_lists(dev, n_lists, cap, dim, cap + dim)
    q, probes = _queries(dev, nq, dim, n_lists, n_probes)
    probes[1, 2] = n_lists             # a super-tile dedupe sentinel
    before = ps.ivf_flat_scan.launches
    vk, ik = ps.ivf_flat_scan(q, probes, data, dsq, ids, kt, ip)
    torch.cuda.synchronize()
    assert ps.ivf_flat_scan.launches == before + 1
    assert vk.shape == (nq, n_probes, min(kt, cap))
    assert bool(torch.isinf(vk[0, -1]).all() and torch.isinf(vk[1, 2]).all())
    vp, ip_ = ps.ivf_flat_scan_plain(q, probes, data, dsq, ids, kt, ip)
    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)) and torch.equal(ik < 0, ~fin)
    scale = float((q * q).sum(1).max() + dsq.max())
    torch.testing.assert_close(vk[fin], vp[fin], rtol=0, atol=1e-5 * scale)
    assert float((ik == ip_).float().mean()) >= 0.99


@pytest.mark.parametrize("cap,rot,kt", [(96, 128, 10), (416, 128, 20),
                                        (2368, 96, 4), (40, 24, 40),
                                        (64, 1024, 64)])
def test_ivf_pq_scan_recon_kernel_matches_plain(dev, cap, rot, kt):
    """Kernel G: Kernel B's distances with each pair's top kt."""
    n_lists, nq, n_probes = 64, 40, 12
    centers, recon, rsq, ids = _random_index(dev, n_lists, cap, rot, cap + kt)
    qrot, probes = _queries(dev, nq, rot, n_lists, n_probes)
    before = ps.ivf_pq_scan_recon.launches
    vk, ik = ps.ivf_pq_scan_recon(qrot, centers, probes, recon, rsq, ids, kt)
    torch.cuda.synchronize()
    assert ps.ivf_pq_scan_recon.launches == before + 1
    assert vk.shape == (nq, n_probes, min(kt, cap))
    vp, ip = ps.ivf_pq_scan_recon_plain(qrot, centers, probes, recon, rsq,
                                        ids, kt)
    _assert_kernel_matches_plain(vk, ik, vp, ip)


@pytest.mark.parametrize("m,n,k,sqrt", [(1000, 1024, 128, False),
                                        (333, 37, 50, True),
                                        (4096, 8192, 96, False),
                                        (70, 3, 2, False), (5, 300, 1000, True)])
def test_fused_l2_nn_kernel_matches_plain(dev, m, n, k, sqrt):
    """Kernel H: dmin within 1e-5 of ‖x‖² + max ‖y‖²; the index equal to
    the plain version's or at a distance tie with it; a duplicated y row
    resolves to its first copy."""
    rng = np.random.default_rng(m + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(dev)
    if n > 5:
        y[n - 1] = y[1]                # two equal rows: index 1 must win
        x[0] = y[1] + 1e-3
    before = fnn.fused_l2_nn.launches
    dk, ik = fnn.fused_l2_nn(x, y, sqrt)
    torch.cuda.synchronize()
    assert fnn.fused_l2_nn.launches == before + 1
    dp, ip = fnn.fused_l2_nn_plain(x, y, sqrt)
    d2k, d2p = (dk ** 2, dp ** 2) if sqrt else (dk, dp)
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    torch.testing.assert_close(d2k, d2p, rtol=0, atol=1e-5 * scale)
    yk = y[ik.long()]
    dist_k = ((x - yk) ** 2).sum(1)
    dist_p = ((x - y[ip.long()]) ** 2).sum(1)
    assert bool(((ik == ip) | ((dist_k - dist_p).abs() <= 1e-5 * scale))
                .all())
    if n > 5:
        assert int(ik[0]) == 1


def test_pair_scans_and_fused_l2_nn_reject_what_they_cannot_hold(dev):
    data, dsq, ids = _flat_lists(dev, 4, 32, 10, 0)
    q = torch.zeros(2, 10, device=dev)
    probes = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(LogicError, match="multiple of 4"):
        ps.ivf_flat_scan(q, probes, data, dsq, ids, 4)
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
    args = _hop_inputs(dev, 2, 300, 16, 16, 0)
    with pytest.raises(LogicError, match="itopk=300"):
        chop.cagra_hop(*args, ip_metric=False)

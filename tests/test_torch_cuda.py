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
from raft_tpu_torch.ops import kmeans_update as ku
from raft_tpu_torch.ops import pq_group_scan as pgs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,dim,k", [(1000, 50, 37), (4096, 128, 300),
                                     (333, 32, 1)])
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

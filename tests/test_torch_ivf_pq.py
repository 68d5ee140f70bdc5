"""raft_tpu_torch IVF-PQ against the JAX package, on the CPU.

A ``raft_tpu``-built index is carried across with ``index_from_numpy`` so
both packages search the same lists; Kernel B's plain version is held to
the JAX fused scan (its Pallas kernel in interpret mode) at the same
probes, and the port's own build is held to the JAX build's recall."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import grouped
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu.neighbors.refine import refine as jax_refine
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
from raft_tpu_torch.ops.pq_group_scan import ivf_pq_scan_fused

LEAVES = ("centers", "codebooks", "list_codes", "list_indices",
          "list_sizes", "rotation", "list_recon", "list_recon_sq")


def _overlap(a, b, k=10):
    return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])


def _carry(index, metric=None):
    arrays = {n: np.asarray(getattr(index, n)) for n in LEAVES}
    return ivf_pq.index_from_numpy(
        arrays, metric=index.metric if metric is None else metric,
        pq_bits=index.pq_bits, codebook_kind=index.codebook_kind,
        device="cpu")


@pytest.fixture(scope="module")
def carried():
    """One small JAX-built index per pq_bits (the shapes of
    tests/test_ivf_pq.py's scan fixture), its probes and group count, and
    the port's copy of it."""
    X, _ = make_blobs(4000, 32, n_clusters=64, cluster_std=1.0, seed=5)
    db, q = np.asarray(X[:3800]), np.asarray(X[3800:3850])
    res = JaxResources(seed=42)
    out = {}
    for pq_bits in (8, 4):
        index = jax_ivf_pq.build(res, jax_ivf_pq.IndexParams(
            n_lists=16, pq_dim=8, pq_bits=pq_bits, kmeans_n_iters=5), db)
        probes = jax_ivf_pq._select_clusters(index.centers, index.rotation,
                                             jnp.asarray(q), 8, index.metric)
        ng = grouped.round_groups(
            int(grouped.num_groups(probes, index.n_lists)))
        out[pq_bits] = (index, np.asarray(probes), ng, _carry(index))
    return db, q, out


def _port_scan(port, q, probes, k, kt, list_indices=None):
    qrot = torch.tensor(q) @ port.rotation
    ids = port.list_indices if list_indices is None else list_indices
    vals, found = ivf_pq_scan_fused(
        qrot, port.centers, torch.tensor(probes), port.list_recon,
        port.list_recon_sq, ids, k, min(kt or k, port.capacity))
    return (ivf_pq._sqrt_epilogue(vals, port.metric).numpy(),
            found.numpy())


def _assert_same_results(pd, pi, rd, ri):
    assert _overlap(pi, ri) >= 0.99
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    np.testing.assert_array_equal(pi == -1, ~np.isfinite(pd))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(pd[fin], rd[fin], rtol=1e-4, atol=1e-4)


def test_index_from_numpy_is_exact(carried):
    _, _, built = carried
    index, _, _, port = built[8]
    assert port.list_recon.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port.list_recon.float().numpy(),
        np.asarray(index.list_recon.astype(jnp.float32)))
    assert port.pq_dim == index.pq_dim and port.capacity == index.capacity
    assert port.size == index.size


@pytest.mark.parametrize("pq_bits", [8, 4])
def test_decode_matches_the_reference_recon_cache(carried, pq_bits):
    """The port's decode of the carried codes rebuilds the JAX recon cache
    bit for bit, and its norms."""
    _, _, built = carried
    index, _, _, port = built[pq_bits]
    recon = ivf_pq._decode_lists(port.codebooks, port.list_codes,
                                 port.pq_dim, port.pq_bits)
    assert torch.equal(recon, port.list_recon)
    np.testing.assert_allclose(ivf_pq._recon_sq(recon).numpy(),
                               np.asarray(index.list_recon_sq),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kt", [0, 4])
def test_kernel_b_plain_matches_jax_fused_scan(carried, kt):
    db, q, built = carried
    index, probes, ng, port = built[8]
    rd, ri = jax_ivf_pq._search_impl_fused_recon_grouped(
        index.centers, index.list_recon, index.list_recon_sq,
        index.list_indices, index.rotation, jnp.asarray(q),
        jnp.asarray(probes), 10, kt, index.metric, ng,
        pallas_interpret=True)
    pd, pi = _port_scan(port, q, probes, 10, kt)
    _assert_same_results(pd, pi, np.asarray(rd), np.asarray(ri))


def test_kernel_b_plain_masks_negative_ids_like_jax(carried):
    """id -1 rows (tests/test_ivf_pq.py's zapped case) never surface;
    exhausted ranks are (+inf, -1), as the JAX fused scan gives."""
    db, q, built = carried
    index, probes, ng, port = built[8]
    zapped = np.where(np.arange(index.capacity)[None, :] % 2 == 0,
                      np.asarray(index.list_indices), -1)
    rd, ri = jax_ivf_pq._search_impl_fused_recon_grouped(
        index.centers, index.list_recon, index.list_recon_sq,
        jnp.asarray(zapped), index.rotation, jnp.asarray(q),
        jnp.asarray(probes), 10, 0, index.metric, ng,
        pallas_interpret=True)
    pd, pi = _port_scan(port, q, probes, 10, 0,
                        list_indices=torch.from_numpy(zapped))
    surviving = set(zapped[zapped >= 0].tolist())
    assert all(int(i) in surviving for i in pi[pi >= 0])
    _assert_same_results(pd, pi, np.asarray(rd), np.asarray(ri))


def test_kernel_b_plain_exhausts_to_inf_and_minus_one(carried):
    """Asking for more neighbours than the probed lists hold leaves the
    tail ranks at (+inf, -1)."""
    _, q, built = carried
    _, probes, _, port = built[8]
    pd, pi = _port_scan(port, q[:4], probes[:4, :1], 256, 0)
    live = (port.list_indices[torch.tensor(probes[:4, 0]).long()]
            >= 0).sum(1).numpy()
    for row, n_live in enumerate(live):
        assert np.isfinite(pd[row, :n_live]).all()
        assert (pi[row, n_live:] == -1).all()
        assert np.isinf(pd[row, n_live:]).all()


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded])
def test_search_matches_jax_search_on_the_same_index(carried, metric):
    """Public search at exact_coarse=True on the carried index against the
    JAX package's search (its CPU path: the recon scan) — same ids but for
    ties, distances within 1e-4."""
    _, q, built = carried
    index, _, _, _ = built[8]
    jidx = dataclasses.replace(index, metric=int(metric))
    sp = dict(n_probes=8, exact_coarse=True)
    rd, ri = jax_ivf_pq.search(JaxResources(seed=0),
                               jax_ivf_pq.SearchParams(**sp), jidx,
                               jnp.asarray(q), 10)
    port = _carry(index, metric=int(metric))
    pd, pi = ivf_pq.search(DeviceResources(device="cpu"),
                           ivf_pq.SearchParams(**sp), port, q, 10)
    assert pi.dtype == torch.int32
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri))


def _sift_like(n, nq, dim, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n + nq, 16)).astype(np.float32)
    a = rng.normal(size=(16, dim)).astype(np.float32) / 4
    x = z @ a + 0.05 * rng.normal(size=(n + nq, dim)).astype(np.float32)
    return x[:n], x[n:]


def _recall(found, truth):
    return np.mean([len(set(f) & set(t)) / len(t)
                    for f, t in zip(found, truth)])


def test_port_build_recall_matches_jax_build():
    """The slice end to end: the port's build + search + refine×2 recall@10
    against brute force is at least the JAX-built recall minus 0.03 at the
    same parameters (random streams differ, so builds are held to
    recall)."""
    db, q = _sift_like(4096, 64, 64, seed=2)
    params = dict(n_lists=32, pq_dim=32, kmeans_n_iters=10)
    truth = ((q[:, None, :] - db[None]) ** 2).sum(-1).argsort(1)[:, :10]

    jres = JaxResources(seed=0)
    jidx = jax_ivf_pq.build(jres, jax_ivf_pq.IndexParams(**params), db)
    _, jc = jax_ivf_pq.search(jres, jax_ivf_pq.SearchParams(n_probes=8),
                              jidx, jnp.asarray(q), 20)
    _, ji = jax_refine(jres, jnp.asarray(db), jnp.asarray(q), jc, 10)

    res = DeviceResources(seed=0, device="cpu")
    pidx = ivf_pq.build(res, ivf_pq.IndexParams(**params), db)
    _, pc = ivf_pq.search(res, ivf_pq.SearchParams(n_probes=8), pidx, q, 20)
    _, pi = refine.refine(res, db, q, pc, 10)
    _, bf = brute_force.knn(res, db, q, 10)

    assert _recall(bf.numpy(), truth) >= 0.99
    jr, pr = _recall(np.asarray(ji), truth), _recall(pi.numpy(), truth)
    assert pr >= jr - 0.03, (pr, jr)

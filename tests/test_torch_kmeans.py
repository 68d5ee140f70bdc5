"""Kernel A's plain version and the port's balanced k-means against the
JAX package, on the CPU.  Inputs are made with numpy from a seed and go
through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_balanced as jax_kmb
from raft_tpu.cluster.kmeans_types import \
    KMeansBalancedParams as JaxKMeansBalancedParams
from raft_tpu.ops.kmeans_update_pallas import fused_assign_update
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.ops.kmeans_update import (kmeans_assign_update,
                                              kmeans_assign_update_plain)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


@pytest.mark.parametrize("n,dim,k,weights", [
    (300, 50, 37, "dyadic"),      # tests/test_ops.py's padding shape
    (300, 50, 37, "ones"),
    (512, 128, 64, "dyadic"),
])
def test_kernel_a_plain_matches_pallas_epilogue(n, dim, k, weights):
    """Counts exact (weights are dyadic, so any summation order is exact),
    sums and dmin + ||x||^2 within the 2e-2 that test_ops.py allows (the
    Pallas epilogue rounds the weights to bf16 for its sums product)."""
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    c = rng.normal(size=(k, dim)).astype(np.float32)
    if weights == "ones":
        w = np.ones(n, np.float32)
    else:
        w = rng.choice([0.25, 0.5, 1.0, 2.0], n).astype(np.float32)
        w[::11] = 0.0
    sums, counts, dmin = fused_assign_update(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), tile=128,
        interpret=True)
    p_sums, p_counts, p_dmin = kmeans_assign_update(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c))
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(counts))
    np.testing.assert_allclose(p_sums.numpy(), np.asarray(sums),
                               rtol=2e-2, atol=2e-2)
    x_sq = (x * x).sum(1)
    np.testing.assert_allclose(p_dmin.numpy() + x_sq,
                               np.asarray(dmin) + x_sq, rtol=2e-2,
                               atol=2e-2)


def test_kernel_a_plain_is_the_exact_bf16_contract():
    """The plain version against float64 numpy on the same bf16-rounded
    values: labels exact, dmin to fp32 rounding, zero-weight rows add
    nothing."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(400, 40)).astype(np.float32)
    c = rng.normal(size=(23, 40)).astype(np.float32)
    w = rng.random(400).astype(np.float32)
    w[::3] = 0.0
    xb, cb = _bf16(x).astype(np.float64), _bf16(c).astype(np.float64)
    d = (c.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * xb @ cb.T
    lab = d.argmin(1)
    sums, counts, dmin = kmeans_assign_update_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c))
    np.testing.assert_allclose(dmin.numpy(), d.min(1), rtol=1e-5,
                               atol=1e-4)
    ref_sums = np.zeros((23, 40))
    ref_counts = np.zeros(23)
    np.add.at(ref_sums, lab, xb * w[:, None])
    np.add.at(ref_counts, lab, w)
    np.testing.assert_allclose(sums.numpy(), ref_sums, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(counts.numpy(), ref_counts, rtol=1e-6,
                               atol=1e-6)


def _blobs(n, dim, k, seed):
    """Well-separated equal-size blobs, rounded to bf16 so both packages'
    bf16 assignment sees exactly the data."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(k, dim)).astype(np.float32)
    x = centers[np.arange(n) % k] + rng.normal(size=(n, dim)).astype(
        np.float32)
    return _bf16(x[rng.permutation(n)]), _bf16(centers)


@pytest.mark.parametrize("fused", [True, False])
def test_one_balanced_iteration_matches(fused):
    """From identical bf16-representable centroids, one Lloyd iteration
    (Kernel A's plain version when ``fused``, plain fp32 otherwise) lands
    the same centers and sizes as the JAX loop (its Pallas pass in
    interpret mode when ``fused``).  No cluster is small enough to be
    re-seeded, so no random draw enters."""
    x, centers = _blobs(2048, 32, 16, seed=3)
    c0 = _bf16(centers + 0.5)    # one perturbed centroid per blob
    jc, jl = jax_kmb._balanced_loop(
        jnp.asarray(x), jnp.asarray(c0), jax.random.key(0), 16, 1,
        DistanceType.L2Expanded, use_fused=128 if fused else 0,
        fused_interpret=fused)
    pc, pl = kmeans_balanced._balanced_loop(
        torch.tensor(x), torch.tensor(c0), torch.Generator(), 16, 1,
        DistanceType.L2Expanded, use_fused=fused)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(np.bincount(pl.numpy(), minlength=16),
                                  np.bincount(np.asarray(jl), minlength=16))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def _inertia(x, centers):
    d = ((x[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    return d.min(1).sum()


def test_fit_inertia_within_margin_of_the_reference():
    """Full fits draw different random numbers (Philox vs threefry), so
    they are held to clustering quality on SIFT-like data (a 16-d latent
    mapped to 32-d plus 5% noise, the shape of the data an IVF index
    holds): the port's inertia within 2% of the JAX fit's — seeds move
    either fit by about 0.5% — and every cluster populated."""
    rng = np.random.default_rng(4)
    z = rng.normal(size=(4096, 16)).astype(np.float32)
    a = rng.normal(size=(16, 32)).astype(np.float32) / 4
    x = z @ a + 0.05 * rng.normal(size=(4096, 32)).astype(np.float32)
    jcent = jax_kmb.fit(None, JaxKMeansBalancedParams(n_iters=10),
                        jnp.asarray(x), 32, key=jax.random.key(1))
    res = DeviceResources(seed=1, device="cpu")
    pcent = kmeans_balanced.fit(res, KMeansBalancedParams(n_iters=10), x, 32)
    ji, pi = _inertia(x, np.asarray(jcent)), _inertia(x, pcent.numpy())
    assert pi <= 1.02 * ji, (pi, ji)
    labels = kmeans_balanced.predict(res, KMeansBalancedParams(), x, pcent)
    assert np.bincount(labels.numpy(), minlength=32).min() > 0

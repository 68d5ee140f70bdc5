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
from raft_tpu_torch.ops.kmeans_update import (
    check_assignment, kmeans_assign_update,
    kmeans_assign_update_labelled_plain, kmeans_assign_update_plain,
    tie_tolerance)


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


def _tie_case():
    """Unit steps, exact in bf16 and in every fp32 sum: row 0 sits at
    the same d = 1 from centroids 0 (+e0) and 1 (-e0), a constructed
    tie; row 1 (= e0) is nearest centroid 0 by d -1 against 3 and 8."""
    dim = 8
    eye = np.eye(dim, dtype=np.float32)
    x = torch.from_numpy(np.stack([eye[1], eye[0]]))
    c = torch.from_numpy(np.stack([eye[0], -eye[0], 4 * eye[0]]))
    _, _, dmin, labels = kmeans_assign_update_labelled_plain(
        x, torch.ones(2), c)
    assert labels.tolist() == [0, 0] and dmin.tolist() == [1.0, -1.0]
    return x, c, dmin, labels


def test_check_assignment_accepts_a_flip_at_a_tie():
    """A kernel may sum in another order and land on the other centroid
    of a tie: the label flips, the check holds."""
    x, c, dmin, labels = _tie_case()
    tau = tie_tolerance(x, c)
    assert tau == 4 * 8 * 2.0 ** -24 * (1 + 16)
    flipped = torch.tensor([1, 0], dtype=torch.int32)
    check = check_assignment(x, c, dmin + tau / 2, flipped, dmin, labels)
    assert check.ok and check.flips == 1 and check.off_tie == 0
    assert check.dmin_err == pytest.approx(tau / 2)


def test_check_assignment_rejects_a_flip_off_a_tie():
    """Row 1's second centroid is 4 further than its first, far past 2τ:
    a kernel label there is wrong, whatever its dmin."""
    x, c, dmin, labels = _tie_case()
    flipped = torch.tensor([0, 1], dtype=torch.int32)
    check = check_assignment(x, c, dmin, flipped, dmin, labels)
    assert not check.ok and check.flips == 1 and check.off_tie == 1


def test_check_assignment_rejects_a_dmin_beyond_tau():
    """Equal labels do not excuse a distance off by more than τ; dmin
    alone (no labels) is held the same way."""
    x, c, dmin, labels = _tie_case()
    tau = tie_tolerance(x, c)
    check = check_assignment(x, c, dmin + 2 * tau, labels, dmin, labels)
    assert not check.ok and check.flips == 0
    assert not check_assignment(x, c, dmin - 2 * tau, None, dmin, None).ok
    assert check_assignment(x, c, dmin, None, dmin, None).ok


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


def _sift_like(n, dim, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 16)).astype(np.float32)
    a = rng.normal(size=(16, dim)).astype(np.float32) / 4
    return z @ a + 0.05 * rng.normal(size=(n, dim)).astype(np.float32)


@pytest.mark.parametrize("dim", [32, 24])
def test_hierarchical_fit_inertia_within_margin_of_the_reference(
        monkeypatch, dim):
    """With the mesocluster threshold lowered to 16 in both packages, a
    32-cluster fit takes the two-level build (6 mesoclusters of 5-6 fine
    clusters, then 2 full-K iterations).  The draws differ (Philox vs
    threefry), so the port is held to clustering quality: its inertia
    within 2% of the JAX fit's — seeds move the ratio by about 0.5% — and
    every cluster populated.  dim 32 runs Kernel A's plain version, dim 24
    the plain fp32 loop."""
    monkeypatch.setattr(jax_kmb, "_MESO_THRESHOLD", 16)
    monkeypatch.setattr(kmeans_balanced, "_MESO_THRESHOLD", 16)
    x = _sift_like(4096, dim, seed=8)
    jcent = jax_kmb.fit(None, JaxKMeansBalancedParams(n_iters=10),
                        jnp.asarray(x), 32, key=jax.random.key(2))
    res = DeviceResources(seed=2, device="cpu")
    pcent = kmeans_balanced.fit(res, KMeansBalancedParams(n_iters=10), x, 32)
    assert pcent.shape == (32, dim)
    ji, pi = _inertia(x, np.asarray(jcent)), _inertia(x, pcent.numpy())
    assert pi <= 1.02 * ji, (pi, ji)
    labels = kmeans_balanced.predict(res, KMeansBalancedParams(), x, pcent)
    assert np.bincount(labels.numpy(), minlength=32).min() > 0


def test_hierarchical_fit_is_the_default_from_the_threshold(monkeypatch):
    """fit dispatches to the two-level build at n_clusters >= the
    threshold, and not below it."""
    calls = []
    real = kmeans_balanced._fit_hierarchical
    monkeypatch.setattr(kmeans_balanced, "_MESO_THRESHOLD", 16)
    monkeypatch.setattr(kmeans_balanced, "_fit_hierarchical",
                        lambda *a: calls.append(a[1]) or real(*a))
    x = _sift_like(1024, 8, seed=9)
    res = DeviceResources(seed=0, device="cpu")
    kmeans_balanced.fit(res, KMeansBalancedParams(n_iters=2), x, 15)
    kmeans_balanced.fit(res, KMeansBalancedParams(n_iters=2), x, 16)
    assert calls == [16]


def test_meso_partition_sample_takes_members_of_each_mesocluster():
    """Every sampled row belongs to its mesocluster; a mesocluster with
    fewer members than ``per`` cycles through all of them; the draws
    replay from the generator's seed."""
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(0, 5, 300))
    labels[labels == 4] = 3            # mesocluster 4 empty
    labels[:2] = 4                     # ... now two members
    gen = torch.Generator().manual_seed(1)
    idx = kmeans_balanced._meso_partition_sample(labels, gen, 5, 64)
    assert idx.shape == (5, 64)
    for m in range(5):
        assert bool((labels[idx[m]] == m).all())
    assert set(idx[4].tolist()) == {0, 1}
    again = kmeans_balanced._meso_partition_sample(
        labels, torch.Generator().manual_seed(1), 5, 64)
    assert torch.equal(idx, again)

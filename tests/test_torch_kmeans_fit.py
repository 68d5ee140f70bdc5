"""raft_tpu_torch k-means, fused L2 NN (Kernel H) and pairwise distances
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Kernel H's plain version is held to ``fused_l2_nn(use_pallas=True)``,
which runs ``fused_l2_nn_pallas`` in interpret mode off the TPU.  The
arithmetic that differs is stated where it matters: on the CPU the JAX
``kmeans.fit`` assigns with fp32 products, while the port's Lloyd loop at
dim >= 32 runs Kernel A's plain version (bf16 products, as the JAX package
does on a TPU), so a fit there is held to an inertia margin; below dim 32
both loops are fp32 and must agree iteration for iteration.  ``predict``,
``cluster_cost``, ``min_cluster_and_distance`` and ``transform`` are fp32
in both packages: distances are held to 1e-5 of the scale ‖x‖² + ‖y‖²
that fp32 cancellation moves them by."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.cluster import kmeans as jax_kmeans
from raft_tpu.cluster import kmeans_types as jax_types
from raft_tpu.distance.fused_l2_nn import fused_l2_nn as jax_fused_l2_nn
from raft_tpu.distance.pairwise import pairwise_distance as jax_pairwise
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.distance import fused_l2_nn as dist_fnn
from raft_tpu_torch.distance.pairwise import distance, pairwise_distance
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.ops import fused_l2_nn as fnn

CPU = DeviceResources(seed=0, device="cpu")
L2 = DistanceType.L2Expanded


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


def _sift_like(n, dim, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 16)).astype(np.float32)
    a = rng.normal(size=(16, dim)).astype(np.float32) / np.float32(4.0)
    x = z @ a
    return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)


def _scale(x, y):
    return float((x * x).sum(1).max() + (y * y).sum(1).max())


def _assert_nn_match(d, i, rd, ri, x, y, sqrt=False):
    """dmin within 1e-5 of the scale; each index equal to the reference's
    or at a distance tie with it (distances recomputed in float64)."""
    d, rd = np.asarray(d, np.float64), np.asarray(rd, np.float64)
    if sqrt:
        d, rd = d ** 2, rd ** 2
    tol = 1e-5 * _scale(x, y)
    np.testing.assert_allclose(d, rd, rtol=0, atol=tol)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    i, ri = np.asarray(i), np.asarray(ri)
    dk = ((x64 - y64[i]) ** 2).sum(1)
    dr = ((x64 - y64[ri]) ** 2).sum(1)
    assert ((i == ri) | (np.abs(dk - dr) <= tol)).all()
    assert np.mean(i == ri) >= 0.99


@pytest.mark.parametrize("m,n,k,sqrt", [(300, 700, 64, False),
                                        (257, 513, 128, True),
                                        (100, 37, 5, False)])
def test_kernel_h_plain_matches_jax_pallas(m, n, k, sqrt):
    """Kernel H's plain version against ``fused_l2_nn_pallas`` (interpreted)
    at shapes that leave ragged tiles on both sides; a duplicated y row
    resolves to its first copy in both."""
    rng = np.random.default_rng(m + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    y[n - 1] = y[3]
    x[0] = y[3] + np.float32(1e-3)
    rd, ri = jax_fused_l2_nn(jnp.asarray(x), jnp.asarray(y), sqrt=sqrt,
                             use_pallas=True)
    d, i = fnn.fused_l2_nn(torch.from_numpy(x), torch.from_numpy(y), sqrt)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    _assert_nn_match(d.numpy(), i.numpy(), rd, ri, x, y, sqrt)
    assert int(i[0]) == int(np.asarray(ri)[0]) == 3


@pytest.mark.parametrize("use_pallas", [False, True])
def test_distance_fused_l2_nn_matches_jax(use_pallas):
    """The public function: both values of ``use_pallas`` run the same
    (plain, on the CPU) computation; the min-reduce alias agrees."""
    x = _sift_like(400, 32, 1)
    y = _sift_like(90, 32, 2)
    rd, ri = jax_fused_l2_nn(jnp.asarray(x), jnp.asarray(y),
                             use_pallas=use_pallas)
    d, i = dist_fnn.fused_l2_nn(x, y, use_pallas=use_pallas, device="cpu")
    _assert_nn_match(d.numpy(), i.numpy(), rd, ri, x, y)
    d2, i2 = dist_fnn.fused_l2_nn_min_reduce(torch.from_numpy(x),
                                             torch.from_numpy(y))
    assert torch.equal(d, d2) and torch.equal(i, i2)


def test_balanced_assign_is_fused_l2_nn_exactly():
    """kmeans_balanced._assign's L2 branch is distance.fused_l2_nn (Kernel
    H on the card): the same labels and distances bit for bit; the
    InnerProduct branch is the argmax of the products."""
    x = torch.from_numpy(_sift_like(700, 24, 3))
    c = torch.from_numpy(_sift_like(37, 24, 4))
    lab, d = kmeans_balanced._assign(x, c, L2)
    rd, ri = dist_fnn.fused_l2_nn(x, c)
    assert lab.dtype == torch.int64
    assert torch.equal(lab, ri.long()) and torch.equal(d, rd)
    lab, d = kmeans_balanced._assign(x, c, DistanceType.InnerProduct)
    best, want = torch.max(x @ c.T, dim=1)
    assert torch.equal(lab, want) and torch.equal(d, -best)


PAIRWISE = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
            DistanceType.InnerProduct, DistanceType.CosineExpanded]


@pytest.mark.parametrize("metric", PAIRWISE, ids=[m.name for m in PAIRWISE])
def test_pairwise_distance_matches_jax(metric):
    x = _sift_like(60, 48, 5)
    y = _sift_like(45, 48, 6)
    ref = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(y), metric))
    got = pairwise_distance(torch.from_numpy(x), torch.from_numpy(y),
                            metric).numpy()
    if metric in (DistanceType.L2Expanded, DistanceType.L2Unexpanded):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * _scale(x, y))
    elif metric in (DistanceType.L2SqrtExpanded,
                    DistanceType.L2SqrtUnexpanded):
        np.testing.assert_allclose(got ** 2, ref ** 2, rtol=0,
                                   atol=1e-5 * _scale(x, y))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        distance(torch.from_numpy(x), torch.from_numpy(y), metric).numpy(),
        got)


def test_pairwise_names_and_the_metrics_not_ported():
    x = torch.from_numpy(_sift_like(5, 8, 7))
    assert torch.equal(pairwise_distance(x, x, "sqeuclidean"),
                       pairwise_distance(x, x, DistanceType.L2Expanded))
    for metric in (DistanceType.L1, DistanceType.Canberra, "hamming"):
        with pytest.raises(NotImplementedError,
                           match="the other pairwise metrics"):
            pairwise_distance(x, x, metric)
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_distance(x, x, "no-such-metric")


def test_kmeans_params_match_the_reference_fields_and_defaults():
    for ours, theirs in ((KMeansParams, jax_types.KMeansParams),):
        assert ({f.name: f.default for f in dataclasses.fields(ours)}
                == {f.name: f.default for f in dataclasses.fields(theirs)})
    for name in ("KMeansPlusPlus", "Random", "Array"):
        assert getattr(InitMethod, name) == getattr(jax_types.InitMethod,
                                                    name)


def _jax_fit(params, x, c0=None, w=None):
    p = jax_types.KMeansParams(**dataclasses.asdict(params))
    c, inertia, n_iter = jax_kmeans.fit(JaxResources(seed=0), p,
                                        jnp.asarray(x),
                                        None if w is None else jnp.asarray(w),
                                        None if c0 is None else
                                        jnp.asarray(c0))
    return np.asarray(c), float(inertia), int(n_iter)


def test_fit_with_array_init_matches_jax_below_dim_32():
    """fp32 assignment and update in both loops: the same iterations,
    centroids within fp32 summation order, the same inertia."""
    x = _sift_like(2000, 16, 8)
    c0 = x[:12].copy()
    w = np.random.default_rng(8).choice([0.5, 1.0, 2.0], 2000).astype(
        np.float32)
    params = KMeansParams(n_clusters=12, init=InitMethod.Array, max_iter=40,
                          tol=1e-6)
    rc, rinertia, rn = _jax_fit(params, x, c0, w)
    c, inertia, n_iter = kmeans.fit(CPU, params, x, w, c0)
    assert n_iter == rn
    np.testing.assert_allclose(c.numpy(), rc, rtol=1e-4, atol=1e-4)
    assert float(inertia) == pytest.approx(rinertia, rel=1e-5)


def test_fit_with_array_init_at_dim_64_within_inertia_margin():
    """The port's loop runs Kernel A (bf16 products) where the JAX CPU loop
    is fp32: the fits land within 1% of each other's inertia."""
    x = _sift_like(3000, 64, 9)
    params = KMeansParams(n_clusters=16, init=InitMethod.Array, max_iter=50)
    _, rinertia, _ = _jax_fit(params, x, x[::187][:16].copy())
    _, inertia, _ = kmeans.fit(CPU, params, x, None, x[::187][:16].copy())
    assert float(inertia) == pytest.approx(rinertia, rel=0.01)


@pytest.mark.parametrize("dim", [16, 64])
def test_kmeans_plus_plus_fit_within_inertia_margin(dim):
    """Default params (k-means++ init, max_iter 300, tol 1e-4): the two
    packages draw differently, so the fits are held to 5% of each other's
    inertia on SIFT-like data."""
    x = _sift_like(3000, dim, 10)
    params = KMeansParams(n_clusters=16)
    _, rinertia, _ = _jax_fit(params, x)
    c, inertia, n_iter = kmeans.fit(CPU, params, x)
    assert 1 <= n_iter <= 300 and c.shape == (16, dim)
    assert float(inertia) == pytest.approx(rinertia, rel=0.05)
    again = kmeans.fit(CPU, params, x)
    assert torch.equal(again[0], c)       # seeded by params.seed


def test_init_plus_plus_picks_distinct_rows_spread_out():
    x = _sift_like(1000, 16, 11)
    c = kmeans.init_plus_plus(CPU, x, 20, generator=torch.Generator()
                              .manual_seed(1))
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in c.tolist())
    assert len({tuple(r) for r in c.tolist()}) == 20
    cost_pp = float(kmeans.cluster_cost(torch.from_numpy(x), c))
    cost_rand = float(kmeans.cluster_cost(torch.from_numpy(x),
                                          torch.from_numpy(x[:20])))
    assert cost_pp < cost_rand


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct])
def test_predict_cost_min_cluster_and_transform_match_jax(metric):
    x = _sift_like(1500, 32, 12)
    c = _sift_like(24, 32, 13)
    w = np.random.default_rng(12).uniform(0.5, 2.0, 1500).astype(np.float32)
    ri, rd = jax_kmeans.min_cluster_and_distance(jnp.asarray(x),
                                                 jnp.asarray(c),
                                                 metric=metric)
    i, d = kmeans.min_cluster_and_distance(torch.from_numpy(x),
                                           torch.from_numpy(c), metric=metric)
    assert i.dtype == torch.int32
    if metric == DistanceType.InnerProduct:
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    else:
        _assert_nn_match(d.numpy(), i.numpy(), rd, ri, x, c,
                         sqrt=metric == DistanceType.L2SqrtExpanded)
    p = KMeansParams(n_clusters=24, metric=metric)
    jp = jax_types.KMeansParams(n_clusters=24, metric=metric)
    labels, inertia = kmeans.predict(CPU, p, x, c, sample_weight=w)
    rlabels, rinertia = jax_kmeans.predict(JaxResources(), jp, x, c,
                                           sample_weight=w)
    assert np.mean(labels.numpy() == np.asarray(rlabels)) >= 0.99
    assert float(inertia) == pytest.approx(float(rinertia), rel=1e-5,
                                           abs=1e-3)
    assert float(kmeans.cluster_cost(x_t := torch.from_numpy(x),
                                     torch.from_numpy(c), metric=metric)
                 ) == pytest.approx(float(jax_kmeans.cluster_cost(
                     jnp.asarray(x), jnp.asarray(c), metric=metric)),
                     rel=1e-5, abs=1e-3)
    t = kmeans.transform(CPU, p, x_t, c).numpy()
    rt = np.asarray(jax_kmeans.transform(JaxResources(), jp, x, c))
    np.testing.assert_allclose(t, rt, rtol=1e-4, atol=1e-5 * _scale(x, c))


def test_update_centroids_matches_jax_and_keeps_empty_clusters():
    x = _sift_like(500, 8, 14)
    labels = np.random.default_rng(14).integers(0, 6, 500).astype(np.int32)
    labels[labels == 4] = 5                      # cluster 4 stays empty
    w = np.random.default_rng(15).uniform(0.1, 3.0, 500).astype(np.float32)
    old = _sift_like(7, 8, 16)
    rc, rn = jax_kmeans.update_centroids(jnp.asarray(x), jnp.asarray(labels),
                                         7, sample_weight=jnp.asarray(w),
                                         old_centroids=jnp.asarray(old))
    c, n = kmeans.update_centroids(torch.from_numpy(x),
                                   torch.from_numpy(labels), 7,
                                   sample_weight=torch.from_numpy(w),
                                   old_centroids=torch.from_numpy(old))
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(n.numpy(), np.asarray(rn), rtol=1e-5)
    np.testing.assert_array_equal(c[4].numpy(), old[4])


def test_sampling_takes_distinct_rows():
    x = torch.arange(200.0).reshape(100, 2)
    for fn in (kmeans.sample_centroids, kmeans.shuffle_and_gather,
               kmeans.init_random):
        got = fn(CPU, x, 30)
        assert got.shape == (30, 2)
        assert len(set(got[:, 0].tolist())) == 30


def test_restarts_keep_the_lowest_inertia_and_fit_predict_agrees():
    x = _sift_like(1200, 16, 17)
    single = [kmeans.fit(CPU, KMeansParams(n_clusters=9, seed=s), x)[1]
              for s in (5,)]
    best = kmeans.fit(CPU, KMeansParams(n_clusters=9, seed=5, n_init=3), x)
    assert float(best[1]) <= float(single[0]) + 1e-3
    labels, c, inertia, n_iter = kmeans.fit_predict(
        CPU, KMeansParams(n_clusters=9, seed=5, n_init=3), x)
    assert torch.equal(c, best[0]) and n_iter == best[2]
    assert float(inertia) == pytest.approx(float(best[1]), rel=1e-6)
    assert labels.shape == (1200,) and int(labels.max()) < 9


def test_find_k_returns_a_k_in_range():
    x = _sift_like(600, 8, 18)
    k, c, inertia = kmeans.find_k(CPU, x, k_max=8, k_min=2, max_iter=20)
    assert 2 <= k <= 8 and c.shape == (k, 8) and float(inertia) > 0

"""The primitives in the port against the JAX package, on the CPU:
``matrix.ops``, ``brute_force.knn_merge_parts``,
``kmeans_balanced.build_clusters`` and ``random``.

The matrix helpers and the merge are held to ``raft_tpu`` bit for bit on
the same numpy inputs.  ``build_clusters`` is held to its own contract
(labels are the nearest centroids, sizes their counts) and to the JAX
fit's inertia within 10%, since threefry and Philox seed the fits
differently.  ``random`` cannot match threefry's bits: each distribution
is held to the JAX package's shape and dtype, to per-seed determinism,
and to its distribution's moments within a few standard errors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu import random as jax_random
from raft_tpu.cluster import kmeans_balanced as jax_kb
from raft_tpu.cluster.kmeans_types import (KMeansBalancedParams as
                                           JaxBalancedParams)
from raft_tpu.matrix import ops as jax_ops
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu_torch import DeviceResources
from raft_tpu_torch import random as rnd
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.matrix import ops
from raft_tpu_torch.neighbors import brute_force

CPU = DeviceResources(device="cpu")
RNG = np.random.default_rng(0)
M = RNG.normal(size=(7, 5)).astype(np.float32)
M[2, 3] = M[2, 1]                                 # a tie for argmax/min


def _eq(ours, theirs):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


IDX = np.array([4, 0, 4, 6], np.int32)
OPS = {
    "gather": (lambda m: ops.gather(m, torch.from_numpy(IDX)),
               lambda m: jax_ops.gather(m, IDX)),
    "gather_if": (lambda m: ops.gather_if(
        m, torch.from_numpy(IDX), torch.tensor([1., -1., 2., -3.]),
        lambda s: s > 0, torch.zeros(4, 5)),
        lambda m: jax_ops.gather_if(m, IDX, jnp.array([1., -1., 2., -3.]),
                                    lambda s: s > 0, jnp.zeros((4, 5)))),
    "scatter": (lambda m: ops.scatter(m, torch.tensor([1, 5]),
                                      torch.ones(2, 5)),
                lambda m: jax_ops.scatter(m, jnp.array([1, 5]),
                                          jnp.ones((2, 5)))),
    "argmax": (ops.argmax, jax_ops.argmax),
    "argmin": (ops.argmin, jax_ops.argmin),
    "slice": (lambda m: ops.slice(m, 1, 2, 5, 4),
              lambda m: jax_ops.slice(m, 1, 2, 5, 4)),
    "copy": (ops.copy, jax_ops.copy),
    "init": (lambda m: ops.init((3, 2), 1.5, device="cpu"),
             lambda m: jax_ops.init((3, 2), 1.5)),
    "linewise_op": (lambda m: ops.linewise_op(
        m, lambda a, b, c: a * b + c, torch.arange(5.), torch.ones(5)),
        lambda m: jax_ops.linewise_op(m, lambda a, b, c: a * b + c,
                                      jnp.arange(5.), jnp.ones(5))),
    "linewise_op_columns": (lambda m: ops.linewise_op(
        m, torch.sub, torch.arange(7.), along_lines=False),
        lambda m: jax_ops.linewise_op(m, jnp.subtract, jnp.arange(7.),
                                      along_lines=False)),
    "col_wise_sort": (ops.col_wise_sort, jax_ops.col_wise_sort),
    "col_wise_sort_descending": (
        lambda m: ops.col_wise_sort(m, ascending=False),
        lambda m: jax_ops.col_wise_sort(m, ascending=False)),
    "reverse": (ops.reverse, jax_ops.reverse),
    "reverse_columns": (lambda m: ops.reverse(m, along_rows=False),
                        lambda m: jax_ops.reverse(m, along_rows=False)),
    "sign_flip": (ops.sign_flip, jax_ops.sign_flip),
    "diagonal": (ops.diagonal, jax_ops.diagonal),
    "set_diagonal": (lambda m: ops.set_diagonal(m, torch.arange(9.)),
                     lambda m: jax_ops.set_diagonal(m, jnp.arange(9.))),
    "triangular_upper": (ops.triangular_upper, jax_ops.triangular_upper),
    "zero_small_values": (lambda m: ops.zero_small_values(m, 0.5),
                          lambda m: jax_ops.zero_small_values(m, 0.5)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_matrix_op_matches_the_jax_package(name):
    ours, theirs = OPS[name]
    m = torch.from_numpy(M.copy())
    out = ours(m)
    _eq(out, theirs(jnp.asarray(M)))
    assert torch.equal(m, torch.from_numpy(M))        # the input untouched
    assert not (isinstance(out, torch.Tensor) and out.data_ptr()
                == m.data_ptr())


@pytest.mark.parametrize("select_min,translated",
                         [(True, False), (False, False), (True, True)])
def test_knn_merge_parts_matches_the_jax_package(select_min, translated):
    keys = RNG.normal(size=(3, 6, 4)).astype(np.float32)
    keys = np.sort(keys, axis=2)
    vals = RNG.integers(0, 50, size=(3, 6, 4)).astype(np.int32)
    kw = (dict(translations=np.array([0, 100, 300], np.int32)) if translated
          else dict(n_samples=50))
    d, i = brute_force.knn_merge_parts(torch.from_numpy(keys),
                                       torch.from_numpy(vals),
                                       select_min=select_min, **kw)
    rd, ri = jax_bf.knn_merge_parts(jnp.asarray(keys), jnp.asarray(vals),
                                    select_min=select_min, **kw)
    _eq(d, rd)
    _eq(i, ri)
    assert i.dtype == torch.int32


def test_knn_merge_parts_refuses_what_the_jax_package_refuses():
    with pytest.raises(Exception, match="n_samples or translations"):
        brute_force.knn_merge_parts(torch.zeros(2, 1, 3),
                                    torch.zeros(2, 1, 3, dtype=torch.int32))
    with pytest.raises(Exception, match="overflow"):
        brute_force.knn_merge_parts(torch.zeros(3, 1, 3),
                                    torch.zeros(3, 1, 3, dtype=torch.int32),
                                    n_samples=2 ** 31 - 1)


NUMPY_CALLS = {
    "matrix.ops.argmax": lambda: ops.argmax(M.copy()),
    "matrix.ops.gather": lambda: ops.gather(M.copy(), IDX),
    "knn_merge_parts": lambda: brute_force.knn_merge_parts(
        np.zeros((2, 1, 3), np.float32), np.zeros((2, 1, 3), np.int32),
        n_samples=5)[0],
    "random.permute": lambda: rnd.permute(5, M.copy())[0]}


@pytest.mark.parametrize("name", sorted(NUMPY_CALLS))
def test_numpy_input_never_runs_on_the_cpu_unasked(name):
    """Entry points without a handle put numpy input on the card, as
    ``matrix.ops.init`` does: without one they raise rather than compute
    on the CPU (``test_torch_cuda.py`` checks the card side)."""
    if torch.cuda.is_available():
        assert NUMPY_CALLS[name]().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            NUMPY_CALLS[name]()


def test_numpy_operands_follow_the_matrix():
    """A numpy operand beside a tensor goes to the tensor's device."""
    m = torch.from_numpy(M.copy())
    _eq(ops.gather(m, IDX), jax_ops.gather(M, IDX))
    _eq(ops.linewise_op(m, torch.add, np.arange(5, dtype=np.float32)),
        jax_ops.linewise_op(jnp.asarray(M), jnp.add,
                            jnp.arange(5, dtype=jnp.float32)))
    d, i = brute_force.knn_merge_parts(
        torch.zeros(2, 1, 3), np.arange(6, dtype=np.int32).reshape(2, 1, 3),
        n_samples=5)
    assert d.device.type == i.device.type == "cpu"


def test_build_clusters_trains_assigns_and_counts():
    X = RNG.normal(size=(600, 6)).astype(np.float32)
    X[:300] += 4.0
    c, labels, sizes = kmeans_balanced.build_clusters(
        DeviceResources(seed=1, device="cpu"), KMeansBalancedParams(
            n_iters=10), X, 8)
    xt = torch.from_numpy(X)
    assert torch.equal(labels, torch.argmin(torch.cdist(xt, c), 1))
    assert torch.equal(sizes, torch.bincount(labels, minlength=8).int())
    jc, jl, js = jax_kb.build_clusters(JaxResources(seed=1),
                                       JaxBalancedParams(n_iters=10), X, 8)
    assert int(np.asarray(js).sum()) == int(sizes.sum()) == 600

    def inertia(cent, lab):
        return float(((xt - torch.as_tensor(np.asarray(cent))[
            torch.as_tensor(np.asarray(lab)).long()]) ** 2).sum())
    assert inertia(c, labels) <= 1.1 * inertia(jc, jl)


# distribution -> (port call, JAX call, mean, variance) at n draws
N = 200_000
DISTS = {
    "uniform": (lambda r: rnd.uniform(r, N, low=-1.0, high=3.0,
                                      device="cpu"),
                lambda k: jax_random.uniform(k, (N,), low=-1.0, high=3.0),
                1.0, 16 / 12),
    "uniformInt": (lambda r: rnd.uniformInt(r, N, low=2, high=9,
                                            device="cpu"),
                   lambda k: jax_random.uniformInt(k, (N,), low=2, high=9),
                   5.0, (7 ** 2 - 1) / 12),
    "normal": (lambda r: rnd.normal(r, N, mu=2.0, sigma=3.0, device="cpu"),
               lambda k: jax_random.normal(k, (N,), mu=2.0, sigma=3.0),
               2.0, 9.0),
    "normalInt": (lambda r: rnd.normalInt(r, N, mu=5.0, sigma=4.0,
                                          device="cpu"),
                  lambda k: jax_random.normalInt(k, (N,), mu=5.0, sigma=4.0),
                  5.0, 16.0 + 1 / 12),
    "lognormal": (lambda r: rnd.lognormal(r, N, sigma=0.5, device="cpu"),
                  lambda k: jax_random.lognormal(k, (N,), sigma=0.5),
                  math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25)),
    "gumbel": (lambda r: rnd.gumbel(r, N, mu=1.0, beta=2.0, device="cpu"),
               lambda k: jax_random.gumbel(k, (N,), mu=1.0, beta=2.0),
               1.0 + 2.0 * 0.5772156649, math.pi ** 2 / 6 * 4),
    "laplace": (lambda r: rnd.laplace(r, N, mu=-1.0, scale=2.0,
                                      device="cpu"),
                lambda k: jax_random.laplace(k, (N,), mu=-1.0, scale=2.0),
                -1.0, 8.0),
    "logistic": (lambda r: rnd.logistic(r, N, mu=0.5, scale=1.5,
                                        device="cpu"),
                 lambda k: jax_random.logistic(k, (N,), mu=0.5, scale=1.5),
                 0.5, math.pi ** 2 / 3 * 2.25),
    "exponential": (lambda r: rnd.exponential(r, N, lam=2.0, device="cpu"),
                    lambda k: jax_random.exponential(k, (N,), lam=2.0),
                    0.5, 0.25),
    "rayleigh": (lambda r: rnd.rayleigh(r, N, sigma=2.0, device="cpu"),
                 lambda k: jax_random.rayleigh(k, (N,), sigma=2.0),
                 2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4),
    "bernoulli": (lambda r: rnd.bernoulli(r, N, prob=0.3, device="cpu"),
                  lambda k: jax_random.bernoulli(k, (N,), prob=0.3),
                  0.3, 0.21),
    "scaled_bernoulli": (lambda r: rnd.scaled_bernoulli(
        r, N, prob=0.3, scale=2.0, device="cpu"),
        lambda k: jax_random.scaled_bernoulli(k, (N,), prob=0.3, scale=2.0),
        2.0 * 0.3 - 2.0 * 0.7, 4.0 * (1 - 0.4 ** 2)),
    "discrete": (lambda r: rnd.discrete(r, N, torch.tensor([1., 0., 3.]),
                                        device="cpu"),
                 lambda k: jax_random.discrete(k, (N,),
                                               jnp.array([1., 0., 3.])),
                 1.5, 0.75),
}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_matches_the_jax_package_by_moments(name):
    ours_fn, theirs_fn, mean, var = DISTS[name]
    ours = ours_fn(rnd.RngState(7))
    theirs = np.asarray(theirs_fn(jax_random.RngState(7)))
    assert tuple(ours.shape) == theirs.shape
    assert str(ours.dtype).split(".")[-1] == str(theirs.dtype) or (
        ours.dtype == torch.bool and theirs.dtype == np.bool_)
    assert torch.equal(ours, ours_fn(rnd.RngState(7)))       # per seed
    assert not torch.equal(ours, ours_fn(rnd.RngState(8)))
    x = ours.double()
    se = math.sqrt(var / N)
    assert abs(float(x.mean()) - mean) <= 5 * se, (float(x.mean()), mean)
    assert abs(float(x.var()) - var) <= 0.05 * var
    assert abs(float(np.mean(theirs)) - mean) <= 5 * se     # the reference


def test_rng_state_advances_as_the_reference():
    s = rnd.RngState(3)
    a = rnd.normal(s, 4, device="cpu")
    b = rnd.normal(s, 4, device="cpu")
    assert s.base_subsequence == 2 and not torch.equal(a, b)
    assert torch.equal(a, rnd.normal(rnd.RngState(3), 4, device="cpu"))


def test_generators_match_the_jax_package_in_shape_and_law():
    X, y = rnd.make_blobs(3000, 4, n_clusters=3, cluster_std=0.5, seed=2,
                          device="cpu")
    jX, jy = jax_random.make_blobs(3000, 4, n_clusters=3, cluster_std=0.5,
                                   seed=2)
    assert X.shape == tuple(np.asarray(jX).shape) and y.dtype == torch.int32
    for c in range(3):
        assert abs(float(X[y == c].std(0).mean()) - 0.5) < 0.05
    X2, _ = rnd.make_blobs(3000, 4, n_clusters=3, seed=2, device="cpu")
    assert torch.equal(X2, rnd.make_blobs(3000, 4, n_clusters=3, seed=2,
                                          device="cpu")[0])
    Xr, yr, coef = rnd.make_regression(500, 6, n_informative=3, seed=1,
                                       device="cpu")
    jXr, jyr, jcoef = jax_random.make_regression(500, 6, n_informative=3,
                                                 seed=1)
    assert Xr.shape == np.asarray(jXr).shape and coef.shape == (6, 1)
    assert bool((coef[3:] == 0).all()) and bool((coef[:3] > 0).all())
    torch.testing.assert_close(yr, (Xr @ coef)[:, 0])
    theta = torch.tensor([[0.55, 0.2, 0.2, 0.05]] * 5)
    src, dst = rnd.rmat_rectangular_generator(3, theta, 5, 4, 4000,
                                              device="cpu")
    jsrc, jdst = jax_random.rmat_rectangular_generator(
        3, jnp.asarray(theta.numpy()), 5, 4, 4000)
    assert src.shape == np.asarray(jsrc).shape and src.dtype == torch.int32
    assert int(src.max()) < 32 and int(dst.max()) < 16
    # quadrant a (both bits 0) at every level is the most likely
    assert float((src == 0).float().mean()) > float(
        (src == 31).float().mean())
    s = rnd.sample_without_replacement(4, 50, 20, device="cpu")
    assert len(set(s.tolist())) == 20 and int(s.max()) < 50
    w = torch.zeros(50)
    w[:10] = 1.0
    sw = rnd.sample_without_replacement(4, 50, 10, weights=w, device="cpu")
    assert sorted(sw.tolist()) == list(range(10))
    data = torch.arange(12.).reshape(6, 2)
    out, perm = rnd.permute(5, data, device="cpu")
    assert sorted(perm.tolist()) == list(range(6))
    assert torch.equal(out, data[perm.long()])
    cov = torch.tensor([[2.0, 0.6], [0.6, 1.0]])
    z = rnd.multi_variable_gaussian(6, torch.tensor([1.0, -1.0]), cov,
                                    100_000, device="cpu")
    torch.testing.assert_close(z.mean(0), torch.tensor([1.0, -1.0]),
                               atol=0.03, rtol=0)
    torch.testing.assert_close(torch.cov(z.T), cov, atol=0.04, rtol=0)

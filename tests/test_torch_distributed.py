"""``raft_tpu_torch.distributed`` kNN and k-means on gloo CPU ranks,
against the JAX package's ``raft_tpu.distributed`` at the same shard count
on the virtual CPU mesh (``tests/test_distributed.py`` holds the JAX ones
to the single-device algorithms).

Four ranks are spawned once for the module (``comms.launch.spawn``); each
runs ``torch_dist_ranks.distributed_checks`` at 4 shards (every rank) and
at 2 (ranks 0 and 1, a group of their own) and returns its results, which
the tests below assert one check each.  Tolerances: kNN distances within
1e-5 of max ‖q‖² + max ‖x‖² (the L2 metrics; the product's summation
order differs) and ids equal or at a distance tie; k-means centroids
within 1e-4 (data in [-10, 10]: 1e-5 of its scale), inertia within 1e-5
relative, ``n_iter`` and labels equal.  The ++ init draws from torch's
Philox where the JAX package draws from threefry, so its fit is held to
the JAX inertia within 2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.cluster.kmeans_types import InitMethod as JaxInit
from raft_tpu.cluster.kmeans_types import KMeansParams as JaxParams
from raft_tpu.comms import CommsSession as JaxSession
from raft_tpu.core.error import RaftError as JaxRaftError
from raft_tpu.distributed import kmeans as jax_kmeans
from raft_tpu.distributed import knn as jax_knn
from raft_tpu_torch.comms import launch

import torch_dist_ranks as ranks

WORLD = 4
SHARDS = (2, 4)
METRICS = {"L2Expanded": 0, "L2SqrtExpanded": 1, "InnerProduct": 6}
K = 8


def _data():
    rng = np.random.default_rng(0)
    centers = rng.uniform(-10, 10, size=(5, 8)).astype(np.float32)
    X = (centers[rng.integers(0, 5, 1600)]
         + 0.5 * rng.normal(size=(1600, 8))).astype(np.float32)
    return dict(db=rng.normal(size=(1024, 16)).astype(np.float32),
                q=rng.normal(size=(32, 16)).astype(np.float32), k=K,
                metrics=tuple(METRICS.values()), X=X, c0=X[:5].copy(),
                max_iter=50, tol=1e-6, X_pp=X, pp_clusters=5)


DATA = _data()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("distributed") / "rendezvous"
    return launch.spawn(ranks.distributed_checks, WORLD, str(path),
                        args=(DATA,), timeout_s=180, collective_s=60)


@pytest.fixture(scope="module")
def jax_handles():
    devs = jax.devices("cpu")
    out = {}
    for shards in SHARDS:
        s = JaxSession(devices=devs[:shards], axis_name="data").init()
        out[shards] = s.worker_handle(seed=0)
    return out


def _ours(runs, shards):
    """Rank 0's results at ``shards``; every rank of the group must agree
    with it."""
    return runs[0][shards]


def _ties_ok(ids, ref_ids, dist_of, tol):
    """Each id equals the reference's or sits at a distance tie with it."""
    same = ids == ref_ids
    gap = np.abs(dist_of(ids) - dist_of(ref_ids))
    return bool((same | (gap <= tol)).all())


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_knn_matches_the_jax_package(runs, jax_handles, shards, metric):
    m = METRICS[metric]
    d, i = _ours(runs, shards)["knn"][m]
    jd, ji = (np.asarray(a) for a in jax_knn.knn(
        jax_handles[shards], DATA["db"], DATA["q"], K, metric=m))
    q, db = DATA["q"], DATA["db"]
    scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
    if m == 6:
        def dist_of(ids):
            return np.take_along_axis(q @ db.T, ids, 1)
    else:
        def dist_of(ids):
            return ((q[:, None, :] - db[ids]) ** 2).sum(-1)
    tol = 1e-5 * scale
    np.testing.assert_allclose(d, jd, rtol=0,
                               atol=tol if m != 1 else np.sqrt(tol))
    assert i.dtype == np.int32 and _ties_ok(i, ji, dist_of, tol)


@pytest.mark.parametrize("shards", SHARDS)
def test_knn_is_replicated_and_takes_tensors(runs, shards):
    """Every rank of the group returns the same answer, and a tensor
    database gives what the numpy one gives."""
    mine = _ours(runs, shards)
    for r in range(shards):
        for m in METRICS.values():
            for a, b in zip(runs[r][shards]["knn"][m], mine["knn"][m]):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(mine["knn tensor"], mine["knn"][0]):
        np.testing.assert_array_equal(a, b)


def _jax_fit(handle, init, n_clusters, X, centroids=None):
    params = JaxParams(n_clusters=n_clusters, max_iter=DATA["max_iter"],
                       tol=DATA["tol"], init=init)
    c, inertia, n_iter = jax_kmeans.fit(
        handle, params, X,
        centroids=None if centroids is None else jnp.asarray(centroids))
    return np.asarray(c), float(inertia), int(n_iter), params


@pytest.mark.parametrize("shards", SHARDS)
def test_kmeans_fit_matches_the_jax_package(runs, jax_handles, shards):
    c, inertia, n_iter = _ours(runs, shards)["fit"]
    jc, jinertia, jn, _ = _jax_fit(jax_handles[shards], JaxInit.Array, 5,
                                   DATA["X"], DATA["c0"])
    assert n_iter == jn
    np.testing.assert_allclose(c, jc, rtol=0, atol=1e-4)
    assert abs(inertia - jinertia) <= 1e-5 * jinertia
    for r in range(shards):
        got = runs[r][shards]["fit"]
        np.testing.assert_array_equal(got[0], c)
        assert got[1:] == (inertia, n_iter)


@pytest.mark.parametrize("shards", SHARDS)
def test_kmeans_predict_matches_the_jax_package(runs, jax_handles, shards):
    ours = _ours(runs, shards)
    c = ours["fit"][0]
    jc, _, _, params = _jax_fit(jax_handles[shards], JaxInit.Array, 5,
                                DATA["X"], DATA["c0"])
    labels = np.asarray(jax_kmeans.predict(jax_handles[shards], params,
                                           DATA["X"], jnp.asarray(c)))
    assert ours["predict"].shape == (DATA["X"].shape[0],)
    np.testing.assert_array_equal(ours["predict"], labels)


@pytest.mark.parametrize("shards", SHARDS)
def test_kmeans_plus_plus_within_margin_of_the_jax_inertia(runs,
                                                           jax_handles,
                                                           shards):
    c, inertia, n_iter = _ours(runs, shards)["fit ++"]
    _, jinertia, _, _ = _jax_fit(jax_handles[shards],
                                 JaxInit.KMeansPlusPlus,
                                 DATA["pp_clusters"], DATA["X_pp"])
    assert c.shape == (DATA["pp_clusters"], DATA["X_pp"].shape[1])
    assert 0 < n_iter <= DATA["max_iter"]
    assert inertia <= 1.02 * jinertia


def _jax_error(handle, case):
    params = JaxParams(n_clusters=5, init=JaxInit.Array)
    calls = {
        "uneven": lambda: jax_knn.knn(handle, DATA["db"][:-1], DATA["q"],
                                      K),
        "k past shard": lambda: jax_knn.knn(
            handle, DATA["db"], DATA["q"], DATA["db"].shape[0]),
        "uneven fit": lambda: jax_kmeans.fit(
            handle, params, DATA["X"][:-1], centroids=DATA["c0"]),
        "array without centroids": lambda: jax_kmeans.fit(
            handle, params, DATA["X"]),
    }
    with pytest.raises(JaxRaftError) as err:
        calls[case]()
    return f"LogicError: {err.value}"


@pytest.mark.parametrize("case", ["uneven", "k past shard", "uneven fit",
                                  "array without centroids"])
def test_errors_are_the_jax_errors(runs, jax_handles, case):
    expected = _jax_error(jax_handles[4], case)
    assert [r[4]["errors"][case] for r in runs] == [expected] * WORLD


@pytest.mark.parametrize("what", ["knn", "fit", "predict"])
def test_a_handle_without_comms_is_refused(runs, what):
    for r in runs:
        assert r["no comms"][what] == (
            f"LogicError: distributed."
            f"{'knn' if what == 'knn' else 'kmeans.' + what}: handle has "
            f"no comms (use CommsSession.worker_handle())")

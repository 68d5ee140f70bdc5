"""The port's ``brute_force.knn`` and ``select_k`` against the JAX
package's, on the CPU: the metrics the port's ``pairwise_distance``
computes, with ``metric_arg``; ``tile_n`` below ``k``; an AOT artifact at
Cosine; and ``select_k``'s order among equal values (``lax.top_k``'s: the
lower position first, in IEEE total order), ``±inf`` and ``-0.0``
included.

Tolerances: distances within 1e-5 of max ‖q‖² + max ‖x‖² at the L2
metrics and InnerProduct (the port scores the L2 family expanded; the JAX
package's L2Unexpanded sums differences), of its square root at the sqrt
metrics, and 1e-5 at Cosine; ids equal, or at a distance tie with the JAX
id where the scores differ in the last bits.  Where rows repeat, ids are
held equal.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.core import aot
from raft_tpu_torch.distance import DistanceType
from raft_tpu_torch.matrix import select_k
from raft_tpu_torch.neighbors import brute_force

CPU = DeviceResources(device="cpu", seed=0)
PORTED = ["L2Expanded", "L2SqrtExpanded", "L2Unexpanded",
          "L2SqrtUnexpanded", "InnerProduct", "CosineExpanded"]
NOT_PORTED = [m.name for m in DistanceType if m.name not in PORTED]


def _rows(n=500, d=16, nq=7, seed=0):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.normal(size=(n, d))).astype(np.float32),
            np.abs(rng.normal(size=(nq, d))).astype(np.float32))


def _scores(metric, q, db):
    """Each (query, row) score at ``metric``, in float64."""
    q, db = q.astype(np.float64), db.astype(np.float64)
    ip = q @ db.T
    if metric == DistanceType.InnerProduct:
        return ip
    if metric == DistanceType.CosineExpanded:
        return 1.0 - ip / np.outer(np.linalg.norm(q, axis=1),
                                   np.linalg.norm(db, axis=1))
    d = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    return np.sqrt(d) if "Sqrt" in metric.name else d


def _tolerance(metric, q, db):
    scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
    if metric == DistanceType.CosineExpanded:
        return 1e-5
    return 1e-5 * (np.sqrt(scale) if "Sqrt" in metric.name else scale)


def _assert_knn_equal(metric, q, db, d, i, jd, ji, exact_ids=False):
    d, i = np.asarray(d), np.asarray(i)
    jd, ji = np.asarray(jd), np.asarray(ji)
    tol = _tolerance(metric, q, db)
    np.testing.assert_allclose(d, jd, rtol=0, atol=tol)
    assert i.dtype == np.int32
    if exact_ids:
        np.testing.assert_array_equal(i, ji)
        return
    s = _scores(metric, q, db)
    gap = np.abs(np.take_along_axis(s, i, 1) - np.take_along_axis(s, ji, 1))
    assert bool(((i == ji) | (gap <= tol)).all())


@pytest.mark.parametrize("tile_n", [65536, 64, 16])
@pytest.mark.parametrize("metric", PORTED)
def test_knn_matches_the_jax_knn_at_each_ported_metric(metric, tile_n):
    db, q = _rows()
    m = DistanceType[metric]
    d, i = brute_force.knn(CPU, torch.from_numpy(db), torch.from_numpy(q),
                           5, metric=m, tile_n=tile_n)
    jd, ji = jax_bf.knn(None, db, q, 5, metric=m,
                        tile_n=min(tile_n, 8192))
    _assert_knn_equal(m, q, db, d, i, jd, ji)


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct",
                                    "CosineExpanded"])
def test_knn_orders_repeated_rows_as_the_jax_knn(metric):
    """40 copies of each of 50 rows: equal distances, ids in the JAX
    order (the lower id first), across tiles too."""
    base, q = _rows(n=50)
    db = np.repeat(base, 40, axis=0)
    m = DistanceType[metric]
    for tile_n in (65536, 48):
        d, i = brute_force.knn(CPU, torch.from_numpy(db),
                               torch.from_numpy(q), 50, metric=m,
                               tile_n=tile_n)
        jd, ji = jax_bf.knn(None, db, q, 50, metric=m, tile_n=tile_n)
        _assert_knn_equal(m, q, db, d, i, jd, ji, exact_ids=True)


@pytest.mark.parametrize("tile_n", [16, 7])
def test_knn_takes_a_tile_narrower_than_k(tile_n):
    """k 50 over tiles of 16 (and 7) rows, 500 rows: the running top k
    starts as k slots of (worst, -1), as the JAX ``_knn_impl`` does."""
    db, q = _rows()
    m = DistanceType.L2Unexpanded
    d, i = brute_force.knn(CPU, torch.from_numpy(db), torch.from_numpy(q),
                           50, tile_n=tile_n)
    jd, ji = jax_bf.knn(None, db, q, 50, tile_n=tile_n)
    _assert_knn_equal(m, q, db, d, i, jd, ji)


def test_knn_narrow_tiles_keep_the_filter_and_offset_contract():
    """A filter admitting fewer rows than k, over tiles narrower than k,
    with a global id offset: the same (worst, -1) slots and shifted ids
    as the JAX knn."""
    db, q = _rows(n=120)
    rng = np.random.default_rng(3)
    mask = rng.random((q.shape[0], 1120)) < 0.02
    mask[:, :1000] = False
    d, i = brute_force.knn(CPU, torch.from_numpy(db), torch.from_numpy(q),
                           10, tile_n=4, global_id_offset=1000,
                           filter=torch.from_numpy(mask))
    jd, ji = jax_bf.knn(None, db, q, 10, tile_n=4, global_id_offset=1000,
                        filter=jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(d), np.asarray(jd), rtol=0,
                               atol=_tolerance(DistanceType.L2Unexpanded,
                                               q, db))
    assert (np.asarray(i) == -1).any()


@pytest.mark.parametrize("metric", ["L2Expanded", "CosineExpanded"])
def test_knn_takes_metric_arg(metric):
    """``metric_arg`` (the Minkowski p of a metric not ported yet) is
    accepted, and leaves the ported metrics' answer as it was."""
    db, q = _rows()
    m = DistanceType[metric]
    base = brute_force.knn(CPU, torch.from_numpy(db), torch.from_numpy(q),
                           5, metric=m)
    got = brute_force.knn(CPU, torch.from_numpy(db), torch.from_numpy(q),
                          5, metric=m, metric_arg=3.0)
    jd, ji = jax_bf.knn(None, db, q, 5, metric=m, metric_arg=3.0)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _assert_knn_equal(m, q, db, *got, jd, ji)


@pytest.mark.parametrize("metric", NOT_PORTED)
def test_a_metric_not_ported_yet_names_its_item(metric):
    db, q = _rows(n=20)
    with pytest.raises(NotImplementedError,
                       match=r"the other pairwise metrics"):
        brute_force.knn(CPU, torch.from_numpy(db), torch.from_numpy(q), 3,
                        metric=DistanceType[metric], metric_arg=3.0)


def test_aot_brute_force_artifact_at_cosine_replays_the_direct_knn():
    """An artifact exported at CosineExpanded, with its ``metric_arg`` in
    the manifest, answers as the direct ``knn`` and as the JAX knn."""
    db, q = _rows(n=300)
    m = DistanceType.CosineExpanded
    buf = aot.export_brute_force_knn(CPU, torch.from_numpy(db), k=5,
                                     batch=4, metric=m, metric_arg=3.0)
    program = aot.read_artifact(io.BytesIO(buf.getvalue()))[0]
    assert (program["metric"], program["metric_arg"]) == (int(m), 3.0)
    g = aot.load_search_fn(buf, device="cpu")
    d, i = g(torch.from_numpy(q[:4]))
    rd, ri = brute_force.knn(CPU, torch.from_numpy(db),
                             torch.from_numpy(q[:4]), 5, metric=m)
    np.testing.assert_array_equal(d.numpy(), rd.numpy())
    np.testing.assert_array_equal(i.numpy(), ri.numpy())
    jd, ji = jax_bf.knn(None, db, q[:4], 5, metric=m)
    _assert_knn_equal(m, q[:4], db, d, i, jd, ji)


def _select_rows():
    """Rows of ties, ±inf and -0.0, some past the whole-row sort's
    length (the rows ``select_k`` selects with ``torch.topk``)."""
    import sys

    long = sys.modules["raft_tpu_torch.matrix.select_k"]._SORT_LEN + 904
    rng = np.random.default_rng(5)
    special = np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, 2.0], np.float32)
    rows = {
        "ints": rng.integers(0, 4, size=(6, 300)).astype(np.float32),
        "specials": rng.choice(special, size=(6, 300)),
        "long ints": rng.integers(0, 3, size=(3, long)).astype(np.float32),
        "long specials": rng.choice(special, size=(3, long)),
        "long distinct": rng.permutation(3 * long).reshape(3, long).astype(
            np.float32),
        "all +inf": np.full((2, 40), np.inf, np.float32),
        "all -inf long": np.full((2, long), -np.inf, np.float32),
        "zeros long": np.zeros((2, long), np.float32),
    }
    return rows


@pytest.mark.parametrize("k", [1, 5, 20])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("kind", sorted(_select_rows()))
def test_select_k_breaks_ties_as_lax_top_k(kind, select_min, k):
    x = _select_rows()[kind]
    payload = np.arange(x.size, dtype=np.int64).reshape(x.shape) * 3
    v, i = select_k(torch.from_numpy(x), k, select_min=select_min)
    jv, ji = jax_select_k(jnp.asarray(x), k, select_min=select_min)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    _, pi = select_k(torch.from_numpy(x), k, select_min=select_min,
                     in_idx=torch.from_numpy(payload))
    np.testing.assert_array_equal(
        pi.numpy(), np.take_along_axis(payload, np.asarray(ji), 1))


def test_select_k_on_a_row_of_inf_keeps_the_first_positions():
    x = torch.full((1, 40), float("inf"))
    assert select_k(x, 5)[1].tolist() == [[0, 1, 2, 3, 4]]
    assert select_k(-x, 5, select_min=False)[1].tolist() == [[0, 1, 2, 3, 4]]

"""The port's delta memtable (``raft_tpu_torch.neighbors.delta``) and the
shared ``grouped.finalize_topk`` epilogue against the JAX package's, on
the CPU.

Random record streams drawn with hypothesis — upserts, deletes, same-id
churn, duplicated replay, resets and regrowth past small capacities — go
through a JAX ``Memtable`` and a port ``Memtable`` (device ``"cpu"``):
every ``apply`` returns the same, the two ``digest()``s are equal, and
``fold_payload()`` / ``fold_items()`` are bit-equal.  ``search``,
``merge_with_main`` and ``merge_with_main_multi`` (with and without a
per-query filter, L2, sqrt-L2 and InnerProduct) give equal results:
distances within 1e-5 of ``||q||^2 + max ||x||^2`` (of ``||q|| max ||x||``
at InnerProduct), ids tie-aware.  ``finalize_topk`` keeps the sentinel
contract of the JAX epilogue bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from raft_tpu.filters import SampleFilter as JaxFilter
from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu.neighbors import delta as jd
from raft_tpu.neighbors import grouped as jgrouped
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import delta, grouped

DIM = 6
ID_SPACE = 48
TOL = 1e-5
L2, L2_SQRT, IP = 0, 1, 6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, n_ops):
    """Records from a numpy seed: upserts (fresh or churned ids), deletes
    and resets; some records replayed again after later ones."""
    rng = np.random.default_rng(seed)
    recs, lsn = [], 0
    for _ in range(n_ops):
        kind = rng.choice(["upsert", "upsert", "churn", "delete", "replay",
                           "reset"], p=[0.3, 0.15, 0.15, 0.25, 0.1, 0.05])
        if kind == "replay" and recs:
            recs.append(recs[int(rng.integers(len(recs)))])
            continue
        if kind == "reset":
            recs.append("reset")
            continue
        lsn += int(rng.integers(1, 3))
        if kind == "delete":
            ids = rng.integers(0, ID_SPACE, size=int(rng.integers(1, 6)))
            recs.append((lsn, jd.OP_DELETE, ids, None))
        else:
            n = int(rng.integers(1, 7))
            ids = (rng.choice(4, size=n) if kind == "churn"
                   else rng.integers(0, ID_SPACE, size=n))
            vecs = rng.standard_normal((n, DIM)).astype(np.float32)
            recs.append((lsn, jd.OP_UPSERT, ids, vecs))
    return recs


def _replay(recs, capacity, tomb_capacity, metric=L2):
    jm = jd.Memtable(DIM, capacity=capacity, tomb_capacity=tomb_capacity,
                     metric=metric)
    tm = delta.Memtable(DIM, capacity=capacity, tomb_capacity=tomb_capacity,
                        metric=metric, device="cpu")
    for r in recs:
        if r == "reset":
            jm.reset()
            tm.reset()
            continue
        a = jm.apply(jd.Record(*r))
        b = tm.apply(delta.Record(*r))
        assert a == b
        assert jm.digest() == tm.digest()
    return jm, tm


STREAMS = dict(seed=st.integers(0, 2 ** 31 - 1), n_ops=st.integers(1, 40),
               capacity=st.integers(1, 6), tomb_capacity=st.integers(1, 6))


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(**STREAMS)
def test_random_streams_give_equal_digests_and_fold_payloads(
        seed, n_ops, capacity, tomb_capacity):
    jm, tm = _replay(_stream(seed, n_ops), capacity, tomb_capacity)
    assert jm.digest() == tm.digest()
    for a, b in zip(jm.fold_payload(), tm.fold_payload()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jm.fold_items(), tm.fold_items()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for attr in ("capacity", "tomb_capacity", "generation", "applied_lsn",
                 "live_rows", "n_tombstones", "select_min"):
        assert getattr(jm, attr) == getattr(tm, attr), attr


def test_regrowth_and_churn_match_the_reference_counts():
    """Same-id churn costs one slot and one tombstone; filling past the
    capacity doubles it, one generation each, in both packages."""
    recs = [(i + 1, jd.OP_UPSERT, np.array([7]),
             np.full((1, DIM), i, np.float32)) for i in range(5)]
    recs += [(10, jd.OP_UPSERT, np.arange(20, 29),
              np.ones((9, DIM), np.float32))]
    jm, tm = _replay(recs, 2, 2)
    assert (tm.live_rows, tm.n_tombstones) == (jm.live_rows,
                                              jm.n_tombstones) == (10, 10)
    assert tm.capacity == jm.capacity == 16
    assert tm.generation == jm.generation
    assert not tm.apply(delta.Record(3, delta.OP_DELETE, np.array([7])))


def test_bad_records_raise_alike():
    for m, kw in ((jd, {}), (delta, {"device": "cpu"})):
        mt = m.Memtable(DIM, **kw)
        with pytest.raises(Exception) as e1:
            mt.apply(m.Record(1, m.OP_UPSERT, np.array([-1]),
                              np.zeros((1, DIM), np.float32)))
        with pytest.raises(Exception) as e2:
            mt.apply(m.Record(1, m.OP_UPSERT, np.array([1, 2]),
                              np.zeros((1, DIM), np.float32)))
        with pytest.raises(ValueError):
            mt.apply(m.Record(1, 9, np.array([1])))
        assert "LogicError" in (type(e1.value).__name__,
                                type(e2.value).__name__)
        with pytest.raises(Exception):
            m.Memtable(DIM, metric=3, **kw)


# ---------------------------------------------------------------------------
# search and the merges
# ---------------------------------------------------------------------------

def _close(label, d, i, ref_d, ref_i, scale):
    """Distances within TOL * scale of the reference's, the same
    sentinels; a differing id only at a distance tie or the row's cut."""
    d, i = np.asarray(d, np.float64), np.asarray(i)
    ref_d, ref_i = np.asarray(ref_d, np.float64), np.asarray(ref_i)
    assert d.shape == ref_d.shape and i.shape == ref_i.shape, label
    fin = np.isfinite(ref_d)
    assert np.array_equal(np.isfinite(d), fin), label
    assert np.array_equal(d[~fin], ref_d[~fin]), label
    assert np.array_equal(i[~fin], ref_i[~fin]), label
    tol = TOL * scale[:, None] * np.ones_like(ref_d)
    err = np.abs(d[fin] - ref_d[fin])
    assert (err <= tol[fin]).all(), (label, err.max())
    for q, j in zip(*np.nonzero(i != ref_i)):
        near = np.abs(ref_d[q] - ref_d[q, j]) <= 2 * tol[q, j]
        cut = abs(ref_d[q, -1] - ref_d[q, j]) <= 2 * tol[q, j]
        assert i[q, j] in ref_i[q][near] or cut, (label, q, j)


def _scale(queries, rows, metric):
    q2 = (queries.astype(np.float64) ** 2).sum(1)
    x2 = float((rows.astype(np.float64) ** 2).sum(1).max()) if rows.size \
        else 0.0
    if metric == IP:
        return np.sqrt(q2 * x2) + 1.0
    return q2 + x2 + 1.0


def _views(jm, tm):
    jv, tv = jm.device_view(), tm.device_view()
    for a, b in zip(jv, tv):
        assert np.array_equal(np.asarray(a), b.numpy())
    return jv, tv


SEARCH = dict(seed=st.integers(0, 2 ** 31 - 1), n_ops=st.integers(1, 30),
              capacity=st.integers(1, 8), k=st.integers(1, 12),
              metric=st.sampled_from([L2, L2_SQRT, IP]))


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(**SEARCH)
def test_search_matches(seed, n_ops, capacity, k, metric):
    jm, tm = _replay(_stream(seed, n_ops), capacity, 4, metric=metric)
    _views(jm, tm)
    q = np.random.default_rng(seed + 1).standard_normal(
        (5, DIM)).astype(np.float32)
    ref = jm.search(q, k)
    ours = tm.search(torch.tensor(q), k)
    rows = jm._data
    scale = _scale(q, rows, metric)
    if metric == L2_SQRT:
        scale = np.sqrt(scale)
    _close("search", ours[0].numpy(), ours[1].numpy(), ref[0], ref[1],
           scale)


def _main_results(rng, nq, k, metric):
    d = np.sort(rng.random((nq, k)).astype(np.float32) * 8, 1)
    if metric == IP:
        d = -d
    i = rng.integers(0, ID_SPACE + 8, size=(nq, k)).astype(np.int32)
    i[:, -1] = -1
    d[:, -1] = np.inf if metric != IP else -np.inf
    return d, i


def _filter_words(rng, nq):
    mask = rng.random((nq, ID_SPACE + 16)) < 0.6
    return np.asarray(JaxFilter.from_mask(mask).words)


MERGE = dict(seed=st.integers(0, 2 ** 31 - 1), n_ops=st.integers(1, 30),
             capacity=st.integers(1, 8), k=st.integers(1, 10),
             metric=st.sampled_from([L2, L2_SQRT, IP]),
             filtered=st.booleans())


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(**MERGE)
def test_merge_with_main_matches(seed, n_ops, capacity, k, metric,
                                 filtered):
    jm, tm = _replay(_stream(seed, n_ops), capacity, 4, metric=metric)
    (jdata, jids, jtombs), (tdata, tids, ttombs) = _views(jm, tm)
    rng = np.random.default_rng(seed + 2)
    nq = 6
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    md, mi = _main_results(rng, nq, k, metric)
    fw = _filter_words(rng, nq) if filtered else None
    ref = jd.merge_with_main(jnp.asarray(md), jnp.asarray(mi),
                             jnp.asarray(q), jdata, jids, jtombs, k=k,
                             metric=metric,
                             filter_words=None if fw is None
                             else jnp.asarray(fw))
    ours = delta.merge_with_main(torch.tensor(md), torch.tensor(mi),
                                 torch.tensor(q), tdata, tids, ttombs, k=k,
                                 metric=metric,
                                 filter_words=None if fw is None
                                 else torch.tensor(fw))
    scale = _scale(q, jm._data, metric)
    if metric == L2_SQRT:
        scale = np.sqrt(scale)
    _close("merge", ours[0].numpy(), ours[1].numpy(), ref[0], ref[1],
           scale + 8.0)
    # an id tombstoned and not live in the memtable is gone from results
    live = tm.fold_payload()[0]
    dead = np.setdiff1d(ttombs.numpy()[ttombs.numpy() >= 0], live)
    assert not np.isin(ours[1].numpy(), dead).any()


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 31 - 1), n_shards=st.integers(1, 3),
       k=st.integers(1, 8), metric=st.sampled_from([L2, IP]),
       replicated=st.booleans())
def test_merge_with_main_multi_matches(seed, n_shards, k, metric,
                                       replicated):
    """Shard memtables (replicated placement: every shard the same
    stream, so each id surfaces from every delta) merged with the main
    results: the union of tombstones, one candidate an id."""
    pairs = []
    for s in range(n_shards):
        recs = _stream(seed if replicated else seed + 97 * s, 20)
        pairs.append(_replay(recs, 4, 4, metric=metric))
    views = [_views(jm, tm) for jm, tm in pairs]
    rng = np.random.default_rng(seed + 3)
    nq = 5
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    md, mi = _main_results(rng, nq, k, metric)
    ref = jd.merge_with_main_multi(
        jnp.asarray(md), jnp.asarray(mi), jnp.asarray(q),
        [(v[0][0], v[0][1]) for v in views], [v[0][2] for v in views],
        k=k, metric=metric)
    ours = delta.merge_with_main_multi(
        torch.tensor(md), torch.tensor(mi), torch.tensor(q),
        [(v[1][0], v[1][1]) for v in views], [v[1][2] for v in views],
        k=k, metric=metric)
    rows = np.concatenate([jm._data for jm, _ in pairs])
    _close("multi", ours[0].numpy(), ours[1].numpy(), ref[0], ref[1],
           _scale(q, rows, metric) + 8.0)
    for row in ours[1].numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == live.size


# ---------------------------------------------------------------------------
# finalize_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_finalize_topk_keeps_the_sentinel_contract(select_min, sqrt, k):
    """Distinct distances (no tie to order), tombstone encodings, padding
    past the candidates and worst-distance survivors: the port's epilogue
    equals the JAX one bit for bit."""
    rng = np.random.default_rng(k + 10 * sqrt + 100 * select_min)
    nq, c = 4, 8
    d = rng.permutation(nq * c).reshape(nq, c).astype(np.float32) / 7
    if not select_min:
        d = -d
    ids = rng.integers(-5, 50, size=(nq, c)).astype(np.int32)
    worst = np.inf if select_min else -np.inf
    d[0, :5] = worst
    d[1, 2] = worst
    ref = jgrouped.finalize_topk(jnp.asarray(d), jnp.asarray(ids), nq, k,
                                 select_min, sqrt, jax_select_k)
    ours = grouped.finalize_topk(torch.tensor(d), torch.tensor(ids), nq, k,
                                 select_min, sqrt, raw(select_k))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert (ours[1].numpy() >= -1).all()

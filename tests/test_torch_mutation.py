"""raft_tpu_torch online mutation against the JAX package, on the CPU.

``neighbors/mutate``'s helpers are held to ``raft_tpu.neighbors.mutate`` on
the same inputs.  An index ``raft_tpu`` builds is serialized and loaded by
the port; after the same ``delete``, ``upsert`` and ``compact`` on both,
the two give the same ``list_indices``, ``list_codes`` / ``list_data``,
``list_sizes``, capacity and generation (the loaded index takes the JAX
index's generation: the stream does not carry it), byte-equal
``serialize`` output, and the same search results (IVF-PQ at the
tolerance of its unfiltered comparison: ids on >= 0.99 of the slots,
distances within 1e-4; IVF-Flat ids equal, distances within 1e-5 of ‖q‖²
+ max ‖x‖²).

The reference's own mutation tests (``tests/test_mutation.py``) run again
inside the port: ``TestMutateHelpers``, ``TestFlatMutation``,
``TestPqMutationParity``, ``TestCagraShim``, ``TestCanaryExclusion`` and
``TestUpsert``.  Its ``verify`` and distributed classes wait for the
port's ``integrity.verify`` and distributed layer.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import ivf_flat as jf
from raft_tpu.neighbors import ivf_pq as jp
from raft_tpu.neighbors import mutate as jmutate
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq, mutate

CPU = DeviceResources(device="cpu", seed=42)
K = 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (a parallel run oversubscribes
    the cores otherwise); results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def naive_knn(db, q, k):
    d = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


def recall(found, truth):
    hits = sum(len(set(f) & set(t)) for f, t in zip(found, truth))
    return hits / truth.size


@pytest.fixture(scope="module")
def dataset():
    X, _ = make_blobs(1000, 16, n_clusters=16, cluster_std=1.0, seed=11)
    return np.asarray(X[:950]), np.asarray(X[950:966])


@pytest.fixture(scope="module")
def pq_dataset():
    X, _ = make_blobs(1200, 32, n_clusters=16, cluster_std=1.0, seed=12)
    return np.asarray(X[:1100]), np.asarray(X[1100:1132])


def _load(jmod, tmod, index):
    """The port's copy of a ``raft_tpu`` index through the byte stream,
    with the JAX index's generation (which the stream does not carry)."""
    buf = io.BytesIO()
    jmod.serialize(None, buf, index)
    buf.seek(0)
    out = tmod.deserialize(CPU, buf)
    out.generation = jmutate.generation(index)
    return out


def _bytes(mod, res, index):
    buf = io.BytesIO()
    mod.serialize(res, buf, index)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the helpers


class TestMutateHelpers:
    def test_encode_decode_roundtrip(self):
        ids = torch.tensor([0, 1, 7, 1 << 20], dtype=torch.int32)
        enc = mutate.encode_tombstones(ids)
        assert bool((enc <= -2).all())
        np.testing.assert_array_equal(
            np.sort(mutate.decode_tombstones(enc)), np.sort(ids.numpy()))

    def test_tombstone_hits_only_live_slots(self):
        li = [[0, 3, -1], [5, -(3 + 2), -1]]
        out, hit = mutate.tombstone(torch.tensor(li, dtype=torch.int32),
                                    [3, 99])
        ref, ref_hit = jmutate.tombstone(jnp.asarray(li, jnp.int32), [3, 99])
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
        assert int(hit.sum()) == 1

    @pytest.mark.parametrize("li", [[[0, -(3 + 2), -(5 + 2)], [3, 1, -1]],
                                    [[-1, -1], [-1, -1]],
                                    [[4, -(4 + 2)], [-(9 + 2), 2]]])
    def test_deleted_ids_and_counts_match_the_reference(self, li):
        class Ours:
            list_indices = torch.tensor(li, dtype=torch.int32)

        class Ref:
            list_indices = jnp.asarray(li, jnp.int32)

        assert mutate.deleted_ids(Ours()) == jmutate.deleted_ids(Ref())
        assert mutate.live_count(Ours()) == jmutate.live_count(Ref())
        assert mutate.dead_fraction(Ours()) == jmutate.dead_fraction(Ref())
        np.testing.assert_array_equal(
            mutate.live_sizes(Ours.list_indices).numpy(),
            np.asarray(jmutate.live_sizes(Ref.list_indices)))

    def test_deleted_ids_prefers_explicit_attr(self):
        class Stub:
            deleted_ids = {4, 9}

        assert mutate.deleted_ids(Stub()) == frozenset({4, 9})

    def test_compaction_order_stable(self):
        li = [[7, -(1 + 2), 9, -1], [-1, 2, -(5 + 2), 3]]
        order, live = mutate.compaction_order(
            torch.tensor(li, dtype=torch.int32))
        ref_order, ref_live = jmutate.compaction_order(
            jnp.asarray(li, jnp.int32))
        np.testing.assert_array_equal(order.numpy(), np.asarray(ref_order))
        np.testing.assert_array_equal(live.numpy(), np.asarray(ref_live))

    def test_generation_helpers(self):
        class A:
            generation = 3

        class B:
            pass

        assert mutate.generation(B()) == 0
        assert mutate.next_generation(A(), B()).generation == 4


# ---------------------------------------------------------------------------
# the port against raft_tpu after the same mutations


@pytest.fixture(scope="module")
def pq_pair(pq_dataset):
    db, _ = pq_dataset
    index = jp.build(JaxResources(seed=42), jp.IndexParams(
        n_lists=16, pq_dim=8, kmeans_n_iters=5), jnp.asarray(db))
    return index, _load(jp, ivf_pq, index)


@pytest.fixture(scope="module")
def flat_pair(dataset):
    db, _ = dataset
    index = jf.build(JaxResources(seed=42), jf.IndexParams(
        n_lists=8, kmeans_n_iters=5), jnp.asarray(db))
    return index, _load(jf, ivf_flat, index)


def _same_arrays(ref, ours, names):
    for name in names:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert ours.capacity == ref.capacity
    assert mutate.generation(ours) == jmutate.generation(ref)


def _mutations(n, dim, seed):
    """A delete, an upsert (half re-inserted, half fresh ids) and a
    compaction, drawn from a seed."""
    rng = np.random.default_rng(seed)
    doomed = np.sort(rng.choice(n, 200, replace=False)).astype(np.int32)
    ids = np.concatenate([doomed[:20], np.arange(n, n + 10)]).astype(
        np.int32)
    vecs = rng.normal(size=(ids.size, dim)).astype(np.float32)
    return doomed, ids, vecs


PQ_ARRAYS = ("list_indices", "list_codes", "list_sizes")
FLAT_ARRAYS = ("list_indices", "list_data", "list_sizes")


@pytest.mark.parametrize("kind", ["ivf_pq", "ivf_flat"])
def test_mutations_match_raft_tpu(pq_dataset, dataset, pq_pair, flat_pair,
                                  kind):
    """delete -> upsert -> compact on both packages: the same arrays,
    capacity, generation and bytes after each step, and the same search
    results at the end."""
    if kind == "ivf_pq":
        (db, q), (ref, ours) = pq_dataset, pq_pair
        jmod, tmod, names = jp, ivf_pq, PQ_ARRAYS
        sp = dict(n_probes=8, exact_coarse=True)
    else:
        (db, q), (ref, ours) = dataset, flat_pair
        jmod, tmod, names = jf, ivf_flat, FLAT_ARRAYS
        sp = dict(n_probes=4, exact_coarse=True)
    jres = JaxResources(seed=0)
    doomed, ids, vecs = _mutations(db.shape[0], db.shape[1], 7)
    steps = (
        (lambda m, r, x: m.delete(r, x, doomed)),
        (lambda m, r, x: m.upsert(r, x, ids, vecs)),
        (lambda m, r, x: m.compact(r, x)))
    for step in steps:
        ref = step(jmod, jres, ref)
        ours = step(tmod, CPU, ours)
        _same_arrays(ref, ours, names)
        assert _bytes(tmod, CPU, ours) == _bytes(jmod, None, ref)
    rd, ri = jmod.search(jres, jmod.SearchParams(**sp), ref, jnp.asarray(q),
                         K)
    pd, pi = tmod.search(CPU, tmod.SearchParams(**sp), ours, q, K)
    rd, ri = np.asarray(rd), np.asarray(ri)
    if kind == "ivf_pq":
        assert np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(pi.numpy(), ri)]) >= 0.99
        np.testing.assert_allclose(pd.numpy(), rd, rtol=1e-4, atol=1e-4)
    else:
        scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
        np.testing.assert_array_equal(pi.numpy(), ri)
        np.testing.assert_allclose(pd.numpy(), rd, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_compact_rebuilds_every_cache_the_parent_carried(pq_dataset,
                                                         pq_pair):
    db, q = pq_dataset
    port = pq_pair[1]
    for mode in ("codes", "recon8"):     # attach the lazy caches
        ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=4, scan_mode=mode),
                      port, q, K)
    gone = ivf_pq.delete(CPU, port, np.arange(0, 400, 2))
    assert gone.list_recon_i8 is port.list_recon_i8    # shared, untouched
    out = ivf_pq.compact(CPU, gone)
    assert set(ivf_pq.compact.cache_seconds) == {"recon", "code_rsq",
                                                 "recon8"}
    fresh = ivf_pq.index_from_numpy(
        {n: getattr(out, n).numpy() for n in ("centers", "codebooks",
                                              "list_codes", "list_indices",
                                              "list_sizes", "rotation")},
        metric=out.metric, pq_bits=out.pq_bits, device="cpu")
    ivf_pq._with_recon(fresh)
    ivf_pq._with_code_rsq(fresh)
    ivf_pq._with_recon8(fresh)
    for name in ("list_recon", "list_recon_sq", "list_code_rsq",
                 "list_recon_i8", "list_recon_scale", "list_recon_i8_sq"):
        assert torch.equal(getattr(out, name), getattr(fresh, name)), name


# ---------------------------------------------------------------------------
# the reference's mutation tests, inside the port


@pytest.fixture(scope="module")
def flat_built(flat_pair):
    return flat_pair[1]


class TestFlatMutation:
    SP = ivf_flat.SearchParams(n_probes=8)

    def test_delete_excludes_ids(self, dataset, flat_built):
        db, q = dataset
        _, ti = naive_knn(db, q, 10)
        doomed = set(ti[:, 0].tolist())
        idx2 = ivf_flat.delete(CPU, flat_built, sorted(doomed))
        _, i2 = ivf_flat.search(CPU, self.SP, idx2, q, 10)
        assert not (set(i2.reshape(-1).tolist()) & doomed)
        keep = np.asarray([r for r in range(db.shape[0])
                           if r not in doomed])
        _, ti2 = naive_knn(db[keep], q, 10)
        assert recall(i2.numpy(), keep[ti2]) > 0.85

    def test_delete_is_a_new_generation(self, flat_built):
        idx2 = ivf_flat.delete(CPU, flat_built, [0])
        assert mutate.generation(idx2) == mutate.generation(flat_built) + 1
        assert 0 in flat_built.list_indices.numpy()
        li = idx2.list_indices.numpy()
        assert 0 not in li[li >= 0]

    def test_delete_nonexistent_is_noop(self, flat_built):
        idx2 = ivf_flat.delete(CPU, flat_built, [10 ** 7])
        assert torch.equal(idx2.list_indices, flat_built.list_indices)

    def test_compact_reclaims_and_preserves_results(self, dataset,
                                                    flat_built):
        _, q = dataset
        idx2 = ivf_flat.delete(CPU, flat_built, list(range(0, 200)))
        assert mutate.dead_fraction(idx2) > 0.0
        idx3 = ivf_flat.compact(CPU, idx2)
        assert mutate.dead_fraction(idx3) == 0.0
        assert mutate.live_count(idx3) == mutate.live_count(idx2)
        assert mutate.generation(idx3) == mutate.generation(idx2) + 1
        d2, i2 = ivf_flat.search(CPU, self.SP, idx2, q, 10)
        d3, i3 = ivf_flat.search(CPU, self.SP, idx3, q, 10)
        assert torch.equal(i2, i3)
        torch.testing.assert_close(d2, d3, rtol=1e-5, atol=1e-4)

    def test_reinsert_after_delete(self, dataset, flat_built):
        db, q = dataset
        _, ti = naive_knn(db, q, 1)
        rid = int(ti[0, 0])
        idx2 = ivf_flat.delete(CPU, flat_built, [rid])
        idx3 = ivf_flat.extend(CPU, idx2, db[rid:rid + 1],
                               np.asarray([rid], np.int32))
        _, i3 = ivf_flat.search(CPU, self.SP, idx3, q[:1], 5)
        assert rid in i3[0].tolist()
        assert rid not in mutate.deleted_ids(idx3)

    def test_delete_everything_searches_empty(self, dataset, flat_built):
        db, q = dataset
        idx2 = ivf_flat.delete(CPU, flat_built, list(range(db.shape[0])))
        assert mutate.live_count(idx2) == 0
        d, i = ivf_flat.search(CPU, self.SP, idx2, q, 5)
        assert (i == -1).all() and torch.isinf(d).all()


class TestPqMutationParity:
    MODES = ("recon", "codes", "recon8", "fused", "auto")

    def _search_all_modes(self, index, q, k, kt=0):
        return {mode: ivf_pq.search(CPU, ivf_pq.SearchParams(
            n_probes=16, scan_mode=mode, per_probe_topk=kt), index, q,
            k)[1].numpy() for mode in self.MODES}

    def test_interleaved_mutations_agree_across_modes(self, pq_dataset,
                                                      pq_pair):
        db, q = pq_dataset
        rng = np.random.default_rng(20260805)
        index, n = pq_pair[1], db.shape[0]
        deleted = set()
        for rnd in range(3):
            doom = rng.choice([r for r in range(n) if r not in deleted],
                              size=40, replace=False)
            index = ivf_pq.delete(CPU, index, np.sort(doom))
            deleted.update(int(v) for v in doom)
            extra = rng.normal(size=(16, db.shape[1])).astype(np.float32)
            index = ivf_pq.extend(CPU, index, extra,
                                  np.arange(n, n + 16, dtype=np.int32))
            n += 16
            for kt in (0, 4):
                by_mode = self._search_all_modes(index, q, 10, kt=kt)
                for mode, ids in by_mode.items():
                    hit = set(ids.reshape(-1).tolist()) & deleted
                    assert not hit, (rnd, kt, mode, hit)
                if kt:
                    continue
                for mode in ("codes", "recon8", "fused"):
                    ov = np.mean([len(set(a) & set(b)) / 10 for a, b in
                                  zip(by_mode[mode], by_mode["recon"])])
                    assert ov > 0.9, (rnd, mode, ov)
        assert mutate.generation(index) == \
            mutate.generation(pq_pair[1]) + 6

    def test_deleted_never_in_topk_property(self, pq_dataset, pq_pair):
        db, q = pq_dataset
        _, ti = naive_knn(db, q, 5)
        doomed = sorted(set(ti.reshape(-1).tolist()))
        index = ivf_pq.delete(CPU, pq_pair[1], doomed)
        for mode, ids in self._search_all_modes(index, q, 10).items():
            assert not (set(ids.reshape(-1).tolist()) & set(doomed)), mode

    def test_compact_preserves_mode_results(self, pq_dataset, pq_pair):
        _, q = pq_dataset
        index = ivf_pq.delete(CPU, pq_pair[1], list(range(0, 300)))
        compacted = ivf_pq.compact(CPU, index)
        assert mutate.dead_fraction(compacted) == 0.0
        before = self._search_all_modes(index, q, 10)
        after = self._search_all_modes(compacted, q, 10)
        for mode in self.MODES:
            np.testing.assert_array_equal(before[mode], after[mode],
                                          err_msg=mode)

    def test_all_deleted_returns_sentinels_every_mode(self, pq_dataset,
                                                      pq_pair):
        db, q = pq_dataset
        index = ivf_pq.delete(CPU, pq_pair[1], list(range(db.shape[0])))
        for mode, ids in self._search_all_modes(index, q, 5).items():
            np.testing.assert_array_equal(
                ids, np.full((q.shape[0], 5), -1), err_msg=mode)

    def test_k_past_the_live_rows_never_surfaces_a_tombstone(self,
                                                             pq_dataset,
                                                             pq_pair):
        db, q = pq_dataset
        keep = 3
        index = ivf_pq.delete(CPU, pq_pair[1], list(range(keep,
                                                          db.shape[0])))
        for mode in self.MODES:
            d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(
                n_probes=16, scan_mode=mode), index, q, 8)
            assert (i >= -1).all(), mode
            assert ((i >= 0).sum(1) <= keep).all(), mode
            assert torch.equal(i == -1, torch.isinf(d)), mode


@pytest.fixture(scope="module")
def graph_index(dataset):
    db, _ = dataset
    _, nbrs = naive_knn(db, db, 17)
    return cagra.index_from_numpy(db, nbrs[:, 1:].astype(np.int32),
                                  device="cpu"), db


class TestCagraShim:
    SP = cagra.SearchParams(itopk_size=32)

    def test_delete_masks_results(self, dataset, graph_index):
        index, db = graph_index
        _, q = dataset
        _, ti = naive_knn(db, q, 1)
        doomed = sorted(set(ti[:, 0].tolist()))
        idx2 = cagra.delete(CPU, index, doomed)
        assert mutate.deleted_ids(idx2) == frozenset(doomed)
        assert mutate.generation(idx2) == mutate.generation(index) + 1
        _, i2 = cagra.search(CPU, self.SP, idx2, q, 10)
        assert not (set(i2.reshape(-1).tolist()) & set(doomed))
        _, i1 = cagra.search(CPU, self.SP, index, q, 1)
        assert set(i1.reshape(-1).tolist()) & set(doomed)

    def test_delete_accumulates_and_shares_the_walk_caches(self,
                                                           graph_index):
        index, _ = graph_index
        idx2 = cagra.delete(CPU, index, [1, 2])
        idx3 = cagra.delete(CPU, idx2, [3])
        assert mutate.deleted_ids(idx3) == frozenset({1, 2, 3})
        if hasattr(index, "_walk_tables"):
            assert idx3._walk_tables is index._walk_tables

    def test_results_stay_sorted_after_mask(self, dataset, graph_index):
        index, _ = graph_index
        _, q = dataset
        idx2 = cagra.delete(CPU, index, list(range(0, 100)))
        d2, i2 = cagra.search(CPU, self.SP, idx2, q, 10)
        d2 = d2.numpy()
        capped = np.where(np.isfinite(d2), d2, np.finfo(np.float32).max)
        assert np.all(np.diff(capped, axis=1) >= -1e-6)
        assert not (set(i2.reshape(-1).tolist()) & set(range(100)))

    def test_the_deleted_set_is_not_serialized(self, graph_index):
        index, _ = graph_index
        idx2 = cagra.delete(CPU, index, [5, 6])
        assert _bytes(cagra, CPU, idx2) == _bytes(cagra, CPU, index)
        back = cagra.deserialize(CPU, io.BytesIO(_bytes(cagra, CPU, idx2)))
        assert mutate.deleted_ids(back) == frozenset()


class TestCanaryExclusion:
    @pytest.fixture(scope="class")
    def canaried(self, dataset):
        db, _ = dataset
        index = jf.build(JaxResources(seed=3), jf.IndexParams(
            n_lists=8, kmeans_n_iters=5, canary_queries=16, canary_k=5,
            canary_floor=0.3), jnp.asarray(db))
        return _load(jf, ivf_flat, index)

    def _gt_ids(self, canaried):
        return sorted(set(int(v) for v in np.asarray(
            canaried.canaries.gt_ids).reshape(-1) if int(v) >= 0))

    def test_health_check_survives_deleting_ground_truth(self, canaried):
        gt_ids = self._gt_ids(canaried)
        idx2 = ivf_flat.delete(CPU, canaried, gt_ids[:len(gt_ids) // 2])
        assert _canary.health_check(CPU, idx2, raise_on_fail=True).ok
        assert ivf_flat.compact(CPU, idx2).canaries is canaried.canaries

    def test_measure_all_ground_truth_deleted(self, canaried):
        idx2 = ivf_flat.delete(CPU, canaried, self._gt_ids(canaried))
        assert _canary.measure(CPU, idx2, idx2.canaries) == 1.0


class TestUpsert:
    def test_flat_upsert_replaces_under_same_id(self, dataset, flat_built):
        db, _ = dataset
        rng = np.random.default_rng(81)
        ids = np.asarray([3, 40, 77], np.int32)
        vecs = rng.normal(size=(3, db.shape[1])).astype(np.float32) * 0.01
        out = ivf_flat.upsert(CPU, flat_built, ids, vecs)
        sp = ivf_flat.SearchParams(n_probes=8)
        _, i = ivf_flat.search(CPU, sp, out, vecs, 1)
        np.testing.assert_array_equal(np.sort(i.numpy().ravel()), ids)
        d2, i2 = ivf_flat.search(CPU, sp, out, db[ids], 1)
        old_self = d2.numpy()[i2.numpy().ravel() == ids]
        assert not np.any(np.isclose(old_self, 0.0))

    def test_flat_one_generation_bump(self, dataset, flat_built):
        db, _ = dataset
        out = ivf_flat.upsert(CPU, flat_built, np.asarray([5], np.int32),
                              db[5:6] + 0.5)
        assert mutate.generation(out) == mutate.generation(flat_built) + 1

    def test_pq_upsert_replaces_under_same_id(self, pq_dataset, pq_pair):
        db, _ = pq_dataset
        rng = np.random.default_rng(82)
        ids = np.asarray([10, 200, 999], np.int32)
        vecs = rng.normal(size=(3, db.shape[1])).astype(np.float32)
        out = ivf_pq.upsert(CPU, pq_pair[1], ids, vecs)
        assert mutate.generation(out) == mutate.generation(pq_pair[1]) + 1
        _, i = ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=16), out,
                             vecs, 1)
        np.testing.assert_array_equal(np.sort(i.numpy().ravel()), ids)
        li = out.list_indices.numpy()
        for v in ids:
            assert int((li == v).sum()) == 1

    def test_pq_upsert_inserts_fresh_ids(self, pq_dataset, pq_pair):
        db, _ = pq_dataset
        fresh = np.asarray([db.shape[0] + 7], np.int32)
        out = ivf_pq.upsert(CPU, pq_pair[1], fresh, db[:1] * 1.001)
        assert int((out.list_indices.numpy() == fresh[0]).sum()) == 1

    def test_pq_churn_loop(self, pq_dataset, pq_pair):
        """A rotating window of ids rewritten four times: one generation
        a batch, every id live exactly once, and recall against the
        evolving ground truth within 0.08 of the pre-churn recall."""
        db, q = pq_dataset
        rng = np.random.default_rng(83)
        cur = np.array(db, copy=True)
        index = pq_pair[1]
        n = db.shape[0]
        sp = ivf_pq.SearchParams(n_probes=16)
        _, f0 = ivf_pq.search(CPU, sp, index, q, 10)
        base_recall = recall(f0.numpy(), naive_knn(db, q, 10)[1])
        for _ in range(4):
            ids = rng.choice(n, size=64, replace=False).astype(np.int32)
            src = rng.choice(n, size=64).astype(np.int32)
            vecs = (db[src] + 0.05 * rng.normal(
                size=(64, db.shape[1]))).astype(np.float32)
            g = mutate.generation(index)
            index = ivf_pq.upsert(CPU, index, ids, vecs)
            assert mutate.generation(index) == g + 1
            cur[ids] = vecs
        li = index.list_indices.numpy()
        live = li[li >= 0]
        assert live.size == n and np.unique(live).size == n
        _, found = ivf_pq.search(CPU, sp, index, q, 10)
        assert recall(found.numpy(), naive_knn(cur, q, 10)[1]) > \
            base_recall - 0.08

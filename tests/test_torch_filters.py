"""raft_tpu_torch filtered search against the JAX package, on the CPU.

The bitset layer (``raft_tpu_torch.filters``) is held to ``raft_tpu.filters``
bit for bit: packing, every constructor, the broadcast of one row (an
``expand``, query stride 0), the coverage rule (an id past the words is
not admitted), intersect, the per-group words, the tenant and hybrid
helpers, and the ``expects`` messages.

Search: an index ``raft_tpu`` builds on the CPU is serialized and loaded by
the port (the two streams are byte-compatible), then one mask goes through
both packages' filtered searches — IVF-PQ in each of the five scan modes,
IVF-Flat at L2 and at InnerProduct, ``brute_force.knn`` and CAGRA's walk —
at k 10 and, through the query-major kernels' plain versions, at k 100
(IVF-PQ ``recon`` at kt 65, ``auto`` at kt 80, ``recon8`` / ``codes`` /
``fused`` at kt 100; IVF-Flat at kt 100), with a 50% and a 5% mask (the
5% mask leaves exhausted slots).
Every returned id is admitted; ids and distances agree at the tolerances
the unfiltered comparisons of the same paths state (IVF-PQ recon / auto:
ids on >= 0.99 of the slots, distances within 1e-4; fused / codes /
recon8, which the JAX package runs through its LUT and XLA twins off the
TPU: ids on >= 0.95; IVF-Flat and brute force: distances within 1e-5 of
‖q‖² + max ‖x‖², ids equal strictly inside each row's k-th distance;
CAGRA, the JAX walk cache attached: ids on >= 0.99 of the slots,
distances within 1e-5).

Inside the port, the reference's own contracts (``tests/test_filters.py``
``TestFilteredParity``): at full probe a filtered search equals the
unfiltered result at a large k filtered afterwards, bit for bit, in every
mode and at selectivities 0.001, 0.5 and 1.0; an all-rejecting filter
gives ``(+inf, -1)`` everywhere; a one-row broadcast equals the
materialized mask; a filter composes with tombstones.  The full-probe
contract holds at k 100 too, where every mode runs a query-major kernel.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import DeviceResources as JaxResources
from raft_tpu.core.error import LogicError as JaxLogicError
from raft_tpu.filters import bitset as jb
from raft_tpu.filters import hybrid as jhybrid
from raft_tpu.filters import tenant as jtenant
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import ivf_flat as jf
from raft_tpu.neighbors import ivf_pq as jp
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.filters import (SampleFilter, TenantFilter, bitset,
                                    candidates_to_filter, hybrid)
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

CPU = DeviceResources(device="cpu")
N, DIM, NQ, K = 2000, 32, 8, 10
MODES = ("auto", "fused", "codes", "recon8", "recon")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (a parallel run oversubscribes
    the cores otherwise); results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    db = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((NQ, DIM)).astype(np.float32)
    mask = rng.random((NQ, N)) < 0.5
    return db, q, mask


def _load(jmod, tmod, index):
    """The port's copy of a ``raft_tpu`` index, through the byte stream."""
    buf = io.BytesIO()
    jmod.serialize(None, buf, index)
    buf.seek(0)
    return tmod.deserialize(CPU, buf)


@pytest.fixture(scope="module")
def pq(dataset):
    db, _, _ = dataset
    index = jp.build(JaxResources(seed=42), jp.IndexParams(
        n_lists=16, pq_dim=8, kmeans_n_iters=4), jnp.asarray(db))
    return index, _load(jp, ivf_pq, index)


@pytest.fixture(scope="module")
def flat(dataset):
    db, _, _ = dataset
    out = {}
    for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
        index = jf.build(JaxResources(seed=42), jf.IndexParams(
            n_lists=16, kmeans_n_iters=4, metric=int(metric)),
            jnp.asarray(db))
        out[metric] = (index, _load(jf, ivf_flat, index))
    return out


def _admitted(ids, mask):
    ids = np.asarray(ids)
    return all(mask[i, j] for i in range(ids.shape[0]) for j in ids[i]
               if j >= 0)


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)])


def _live_overlap(a, b):
    """The share of the reference's returned ids (>= 0) that the port
    returns too, per row (exhausted slots are compared apart)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.mean([len(set(x[x >= 0]) & set(y[y >= 0]))
                    / max(1, int((y >= 0).sum()))
                    for x, y in zip(a, b)])


def _exhausted_rule(d, i):
    """Exhausted slots are (±inf, -1), never a tombstone code."""
    d, i = np.asarray(d), np.asarray(i)
    assert (i >= -1).all()
    np.testing.assert_array_equal(i == -1, ~np.isfinite(d))


# ---------------------------------------------------------------------------
# the bitset layer, bit for bit


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000])
def test_pack_and_unpack_are_bit_equal(n):
    rng = np.random.default_rng(n)
    mask = rng.random((3, n)) < 0.4
    ours = bitset.pack_mask(torch.from_numpy(mask))
    ref = np.asarray(jb.pack_mask(jnp.asarray(mask)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(
        bitset.unpack_words(ours, n).numpy(),
        np.asarray(jb.unpack_words(jnp.asarray(ref), n)))
    assert bitset.n_words_for(n) == jb.n_words_for(n)


@pytest.mark.parametrize("nq", [1, 4])
def test_constructors_are_bit_equal_and_broadcast_without_copies(nq):
    ids = [0, 5, 31, 32, 63, 64, 99, -3, 500]
    pairs = [(SampleFilter.from_ids(ids, 100, nq),
              jb.SampleFilter.from_ids(ids, 100, nq)),
             (SampleFilter.all_rows(100, nq),
              jb.SampleFilter.all_rows(100, nq))]
    for ours, ref in pairs:
        np.testing.assert_array_equal(ours.words.numpy(),
                                      np.asarray(ref.words))
        assert ours.n_rows == ref.n_rows and ours.nq == ref.nq
        np.testing.assert_array_equal(ours.admitted_counts(),
                                      ref.admitted_counts())
        if nq > 1:
            assert ours.words.stride(0) == 0
    w = np.asarray(pairs[0][1].words)
    np.testing.assert_array_equal(
        SampleFilter.from_words(w, 100).words.numpy(),
        np.asarray(jb.SampleFilter.from_words(w, 100).words))


def test_intersect_is_bit_equal_and_keeps_a_broadcast_row():
    rng = np.random.default_rng(1)
    mask = rng.random((4, 70)) < 0.5
    a, ja = (SampleFilter.from_mask(mask),
             jb.SampleFilter.from_mask(jnp.asarray(mask)))
    b, jbb = (SampleFilter.from_ids(range(0, 70, 3), 70, 4),
              jb.SampleFilter.from_ids(range(0, 70, 3), 70, 4))
    np.testing.assert_array_equal(a.intersect(b).words.numpy(),
                                  np.asarray(ja.intersect(jbb).words))
    both = b.intersect(SampleFilter.all_rows(70, 4))
    assert both.words.stride(0) == 0
    np.testing.assert_array_equal(both.words.numpy(), b.words.numpy())


def test_query_bits_and_the_coverage_rule():
    rng = np.random.default_rng(2)
    words = rng.integers(-2**31, 2**31, size=(3, 4), dtype=np.int64).astype(
        np.int32)
    ids = rng.integers(-5, 160, size=(3, 50)).astype(np.int32)
    qids = np.arange(3)
    ours = bitset.query_bits(torch.from_numpy(words), torch.from_numpy(qids),
                             torch.from_numpy(ids))
    ref = jb.query_bits(jnp.asarray(words), jnp.asarray(qids),
                        jnp.asarray(ids))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # ids 128.. lie past 4 words: never admitted, even where bits are set
    assert (ours.numpy()[ids >= 128] == 0).all()
    assert (ours.numpy()[ids < 0] == 0).all()


def test_group_admission_words_are_bit_equal():
    rng = np.random.default_rng(3)
    n_lists, cap, nq, n_probes = 4, 40, 3, 2
    li = rng.permutation(n_lists * cap).reshape(n_lists, cap).astype(
        np.int32)
    li[:, 35:] = -1
    li[0, 3] = -(7 + 2)
    words = np.asarray(jb.pack_mask(jnp.asarray(
        rng.random((nq, n_lists * cap)) < 0.5)))
    group_list = np.array([0, 2, 3], np.int32)
    P = nq * n_probes
    slot_pairs = rng.integers(0, P + 1, size=(3, 128)).astype(np.int32)
    ours = bitset.group_admission_words(
        torch.from_numpy(words), torch.from_numpy(group_list),
        torch.from_numpy(slot_pairs), torch.from_numpy(li), n_probes, P)
    ref = jb.group_admission_words(
        jnp.asarray(words), jnp.asarray(group_list), jnp.asarray(slot_pairs),
        jnp.asarray(li), n_probes, P)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _messages(ours, ref):
    """The two calls' LogicError messages."""
    out = []
    for fn, exc in ((ours, LogicError), (ref, JaxLogicError)):
        with pytest.raises(exc) as err:
            fn()
        out.append(str(err.value))
    return out


@pytest.mark.parametrize("case", ["nq mismatch", "not a bool mask",
                                  "narrow words", "mask rank",
                                  "intersect bounds", "as_filter width",
                                  "as_filter narrow"])
def test_expects_messages_are_the_reference_s(case):
    m3 = np.zeros((3, 40), bool)
    calls = {
        "nq mismatch": lambda mod, a: mod.query_filter_words(
            mod.SampleFilter.from_mask(a(m3)), 5, "x.search"),
        "not a bool mask": lambda mod, a: mod.query_filter_words(
            a(m3.astype(np.int32)), 3, "x.search"),
        "narrow words": lambda mod, a: mod.SampleFilter.from_words(
            a(np.zeros((3, 1), np.int32)), 40),
        "mask rank": lambda mod, a: mod.SampleFilter.from_mask(
            a(np.zeros(40, bool))),
        "intersect bounds": lambda mod, a: mod.SampleFilter.all_rows(
            40).intersect(mod.SampleFilter.all_rows(41)),
        "as_filter width": lambda mod, a: mod.as_filter(a(m3), 41),
        "as_filter narrow": lambda mod, a: mod.as_filter(
            mod.SampleFilter.all_rows(32), 40),
    }
    ours, ref = _messages(lambda: calls[case](bitset, torch.as_tensor),
                          lambda: calls[case](jb, jnp.asarray))
    assert ours == ref


def test_query_filter_words_broadcasts_one_row_and_packs_masks():
    rng = np.random.default_rng(4)
    mask = rng.random((1, 90)) < 0.5
    one = bitset.query_filter_words(SampleFilter.from_mask(mask), 6, "s")
    assert one.shape == (6, 3) and one.stride(0) == 0
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jb.query_filter_words(
            jb.SampleFilter.from_mask(jnp.asarray(mask)), 6, "s")))
    full = rng.random((6, 90)) < 0.5
    np.testing.assert_array_equal(
        bitset.query_filter_words(torch.from_numpy(full), 6, "s").numpy(),
        np.asarray(jb.query_filter_words(jnp.asarray(full), 6, "s")))
    assert bitset.query_filter_words(None, 6, "s") is None
    words = bitset.pack_mask(torch.from_numpy(full))
    np.testing.assert_array_equal(
        bitset.as_filter(words, 90).words.numpy(),
        np.asarray(jb.as_filter(jnp.asarray(words.numpy()), 90).words))


def test_tenant_filter_matches_the_reference():
    ranges = {"a": (0, 40), "b": (40, 70), "c": (75, 100)}
    ours, ref = TenantFilter(ranges, 90), jtenant.TenantFilter(ranges, 90)
    assert ours.tenants == ref.tenants
    for t in ranges:
        np.testing.assert_array_equal(ours.words_for(t), ref.words_for(t))
        f = ours.filter_for(t, 5)
        assert f.words.stride(0) == 0
        np.testing.assert_array_equal(f.words.numpy(),
                                      np.asarray(ref.filter_for(t, 5).words))
    assert [ours.owner_of(i) for i in (0, 45, 72, 99)] == \
        [ref.owner_of(i) for i in (0, 45, 72, 99)]
    ours_msg, ref_msg = _messages(
        lambda: TenantFilter({"a": (0, 5), "b": (3, 9)}, 9),
        lambda: jtenant.TenantFilter({"a": (0, 5), "b": (3, 9)}, 9))
    assert ours_msg == ref_msg
    ours_msg, ref_msg = _messages(lambda: ours.range_of("z"),
                                  lambda: ref.range_of("z"))
    assert ours_msg == ref_msg


def test_hybrid_candidates_and_the_search_stand_in():
    ids = np.array([[3, -1, 70, 5], [0, 1, 2, 200]])
    np.testing.assert_array_equal(
        candidates_to_filter(ids, 100).words.numpy(),
        np.asarray(jhybrid.candidates_to_filter(ids, 100).words))
    with pytest.raises(NotImplementedError, match="the tail"):
        hybrid.search(CPU, None, None, None, 5)


# ---------------------------------------------------------------------------
# search against the JAX package on one loaded index


@pytest.mark.parametrize("mode", MODES)
def test_ivf_pq_filtered_search_matches_raft_tpu(dataset, pq, mode):
    _, q, mask = dataset
    jidx, port = pq
    sp = dict(n_probes=8, exact_coarse=True, scan_mode=mode)
    rd, ri = jp.search(JaxResources(seed=0), jp.SearchParams(**sp), jidx,
                       jnp.asarray(q), K,
                       filter=jb.SampleFilter.from_mask(jnp.asarray(mask)))
    pd, pi = ivf_pq.search(CPU, ivf_pq.SearchParams(**sp), port, q, K,
                           filter=SampleFilter.from_mask(mask))
    pd, pi, rd, ri = pd.numpy(), pi.numpy(), np.asarray(rd), np.asarray(ri)
    assert _admitted(pi, mask)
    _exhausted_rule(pd, pi)
    if mode in ("auto", "recon"):
        assert _overlap(pi, ri) >= 0.99
        np.testing.assert_allclose(pd, rd, rtol=1e-4, atol=1e-4)
    else:
        assert _overlap(pi, ri) >= 0.95


def _flat_same(pd, pi, rd, ri, scale):
    atol = 1e-5 * scale
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=atol)
    for prow, pids, rrow, rids in zip(pd, pi, rd, ri):
        fin = rrow[np.isfinite(rrow)]
        if fin.size == 0:
            continue
        edge = fin[-1]
        inner = np.abs(rrow - edge) > atol
        if rrow[0] > rrow[-1]:          # InnerProduct: descending
            assert set(pids[rrow > edge + atol]) == \
                set(rids[rrow > edge + atol])
        else:
            assert set(pids[(rrow < edge) & inner]) == \
                set(rids[(rrow < edge) & inner])


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=["L2", "IP"])
def test_ivf_flat_filtered_search_matches_raft_tpu(dataset, flat, metric):
    db, q, mask = dataset
    jidx, port = flat[metric]
    rd, ri = jf.search(JaxResources(seed=0),
                       jf.SearchParams(n_probes=8, exact_coarse=True), jidx,
                       jnp.asarray(q), K,
                       filter=jb.SampleFilter.from_mask(jnp.asarray(mask)))
    pd, pi = ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=8), port,
                             q, K, filter=SampleFilter.from_mask(mask))
    assert _admitted(pi, mask)
    _exhausted_rule(pd, pi)
    scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
    _flat_same(pd.numpy(), pi.numpy(), np.asarray(rd), np.asarray(ri),
               scale)


@pytest.mark.parametrize("offset", [0, 300])
def test_brute_force_filtered_knn_matches_raft_tpu(dataset, offset):
    db, q, mask = dataset
    # the filter covers the GLOBAL ids: rows shifted by the offset
    gmask = np.zeros((NQ, N + offset), bool)
    gmask[:, offset:] = mask
    rd, ri = jbf.knn(JaxResources(seed=0), jnp.asarray(db), jnp.asarray(q),
                     K, global_id_offset=offset,
                     filter=jb.SampleFilter.from_mask(jnp.asarray(gmask)))
    pd, pi = brute_force.knn(CPU, db, q, K, global_id_offset=offset,
                             filter=SampleFilter.from_mask(gmask))
    assert _admitted(pi, gmask)
    scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
    _flat_same(pd.numpy(), pi.numpy(), np.asarray(rd), np.asarray(ri),
               scale)


def test_brute_force_starved_slots_are_inf_and_minus_one(dataset):
    db, q, _ = dataset
    f = SampleFilter.from_ids([3, 17], N)
    d, i = brute_force.knn(CPU, db, q, K, filter=f)
    assert set(i[:, :2].reshape(-1).tolist()) <= {3, 17}
    assert (i[:, 2:] == -1).all() and torch.isinf(d[:, 2:]).all()


@pytest.fixture(scope="module")
def walk(dataset):
    db, _, _ = dataset
    index = jc.build(JaxResources(seed=5), jc.IndexParams(
        intermediate_graph_degree=16, graph_degree=8), jnp.asarray(db))
    return index, _load(jc, cagra, index)


_WALK = dict(itopk_size=32, search_width=2, entry_points=256)


def _walk_port(jax_index, port):
    """The port's index with the JAX index's walk cache attached (the entry
    set is a random draw)."""
    (pdim, quant), = list(jax_index._walk_tables)
    _, proj, _ = jax_index._walk_tables[(pdim, quant)][:3]
    _, _, eids = jax_index._walk_entries[(pdim, 256)]
    return cagra.attach_walk_cache(port, np.asarray(proj), np.asarray(eids))


def test_cagra_filtered_walk_matches_raft_tpu(dataset, walk):
    _, q, mask = dataset
    jidx, port = walk
    rd, ri = jc.search(JaxResources(seed=0), jc.SearchParams(**_WALK), jidx,
                       jnp.asarray(q), K,
                       filter=jb.SampleFilter.from_mask(jnp.asarray(mask)))
    port = _walk_port(jidx, port)
    pd, pi = cagra.search(CPU, cagra.SearchParams(**_WALK), port, q, K,
                          filter=SampleFilter.from_mask(mask))
    assert _admitted(pi, mask)
    assert (pi.numpy() == np.asarray(ri)).mean() >= 0.99
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's contracts, held inside the port


def _posthoc(d_u, i_u, mask, k):
    """Drop the rows each query rejects from a big unfiltered result."""
    d_u, i_u = np.asarray(d_u), np.asarray(i_u)
    worst = np.inf if d_u[0, 0] <= d_u[0, -1] else -np.inf
    ref_d = np.full((d_u.shape[0], k), worst, np.float32)
    ref_i = np.full((d_u.shape[0], k), -1, np.int32)
    for qi in range(d_u.shape[0]):
        keep = [(d_u[qi, j], i_u[qi, j]) for j in range(d_u.shape[1])
                if i_u[qi, j] >= 0 and mask[qi, i_u[qi, j]]][:k]
        for j, (dv, iv) in enumerate(keep):
            ref_d[qi, j], ref_i[qi, j] = dv, iv
    return ref_d, ref_i


def _pq_full(mode, kt=0):
    return ivf_pq.SearchParams(n_probes=16, scan_mode=mode,
                               per_probe_topk=kt)


@pytest.mark.parametrize("mode", MODES)
def test_ivf_pq_full_probe_equals_the_unfiltered_result_filtered(
        dataset, pq, mode):
    _, q, mask = dataset
    port = pq[1]
    # the unfiltered reference keeps 128 rows a pair (the widest kt the
    # codes and int8 scans take) and 512 a query: enough that every query
    # keeps K admitted rows
    d_u, i_u = ivf_pq.search(CPU, _pq_full(mode, 128), port, q, 512)
    ref_d, ref_i = _posthoc(d_u, i_u, mask, K)
    assert (ref_i >= 0).all()
    d_f, i_f = ivf_pq.search(CPU, _pq_full(mode), port, q, K,
                             filter=SampleFilter.from_mask(mask))
    np.testing.assert_array_equal(i_f.numpy(), ref_i)
    np.testing.assert_array_equal(d_f.numpy(), ref_d)


@pytest.mark.parametrize("selectivity", [0.001, 0.5, 1.0])
def test_selectivity_sweep(dataset, pq, flat, selectivity):
    _, q, _ = dataset
    mask = np.random.default_rng(int(selectivity * 1000)).random(
        (NQ, N)) < selectivity
    f = SampleFilter.from_mask(mask)
    for search, params, index in (
            (ivf_pq.search, _pq_full("auto"), pq[1]),
            (ivf_flat.search, ivf_flat.SearchParams(n_probes=16),
             flat[DistanceType.L2Expanded][1]),
            (ivf_flat.search, ivf_flat.SearchParams(n_probes=16),
             flat[DistanceType.InnerProduct][1])):
        # k = N: at 0.001 the few admitted rows sit far down the
        # unfiltered order
        d_u, i_u = search(CPU, params, index, q, N)
        ref_d, ref_i = _posthoc(d_u, i_u, mask, K)
        d_f, i_f = search(CPU, params, index, q, K, filter=f)
        np.testing.assert_array_equal(i_f.numpy(), ref_i)
        np.testing.assert_array_equal(d_f.numpy(), ref_d)


@pytest.mark.parametrize("mode", MODES)
def test_an_all_rejecting_filter_gives_sentinels(dataset, pq, mode):
    _, q, _ = dataset
    empty = SampleFilter.from_mask(np.zeros((NQ, N), bool))
    d, i = ivf_pq.search(CPU, _pq_full(mode), pq[1], q, K, filter=empty)
    assert (i == -1).all() and torch.isinf(d).all()


def test_all_rejecting_on_flat_brute_force_and_walk(dataset, flat, walk):
    db, q, _ = dataset
    empty = SampleFilter.from_mask(np.zeros((1, N), bool))
    for d, i in (
            ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=16),
                            flat[DistanceType.L2Expanded][1], q, K,
                            filter=empty),
            brute_force.knn(CPU, db, q, K, filter=empty),
            cagra.search(CPU, cagra.SearchParams(**_WALK),
                         _walk_port(*walk), q, K, filter=empty)):
        assert (i == -1).all() and torch.isinf(d).all()


def test_a_broadcast_row_equals_the_materialized_mask(dataset, pq, flat,
                                                      walk):
    _, q, mask = dataset
    one = SampleFilter.from_mask(mask[:1])
    assert bitset.query_filter_words(one, NQ, "s").stride(0) == 0
    full = SampleFilter.from_mask(np.repeat(mask[:1], NQ, 0))
    port_walk = _walk_port(*walk)
    for search, params, index in (
            (ivf_pq.search, _pq_full("fused"), pq[1]),
            (ivf_flat.search, ivf_flat.SearchParams(n_probes=4),
             flat[DistanceType.L2Expanded][1]),
            (cagra.search, cagra.SearchParams(**_WALK), port_walk)):
        d_b, i_b = search(CPU, params, index, q, K, filter=one)
        d_f, i_f = search(CPU, params, index, q, K, filter=full)
        assert torch.equal(i_b, i_f) and torch.equal(d_b, d_f)


def test_a_filter_composes_with_tombstones(dataset, pq):
    _, q, mask = dataset
    doomed = np.nonzero(mask[0])[0][:200]
    mutated = ivf_pq.delete(CPU, pq[1], doomed)
    d_u, i_u = ivf_pq.search(CPU, _pq_full("auto"), mutated, q, 512)
    ref_d, ref_i = _posthoc(d_u, i_u, mask, K)
    d_f, i_f = ivf_pq.search(CPU, _pq_full("auto"), mutated, q, K,
                             filter=SampleFilter.from_mask(mask))
    np.testing.assert_array_equal(i_f.numpy(), ref_i)
    np.testing.assert_array_equal(d_f.numpy(), ref_d)
    live = i_f.numpy()
    assert not np.isin(live[live >= 0], doomed).any()


def test_a_tenant_filter_keeps_each_query_in_its_range(dataset, pq):
    _, q, _ = dataset
    tenants = TenantFilter({"lo": (0, 1000), "hi": (1000, N)}, N)
    for name, (lo, hi) in tenants.ranges.items():
        _, i = ivf_pq.search(CPU, _pq_full("auto"), pq[1], q, K,
                             filter=tenants.filter_for(name))
        got = i.numpy()
        assert ((got >= lo) & (got < hi)).all()


K_WIDE = 100
WIDE_MODES = (("recon", 65), ("auto", 80), ("recon8", 100), ("codes", 100),
              ("fused", 100))


@pytest.fixture(scope="module")
def sparse_mask():
    """A 5% per-query mask: at 4 of 16 lists a query sees ~25 admitted
    rows, fewer than k 100, so its last slots are exhausted."""
    return np.random.default_rng(5).random((NQ, N)) < 0.05


@pytest.mark.parametrize("dense", [True, False], ids=["50%", "5%"])
@pytest.mark.parametrize("mode,kt", WIDE_MODES)
def test_ivf_pq_filtered_search_at_k_100_matches_raft_tpu(
        dataset, pq, sparse_mask, mode, kt, dense):
    """k 100 with a per-pair kt past 64: each mode's query-major kernel
    (its plain version here) against the JAX package's filtered search on
    the same loaded index, at the k-10 test's tolerances; every id
    admitted, exhausted slots (+inf, -1)."""
    _, q, mask = dataset
    mask = mask if dense else sparse_mask
    jidx, port = pq
    sp = dict(n_probes=4, exact_coarse=True, scan_mode=mode,
              per_probe_topk=kt)
    rd, ri = jp.search(JaxResources(seed=0), jp.SearchParams(**sp), jidx,
                       jnp.asarray(q), K_WIDE,
                       filter=jb.SampleFilter.from_mask(jnp.asarray(mask)))
    pd, pi = ivf_pq.search(CPU, ivf_pq.SearchParams(**sp), port, q, K_WIDE,
                           filter=SampleFilter.from_mask(mask))
    pd, pi, rd, ri = pd.numpy(), pi.numpy(), np.asarray(rd), np.asarray(ri)
    assert _admitted(pi, mask)
    _exhausted_rule(pd, pi)
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    assert dense or not np.isfinite(pd).all()
    if mode in ("auto", "recon"):
        assert _live_overlap(pi, ri) >= 0.99
        np.testing.assert_allclose(pd, rd, rtol=1e-4, atol=1e-4)
    else:
        assert _live_overlap(pi, ri) >= 0.95


@pytest.mark.parametrize("dense", [True, False], ids=["50%", "5%"])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=["L2", "IP"])
def test_ivf_flat_filtered_search_at_k_100_matches_raft_tpu(
        dataset, flat, sparse_mask, metric, dense):
    """k 100 (Kernel F's query-major route, its plain version here)
    against the JAX package, at the k-10 test's tolerances; every id
    admitted, exhausted slots (±inf, -1)."""
    db, q, mask = dataset
    mask = mask if dense else sparse_mask
    jidx, port = flat[metric]
    rd, ri = jf.search(JaxResources(seed=0),
                       jf.SearchParams(n_probes=4, exact_coarse=True), jidx,
                       jnp.asarray(q), K_WIDE,
                       filter=jb.SampleFilter.from_mask(jnp.asarray(mask)))
    pd, pi = ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=4), port,
                             q, K_WIDE, filter=SampleFilter.from_mask(mask))
    assert _admitted(pi, mask)
    _exhausted_rule(pd, pi)
    assert dense or not torch.isfinite(pd).all()
    scale = float((q * q).sum(1).max() + (db * db).sum(1).max())
    _flat_same(pd.numpy(), pi.numpy(), np.asarray(rd), np.asarray(ri),
               scale)


@pytest.mark.parametrize("mode", MODES)
def test_ivf_pq_full_probe_at_k_100_equals_the_unfiltered_result_filtered(
        dataset, pq, mode):
    """The full-probe contract at k 100 (per-pair kt 100: every mode's
    query-major kernel): the filtered result equals the unfiltered one
    (kt 128, k 512) with the rejected rows dropped, bit for bit."""
    _, q, mask = dataset
    port = pq[1]
    d_u, i_u = ivf_pq.search(CPU, _pq_full(mode, 128), port, q, 512)
    ref_d, ref_i = _posthoc(d_u, i_u, mask, K_WIDE)
    assert (ref_i >= 0).all()
    d_f, i_f = ivf_pq.search(CPU, _pq_full(mode), port, q, K_WIDE,
                             filter=SampleFilter.from_mask(mask))
    np.testing.assert_array_equal(i_f.numpy(), ref_i)
    np.testing.assert_array_equal(d_f.numpy(), ref_d)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=["L2", "IP"])
def test_ivf_flat_full_probe_at_k_100_equals_the_unfiltered_result_filtered(
        dataset, flat, metric):
    """IVF-Flat's full-probe contract at k 100 (Kernel F's query-major
    route): bit for bit against the unfiltered search at k = N filtered
    afterwards."""
    _, q, mask = dataset
    index = flat[metric][1]
    params = ivf_flat.SearchParams(n_probes=16)
    d_u, i_u = ivf_flat.search(CPU, params, index, q, N)
    ref_d, ref_i = _posthoc(d_u, i_u, mask, K_WIDE)
    d_f, i_f = ivf_flat.search(CPU, params, index, q, K_WIDE,
                               filter=SampleFilter.from_mask(mask))
    np.testing.assert_array_equal(i_f.numpy(), ref_i)
    np.testing.assert_array_equal(d_f.numpy(), ref_d)

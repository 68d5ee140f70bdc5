"""The rest of CAGRA in raft_tpu_torch against raft_tpu's, on the CPU: the
deep-scale build (the in-place reverse merge and walk rounds, their table
plan), the direct exact walk, and walks and hops past 256.

The same numpy-made inputs go through both packages.  Where the arithmetic
is exact (data in quarters, rows in bf16, sums of exact products) results
are held bit for bit; the walks, whose fp32 sums run in other orders, to
ids equal off key ties and keys within 1e-5 relative; the builds, whose
random draws differ (Philox, not threefry), to recall margins.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import cagra as jc
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import cagra_hop as chop
from raft_tpu_torch.ops import cagra_walk as cw

L2, L2S, IP = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.InnerProduct)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small torch ops slow ~100x when torch's intra-op pool
    oversubscribes the cores under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    """numpy (or a jax array) -> CPU tensor (a copy)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())


def recall(found, truth):
    return sum(len(set(f) & set(g)) for f, g in zip(found, truth)) / truth.size


def naive_knn(db, q, k, ip=False):
    if ip:
        d = -(q @ db.T)
    else:
        d = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _manifold(n, dim, latent, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, latent)).astype(np.float32)
    A = rng.normal(size=(latent, dim)).astype(np.float32) / np.sqrt(latent)
    return (Z @ A + noise * rng.normal(size=(n, dim))).astype(np.float32)


@pytest.fixture(scope="module")
def quarters():
    """1,500 x 16 blob rows in quarters (every bf16 row, product and fp32
    sum of the reranks exact), their exact 17-NN graph (self first) and a
    projection to 8 dims in 64ths."""
    X, _ = make_blobs(1500, 16, n_clusters=12, cluster_std=1.0, seed=5)
    db = (np.round(np.asarray(X) * 4) / 4).astype(np.float32)
    knn = naive_knn(db, db, 17).astype(np.int32)
    vecs = np.linalg.eigh(db.T @ db)[1]
    proj = (np.round(vecs[:, -8:] * 64) / 64).astype(np.float32)
    return db, knn, proj


def _ids_and_second(rng, n, kg, m2):
    """A graph of kg ids a row (distinct) and m2 extra candidates a row with
    -1 slots and repeats, both numpy int32."""
    knn = np.stack([rng.permutation(n)[:kg] for _ in range(n)]).astype(
        np.int32)
    second = rng.integers(0, n, size=(n, m2)).astype(np.int32)
    second[rng.random((n, m2)) < 0.1] = -1
    second[:, 1] = knn[:, 0]                  # a repeat of an old edge
    return knn, second


# ---------------------------------------------------------------------------
# the deep regime's in-place rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [300, 256, 1500, 4096])
@pytest.mark.parametrize("metric", [L2, IP])
def test_merge_refine_inplace_matches_jax(quarters, chunk, metric):
    """The reverse merge per chunk, written back in place: bit for bit the
    JAX loop, the overlapping last chunk (1,500 % 300 = 0, % 256 = 220)
    reranking rows an earlier chunk already rewrote."""
    db = quarters[0]
    n = db.shape[0]
    ip = metric == IP
    knn, second = _ids_and_second(np.random.default_rng(chunk), n, 17, 12)
    ours = cagra._merge_refine_inplace(t(db), t(knn), t(second), 17, ip,
                                       chunk=min(chunk, n))
    ref = jc._merge_refine_inplace(jnp.asarray(db), jnp.asarray(knn),
                                   jnp.asarray(second), 17, ip,
                                   chunk=min(chunk, n))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_merge_refine_inplace_overlap_reranks_the_new_rows(quarters):
    """At n % chunk != 0 the last chunk starts at n - chunk: its first rows
    are reranked twice, the second time with the first pass's result as
    ``old`` — not the short-last-chunk result."""
    db = quarters[0]
    n = db.shape[0]
    knn, second = _ids_and_second(np.random.default_rng(3), n, 17, 12)
    once = cagra._merge_refine_inplace(t(db), t(knn), t(second), 17, False,
                                       chunk=n)
    twice = cagra._merge_refine_inplace(t(db), t(knn), t(second), 17, False,
                                        chunk=800)
    # rows 700..799 went through both chunks: [0, 800) then [700, 1500)
    xsq = t((db.astype(np.float32) ** 2).sum(1))
    again, _ = cagra._rerank_rows(t(db), xsq, t(db[700:800]),
                                  once[700:800], t(second[700:800]), 17,
                                  False)
    np.testing.assert_array_equal(twice[700:800].numpy(), again.numpy())
    np.testing.assert_array_equal(twice[800:].numpy(), once[800:].numpy())


@pytest.mark.parametrize("chunk", [400, 1500])
@pytest.mark.parametrize("metric", [L2, IP])
def test_walk_refine_fused_matches_jax(quarters, chunk, metric):
    """A deep round's walk + rerank per chunk, in place, on the port's bf16
    walk table (bit-exact with JAX's), at search width 1: the graph rows
    equal JAX's off key ties (the walk's projected keys sum in their own
    order), and each row's exact keys within 1e-5 relative."""
    db, knn, proj = quarters
    ip = metric == IP
    n = db.shape[0]
    graph = np.ascontiguousarray(knn[:, 1:])           # 16 neighbors
    table, tproj = cagra._build_walk_table(t(db), t(graph), 8, proj=t(proj))
    ref = jc._walk_refine_fused(
        jnp.asarray(db), jnp.asarray(knn), jnp.asarray(table.numpy()),
        jnp.asarray(proj), None, 17, 32, 4, metric, 16, chunk=chunk)
    ours = cagra._walk_refine_fused(t(db), t(knn), table, tproj, None, 17,
                                    32, 4, metric, 16, chunk=chunk)
    ours, ref = ours.numpy(), np.asarray(ref)
    assert (ours == ref).mean() >= 0.99

    def keys(rows):
        x = db[rows]
        if ip:
            return -(x * db[:, None, :]).sum(-1)
        return ((x - db[:, None, :]) ** 2).sum(-1)

    np.testing.assert_allclose(np.sort(keys(ours), 1), np.sort(keys(ref), 1),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the table plan
# ---------------------------------------------------------------------------

def test_table_plan_deep_matches_jax():
    """``_table_plan(deep=True)`` (no bf16 rung) and the default ladder
    against JAX's over a grid of (n, kg, pdim, budget)."""
    for n in (1000, 1_000_000, 10_000_000):
        for kg in (17, 33, 65, 129, 291):
            for pdim in (8, 13, 16, 32, 96):
                for budget in (1 << 20, 1 << 28, 5 << 30, 6 << 30, 1 << 40):
                    for deep in (False, True):
                        assert cagra._table_plan(n, kg, pdim, budget,
                                                 deep=deep) == \
                            jc._table_plan(n, kg, pdim, budget, deep=deep)


class _Planned(Exception):
    pass


def test_deep_walk_round_budget_and_plan_match_jax(monkeypatch):
    """The deep round's budget (min(the 6 GiB cap, device memory − the
    fp32 dataset − the graph padded to 128 columns − 3 GiB)) and its plan,
    against ``raft_tpu``'s ``_deep_walk_round`` given the same device
    memory (its ``_hbm_bytes`` patched; the plan read where it builds the
    table), over a grid of (n, dim, kg, pdim, memory)."""
    seen = []

    def capture(dataset, knn, plan, vecs):
        seen.append(plan)
        raise _Planned

    monkeypatch.setattr(jc, "_build_refine_table", capture)
    for hbm in (16 << 30, 80 << 30, 80_000_000_000, 8 << 30):
        monkeypatch.setattr(jc, "_hbm_bytes", lambda hbm=hbm: hbm)
        for n, dim in ((10_000_000, 96), (4_000_000, 128), (1_000_000, 960),
                       (20_000_000, 96)):
            for kg in (33, 65, 129):
                for pdim in (8, 16, 32):
                    seen.clear()
                    fake = types.SimpleNamespace(shape=(n, dim))
                    try:
                        out = jc._deep_walk_round(fake, "knn", kg, L2, pdim,
                                                  8)
                        assert out == "knn"
                        ref = None
                    except _Planned:
                        ref = seen[0]
                    budget, plan = cagra._deep_table_plan(n, dim, kg, pdim,
                                                          hbm)
                    assert plan == ref, (hbm, n, dim, kg, pdim)
                    assert budget <= cagra._WALK_TABLE_MAX_BYTES
    # the deep-cagra-10m configuration on an 80 GB card: the int8 rung at
    # degree 32 and pdim 8, the one that fits the 6 GiB cap
    assert cagra._deep_table_plan(10_000_000, 96, 65, 16,
                                  80 << 30)[1] == (32, 8, True)


# ---------------------------------------------------------------------------
# the deep-scale build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deep_rows():
    return _manifold(12_000, 32, 8, seed=11)


def test_deep_build_matches_default_and_jax(deep_rows, monkeypatch):
    """The deep regime (thresholds lowered in both packages, as
    tests/test_cagra.py does): recall@16 of the kNN graph on sampled nodes
    >= 0.9, at least the default path's less 0.05 and within 0.03 of the
    JAX deep build's; ``prune`` of the port's deep graph is bit for bit
    JAX's (whose deep prune runs its host tail)."""
    X = deep_rows
    n, deg = X.shape[0], 16
    for mod in (cagra, jc):
        monkeypatch.setattr(mod, "_BRUTE_BUILD_MAX", 4096)
    res = DeviceResources(seed=0, device="cpu")
    knn_default = cagra.build_knn_graph(res, X, deg).numpy()
    for mod in (cagra, jc):
        monkeypatch.setattr(mod, "_DEEP_SCALE_ROWS", 10_000)
    knn_deep = cagra.build_knn_graph(res, X, deg).numpy()
    assert "reverse_merge" in cagra.build.stage_seconds
    assert len(cagra.build.deep_plans) == 2
    assert all(p is not None for p in cagra.build.deep_plans)
    knn_jax = np.asarray(jc.build_knn_graph(JaxResources(seed=0), X, deg))
    sample = np.arange(0, n, 61)
    gt = naive_knn(X, X[sample], deg + 1)[:, 1:]
    r_def, r_deep, r_jax = (recall(k[sample], gt)
                            for k in (knn_default, knn_deep, knn_jax))
    assert r_deep >= 0.9, r_deep
    assert r_deep >= r_def - 0.05, (r_def, r_deep)
    assert abs(r_deep - r_jax) <= 0.03, (r_deep, r_jax)
    ours = cagra.prune(res, t(knn_deep), 8).numpy()
    ref = np.asarray(jc.prune(JaxResources(seed=0), jnp.asarray(knn_deep), 8))
    np.testing.assert_array_equal(ours, ref)


def test_reverse_edges_stay_on_the_device_within_a_quarter_of_memory(
        monkeypatch):
    """``_reverse_edges_auto`` sorts on the device while the edges' sort
    fits a quarter of device memory, else on the host, with the same
    result either way."""
    rng = np.random.default_rng(2)
    knn = t(rng.integers(0, 5000, size=(5000, 60)).astype(np.int32))
    device = cagra._reverse_edges_auto(knn, 5000, 32)
    host_calls = []
    real = cagra._reverse_edges_host

    def spy(*a):
        host_calls.append(a[1])
        return real(*a)

    monkeypatch.setattr(cagra, "_reverse_edges_host", spy)
    cagra._reverse_edges_auto(knn, 5000, 32)
    assert host_calls == []
    monkeypatch.setattr(cagra, "_chunk_budget",
                        lambda dev: 5000 * 48 * cagra._REV_EDGE_BYTES // 17)
    host = cagra._reverse_edges_auto(knn, 5000, 32)
    assert host_calls == [5000]
    np.testing.assert_array_equal(host.numpy(), device.numpy())
    # 10M rows x 48 source columns on an 80 GB card: on the device
    assert 10_000_000 * 48 * cagra._REV_EDGE_BYTES <= 16 * (80 << 30) // 64


# ---------------------------------------------------------------------------
# the direct exact walk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def walk_index():
    """A JAX-built index over 2,000 x 16 blob rows (graph degree 16) and
    40 queries."""
    X, _ = make_blobs(2100, 16, n_clusters=30, cluster_std=1.0, seed=11)
    db, q = np.asarray(X[:2000]), np.asarray(X[2000:2040])
    jidx = jc.build(JaxResources(seed=42), jc.IndexParams(
        intermediate_graph_degree=32, graph_degree=16), db)
    return jidx, db, q


def _half_words(nq, n, seed):
    mask = np.random.default_rng(seed).random((nq, n)) < 0.5
    return bitset.pack_mask(torch.from_numpy(mask)).numpy()


def _assert_ties_only(od, oi, rd, ri, scale):
    """Keys within 1e-5 of each row's ``scale`` (‖q‖² + max ‖x‖²: fp32
    sums of ‖q‖² + ‖x‖² − 2⟨q, x⟩ in another order move a key by ~1e-7 of
    it, whatever the key), and ids equal but where the two keys tie
    within that tolerance (each row holds the same ids off its last tied
    rank)."""
    tol = 1e-5 * scale[:, None]
    assert bool(np.all(np.abs(od - rd) <= tol)), float(np.abs(od - rd).max())
    diff = oi != ri
    tied = np.abs(od[:, :, None] - od[:, None, :]) <= tol[:, :, None]
    for r, c in np.argwhere(diff):
        others = np.delete(np.arange(od.shape[1]), c)
        assert bool(tied[r, c, others].any()), (r, c, od[r], rd[r])
    for r in np.unique(np.argwhere(diff)[:, 0]):
        last = np.abs(od[r] - od[r, -1]) <= tol[r]
        assert set(oi[r][~last]) == set(ri[r][~last])


@pytest.mark.parametrize("metric", [L2, L2S, IP])
@pytest.mark.parametrize("itopk,width", [(16, 1), (32, 2), (48, 1), (64, 2)])
@pytest.mark.parametrize("filtered", [False, True])
def test_direct_walk_matches_jax_given_the_seeds(walk_index, metric, itopk,
                                                 width, filtered):
    """``_search_impl`` (seeding, the exact-row walk's plain version, the
    output) against JAX's given the same ``seed_ids`` (4 x itopk draws,
    with repeats), for each metric, width and a 50% per-query filter."""
    jidx, db, q = walk_index
    n, nq, k = db.shape[0], q.shape[0], 10
    rng = np.random.default_rng(itopk + width + metric)
    seeds = rng.integers(0, n, size=(nq, max(4 * itopk, 128))).astype(
        np.int32)
    fw = _half_words(nq, n, itopk) if filtered else None
    max_iter = 10 + itopk // width
    ref = jc._search_impl(jnp.asarray(db), jidx.graph, jnp.asarray(q),
                          jnp.asarray(seeds), k, itopk, width, max_iter,
                          metric,
                          filter_words=None if fw is None else jnp.asarray(fw))
    od, oi = cagra._search_impl(t(db), t(np.asarray(jidx.graph)), t(q),
                                t(seeds), k, itopk, width, max_iter, metric,
                                filter_words=None if fw is None else t(fw))
    rd, ri = (np.asarray(x) for x in ref)
    od = od.numpy()
    if metric == L2S:
        od, rd = od ** 2, rd ** 2
    scale = (q * q).sum(1) + (db * db).sum(1).max()
    _assert_ties_only(od, oi.numpy(), rd, ri, scale)
    if filtered:
        keep = oi.numpy() >= 0
        bits = bitset.query_bits(t(fw), torch.arange(nq), oi)
        assert bool((bits.numpy()[keep] == 1).all())


def test_direct_walk_exit_check_changes_nothing(walk_index):
    """The plain direct walk checks its all(visited) exit every 8 hops or
    never: the same result (a visited buffer is a fixed point)."""
    jidx, db, q = walk_index
    seeds = t(np.random.default_rng(1).integers(0, 2000, size=(40, 128))
              .astype(np.int32))
    g = t(np.asarray(jidx.graph))
    a = cagra._search_impl(t(db), g, t(q), seeds, 10, 32, 1, 42, L2)
    b = cagra._search_impl(t(db), g, t(q), seeds, 10, 32, 1, 42, L2,
                           exit_every=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("route", ["walk_pdim=0", "no table fits"])
def test_public_direct_search_recall_matches_jax(walk_index, monkeypatch,
                                                 route):
    """Public ``search`` on a carried index through the direct walk (its
    seeds are the handle's draws: Philox against threefry), recall@10
    within 0.02 of JAX's; no walk table is built."""
    jidx, db, q = walk_index
    sp = dict(itopk_size=64, search_width=2)
    if route == "walk_pdim=0":
        sp["walk_pdim"] = 0
    else:
        for mod in (cagra, jc):
            monkeypatch.setattr(mod, "_WALK_TABLE_MAX_BYTES", 1)
    fresh = jc.Index(dataset=jidx.dataset, graph=jidx.graph)
    _, ri = jc.search(JaxResources(seed=3), jc.SearchParams(**sp), fresh,
                      jnp.asarray(q), 10)
    idx = cagra.index_from_numpy(db, np.asarray(jidx.graph), device="cpu")
    res = DeviceResources(seed=3, device="cpu")
    _, oi = cagra.search(res, cagra.SearchParams(**sp), idx, q, 10)
    assert not getattr(idx, "_walk_tables", {})
    gt = naive_knn(db, q, 10)
    r_ref, r_ours = recall(np.asarray(ri), gt), recall(oi.numpy(), gt)
    assert abs(r_ours - r_ref) <= 0.02, (r_ours, r_ref)


def test_direct_walk_drops_deleted_ids(walk_index):
    """``_mask_deleted`` applies after the direct walk."""
    jidx, db, q = walk_index
    idx = cagra.index_from_numpy(db, np.asarray(jidx.graph), device="cpu")
    res = DeviceResources(seed=0, device="cpu")
    sp = cagra.SearchParams(itopk_size=32, walk_pdim=0)
    _, first = cagra.search(res, sp, idx, q, 10)
    gone = cagra.delete(res, idx, first[:, 0])
    d, i = cagra.search(res, sp, gone, q, 10)
    assert not bool(torch.isin(i, first[:, 0]).any())
    assert bool((i[torch.isinf(d)] == -1).all())
    fin = torch.isfinite(d)
    assert bool((torch.diff(d, dim=1)[fin[:, 1:]] >= 0).all())


# ---------------------------------------------------------------------------
# hops and walks past 256
# ---------------------------------------------------------------------------

def _hop_case(seed, nq, itopk, wd, pdim):
    """A sorted buffer of distinct ids with a dead tail and random visited
    flags; candidates with masked ids, repeats and ids already buffered."""
    rng = np.random.default_rng(seed)
    id_hi = 4 * (itopk + wd)
    buf_d = np.sort(rng.random((nq, itopk)).astype(np.float32) * 2, axis=1)
    buf_d[:, itopk - itopk // 8:] = np.inf
    buf_i = np.stack([rng.permutation(id_hi)[:itopk] for _ in range(nq)]
                     ).astype(np.int32)
    buf_i[np.isinf(buf_d)] = -1
    vis = rng.random((nq, itopk)) < 0.3
    nb_id = rng.integers(0, id_hi, size=(nq, wd)).astype(np.int32)
    nb_id[:, :wd // 16] = -1
    nb_id[:, -1] = buf_i[:, 0]
    qp = t(rng.normal(size=(nq, pdim)).astype(np.float32)).to(torch.bfloat16)
    rows = rng.normal(size=(id_hi, pdim)).astype(np.float32)
    nb_p = t(rows[np.maximum(nb_id, 0)]).to(torch.bfloat16)
    nb_sq = t((rng.random(id_hi) * 3).astype(np.float32)[np.maximum(nb_id,
                                                                    0)])
    q_sq = t((rng.random(nq) * 3).astype(np.float32))
    return qp, q_sq, nb_p, nb_sq, t(nb_id), t(buf_d), t(buf_i), t(vis)


@pytest.mark.parametrize("itopk,wd", [(300, 512), (512, 512), (291, 320)])
def test_plain_hop_past_256_matches_merge_candidates(itopk, wd):
    """Kernel I's plain hop at itopk 300 / 512 with wd 512 (and the kg-291
    merge) against ``raft_tpu``'s ``_merge_candidates`` on the same keys:
    bit for bit."""
    args = _hop_case(itopk + wd, 6, itopk, wd, 16)
    key, ids = chop.hop_keys(*args[:5], False)
    bd, bi, bv = args[5:]
    ref = jc._merge_candidates(jnp.asarray(bd.numpy()),
                               jnp.asarray(bi.numpy()),
                               jnp.asarray(bv.numpy()),
                               jnp.asarray(key.numpy()),
                               jnp.asarray(ids.numpy()), itopk)
    ours = chop.cagra_hop_plain(*args, ip_metric=False)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def walk_cache(walk_index):
    jidx = walk_index[0]
    pdim = jc._auto_pdim(jidx)
    return jc._walk_cache(JaxResources(seed=1), jidx, pdim, 512)


@pytest.mark.parametrize("itopk,width", [(300, 32), (512, 32), (512, 1)])
def test_plain_walk_past_256_matches_jax(walk_index, walk_cache, itopk,
                                         width):
    """``_search_impl_walk`` past 256 (itopk 300 and 512, wd 512 = width 32
    x degree 16) against JAX's with ``fused_hop=False`` on a carried walk
    cache: ids equal on >= 0.99 of slots, exact distances within 1e-5."""
    jidx, db, q = walk_index
    c = walk_cache
    k = 10
    rerank = max(min(itopk, max(32, 2 * k)), k)
    max_iter = 10 + itopk // width
    ref = jc._search_impl_walk(
        jidx.dataset, c.table, c.entry_proj, c.entry_sq, c.entry_ids,
        c.proj, jnp.asarray(q), k, itopk, width, max_iter, jidx.metric,
        rerank, jidx.graph_degree, fused_hop=False)
    ours = cagra._search_impl_walk(
        t(db), t(c.table), t(np.asarray(c.entry_proj).astype(np.float32)).to(
            torch.bfloat16), t(c.entry_sq), t(c.entry_ids), t(c.proj), t(q),
        k, itopk, width, max_iter, L2, rerank, jidx.graph_degree)
    od, oi = (x.numpy() for x in ours)
    rd, ri = (np.asarray(x) for x in ref)
    assert (oi == ri).mean() >= 0.99
    np.testing.assert_allclose(od, rd, rtol=1e-5, atol=1e-5)


def test_walks_past_shared_memory_run_the_plain_walk_and_count(walk_index,
                                                               monkeypatch):
    """No gate picks the plain versions: CPU tensors run them because they
    lie on the CPU.  With both kernels' shared memory lowered (1,024 B) the
    gates refuse every shape of the search, naming shared memory (on the
    card the wrappers raise with that reason), and the table walk and the
    direct walk on the CPU return what they return at the real limit."""
    jidx, db, q = walk_index
    idx = cagra.index_from_numpy(db, np.asarray(jidx.graph), device="cpu")
    deg = idx.graph_degree
    out = {}
    for limit in (cw.SMEM_MAX, 1024):
        for mod in (cw, chop):
            monkeypatch.setattr(mod, "SMEM_MAX", limit)
        refused = limit == 1024
        assert bool(cw.walk_reject_reason(40, 64, 2, deg, 16)) == refused
        assert bool(cw.walk_exact_reject_reason(40, 64, 1, deg, 32)) == \
            refused
        assert bool(chop.hop_reject_reason(40, 65, 96, 32)) == refused
        if refused:
            assert cw.walk_reject_reason(40, 64, 2, deg, 16).startswith(
                "shared memory")
        res = DeviceResources(seed=5, device="cpu")
        out[limit] = (cagra.search(res, cagra.SearchParams(
            itopk_size=64, search_width=2), idx, q, 10) + cagra.search(
                res, cagra.SearchParams(walk_pdim=0), idx, q, 10))
        assert out[limit][2].shape == (40, 10)
    for a, b in zip(out[cw.SMEM_MAX], out[1024]):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def wide_rows():
    return _manifold(3000, 32, 6, seed=4)


def test_build_at_intermediate_degree_290_matches_jax(wide_rows,
                                                      monkeypatch):
    """A clustered build at intermediate degree 290: its refinement merge
    runs at itopk 291 with wd 320 (256 walked + 64 reverse edges); the
    kNN graph's recall@290 on sampled nodes within 0.03 of JAX's."""
    X = wide_rows
    for mod in (cagra, jc):
        monkeypatch.setattr(mod, "_BRUTE_BUILD_MAX", 1000)
    res = DeviceResources(seed=0, device="cpu")
    ours = cagra.build_knn_graph(res, X, 290).numpy()
    assert "walk_refine_1" in cagra.build.stage_seconds
    ref = np.asarray(jc.build_knn_graph(JaxResources(seed=0), X, 290))
    sample = np.arange(0, X.shape[0], 37)
    gt = naive_knn(X, X[sample], 291)[:, 1:]
    r_ours, r_ref = recall(ours[sample], gt), recall(ref[sample], gt)
    assert r_ours >= 0.9 and abs(r_ours - r_ref) <= 0.03, (r_ours, r_ref)

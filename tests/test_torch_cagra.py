"""raft_tpu_torch CAGRA against raft_tpu's, on the CPU.

The same numpy-made inputs go through both packages.  Kernel I's plain
version (``ops/cagra_hop.cagra_hop_plain``) is held to the Pallas hop in
interpret mode and to the JAX XLA twin ``_merge_candidates``; the walk
primitives and the table formats bit for bit; the walk search to a
``raft_tpu``-built index carried across with its walk cache; the builds,
whose random draws differ (Philox, not threefry), to recall margins.
Every tolerance is stated where it is checked.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import cagra as jc
from raft_tpu.ops.cagra_hop_pallas import fused_hop
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import cagra_hop as chop
from raft_tpu_torch.ops.vmem_budget import merge_window_request


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small torch ops slow ~100x when torch's intra-op pool
    oversubscribes the cores under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a, dtype=None):
    """numpy (or a jax array) -> CPU tensor; bf16 through float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(np.ascontiguousarray(a).copy())
    return x if dtype is None else x.to(dtype)


def recall(found, truth):
    return sum(len(set(f) & set(g)) for f, g in zip(found, truth)) / truth.size


def naive_knn(db, q, k):
    d = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


@pytest.fixture(scope="module")
def blobs():
    """tests/test_cagra.py's data: 2000 x 16 blobs and 40 queries."""
    X, _ = make_blobs(2100, 16, n_clusters=30, cluster_std=1.0, seed=11)
    return np.asarray(X[:2000]), np.asarray(X[2000:2040])


@pytest.fixture(scope="module")
def jax_index(blobs):
    db, _ = blobs
    return jc.build(JaxResources(seed=42),
                    jc.IndexParams(intermediate_graph_degree=32,
                                   graph_degree=16), db)


@pytest.fixture(scope="module")
def jax_cache(jax_index):
    """The JAX index's bf16 walk cache (512 entry points)."""
    pdim = jc._auto_pdim(jax_index)
    fmt = jc._search_table_format(jax_index, pdim)
    assert fmt == (pdim, False)
    return jc._walk_cache(JaxResources(seed=1), jax_index, pdim, 512)


def _carried(jax_index):
    return cagra.index_from_numpy(np.asarray(jax_index.dataset),
                                  np.asarray(jax_index.graph),
                                  int(jax_index.metric), device="cpu")


def _manifold(n, dim, latent, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, latent)).astype(np.float32)
    A = rng.normal(size=(latent, dim)).astype(np.float32) / np.sqrt(latent)
    return (Z @ A + noise * rng.normal(size=(n, dim))).astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel I's plain version
# ---------------------------------------------------------------------------

def _hop_inputs(seed, nq, itopk, wd, pdim, id_hi):
    """tests/test_cagra.py's hop inputs (masked parents, a repeated
    candidate, buffered candidates carrying their exact key), with the
    projections rounded to bf16 first: the walk hands the hop bf16 values,
    and a buffered copy's key is computed from the same values."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16)  # noqa
                            .astype(jnp.float32))
    qp = bf(rng.normal(size=(nq, pdim)).astype(np.float32))
    qsq = (rng.random(nq) * 3).astype(np.float32)
    nbp = bf(rng.normal(size=(nq, wd, pdim)).astype(np.float32))
    nbsq = (rng.random((nq, wd)) * 3).astype(np.float32)
    nbid = rng.integers(0, id_hi, size=(nq, wd)).astype(np.int32)
    nbid[0, :4] = -1
    if nq > 1 and wd > 6:
        nbid[1, 5] = nbid[1, 6]
    for r in range(nq):
        first = {}
        for j in range(wd):
            cid = int(nbid[r, j])
            if cid < 0:
                continue
            if cid in first:
                nbp[r, j] = nbp[r, first[cid]]
                nbsq[r, j] = nbsq[r, first[cid]]
            else:
                first[cid] = j
    key, _ = chop.hop_keys(t(qp), t(qsq), t(nbp), t(nbsq), t(nbid), False)
    d_c = key.numpy()
    bufd = np.sort(rng.random((nq, itopk)).astype(np.float32) * 2, axis=1)
    bufd[:, itopk - 3:] = np.inf
    bufi = np.zeros((nq, itopk), np.int32)
    for r in range(nq):
        bufi[r] = np.random.default_rng(r).permutation(
            10 * itopk)[:itopk] + 10 * id_hi
        for slot, j in ((2, 1), (5, min(7, wd - 1))):
            if nbid[r, j] >= 0:
                bufi[r, slot] = nbid[r, j]
                bufd[r, slot] = d_c[r, j]
    order = np.argsort(bufd, axis=1)
    bufd = np.take_along_axis(bufd, order, axis=1)
    bufi = np.take_along_axis(bufi, order, axis=1)
    bufi[bufd == np.inf] = -1
    vis = np.asarray(np.random.default_rng(9).random((nq, itopk)) < 0.3)
    vis[bufd == np.inf] = False
    return qp, qsq, nbp, nbsq, nbid, bufd, bufi, vis


def _assert_same_buffer(ours, ref):
    """Finite slots: ids and visited flags equal, keys within 1e-5
    (relative and absolute: the two sum the same exact products in other
    orders); the rest (+inf, -1)."""
    od, oi, ov = (x.numpy() for x in ours)
    rd, ri, rv = (np.asarray(x) for x in ref)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(od), fin)
    np.testing.assert_allclose(od[fin], rd[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(oi[fin], ri[fin])
    np.testing.assert_array_equal(ov[fin], rv[fin])
    assert (oi[~fin] == -1).all()


@pytest.mark.parametrize("seed,nq,itopk,wd,pdim,mw", [
    (0, 5, 16, 24, 16, 1),      # the legacy in-pass merge's shape
    (0, 5, 16, 24, 16, 2),      # test_staged_merge_parity's five shapes
    (1, 7, 64, 64, 32, 0),
    (2, 16, 64, 96, 64, 2),
    (3, 3, 48, 32, 64, 2),
    (4, 1, 64, 48, 16, 2)])
def test_hop_plain_matches_the_pallas_hop(seed, nq, itopk, wd, pdim, mw):
    qp, qsq, nbp, nbsq, nbid, bufd, bufi, vis = _hop_inputs(
        seed, nq, itopk, wd, pdim, 40 if mw == 1 else 200)
    ref = fused_hop(jnp.asarray(qp).astype(jnp.bfloat16), jnp.asarray(qsq),
                    jnp.asarray(nbp).astype(jnp.bfloat16), jnp.asarray(nbsq),
                    jnp.asarray(nbid), jnp.asarray(bufd), jnp.asarray(bufi),
                    jnp.asarray(vis), itopk=itopk, ip_metric=False,
                    interpret=True, merge_window=mw)
    ours = chop.cagra_hop(t(qp, torch.bfloat16), t(qsq),
                          t(nbp, torch.bfloat16), t(nbsq), t(nbid), t(bufd),
                          t(bufi), t(vis), ip_metric=False)
    _assert_same_buffer(ours, ref)


@pytest.mark.parametrize("itopk,wd,ip", [(96, 64, False), (32, 64, True),
                                         (65, 96, False)])
def test_hop_plain_matches_merge_candidates(itopk, wd, ip):
    """Against the XLA twin at the build round's shape (itopk 96, wd 64),
    the exact merge's (65, 96) and with InnerProduct keys."""
    pdim = 16
    qp, qsq, nbp, nbsq, nbid, bufd, bufi, vis = _hop_inputs(
        7, 9, itopk, wd, pdim, 300)
    ipx = np.einsum("qp,qwp->qw", qp, nbp).astype(np.float32)
    d_c = -ipx if ip else qsq[:, None] + nbsq - 2.0 * ipx
    d_c = np.where(nbid >= 0, d_c, np.inf).astype(np.float32)
    if ip:              # a buffered copy carries its IP key
        key, _ = chop.hop_keys(t(qp), t(qsq), t(nbp), t(nbsq), t(nbid), True)
        for r in range(bufi.shape[0]):
            for s in range(itopk):
                hit = np.nonzero(nbid[r] == bufi[r, s])[0]
                if bufi[r, s] >= 0 and hit.size:
                    bufd[r, s] = key[r, hit[0]]
        order = np.argsort(bufd, axis=1, kind="stable")
        bufd, bufi, vis = (np.take_along_axis(a, order, 1)
                           for a in (bufd, bufi, vis))
    ref = jc._merge_candidates(jnp.asarray(bufd), jnp.asarray(bufi),
                               jnp.asarray(vis), jnp.asarray(d_c),
                               jnp.asarray(nbid), itopk)
    ours = chop.cagra_hop(t(qp, torch.bfloat16), t(qsq),
                          t(nbp, torch.bfloat16), t(nbsq), t(nbid), t(bufd),
                          t(bufi), t(vis), ip_metric=ip)
    _assert_same_buffer(ours, ref)


@pytest.mark.parametrize("A,B", [(64, 64), (24, 64), (32, 128), (96, 64),
                                 (65, 96)])
def test_bitonic_merge_is_bit_exact(A, B):
    rng = np.random.default_rng(A * 100 + B)
    q = 13
    a_k = np.sort(rng.normal(size=(q, A)).astype(np.float32), axis=1)
    b_k = np.sort(rng.normal(size=(q, B)).astype(np.float32), axis=1)
    a_k[:, -3:] = b_k[:, -2:-1] = np.inf            # inf tails, ties
    b_k[:, 3] = b_k[:, 4] = a_k[:, 5]
    a_i = rng.integers(0, 10000, (q, A)).astype(np.int32)
    b_i = rng.integers(0, 10000, (q, B)).astype(np.int32)
    a_v = rng.random((q, A)) < 0.5
    ref = jc._bitonic_merge(jnp.asarray(a_k), jnp.asarray(a_i),
                            jnp.asarray(a_v), jnp.asarray(b_k),
                            jnp.asarray(b_i), A)
    ours = cagra._bitonic_merge(t(a_k), t(a_i), t(a_v), t(b_k), t(b_i), A)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("width", [1, 2, 3])
def test_select_parents_is_bit_exact(width):
    rng = np.random.default_rng(width)
    nq, A = 11, 24
    bd = np.sort(rng.random((nq, A)).astype(np.float32), axis=1)
    bd[:, -5:] = np.inf
    bi = rng.integers(0, 500, (nq, A)).astype(np.int32)
    bi[np.isinf(bd)] = -1
    bi[:, 3] = -1                                    # a dead finite slot
    vis = rng.random((nq, A)) < 0.6
    vis[0] = True                                    # nothing left
    vis[1, :-2] = True                               # only dead slots left
    ref = jc._select_parents(jnp.asarray(bd), jnp.asarray(bi),
                             jnp.asarray(vis), width)
    ours = cagra._select_parents(t(bd), t(bi), t(vis), width)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_hop_gate_and_merge_window():
    """The gate admits every shape of the conf's search points and the
    build's rounds, and past 256 (itopk 300 and 512, wd 512, the kg-291
    merge, pdim 5000): it refuses only for shared memory, past the opt-in
    maximum; merge_window keeps its accepted values."""
    assert chop.supported_hop(5000, 128, 64, 16)
    assert chop.supported_hop(8192, 96, 64, 16)
    assert chop.supported_hop(1, 24, 32, 16, merge_window=2)
    assert chop.supported_hop(64, 300, 64, 16)
    assert chop.supported_hop(64, 512, 512, 16)
    assert chop.supported_hop(4096, 291, 320, 128)
    assert chop.supported_hop(64, 64, 64, 5000)
    # the merge network (8 bytes an entry), the query, the candidates'
    # keys and ids, and (wd past 32) the dedupe's hash table: 8 bytes a
    # slot, 2 (itopk + wd) rounded up to a power of two
    assert chop.hop_smem_bytes(64, 64, 16) == \
        8 * 128 + 4 * (16 + 128) + 8 * 256
    assert chop.hop_smem_bytes(512, 512, 16) == \
        8 * 1024 + 4 * (16 + 1024) + 8 * 2048
    assert chop.hop_smem_bytes(64, 32, 16) == 8 * 128 + 4 * (16 + 64)
    # itopk 8,192 with wd 8,192 fits since the network's entries packed to
    # 8 bytes (with no room for the table: it dedupes by compare); twice
    # that does not
    assert chop.supported_hop(64, 8192, 8192, 16)
    assert chop.hop_reject_reason(64, 16384, 16384, 16).startswith(
        "shared memory 393280 B above 232448")
    assert chop.hop_reject_reason(64, 64, 64, 60000).startswith(
        "shared memory")
    assert chop.hop_reject_reason(64, 0, 64, 16).startswith("itopk=0")
    assert chop.hop_reject_reason(0, 64, 64, 16).startswith("nq=0")
    assert merge_window_request("auto") == 0
    assert merge_window_request(2) == 2
    with pytest.raises(ValueError, match="merge_window"):
        merge_window_request(-1)


# ---------------------------------------------------------------------------
# walk tables
# ---------------------------------------------------------------------------

def _dyadic(blobs, jax_index, pdim):
    """Data in quarters and a projection in 64ths: every product and sum
    is exact in fp32, so both packages' products agree bit for bit and the
    test sees the packing alone.  (dataset, graph, proj, vecs whose last
    pdim columns are proj)."""
    db = np.round(blobs[0] * 4) / 4
    vecs = np.asarray(jc._calib_vecs(jax_index))
    proj = (np.round(vecs[:, -pdim:] * 64) / 64).astype(np.float32)
    full = np.zeros_like(vecs)
    full[:, -pdim:] = proj
    return db.astype(np.float32), np.asarray(jax_index.graph), proj, full


@pytest.mark.parametrize("pdim", [8, 12])
def test_bf16_walk_table_is_bit_exact(blobs, jax_index, pdim):
    db, g, proj, vecs = _dyadic(blobs, jax_index, pdim)
    ref, _ = jc._build_walk_table(jnp.asarray(db), jnp.asarray(g), pdim,
                                  vecs=jnp.asarray(vecs))
    ours, _ = cagra._build_walk_table(t(db), t(g), pdim, proj=t(proj))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("deg", [0, 8])
def test_int8_walk_table_is_bit_exact(blobs, jax_index, deg):
    db, g, proj, vecs = _dyadic(blobs, jax_index, 8)
    ref, _, rs = jc._build_walk_table_q(jnp.asarray(db), jnp.asarray(g), 8,
                                        deg=deg, vecs=jnp.asarray(vecs))
    ours, _, s = cagra._build_walk_table_q(t(db), t(g), 8, deg=deg,
                                           proj=t(proj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_neighborhood_is_bit_exact(blobs, jax_index, quant):
    db, g, proj, vecs = _dyadic(blobs, jax_index, 8)
    build = jc._build_walk_table_q if quant else jc._build_walk_table
    out = build(jnp.asarray(db), jnp.asarray(g), 8, vecs=jnp.asarray(vecs))
    table, scales = out[0], (out[2] if quant else None)
    deg = g.shape[1]
    unit = jc._quant_unit(8) if quant else 12
    rows = np.asarray(table)[:64, :deg * unit].reshape(32, 2, deg, unit)
    ref = jc._decode_neighborhood(jnp.asarray(rows), 8, deg, quant, scales)
    ours = cagra._decode_neighborhood(
        t(rows), 8, deg, quant, None if scales is None else t(scales))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r).astype(np.float32))
    np.testing.assert_array_equal(ours[2].numpy()[:, 0], g[:64:2])


def test_percentile_matches_jnp():
    """Linear interpolation between the same two order statistics: within
    2e-5 relative of ``jnp.percentile`` (XLA folds the constants of the
    interpolation weight in its own order, which moves the weight by up
    to ~6e-5 of a step)."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 1000, 65537):
        x = rng.normal(size=n).astype(np.float32)
        ref = float(np.asarray(jnp.percentile(jnp.asarray(x), 99.9)))
        ours = float(cagra._percentile(t(x), 99.9))
        assert abs(ours - ref) <= 2e-5 * abs(ref), (n, ours, ref)


def test_calibration_matches_jax(jax_index):
    """The overlap statistics equal JAX's given the same eigenvectors (the
    selections are exact on both sides here), so the calibrated pdim is
    the same; the table-format ladder reads the same byte gate."""
    idx = _carried(jax_index)
    vecs = np.asarray(jc._calib_vecs(jax_index))
    idx._walk_calib_vecs = t(vecs)
    q, pool, sc = jc._calib_sample(jax_index.dataset)
    tq, tpool, tsc = cagra._calib_sample(idx.dataset)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(sc))
    for pdim in (8, 16):
        for quant in (False, True):
            ref = float(jc._calib_overlap(q, pool, sc, jnp.asarray(vecs),
                                          pdim, 10, False, quant=quant))
            ours = cagra._calib_overlap(tq, tpool, tsc, t(vecs), pdim, 10,
                                        False, quant=quant)
            assert abs(ours - ref) <= 1e-6, (pdim, quant, ours, ref)
    assert cagra._auto_pdim(idx) == jc._auto_pdim(jax_index)
    pdim = cagra._auto_pdim(idx)
    assert cagra._search_table_format(idx, pdim) == \
        jc._search_table_format(jax_index, pdim)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def _walk_both(jax_index, cache, q, itopk, width, quant=False, k=10,
               exit_every=cagra._EXIT_CHECK_EVERY):
    rerank = max(min(itopk, max(32, 2 * k)), k)
    max_iter = 10 + itopk // width
    ref = jc._search_impl_walk(
        jax_index.dataset, cache.table, cache.entry_proj, cache.entry_sq,
        cache.entry_ids, cache.proj, jnp.asarray(q), k, itopk, width,
        max_iter, jax_index.metric, rerank, jax_index.graph_degree,
        quant=quant, scales=cache.scales)
    ours = cagra._search_impl_walk(
        t(np.asarray(jax_index.dataset)), t(cache.table),
        t(cache.entry_proj), t(cache.entry_sq), t(cache.entry_ids),
        t(cache.proj), t(q), k, itopk, width, max_iter,
        DistanceType.L2Expanded, rerank, jax_index.graph_degree, quant=quant,
        scales=None if cache.scales is None else t(cache.scales),
        exit_every=exit_every)
    return ours, ref


def _assert_walk_parity(ours, ref):
    """Ids equal on >= 0.99 of slots (the rest at distance ties); exact
    distances within 1e-5 relative (fp32 sums in other orders)."""
    od, oi = (x.numpy() for x in ours)
    rd, ri = (np.asarray(x) for x in ref)
    assert (oi == ri).mean() >= 0.99
    np.testing.assert_allclose(od, rd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("itopk,width", [(16, 1), (32, 1), (32, 2), (64, 1),
                                         (64, 2)])
def test_walk_matches_jax_on_a_carried_index(blobs, jax_index, jax_cache,
                                             itopk, width):
    _, q = blobs
    _assert_walk_parity(*_walk_both(jax_index, jax_cache, q, itopk, width))


def test_quant_walk_matches_jax(monkeypatch):
    """The int8 format, selected by the byte gate (patched in both
    modules) on test_format_ladder's manifold data, where the int8 rung
    passes its fidelity gate."""
    rng = np.random.default_rng(13)
    Z = rng.normal(size=(6040, 6)).astype(np.float32)
    A = rng.normal(size=(6, 32)).astype(np.float32) / np.sqrt(6)
    X = (Z @ A).astype(np.float32)
    db, q = X[:6000], X[6000:]
    jidx = jc.build(JaxResources(seed=0), jc.IndexParams(
        intermediate_graph_degree=32, graph_degree=16), jnp.asarray(db))
    pdim = jc._auto_pdim(jidx) or 16
    q_bytes = jc._table_bytes(jidx.size, jidx.graph_degree,
                              max(pdim - pdim % 2, 8), True)
    monkeypatch.setattr(jc, "_WALK_TABLE_MAX_BYTES", q_bytes)
    monkeypatch.setattr(cagra, "_WALK_TABLE_MAX_BYTES", q_bytes)
    fmt = jc._search_table_format(jidx, pdim)
    assert fmt is not None and fmt[1]
    idx = _carried(jidx)
    idx._walk_calib_vecs = t(jc._calib_vecs(jidx))
    assert cagra._search_table_format(idx, pdim) == fmt
    cache = jc._walk_cache(JaxResources(seed=2), jidx, fmt[0], 256,
                           quant=True)
    _assert_walk_parity(*_walk_both(jidx, cache, q, 32, 1, quant=True))


def test_exit_check_does_not_change_the_result(blobs, jax_index, jax_cache):
    """A fully visited buffer is a fixed point of the hop: checking the
    exit every hop, every 8 hops or never gives identical results."""
    _, q = blobs
    outs = [_walk_both(jax_index, jax_cache, q, 32, 1, exit_every=e)[0]
            for e in (1, 8, 0)]
    for d, i in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(i, outs[0][1])


def test_public_search_on_a_carried_walk_cache(blobs, jax_index):
    """``search`` resolves itopk, max_iterations and rerank as JAX does:
    with the JAX index's projection and entry ids attached, it returns the
    JAX search's result (ids >= 0.99 of slots, distances 1e-5)."""
    _, q = blobs
    sp = jc.SearchParams(itopk_size=32, search_width=2, entry_points=256)
    ref = jc.search(JaxResources(seed=3), sp, jax_index, jnp.asarray(q), 10)
    (pdim, _), = [key for key in jax_index._walk_tables]
    _, proj, _ = jax_index._walk_tables[(pdim, False)]
    _, _, eids = jax_index._walk_entries[(pdim, 256)]
    idx = cagra.attach_walk_cache(_carried(jax_index), np.asarray(proj),
                                  np.asarray(eids))
    ours = cagra.search(DeviceResources(device="cpu"),
                        cagra.SearchParams(**dataclasses.asdict(sp)), idx,
                        q, 10)
    _assert_walk_parity(ours, ref)


def test_self_walk_matches_jax(blobs, jax_index, jax_cache):
    """The build's warm-seeded self-walk on a carried table: candidate ids
    equal on >= 0.99 of slots."""
    db = jax_index.dataset
    ref = np.asarray(jc._self_walk_chunked(
        db, jax_cache.table, jax_cache.proj, 32, 4, 1, jax_index.metric,
        jax_index.graph_degree, chunk=512))
    ours = cagra._self_walk_chunked(
        t(np.asarray(db)), t(jax_cache.table), t(jax_cache.proj), 32, 4, 1,
        DistanceType.L2Expanded, jax_index.graph_degree, chunk=512)
    assert (ours.numpy() == ref).mean() >= 0.99


@pytest.mark.parametrize("with_d", [False, True])
def test_merge_refine_matches_jax(blobs, jax_index, with_d):
    """The rounds' exact rerank: [knn | second] through _rerank_rows, and
    — with the carried keys — the sorted merge on Kernel I's plain
    version.  Ids equal on >= 0.99 of slots, keys within 1e-5 relative."""
    db = np.asarray(jax_index.dataset, np.float32)
    knn = np.asarray(jc.build_knn_graph(JaxResources(seed=0), db, 24))
    rng = np.random.default_rng(5)
    second = rng.integers(-1, db.shape[0], (db.shape[0], 40)).astype(np.int32)
    first, first_d = jc._merge_refine_chunked(
        jnp.asarray(db), jnp.asarray(knn[:, :12]), jnp.asarray(knn[:, 12:]),
        16, False, chunk=512, with_d=True)
    fd = first_d if with_d else None
    ri, rd = jc._merge_refine_chunked(jnp.asarray(db), first,
                                      jnp.asarray(second), 16, False,
                                      chunk=512, first_d=fd, with_d=True)
    oi, od = cagra._merge_refine_chunked(
        t(db), t(first), t(second), 16, False, chunk=512,
        first_d=None if fd is None else t(fd), with_d=True)
    assert (oi.numpy() == np.asarray(ri)).mean() >= 0.99
    np.testing.assert_allclose(od.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_knn(blobs):
    return np.asarray(jc.build_knn_graph(JaxResources(seed=0), blobs[0], 32))


def test_exact_knn_graph_equals_jax_up_to_ties(blobs, jax_knn):
    db, _ = blobs
    ours = cagra.build_knn_graph(DeviceResources(device="cpu"), db,
                                 32).numpy()
    assert ours.shape == jax_knn.shape
    assert not (ours == np.arange(len(db))[:, None]).any()
    d = ((db[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    rows = np.arange(len(db))[:, None]
    # a differing id sits at the same distance (1e-4 of the scale) as
    # the reference's id at that rank
    scale = 1e-4 * (1.0 + d.max())
    assert np.all((ours == jax_knn)
                  | (np.abs(d[rows, ours] - d[rows, jax_knn]) <= scale))


def test_reverse_edges_are_bit_exact(jax_knn):
    n = jax_knn.shape[0]
    fwd = jax_knn[:, :8]
    ref = np.asarray(jc._reverse_edges(jnp.asarray(fwd), n, 8))
    np.testing.assert_array_equal(cagra._reverse_edges(t(fwd), n, 8).numpy(),
                                  ref)
    np.testing.assert_array_equal(cagra._reverse_edges_host(fwd, n, 8), ref)
    np.testing.assert_array_equal(
        cagra._reverse_edges_auto(t(jax_knn), n, 16).numpy(),
        np.asarray(jc._reverse_edges_auto(jnp.asarray(jax_knn), n, 16)))


def test_detour_order_and_prune_are_bit_exact(jax_knn):
    ref = np.asarray(jc._detour_order(jnp.asarray(jax_knn)))
    np.testing.assert_array_equal(
        cagra._detour_order(t(jax_knn), block=300).numpy(), ref)
    res = DeviceResources(device="cpu")
    for deg in (16, 32):
        np.testing.assert_array_equal(
            cagra.prune(res, t(jax_knn), deg).numpy(),
            np.asarray(jc.prune(JaxResources(), jnp.asarray(jax_knn), deg)))


def test_clustered_graph_recall_within_jax(monkeypatch):
    """The clustered pass (``_BRUTE_BUILD_MAX`` patched low in both
    modules) on 6000 manifold rows: graph recall within 0.03 of JAX's."""
    X = _manifold(6000, 32, 8, seed=3)
    monkeypatch.setattr(jc, "_BRUTE_BUILD_MAX", 1000)
    monkeypatch.setattr(cagra, "_BRUTE_BUILD_MAX", 1000)
    deg = 16
    ref = np.asarray(jc.build_knn_graph(JaxResources(seed=0), X, deg))
    ours = cagra.build_knn_graph(DeviceResources(device="cpu"), X,
                                 deg).numpy()
    assert set(cagra.build.stage_seconds) == {
        "calibration", "kmeans", "layout", "scan", "reverse_edges",
        "walk_refine_0", "walk_refine_1"}
    sample = np.arange(0, len(X), 37)
    gt = naive_knn(X, X[sample], deg + 1)[:, 1:]
    r_ref, r_ours = recall(ref[sample], gt), recall(ours[sample], gt)
    assert ours.min() >= 0 and not (ours[sample] == sample[:, None]).any()
    assert r_ours >= r_ref - 0.03, (r_ours, r_ref)


def test_build_and_search_recall_within_jax(blobs):
    """tests/test_cagra.py's blobs, its build (32 -> 16) and a search at
    itopk 32, width 2: recall@10 within 0.03 of JAX's."""
    db, q = blobs
    params = dict(intermediate_graph_degree=32, graph_degree=16)
    sp = dict(itopk_size=32, search_width=2)
    jidx = jc.build(JaxResources(seed=42), jc.IndexParams(**params), db)
    _, ri = jc.search(JaxResources(seed=42), jc.SearchParams(**sp), jidx,
                      jnp.asarray(q), 10)
    res = DeviceResources(seed=42, device="cpu")
    idx = cagra.build(res, cagra.IndexParams(**params), db)
    g = idx.graph.numpy()
    assert g.shape == (len(db), 16) and g.min() >= 0
    _, oi = cagra.search(res, cagra.SearchParams(**sp), idx, q, 10)
    gt = naive_knn(db, q, 10)
    r_ref, r_ours = recall(np.asarray(ri), gt), recall(oi.numpy(), gt)
    assert r_ours >= r_ref - 0.03, (r_ours, r_ref)


def test_params_match_the_reference_fields_and_defaults():
    for ours, ref in ((cagra.IndexParams, jc.IndexParams),
                      (cagra.SearchParams, jc.SearchParams)):
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())


# ---------------------------------------------------------------------------
# paths deferred by earlier slices, now run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    X = _manifold(300, 16, 4, seed=2)
    res = DeviceResources(seed=0, device="cpu")
    idx = cagra.build(res, cagra.IndexParams(intermediate_graph_degree=16,
                                             graph_degree=8), X)
    return res, idx, X


TINY = cagra.IndexParams(intermediate_graph_degree=16, graph_degree=8)


def _reloaded(r, i):
    buf = io.BytesIO()
    cagra.serialize(r, buf, i)
    buf.seek(0)
    return cagra.deserialize(r, buf)


def _saved(r, i, path):
    cagra.save(r, path, i)
    return path


@pytest.mark.parametrize("call,item", [
    (lambda r, i, X, d: cagra.search(r, cagra.SearchParams(), i, X[:2], 5,
                                     filter=np.ones((2, 300), bool)),
     None),
    (lambda r, i, X, d: cagra.serialize(r, io.BytesIO(), i), None),
    (lambda r, i, X, d: _reloaded(r, i), None),
    (lambda r, i, X, d: cagra.save(r, str(d / "x"), i), None),
    (lambda r, i, X, d: cagra.load(r, _saved(r, i, str(d / "x"))), None),
    (lambda r, i, X, d: cagra.delete(r, i, [0]), None),
    (lambda r, i, X, d: cagra.build(r, dataclasses.replace(
        TINY, canary_queries=4), X), None),
    (lambda r, i, X, d: cagra.build(r, TINY, X, checkpoint=str(d / "ckpt")),
     None),
    (lambda r, i, X, d: cagra.build(r, TINY, X, resume=True), None),
    (lambda r, i, X, d: cagra.search(r, cagra.SearchParams(walk_pdim=0), i,
                                     X[:2], 5), "CAGRA direct walk"),
    (lambda r, i, X, d: cagra.search(r, cagra.SearchParams(itopk_size=300),
                                     i, X[:2], 5), "CAGRA wide hops")])
def test_deferred_paths_raise(tiny, tmp_path, call, item):
    """Every path an earlier slice deferred completes: persistence,
    filters and delete (item None), the direct walk and hops past 256
    (``item`` names the ROADMAP label they shipped under).  A search
    returns (distances, ids) of (2, 5)."""
    res, idx, X = tiny
    out = call(res, idx, X, tmp_path)
    assert out is None or isinstance(out, (cagra.Index, tuple))
    if item is not None:
        d, i = out
        assert d.shape == i.shape == (2, 5)
        assert bool(torch.isfinite(d).all()) and bool((i >= 0).all())


def test_wide_build_hops_raise_before_the_walk(monkeypatch):
    """A clustered build whose refinement merge runs at itopk = degree + 1
    = 291 > 256 completes through every stage, the walk rounds included."""
    monkeypatch.setattr(cagra, "_BRUTE_BUILD_MAX", 100)
    X = _manifold(400, 32, 4, seed=6)
    idx = cagra.build(DeviceResources(device="cpu"), cagra.IndexParams(
        intermediate_graph_degree=290, graph_degree=8,
        build_proj_dim=8), X)
    assert idx.graph.shape == (400, 8) and int(idx.graph.min()) >= 0
    stages = cagra.build.stage_seconds
    assert "kmeans" in stages and "walk_refine_1" in stages


def test_deep_regime_and_no_table_raise(tiny, monkeypatch):
    """The deep regime builds (its stages: the reverse merge, then the
    walk rounds), and a search with no table format that fits takes the
    direct walk, each query's own row first at distance 0."""
    res, idx, X = tiny
    monkeypatch.setattr(cagra, "_BRUTE_BUILD_MAX", 100)
    monkeypatch.setattr(cagra, "_DEEP_SCALE_ROWS", 200)
    deep = cagra.build(res, cagra.IndexParams(intermediate_graph_degree=16,
                                              graph_degree=8,
                                              build_proj_dim=8), X)
    assert deep.graph.shape == (300, 8)
    assert "reverse_merge" in cagra.build.stage_seconds
    assert "walk_refine_1" in cagra.build.stage_seconds
    assert cagra.build.deep_plans == [(17, 8, True)] * 2
    monkeypatch.setattr(cagra, "_WALK_TABLE_MAX_BYTES", 1)
    fresh = cagra.Index(dataset=idx.dataset, graph=idx.graph)
    d, i = cagra.search(res, cagra.SearchParams(), fresh, X[:2], 5)
    assert not getattr(fresh, "_walk_tables", {})
    np.testing.assert_array_equal(i[:, 0].numpy(), [0, 1])
    assert float(d[:, 0].abs().max()) < 1e-4


def test_merge_refine_debug_checks(monkeypatch):
    """With ``_DEBUG_CHECKS`` on, the sorted merge's precondition (first
    rows sorted by key and duplicate-free) is checked on the host."""
    from raft_tpu_torch import LogicError

    monkeypatch.setattr(cagra, "_DEBUG_CHECKS", True)
    rng = np.random.default_rng(5)
    xf = t(rng.normal(size=(32, 8)).astype(np.float32))
    first = torch.arange(4, dtype=torch.int32).repeat(32, 1)
    first_d = torch.arange(4, dtype=torch.float32).repeat(32, 1)
    second = t(rng.integers(0, 32, size=(32, 4)).astype(np.int32))
    out, _ = cagra._merge_refine_chunked(xf, first, second, 4, False,
                                         first_d=first_d, with_d=True)
    assert out.shape == (32, 4)
    bad = first_d.clone()
    bad[3, 0] = 99.0
    with pytest.raises(LogicError, match="sorted"):
        cagra._merge_refine_chunked(xf, first, second, 4, False,
                                    first_d=bad)
    dup = first.clone()
    dup[2, 1] = dup[2, 0]
    with pytest.raises(LogicError, match="duplicate-free"):
        cagra._merge_refine_chunked(xf, dup, second, 4, False,
                                    first_d=first_d)

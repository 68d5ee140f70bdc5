"""Kernel I's walk route (``ops/cagra_walk``) against raft_tpu, on the CPU.

The plain walk (``cagra_walk_plain``: per hop ``select_parents`` →
``expand`` → ``cagra_hop_plain``) is what the walk kernel equals bit for
bit on the card (``tests/test_torch_cuda.py``).  Here it is held to the
JAX walk on a ``raft_tpu``-built index carried across with its walk cache,
in both table formats; to the JAX walk's pieces hop for hop on buffers
with dead and +inf slots; its per-query exit to the fixed hop count; and
the kernel's gate to Kernel I's hop gate.  Every tolerance is stated where
it is checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import cagra as jc
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import cagra_hop as chop
from raft_tpu_torch.ops import cagra_walk as cw


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small torch ops slow ~100x when torch's intra-op pool
    oversubscribes the cores under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    """numpy (or a jax array) -> CPU tensor; bf16 through float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


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
def caches(jax_index):
    """The JAX index's walk caches (512 entry points), bf16 and int8, each
    at the calibrated pdim."""
    pdim = jc._auto_pdim(jax_index)
    assert pdim % 2 == 0
    return {quant: jc._walk_cache(JaxResources(seed=1), jax_index, pdim, 512,
                                  quant=quant)
            for quant in (False, True)}


def _walk_inputs(cache, q, itopk):
    """The port's seeded walk inputs over a carried cache: (qp_t, q_sq,
    table, buf_d, buf_i, visited, scales)."""
    scales = None if cache.scales is None else t(cache.scales)
    quant = scales is not None
    q_sq, qp, qp_t = cagra._query_side(t(q).float(), t(cache.proj), quant,
                                       scales)
    seeded = cagra._seed_walk(qp, q_sq, t(cache.entry_proj),
                              t(cache.entry_sq), t(cache.entry_ids), itopk,
                              False)
    return (qp_t, q_sq, t(cache.table)) + seeded + (scales,)


# ---------------------------------------------------------------------------
# the plain walk against the JAX walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_plain_walk_matches_jax_walk(blobs, jax_index, caches, quant, width):
    """At k = rerank = itopk the result is the walk's whole buffer, re-scored
    exactly and sorted: ids equal on >= 0.99 of slots (the rest at distance
    ties or at a bf16 rounding the two products' summation orders flip),
    exact distances within 1e-5 relative (fp32 sums in other orders)."""
    _, q = blobs
    cache = caches[quant]
    itopk = 32
    max_iter = 10 + itopk // width
    args = (cache.table, cache.entry_proj, cache.entry_sq, cache.entry_ids,
            cache.proj)
    ref = jc._search_impl_walk(
        jax_index.dataset, *args, jnp.asarray(q), itopk, itopk, width,
        max_iter, jax_index.metric, itopk, jax_index.graph_degree,
        quant=quant, scales=cache.scales)
    ours = cagra._search_impl_walk(
        t(jax_index.dataset), *(t(a) for a in args), t(q), itopk, itopk,
        width, max_iter, DistanceType.L2Expanded, itopk,
        jax_index.graph_degree, quant=quant,
        scales=None if cache.scales is None else t(cache.scales))
    od, oi = (x.numpy() for x in ours)
    rd, ri = (np.asarray(x) for x in ref)
    assert (oi == ri).mean() >= 0.99
    np.testing.assert_allclose(od, rd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_exit_every_gives_identical_buffers(blobs, caches, quant):
    """The all(visited) exit checked every hop, every 8 hops or never:
    identical buffers and hop counts (a fully visited buffer is a fixed
    point of the hop), every query's walk ending before the hop cap."""
    _, q = blobs
    *args, scales = _walk_inputs(caches[quant], q, 24)
    outs = [cw.cagra_walk_plain(*args, deg=16, search_width=2,
                                max_iterations=120, ip_metric=False,
                                quant=quant, scales=scales, exit_every=e,
                                return_hops=True)
            for e in (1, 8, 0)]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
    hops = outs[0][3]
    assert bool((hops > 0).all()) and bool((hops < 120).all())
    assert bool(outs[0][2].all())


def _jax_pieces_walk(table, qp_t, q_sq, buf_d, buf_i, vis, deg, pdim, width,
                     iters, quant, scales):
    """The reference walk hop by hop from the JAX package's pieces:
    ``_select_parents``, the fat-row gather and ``_decode_neighborhood``,
    the keys of Kernel I's plain version (``hop_keys``, the summation order
    both routes share) and ``_merge_candidates``."""
    unit = jc._quant_unit(pdim) if quant else pdim + 4
    jt = jnp.asarray(table)
    bd, bi, bv = (jnp.asarray(x) for x in (buf_d, buf_i, vis))
    nq = bd.shape[0]
    for _ in range(iters):
        sel, ok, bv = jc._select_parents(bd, bi, bv, width)
        rows = jt[jnp.where(ok, sel, 0)][..., :deg * unit].reshape(
            nq, width, deg, unit)
        nb_p, nb_sq, nb_id = jc._decode_neighborhood(
            rows, pdim, deg, quant, None if scales is None
            else jnp.asarray(scales))
        nb_id = jnp.where(ok[:, :, None], nb_id, -1)
        key, ids = chop.hop_keys(
            qp_t, q_sq, t(nb_p).reshape(nq, width * deg, pdim),
            t(nb_sq).reshape(nq, width * deg),
            t(nb_id).reshape(nq, width * deg), False)
        bd, bi, bv = jc._merge_candidates(bd, bi, bv, jnp.asarray(key),
                                          jnp.asarray(ids), bd.shape[1])
    return bd, bi, bv


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_dead_parents_and_the_last_slot_clamp(blobs, caches, quant, width):
    """Buffers with every slot visited, one unvisited slot left (width > 1
    consumes it, then clamps to slot itopk - 1 with a dead parent), a dead
    finite slot, a +inf tail, and nothing alive at all: the plain walk
    equals the JAX pieces' walk bit for bit, hop for hop."""
    _, q = blobs
    qp_t, q_sq, table, bd, bi, bv, scales = _walk_inputs(caches[quant],
                                                         q[:8], 24)
    bd, bi, bv = bd.clone(), bi.clone(), bv.clone()
    bv[0] = True                                   # all visited
    bv[1, :] = True
    bv[1, 5] = False                               # one slot left
    bi[2, 0] = -1                                  # a dead finite slot
    bd[3, -8:] = float("inf")                      # a +inf tail
    bi[3, -8:] = -1
    bd[4] = float("inf")                           # nothing alive
    bi[4] = -1
    bv[5, :-1] = True                              # only the last slot
    pdim = qp_t.shape[1]
    iters = 6
    ours = cw.cagra_walk_plain(qp_t, q_sq, table, bd, bi, bv, deg=16,
                               search_width=width, max_iterations=iters,
                               ip_metric=False, quant=quant, scales=scales,
                               exit_every=0)
    ref = _jax_pieces_walk(table, qp_t, q_sq, bd, bi, bv, 16, pdim, width,
                           iters, quant, scales)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert torch.equal(ours[0][0], bd[0]) and torch.equal(ours[1][0], bi[0])
    # a dead buffer consumes one slot per parent until it is all visited
    assert bool((ours[1][4] == -1).all())
    assert int(ours[2][4].sum()) == min(iters * width, 24)


# ---------------------------------------------------------------------------
# the gate and the shared-memory formula
# ---------------------------------------------------------------------------

def test_walk_gate_admits_every_hop_shape():
    """Every shape Kernel I's hop gate admits, the walk gate admits (bf16
    any pdim, int8 even pdim), staged or, where the fat rows do not fit,
    from the table."""
    for nq in (1, 5000, 2 ** 31 - 1):
        for itopk in (1, 24, 64, 65, 96, 128, 256):
            for width, deg in ((1, 16), (1, 32), (2, 32), (1, 64), (4, 64),
                               (1, 96), (3, 85), (8, 32), (256, 1)):
                for pdim in (1, 8, 13, 16, 128, 1024, 4096):
                    if chop.hop_reject_reason(nq, itopk, width * deg, pdim):
                        continue
                    assert cw.walk_reject_reason(nq, itopk, width, deg,
                                                 pdim) == ""
                    if pdim % 2 == 0:
                        assert cw.supported_walk(nq, itopk, width, deg, pdim,
                                                 quant=True)
                    staged = cw.walk_staged(itopk, width, deg, pdim)
                    assert cw.walk_smem_bytes(itopk, width, deg, pdim,
                                              staged=staged) <= cw.SMEM_MAX


def test_walk_smem_formula_and_refusals():
    # the search shape: 2 fat rows of 32 x 20 lanes, the dedupe's hash
    # table (64 candidates: 256 slots of 8 bytes), the merge network of
    # 128 entries of 8 bytes, then the query, the 64 candidates' keys and
    # ids, 2 parents, the flag
    assert cw.walk_smem_bytes(64, 2, 32, 16) == \
        2 * 640 * 2 + 8 * 256 + 8 * 128 + 4 * (16 + 2 * 64 + 2 * 2 + 1)
    # int8, pdim 16: 11 lanes a neighbor, a row rounded to 16 bytes; 30
    # candidates dedupe by compare, with no table
    assert cw.walk_smem_bytes(32, 1, 30, 16, quant=True) == \
        336 * 2 + 8 * 64 + 4 * (16 + 2 * 30 + 2 + 1)
    assert cw.walk_smem_bytes(64, 2, 32, 16, staged=False) == \
        8 * 256 + 8 * 128 + 4 * (16 + 2 * 64 + 2 * 2 + 1)
    assert cw.walk_staged(96, 1, 64, 16)
    assert not cw.walk_staged(256, 4, 64, 4096)
    # past 256: the walk gate refuses only for shared memory
    for itopk, width, deg in ((300, 1, 32), (512, 1, 32), (256, 8, 64),
                              (1024, 16, 64)):
        assert cw.walk_reject_reason(64, itopk, width, deg, 16) == ""
        assert cw.walk_exact_reject_reason(64, itopk, width, deg, 96) == ""
    assert cw.walk_reject_reason(64, 64, 1, 32, 5000) == ""
    assert cw.walk_reject_reason(64, 16384, 16, 512, 16).startswith(
        "shared memory")
    assert cw.walk_exact_reject_reason(64, 64, 1, 32, 60000).startswith(
        "shared memory")
    # the exact source: the 64 candidates' staged rows (dim 96 padded to
    # 100 f32, an odd count of 16-byte units), the hash table, the
    # query's fp32 row and the merge network
    assert cw.exact_stride(96) == 100 and cw.exact_stride(128) == 132
    assert cw.exact_stride(13) == 20 and cw.exact_stride(4) == 4
    assert cw.walk_exact_staged(64, 2, 32, 96)
    assert cw.walk_exact_smem_bytes(64, 2, 32, 96) == \
        64 * 100 * 4 + 8 * 256 + 8 * 128 + 4 * (96 + 2 * 64 + 2 * 2 + 1)
    # rows past shared memory are read from device memory, unstaged
    assert not cw.walk_exact_staged(64, 2, 32, 1000)
    assert cw.walk_exact_smem_bytes(64, 2, 32, 1000) == \
        8 * 256 + 8 * 128 + 4 * (1000 + 2 * 64 + 2 * 2 + 1)
    assert cw.walk_reject_reason(64, 64, 1, 32, 13, quant=True).startswith(
        "pdim=13 odd")
    assert cw.walk_reject_reason(64, 64, 0, 32, 16).startswith(
        "search_width=0")
    assert cw.walk_reject_reason(0, 64, 1, 32, 16).startswith("nq=0")


# the parent design's shared-memory formulas (before the hash table, the
# staged exact rows and the dedupe's scratch in the merge network), copied
# here so that the gates can be held to them
def _parent_walk_smem(itopk, width, deg, pdim, quant, staged):
    wd = width * deg
    stage = 0
    if staged:
        stage = width * (-(-(deg * cw.walk_unit(pdim, quant)) // 8) * 8) * 2
    return stage + 4 * (pdim + 3 * chop.hop_pow2(itopk + wd) + 3 * wd
                        + 2 * width + 1)


def _parent_walk_admits(itopk, width, deg, pdim, quant):
    if quant and pdim % 2:
        return False
    staged = _parent_walk_smem(itopk, width, deg, pdim, quant,
                               True) <= cw.SMEM_MAX
    return _parent_walk_smem(itopk, width, deg, pdim, quant,
                             staged) <= cw.SMEM_MAX


def _parent_hop_smem(itopk, wd, pdim):
    return 4 * (pdim + 2 * wd + 3 * chop.hop_pow2(itopk + wd))


ADMISSION_GRID = [
    (itopk, width, deg, pdim)
    for itopk in (1, 24, 64, 65, 96, 128, 256, 300, 512, 1024, 2048, 4096,
                  8192, 12000, 16000)
    for width, deg in ((1, 16), (1, 32), (2, 32), (1, 64), (4, 64), (1, 96),
                       (3, 85), (8, 32), (256, 1), (16, 32), (8, 64),
                       (16, 64), (16, 512))
    for pdim in (1, 8, 13, 16, 96, 128, 1024, 4096, 20000)]


def test_every_shape_the_parent_admitted_is_still_admitted():
    """The gates of the walk (bf16 and int8 tables), the exact-row source
    and the hop kernel admit every shape the parent design's formulas
    admitted — the hop gate's grid, the walks past 256 and the exact-row
    shapes, up to and past shared memory — and the table is added only
    where it fits."""
    admitted = 0
    for itopk, width, deg, pdim in ADMISSION_GRID:
        wd = width * deg
        for quant in (False, True):
            if _parent_walk_admits(itopk, width, deg, pdim, quant):
                admitted += 1
                assert cw.walk_reject_reason(5000, itopk, width, deg, pdim,
                                             quant) == ""
        if _parent_walk_smem(itopk, width, deg, pdim, False,
                             False) <= cw.SMEM_MAX:
            assert cw.walk_exact_reject_reason(5000, itopk, width, deg,
                                               pdim) == ""
            assert cw.walk_exact_smem_bytes(itopk, width, deg,
                                            pdim) <= cw.SMEM_MAX
        if _parent_hop_smem(itopk, wd, pdim) <= chop.SMEM_MAX:
            assert chop.hop_reject_reason(5000, itopk, wd, pdim) == ""
            assert chop.hop_smem_bytes(itopk, wd, pdim) <= chop.SMEM_MAX
    # the grid reaches past shared memory on both sides
    assert 0 < admitted < 2 * len(ADMISSION_GRID)


def _home_slot(ids, slots):
    """``csrc/hop_merge.cuh home_slot``: the slot where probing for an id
    (an int or an int array) starts in a table of ``slots``,
    ``(id * 0x9E3779B1 mod 2^32) >> (32 - log2 slots)``."""
    return ((ids * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - (slots.bit_length()
                                                        - 1))


def _hashed_keep(buf_i, cand_i):
    """The hash dedupe of ``csrc/hop_merge.cuh``, slot for slot, on one
    query: the table's size and home slots of ``cagra_hop`` (the ones its
    gate sizes), linear probing, the buffer's ids tagged 0 then candidate
    j's tagged j + 1 (an id already there keeps the smaller tag); j lives
    iff its id's slot ends with tag j + 1.  Inserting one by one gives the
    parallel inserts' result: each id takes one slot and the smallest tag.
    Also returns the longest probe."""
    slots = chop.hash_slots(len(buf_i), len(cand_i))
    table = [None] * slots
    longest = 0

    def insert(i, tag):
        nonlocal longest
        s = _home_slot(int(i), slots)
        for probe in range(slots):
            if table[s] is None:
                table[s] = [int(i), tag]
                break
            if table[s][0] == i:
                table[s][1] = min(table[s][1], tag)
                break
            s = (s + 1) % slots
        else:
            raise AssertionError("the table filled up")
        longest = max(longest, probe)
        return s

    for b in buf_i:
        if b >= 0:
            insert(b, 0)
    where = [insert(c, j + 1) if c >= 0 else -1
             for j, c in enumerate(cand_i)]
    return (np.array([s >= 0 and table[s][1] == j + 1
                      for j, s in enumerate(where)]), longest)


def _merge_keep(buf_i, cand_i):
    """Which candidates ``merge_candidates`` keeps: candidate j keyed j,
    under a buffer keyed 1e6 + slot, merged to wd slots — the live
    candidates come first, in order."""
    itopk, wd = len(buf_i), len(cand_i)
    bd = torch.arange(itopk, dtype=torch.float32)[None] + 1e6
    cd = torch.arange(wd, dtype=torch.float32)[None]
    out_d, _, _ = chop.merge_candidates(
        bd, torch.tensor(buf_i, dtype=torch.int32)[None],
        torch.zeros(1, itopk, dtype=torch.bool), cd,
        torch.tensor(cand_i, dtype=torch.int32)[None], wd)
    keep = np.zeros(wd, bool)
    keep[[int(k) for k in out_d[0] if k < 1e6]] = True
    return keep


def _colliding(slots, n, start=0):
    """n ids >= start with one home slot in a table of ``slots``."""
    home, out, i = None, [], start
    while len(out) < n:
        h = _home_slot(i, slots)
        if home is None:
            home = h
        if h == home:
            out.append(i)
        i += 1
    return out


def test_hash_table_size_and_home_slots():
    """The table the gates size holds at least twice the ids a hop puts in
    it, a power of two, and every home slot lies in it."""
    for itopk, wd in ((64, 64), (512, 32), (256, 512), (65, 96), (1, 33),
                      (300, 2048)):
        slots = chop.hash_slots(itopk, wd)
        assert slots >= 2 * (itopk + wd) and slots & (slots - 1) == 0
        assert slots < 4 * (itopk + wd)
        h = _home_slot(np.arange(0, 2 ** 31 - 1, 9973, dtype=np.int64),
                       slots)
        assert h.min() >= 0 and h.max() < slots
    assert _home_slot(1, 256) == 0x9E3779B1 >> 24


@pytest.mark.parametrize("case", [
    "one id", "all buffered", "colliding", "multiples of the size",
    "negative ids", "fullest", "random"])
def test_hashed_dedupe_model_matches_merge_candidates(case):
    """The hash dedupe's model keeps exactly the candidates
    ``merge_candidates`` keeps, on inputs chosen against it."""
    rng = np.random.default_rng(7)
    itopk, wd = 64, 64
    buf = rng.choice(10 ** 6, itopk, replace=False)
    if case == "one id":
        cand = np.full(wd, 777)
    elif case == "all buffered":
        cand = rng.choice(buf, wd)
    elif case == "colliding":
        slots = chop.hash_slots(itopk, wd)
        ids = _colliding(slots, 40, 5)
        buf = np.array(ids[:20] + list(rng.choice(10 ** 6, itopk - 20,
                                                  replace=False) + 10 ** 6))
        cand = np.array(ids[10:40] + ids[10:40] + [ids[0]] * 4)
    elif case == "multiples of the size":
        slots = chop.hash_slots(itopk, wd)
        buf = np.arange(itopk) * slots
        cand = (np.arange(wd) % 48) * slots + slots * 40
    elif case == "negative ids":
        buf[::3] = -1
        cand = rng.choice(np.concatenate([buf, [-1] * 20, [5, 6, 7]]), wd)
    elif case == "fullest":
        # itopk + wd distinct live ids, all one home slot: the table at
        # its highest load (half of 2 (itopk + wd) slots, rounded to a
        # power of two) with one probe chain through all of them
        itopk, wd = 96, 32
        ids = _colliding(chop.hash_slots(itopk, wd), itopk + wd)
        buf = np.array(ids[:itopk])
        cand = np.array(ids[itopk:])
    else:
        itopk, wd = 512, 32
        buf = rng.choice(4000, itopk, replace=False)
        cand = rng.integers(-1, 4000, wd)
    keep, longest = _hashed_keep(buf, cand)
    np.testing.assert_array_equal(keep, _merge_keep(buf, cand))
    if case == "fullest":
        assert chop.hash_slots(itopk, wd) == 2 * (itopk + wd)
        assert keep.all() and longest == itopk + wd - 1


def _sort_key(key, j):
    """``hop_merge::sort_key``: (key, j) in 64 bits, key bits mapped to an
    unsigned order with -0 read as +0."""
    u = int(np.array(np.float32(key) + np.float32(0.0),
                     np.float32).view(np.uint32))
    o = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (o << 32) | j


def test_sort_rank_is_the_counting_rank():
    """The hash route's rank (a sort of the packed (key, j)) places every
    candidate where the counting rank does, on keys with ties, -0 and +0,
    negatives (InnerProduct) and +inf (dead)."""
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        rng.choice(np.float32([-2.5, -0.0, 0.0, 1.0, 3.0, np.inf]), 40),
        rng.normal(size=24).astype(np.float32)]).astype(np.float32)
    rng.shuffle(keys)
    wd = len(keys)
    count = [sum(1 for i in range(wd) if keys[i] < keys[j]
                 or (keys[i] == keys[j] and i < j)) for j in range(wd)]
    order = sorted(range(wd), key=lambda j: _sort_key(keys[j], j))
    assert [order.index(j) for j in range(wd)] == count


def test_plain_walk_checks_its_inputs(blobs, caches):
    _, q = blobs
    qp_t, q_sq, table, bd, bi, bv, _ = _walk_inputs(caches[False], q[:4], 24)
    kw = dict(deg=16, search_width=1, max_iterations=2, ip_metric=False)
    from raft_tpu_torch import LogicError

    with pytest.raises(LogicError, match="narrower"):
        cw.cagra_walk(qp_t, q_sq, table[:, :100], bd, bi, bv, **kw)
    with pytest.raises(LogicError, match="3 scales"):
        cw.cagra_walk(qp_t, q_sq, table, bd, bi, bv, quant=True, **kw)
    with pytest.raises(LogicError, match="shape mismatch"):
        cw.cagra_walk(qp_t, q_sq[:2], table, bd, bi, bv, **kw)


# ---------------------------------------------------------------------------
# the callers: one walk call per walk, the helpers where they were
# ---------------------------------------------------------------------------

def test_moved_helpers_keep_their_private_names():
    assert cagra._select_parents is cw.select_parents
    assert cagra._expand is cw.expand
    assert cagra._decode_neighborhood is cw.decode_neighborhood
    assert cagra._quant_unit is cw.quant_unit
    assert cagra._merge_candidates is chop.merge_candidates


class _Calls:
    """Stands in for an ops module in ``neighbors.cagra``, counting each
    function's calls and passing them on."""

    def __init__(self, real):
        self.real, self.calls = real, {}

    def __getattr__(self, name):
        fn = getattr(self.real, name)
        if not callable(fn) or name.startswith("__"):
            return fn

        def counted(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)

        return counted


def test_search_and_self_walk_call_the_walk_once_each(blobs, jax_index,
                                                      monkeypatch):
    """``search`` makes one ``cagra_walk`` call and no hop call; the
    build's self-walk one per chunk of nodes."""
    db, q = blobs
    walk, hop = _Calls(cw), _Calls(chop)
    monkeypatch.setattr(cagra, "_walk", walk)
    monkeypatch.setattr(cagra, "_hop", hop)
    idx = cagra.index_from_numpy(np.asarray(jax_index.dataset),
                                 np.asarray(jax_index.graph),
                                 int(jax_index.metric), device="cpu")
    cagra.search(DeviceResources(device="cpu"),
                 cagra.SearchParams(itopk_size=32, search_width=2,
                                    entry_points=256), idx, q[:5], 10)
    assert walk.calls.get("cagra_walk") == 1
    assert "cagra_hop" not in hop.calls
    (pdim, quant), = list(idx._walk_tables)
    table, proj, _ = idx._walk_tables[(pdim, quant)]
    cagra._self_walk_chunked(t(db[:1000]), table, proj, 32, 2, 1,
                             DistanceType.L2Expanded, 16, chunk=256)
    assert walk.calls["cagra_walk"] == 1 + 4
    assert "cagra_hop" not in hop.calls


def test_public_search_equals_the_plain_walk_search(blobs, jax_index):
    """``search`` on a carried walk cache equals ``_search_impl_walk``
    driven with the plain walk's exit checked every hop (the same
    buffers, so the same result bit for bit)."""
    _, q = blobs
    sp = cagra.SearchParams(itopk_size=32, search_width=2, entry_points=256)
    idx = cagra.index_from_numpy(np.asarray(jax_index.dataset),
                                 np.asarray(jax_index.graph),
                                 int(jax_index.metric), device="cpu")
    d, i = cagra.search(DeviceResources(device="cpu"), sp, idx, q, 10)
    (pdim, quant), = list(idx._walk_tables)
    cache = cagra._walk_cache(None, idx, pdim, 256, quant=quant)
    d2, i2 = cagra._search_impl_walk(
        idx.dataset, cache.table, cache.entry_proj, cache.entry_sq,
        cache.entry_ids, cache.proj, t(q), 10, 32, 2, 10 + 32 // 2,
        DistanceType.L2Expanded, 32, idx.graph_degree, quant=quant,
        scales=cache.scales, exit_every=1)
    assert torch.equal(d, d2) and torch.equal(i, i2)

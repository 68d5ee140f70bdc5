"""The pair-group pass of Kernels F and G (``csrc/pair_list_scan.cu``) in
raft_tpu_torch, on the CPU.

The kernel runs on the card only; here its gate, its shared-memory
layout (``pair_scan.pair_list_layout``, the one copy of the formula the
kernel reads) and the route ``ivf_flat_scan`` / ``ivf_pq_scan_recon``
take at each kt are checked, and its plain version — the grouped
schedule on the pass's groups of 64 or 32 pairs (``flat_list_scan_plain``
for F, ``grouped_pair_topk`` for G: each group's pairs against its list,
their top kt scattered by ``slot_pairs``) — is held:

- to the JAX package's grouped Pallas scans ``grouped_flat_l2_scan`` and
  ``grouped_l2_scan`` (interpreted, on groups of 128 as the JAX package
  makes them), at kt 65-128, with exact ties (duplicated rows in a list),
  unfiltered and with ``adm_words`` (``group_admission_words``) at 5% and
  50%: per pair, values within 1e-5 of ‖q‖² + max ‖x‖² (F) or 1e-4 (G),
  the same exhausted slots, ids equal but at distance ties;
- to the query-major plain versions at kt up to 256: the same ids and
  values within 1e-6 of that scale (a product batched otherwise may round
  its last bit);

and the row-10 variants' plain version on the same grouped schedule
(``pair_scan_variant_grouped_plain``) to ``pair_scan_variant_plain``,
which ``test_torch_profiles.py`` holds to the JAX ``run_var``.  Inputs are
numpy draws from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.ops import pq_group_scan_pallas as pqp
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped, ivf_flat
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_group_scan as pgs
from raft_tpu_torch.profiles import pair_list_decomp, pair_list_turns

LIMIT = 232_448                      # an H100 block's dynamic shared memory


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test, as the other port test files:
    a parallel test run otherwise oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the gate, the layout and the routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kt,route", [(1, "list"), (64, "list"),
                                      (65, "pair"), (128, "pair"),
                                      (256, "pair"), (257, "query")])
def test_routes_by_kt_name_their_reason(kt, route):
    """kt up to 64 takes the list-major passes, 65 to 256 the pair-group
    pass, past 256 the query-major kernels, for F and G alike; each route
    past the first names the refusals before it."""
    f_route, f_why = ps.flat_scan_route(416, 128, kt)
    g_route, g_why = ps.recon_scan_route(128, kt)
    assert f_route == g_route == route
    if route == "list":
        assert f_why == g_why == ""
    else:
        assert "outside 1..64 (the list-major route)" in f_why
        assert "outside 1..64 (the list-major route)" in g_why
    if route == "query":
        assert "outside 1..256 (the pair-group route)" in f_why
        assert "outside 1..256 (the pair-group route)" in g_why


@pytest.mark.parametrize("dim", [1, 3, 25, 50, 96, 127, 128, 129, 512, 1024])
@pytest.mark.parametrize("kt", [65, 100, 128, 129, 200, 256])
def test_flat_gate_takes_every_width(dim, kt):
    """Kernel F's pair-group pass takes every row width from 1 to 1,024
    and every kt from 65 to 256, at any capacity (shared memory does not
    grow with it) and super-tile factor up to 8."""
    for rows, sub in ((416, 1), (60_000, 1), (832, 2), (768, 8)):
        assert not ps.flat_pair_list_reject_reason(rows, dim, kt, sub)
        assert ps.flat_scan_route(rows, dim, kt, sub)[0] == "pair"
    # where the query-major kernel refuses the capacity
    assert "shared memory" in ps.pair_scan_reject_reason(60_000, dim, kt, 4)


def test_gates_name_their_refusals():
    """A width past 1,024 (or, for G, off a multiple of 8), kt 0 or 257,
    and a tile that F equal sub-lists cannot split each name their
    reason."""
    assert "outside 1..1024" in ps.flat_pair_list_reject_reason(416, 1025, 100)
    assert "outside 1..1024" in ps.flat_pair_list_reject_reason(416, 0, 100)
    assert "outside 1..256" in ps.flat_pair_list_reject_reason(416, 128, 257)
    assert "outside 1..256" in ps.flat_pair_list_reject_reason(416, 128, 0)
    assert "sub-lists" in ps.flat_pair_list_reject_reason(100, 128, 70, 3)
    assert "sub-lists" in ps.flat_pair_list_reject_reason(1600, 128, 70, 16)
    assert "multiple of 8" in ps.recon_pair_list_reject_reason(100, 100)
    assert "outside 1..1024" in ps.recon_pair_list_reject_reason(1032, 100)
    assert "outside 1..256" in ps.recon_pair_list_reject_reason(128, 300)
    for rot in (8, 24, 96, 128, 136, 256, 1024):
        for kt in (65, 128, 256):
            assert not ps.recon_pair_list_reject_reason(rot, kt)
    # past both grouped routes: the query-major kernels and their own gates
    route, why = ps.flat_scan_route(416, 1025, 100)
    assert route == "query" and "outside 1..1024" in why


def test_the_layout_reports_a_shape_past_shared_memory():
    """At 64 pairs a group (an explicit ``group``) a kt-256 scan at dim 128
    needs more than the card holds: the layout raises, naming the bytes,
    while the gate admits the shape (at 32 pairs a group).  At 32 every
    shape the gates admit fits, resident or not, which is why the layout
    tries no smaller group; an explicit 16 is taken, a size the kernel
    does not take is refused."""
    need = ps._pair_layout(128, 256, True, True, 64, False).total
    assert need > LIMIT
    with pytest.raises(LogicError, match=f"need {need} B of shared memory"):
        ps.pair_list_layout(128, 256, True, group=64)
    assert not ps.flat_pair_list_reject_reason(416, 128, 256)
    assert ps.flat_scan_route(416, 128, 256)[0] == "pair"
    assert ps.pair_list_layout(128, 256, True).group == 32
    for fp32, widths in ((True, range(1, 1025)), (False, range(8, 1025, 8))):
        for width in widths:
            for extract in (True, False):
                assert ps._pair_layout(width, 256, fp32, extract, 32,
                                       False).total <= LIMIT
    assert ps.pair_list_layout(128, 100, True, group=16).group == 16
    assert ps.pair_list_layout(128, 100, False, group=32).group == 32
    with pytest.raises(LogicError, match="not one of 64, 32, 16"):
        ps.pair_list_layout(128, 100, True, group=48)


@pytest.mark.parametrize("fp32", [True, False], ids=["F", "G"])
@pytest.mark.parametrize("width", [8, 24, 96, 128, 256, 1024])
@pytest.mark.parametrize("kt", [1, 10, 64, 65, 100, 128, 129, 256])
@pytest.mark.parametrize("extract", [True, False])
def test_layout_fits_the_card(fp32, width, kt, extract):
    """``pair_list_layout`` at every width and kt: within 232,448 B, the
    offsets ascending, the operands on 1024-byte atoms, a pair's kept
    entries a power of two from 32 holding kt, its buffer 32 or 64
    entries; 64 pairs a group up to kt 128, 32 past it (at dim 128); F's
    queries resident where they fit at that group size, G's residuals up
    to 128 dims; the raw variant keeps nothing."""
    lay = ps.pair_list_layout(width, kt, fp32, extract)
    assert lay is not None and lay.total <= LIMIT
    offsets = [lay.a, lay.b, lay.op, lay.key, lay.keep_v, lay.keep_s,
               lay.buf_v, lay.buf_s, lay.cnt, lay.thr, lay.ssq, lay.pair,
               lay.sub, lay.total]
    assert offsets == sorted(offsets) and lay.a == 0
    for off in (lay.a, lay.b, lay.b_step, lay.a_step, lay.a_lo, lay.op):
        assert off % 1024 == 0
    assert lay.group in ps.PAIR_GROUPS
    if extract:
        assert lay.keep >= max(kt, 32) and lay.keep & (lay.keep - 1) == 0
        assert lay.buf == (64 if lay.keep >= 64 else 32)
        assert lay.keep_s - lay.keep_v == lay.group * lay.keep * 4
        assert lay.buf_s - lay.buf_v == lay.group * lay.buf * 4
        if width == 128:
            assert lay.group == (64 if kt <= 128 else 32)
    else:
        assert lay.keep == lay.buf == 0 and lay.keep_v == lay.cnt
        assert lay.group == 64
    if fp32:
        # a ring of three raw stages of 16 KB + 1 KB of norms and ids
        assert lay.b_step == 17_408 and lay.op - lay.b == 3 * 17_408
        atoms = -(-width // 32)
        if lay.resident:
            assert lay.a_lo == atoms * 8192 and lay.b == 2 * atoms * 8192
        else:
            assert lay.a_lo == 8192 and lay.b == 16_384
            assert ps._pair_layout(width, kt, fp32, extract, lay.group,
                                   True).total > LIMIT
    else:
        assert bool(lay.resident) == (-(-width // 16) * 16 <= 128)
        assert lay.b_step >= 64 * 128 * 4        # the window's distances
    assert list(lay.as_c()) == list(lay)


def test_group_sizes_follow_the_layout():
    """``build_groups`` at the pass's group size: every in-range pair in
    exactly one slot, groups of one list, at most ``group`` pairs, the
    list's pairs in order; the default group stays 128."""
    rng = np.random.default_rng(3)
    probes = torch.from_numpy(rng.integers(-1, 12, (300, 5)).astype(
        np.int32))
    probes[:20, 0] = 3                                  # a hot list
    for group in (64, 32, 16):
        gl, sp = grouped.build_groups(probes, 10, group)
        assert sp.shape == (gl.shape[0], group)
        assert int(grouped.num_groups(probes, 10, group)) == gl.shape[0]
        flat = probes.reshape(-1).long()
        live = sp[sp < probes.numel()].long()
        valid = torch.nonzero((flat >= 0) & (flat < 10))[:, 0]
        assert torch.equal(torch.sort(live).values, valid)
        for lst, slots in zip(gl.long(), sp.long()):
            got = slots[slots < probes.numel()]
            assert bool((flat[got] == lst).all())
            assert bool((got[1:] > got[:-1]).all())
    assert grouped.build_groups(probes, 10)[1].shape[1] == grouped.GROUP


# ---------------------------------------------------------------------------
# the plain version on the pass's groups, against the JAX grouped scans
# ---------------------------------------------------------------------------

def _ids(rng, n_lists, cap):
    """ids with padding (-1) past each list's size and tombstones
    (<= -2)."""
    sizes = rng.integers(cap // 2, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for lst, s in enumerate(sizes):
        ids[lst, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 1::9] = np.where(ids[:, 1::9] >= 0, -(ids[:, 1::9] + 2), -1)
    return ids


def _flat_lists(n_lists, cap, dim, seed):
    """fp32 rows with exact ties: slots 20..29 of each list repeat rows
    0..9 (the same distance at two slots)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_lists, cap, dim)).astype(np.float32)
    data[:, 20:30] = data[:, 0:10]
    return (torch.from_numpy(data), torch.from_numpy((data ** 2).sum(-1)),
            torch.from_numpy(_ids(rng, n_lists, cap)))


def _recon_lists(n_lists, cap, rot, seed):
    """bf16 recon rows with the same exact ties, their norms, ids and
    centers."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_lists, cap, rot)).astype(np.float32)
    x[:, 20:30] = x[:, 0:10]
    recon = torch.from_numpy(x).to(torch.bfloat16)
    centers = torch.from_numpy(rng.normal(size=(n_lists, rot)).astype(
        np.float32))
    return (centers, recon, (recon.float() ** 2).sum(-1),
            torch.from_numpy(_ids(rng, n_lists, cap)))


def _probes(seed, nq, n_probes, n_lists):
    """distinct lists per query, a sentinel past the lists and a negative
    probe (pairs in no group)."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.choice(n_lists, n_probes, replace=False)
                  for _ in range(nq)]).astype(np.int32)
    p[1, 0] = n_lists
    p[0, -1] = -1
    return torch.from_numpy(p)


def _filter(nq, n_ids, selectivity, seed):
    mask = np.random.default_rng(seed).random((nq, n_ids)) < selectivity
    return mask, bitset.pack_mask(torch.from_numpy(mask))


def _jax_groups(probes, n_lists):
    """Groups of 128 for the JAX kernels (``build_groups`` at its default
    size, which maps a negative probe to no group as the sentinel)."""
    gl, sp = grouped.build_groups(probes, n_lists)
    return jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy())


def _per_pair(jv, ji, sp, n_pairs, kt):
    """The JAX kernel's (n_groups, GROUP, kt) output scattered to pairs:
    (n_pairs, kt) values (+inf where no group holds a pair) and ids (-1
    at +inf)."""
    slots = np.asarray(sp).reshape(-1)
    live = slots < n_pairs
    v = np.full((n_pairs, kt), np.inf, np.float32)
    i = np.full((n_pairs, kt), -1, np.int32)
    v[slots[live]] = np.asarray(jv).reshape(-1, kt)[live]
    i[slots[live]] = np.asarray(ji).reshape(-1, kt)[live]
    return v, np.where(np.isfinite(v), i, -1)


def _assert_pairs_match(got_v, got_i, ref_v, ref_i, tol):
    """Per pair: the same exhausted slots (-1 exactly there), values within
    ``tol``, ids equal except next to a value within 2 ``tol``."""
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_array_equal(got_i < 0, ~fin)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=0, atol=tol)
    tie = np.zeros(got_v.shape, bool)
    with np.errstate(invalid="ignore"):          # inf - inf past the live
        near = np.abs(np.diff(got_v, axis=1)) <= 2 * tol
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    assert not ((got_i != ref_i) & ~tie).any()


def _admission(fw, probes, n_lists, ids):
    """The JAX package's groups and their admission words for ``fw``."""
    gl, sp = _jax_groups(probes, n_lists)
    adm = jax_bitset.group_admission_words(
        jnp.asarray(fw.numpy()), gl, sp, jnp.asarray(ids.numpy()),
        probes.shape[1], probes.numel())
    return gl, sp, adm


@pytest.mark.parametrize("kt", [65, 100, 128])
@pytest.mark.parametrize("selectivity", [None, 0.05, 0.5])
def test_flat_pass_matches_the_jax_grouped_flat_scan(kt, selectivity):
    """F's pair-group schedule (groups of 64) against
    ``grouped_flat_l2_scan`` (interpreted, on groups of 128) at kt
    65-128, with exact ties, unfiltered and with ``adm_words`` at 5% and
    50%: per pair within 1e-5 of ‖q‖² + max ‖x‖², ids but at ties, the
    pairs no group holds empty; every id admitted by its query."""
    n_lists, cap, dim, nq, n_probes = 6, 160, 32, 40, 3
    data, dsq, ids = _flat_lists(n_lists, cap, dim, kt)
    rng = np.random.default_rng(kt + 1)
    q = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32))
    probes = _probes(kt + 2, nq, n_probes, n_lists)
    fw, adm = None, None
    jgl, jsp = _jax_groups(probes, n_lists)
    if selectivity is not None:
        mask, fw = _filter(nq, int(ids.max()) + 1, selectivity, kt)
        jgl, jsp, adm = _admission(fw, probes, n_lists, ids)
    layout = ps.pair_list_layout(dim, kt, True)
    assert layout.group == 64
    groups = grouped.build_groups(probes, n_lists, layout.group)
    pv, pi = ps.flat_pair_list_scan(q, probes, *groups, data, dsq, ids, kt,
                                    filter_words=fw)
    jv, ji = pqp.grouped_flat_l2_scan(
        jgl, jsp, jnp.asarray(q.numpy()), jnp.asarray(data.numpy()),
        jnp.asarray(dsq.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True, adm_words=adm)
    ref_v, ref_i = _per_pair(jv, ji, jsp, probes.numel(), kt)
    tol = 1e-5 * float((q * q).sum(1).max() + dsq.max())
    got_v = pv.reshape(-1, kt).numpy()
    got_i = pi.reshape(-1, kt).numpy()
    _assert_pairs_match(got_v, got_i, ref_v, ref_i, tol)
    assert np.isinf(got_v[[1 * n_probes, n_probes - 1]]).all()
    if fw is not None:
        flat = pi.reshape(nq, -1).numpy()
        assert mask[np.nonzero(flat >= 0)[0], flat[flat >= 0]].all()
        if selectivity < 0.5:
            assert not np.isfinite(got_v).all()


@pytest.mark.parametrize("kt", [65, 128])
@pytest.mark.parametrize("selectivity", [None, 0.05, 0.5])
def test_recon_pass_matches_the_jax_grouped_scan(kt, selectivity):
    """G's pair-group schedule against ``grouped_l2_scan`` (interpreted)
    at rot 128 and a capacity that is a multiple of 16, as the JAX kernel
    takes, with exact ties, unfiltered and with ``adm_words``: per pair
    within 1e-4, ids but at ties."""
    n_lists, cap, rot, nq, n_probes = 6, 144, 128, 40, 3
    centers, recon, rsq, ids = _recon_lists(n_lists, cap, rot, kt)
    rng = np.random.default_rng(kt + 3)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    probes = _probes(kt + 4, nq, n_probes, n_lists)
    fw, adm = None, None
    jgl, jsp = _jax_groups(probes, n_lists)
    if selectivity is not None:
        mask, fw = _filter(nq, int(ids.max()) + 1, selectivity, kt + 1)
        jgl, jsp, adm = _admission(fw, probes, n_lists, ids)
    layout = ps.pair_list_layout(rot, kt, False)
    groups = grouped.build_groups(probes, n_lists, layout.group)
    pv, pi = ps.recon_pair_list_scan(qrot, centers, probes, *groups, recon,
                                     rsq, ids, kt, filter_words=fw)
    jv, ji = pqp.grouped_l2_scan(
        jgl, jsp, jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
        jnp.asarray(recon.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rsq.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True, adm_words=adm)
    ref_v, ref_i = _per_pair(jv, ji, jsp, probes.numel(), kt)
    _assert_pairs_match(pv.reshape(-1, kt).numpy(), pi.reshape(-1, kt).numpy(),
                        ref_v, ref_i, 1e-4)
    if fw is not None:
        flat = pi.reshape(nq, -1).numpy()
        assert mask[np.nonzero(flat >= 0)[0], flat[flat >= 0]].all()


# ---------------------------------------------------------------------------
# the plain version on the pass's groups, against the query-major plain
# ---------------------------------------------------------------------------

FLAT_CASES = {  # n_lists, cap, dim, nq, n_probes, F, kt, ip
    "kt65": (8, 120, 16, 60, 4, 1, 65, False),
    "kt100-ip": (8, 120, 16, 60, 4, 1, 100, True),
    "kt256-group32": (6, 300, 12, 40, 3, 1, 256, False),
    "kt200-super-F2": (16, 120, 16, 70, 6, 2, 200, False),
    "kt129-super-F4-ip": (16, 64, 8, 70, 8, 4, 129, True),
    "dim25-kt70": (8, 100, 25, 50, 4, 1, 70, False),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_pass_equals_the_query_major_plain(case):
    """F's pair-group schedule gives ``ivf_flat_scan``'s plain output at kt
    up to 256 (groups of 64, and of 32 at kt past 128), L2 and
    InnerProduct, super-tiled views with their dedupe sentinels: the same
    ids and exhausted slots, values within 1e-6 of ‖q‖² + max ‖x‖², exact
    ties kept in slot order; the public wrapper on CPU tensors is that
    plain version."""
    n_lists, cap, dim, nq, n_probes, F, kt, ip = FLAT_CASES[case]
    data, dsq, ids = _flat_lists(n_lists, cap, dim, cap + kt)
    rng = np.random.default_rng(dim + kt)
    q = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32))
    probes = _probes(nq, nq, n_probes, n_lists)
    n_eff = n_lists // F
    if F > 1:
        probes = torch.where(probes < 0, torch.full_like(probes, n_lists),
                             probes)
        probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
        data = data.reshape(n_eff, F * cap, dim)
        dsq, ids = dsq.reshape(n_eff, F * cap), ids.reshape(n_eff, F * cap)
    rows = data.shape[1]
    assert ps.flat_scan_route(rows, dim, min(kt, rows), F)[0] == "pair"
    layout = ps.pair_list_layout(dim, min(kt, rows), True)
    assert layout.group == (64 if kt <= 128 else 32)
    groups = grouped.build_groups(probes, n_eff, layout.group)
    lv, li = ps.flat_pair_list_scan(q, probes, *groups, data, dsq, ids, kt,
                                    ip, sub_lists=F)
    rv, ri = ps.ivf_flat_scan_plain(q, probes, data, dsq, ids, kt, ip)
    assert lv.shape == rv.shape == (*probes.shape, min(kt, rows))
    assert torch.equal(li, ri)
    assert torch.equal(torch.isfinite(lv), torch.isfinite(rv))
    scale = float((q * q).sum(1).max() + dsq.max())
    torch.testing.assert_close(lv, rv, rtol=0, atol=1e-6 * scale)
    wv, wi = ps.ivf_flat_scan(q, probes, data, dsq, ids, kt, ip,
                              sub_lists=F)
    assert torch.equal(wv, rv) and torch.equal(wi, ri)
    # exact ties (a row and its copy) keep the lower slot first
    slot = {int(i): s for s, i in enumerate(ids.reshape(-1).tolist())
            if i >= 0}
    fin = torch.isfinite(lv)
    same = (lv[..., 1:] == lv[..., :-1]) & fin[..., 1:]
    pairs = torch.nonzero(same)
    assert pairs.shape[0] > 0
    for a, b, r in pairs.tolist():
        assert slot[int(li[a, b, r])] < slot[int(li[a, b, r + 1])]


@pytest.mark.parametrize("kt", [65, 100, 200, 256])
def test_recon_pass_equals_the_query_major_plain(kt):
    """G's pair-group schedule gives ``ivf_pq_scan_recon``'s plain output
    bit for bit at kt up to 256, ties included; the public wrapper on CPU
    tensors is that plain version."""
    n_lists, cap, rot, nq, n_probes = 8, 260, 24, 50, 4
    centers, recon, rsq, ids = _recon_lists(n_lists, cap, rot, kt)
    rng = np.random.default_rng(kt)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    probes = _probes(kt, nq, n_probes, n_lists)
    assert ps.recon_scan_route(rot, kt)[0] == "pair"
    group = ps.pair_list_layout(rot, kt, False).group
    groups = grouped.build_groups(probes, n_lists, group)
    lv, li = ps.recon_pair_list_scan(qrot, centers, probes, *groups, recon,
                                     rsq, ids, kt)
    rv, ri = ps.ivf_pq_scan_recon_plain(qrot, centers, probes, recon, rsq,
                                        ids, kt)
    assert lv.shape == rv.shape == (nq, n_probes, kt)
    assert torch.equal(lv, rv) and torch.equal(li, ri)
    assert bool(torch.isinf(lv[0, -1]).all()) and bool((li[0, -1] == -1).all())
    wv, wi = ps.ivf_pq_scan_recon(qrot, centers, probes, recon, rsq, ids, kt)
    assert torch.equal(wv, rv) and torch.equal(wi, ri)


# ---------------------------------------------------------------------------
# the row-10 variants on the pass's groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["F", "G"])
@pytest.mark.parametrize("gather,extract", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_variants_on_the_grouped_schedule_equal_the_plain_variants(
        bf16, gather, extract):
    """``pair_scan_variant_grouped_plain`` (each group's pairs against its
    list, scattered by slot) against ``pair_scan_variant_plain``: raw
    blocks at every slot (+inf on the pairs no group holds) and
    selections with the same ids, values within 1e-6 of ‖q‖² + max ‖x‖²
    (a product batched otherwise may round its last bit)."""
    n_lists, cap, width, nq, n_probes, kt = 8, 90, 16, 40, 4, 10
    if bf16:
        centers, data, dsq, ids = _recon_lists(n_lists, cap, width, 5)
    else:
        centers = None
        data, dsq, ids = _flat_lists(n_lists, cap, width, 5)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(nq, width)).astype(np.float32))
    probes = _probes(7, nq, n_probes, n_lists)
    q_in = q if gather else q.repeat_interleave(n_probes, 0)
    group = ps.pair_list_layout(width, kt, not bf16, extract).group
    groups = grouped.build_groups(probes, n_lists, group)
    kw = dict(gather=gather, extract=extract, centers=centers)
    got = ps.pair_scan_variant_grouped_plain(q_in, probes, *groups, data,
                                             dsq, ids, kt, **kw)
    ref = ps.pair_scan_variant_plain(q_in, probes, data, dsq, ids, kt, **kw)
    scale = float((q * q).sum(1).max() + dsq.max())
    if extract:
        assert torch.equal(got[1], ref[1])
        got, ref = got[0], ref[0]
    assert got.shape == ref.shape
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    assert bool(torch.isinf(got[0, -1]).all())
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * scale)
    # the wrappers on CPU tensors are the plain variants
    for wrapper in (ps.pair_scan_variant, ps.pair_scan_variant_query_major):
        out = wrapper(q_in, probes, data, dsq, ids, kt, **kw)
        ref2 = ps.pair_scan_variant_plain(q_in, probes, data, dsq, ids, kt,
                                          **kw)
        if extract:
            assert torch.equal(out[0], ref2[0]) and torch.equal(out[1],
                                                                ref2[1])
        else:
            assert torch.equal(out, ref2)


def test_pass_sources_state_the_layout_the_python_formula_gives():
    """The C layout struct has the Python formula's 23 fields (D and E's
    raw stages among them), in order, and the kernel's kt bound is
    PAIR_KT_MAX."""
    import re

    src = (ps._cuda.SRC_DIR / "pair_list_scan.cu").read_text()
    body = re.search(r"struct PairLayout \{([^}]*)\}", src).group(1)
    fields = [f.strip() for f in body.replace("int", "").replace(";", "")
              .split(",")]
    assert fields == list(ps.PairLayout._fields)
    assert f"kKtMax = {ps.PAIR_KT_MAX};" in src
    assert ps.PAIR_KT_MAX == pgs.K_MAX == 256


@pytest.mark.parametrize("name", list(pair_list_decomp.VARIANTS))
def test_pair_list_decomp_variants_apply_to_the_pass_source(name):
    """Each decomposition variant's substitutions match
    ``pair_list_scan.cu`` exactly once each (the profile raises
    otherwise), and only ``as built`` leaves the source as it is."""
    base = (ps._cuda.SRC_DIR / "pair_list_scan.cu").read_text()
    text = pair_list_decomp.variant_sources(name)["pair_list_scan.cu"]
    assert (text == base) == (name == "as built")


def test_pair_list_profiles_need_the_card(monkeypatch):
    """Off the card both profiles of the pass stop before they build or
    draw anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pair_list_decomp, "build", lambda *a: pytest.fail(
        "built without a card"))
    with pytest.raises(SystemExit):
        pair_list_decomp.main()
    with pytest.raises(SystemExit):
        pair_list_turns.main()

"""Kernels D and E past kt 64 in raft_tpu_torch: the pair-group pass
(``csrc/pair_list_scan.cu``) over the packed PQ codes and over the int8
recon cache, on the CPU.

The kernel runs on the card only.  Here its plain version — the grouped
schedule on the pass's groups of 64 or 32 pairs
(``pq_group_scan.grouped_pair_topk`` over the decoded rows for D, the
scaled int8 dot for E: each group's pairs against its list, their top kt
scattered by ``slot_pairs``) — is held:

- to the JAX package's grouped Pallas scans ``grouped_code_scan`` (the
  codes in its lane-major layout, ``pack_code_lanes``) and
  ``grouped_recon8_scan`` (the int8 rows padded to its 128 lanes),
  interpreted, on groups of 128 as the JAX package makes them, at kt 65
  and 128, 4- and 8-bit codes at pq_len 1 and 2, unfiltered and with
  ``adm_words`` (``group_admission_words``) at 5% and 50%: per pair,
  values within 1e-4 of max sub_sq + max rsq (the two packages sum the
  same exact products in another order), the same exhausted slots, ids
  equal but at distance ties; every id admitted by its query;
- to the query-major plain versions, bit for bit;

and the routes (``codes_scan_route``, ``recon8_scan_route``), the gates'
reasons, the shared-memory layout (``code_pair_list_layout``,
``recon8_pair_list_layout``: the one ``PairLayout`` formula, with D and
E's raw stages) are checked.  Inputs are numpy
draws from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.ops import pq_code_scan_pallas as pcp
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops import pq_group_scan as pgs

LIMIT = 232_448                      # an H100 block's dynamic shared memory


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test, as the other port test files:
    a parallel test run otherwise oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(rng, n_lists, cap):
    """Each list's first size slots hold fresh ids, a few tombstoned (<=
    -2), the rest padding (-1)."""
    sizes = rng.integers(cap // 2, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for lst, s in enumerate(sizes):
        ids[lst, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 3::11] = np.where(ids[:, 3::11] >= 0, -(ids[:, 3::11] + 2), -1)
    return ids


def _code_lists(n_lists, cap, pq_dim, pq_len, pq_bits, seed):
    """Random packed codes with exact ties (rows 20-29 repeat rows 0-9),
    codebooks, centers, ids, and the norms of the rows' bf16
    reconstructions."""
    rng = np.random.default_rng(seed)
    W = -(-pq_dim * pq_bits // 8)
    codes = rng.integers(0, 256, (n_lists, cap, W)).astype(np.uint8)
    codes[:, 20:30] = codes[:, 0:10]
    codes = torch.from_numpy(codes)
    books = torch.from_numpy(rng.normal(
        size=(pq_dim, 1 << pq_bits, pq_len)).astype(np.float32))
    centers = torch.from_numpy(rng.normal(
        size=(n_lists, pq_dim * pq_len)).astype(np.float32))
    rsq = (pcs.decode_codes(codes, books, pq_bits).float() ** 2).sum(-1)
    return centers, codes, books, rsq, torch.from_numpy(_ids(rng, n_lists,
                                                             cap))


def _int8_lists(n_lists, cap, rot, seed):
    """int8 rows of round16(rot) bytes (zeros past rot) with exact ties,
    the lists' scales, the dequantized norms, centers and ids."""
    rng = np.random.default_rng(seed)
    rot_pad = -(-rot // 16) * 16
    q8 = rng.integers(-127, 128, (n_lists, cap, rot_pad)).astype(np.int8)
    q8[:, :, rot:] = 0
    q8[:, 20:30] = q8[:, 0:10]
    scales = rng.uniform(0.01, 0.1, n_lists).astype(np.float32)
    rsq8 = (scales[:, None] ** 2
            * (q8.astype(np.float32) ** 2).sum(-1)).astype(np.float32)
    centers = rng.normal(size=(n_lists, rot)).astype(np.float32)
    return (torch.from_numpy(q8), torch.from_numpy(scales),
            torch.from_numpy(rsq8), torch.from_numpy(centers),
            torch.from_numpy(_ids(rng, n_lists, cap)))


def _probes(seed, nq, n_probes, n_lists):
    """Distinct lists per query, a sentinel past the lists and a negative
    probe (pairs in no group)."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.choice(n_lists, n_probes, replace=False)
                  for _ in range(nq)]).astype(np.int32)
    p[1, 0] = n_lists
    p[0, -1] = -1
    return torch.from_numpy(p)


def _scale(qrot, centers, probes, rsq):
    """max sub_sq + max rsq over the in-range pairs: the scale a change of
    summation order moves a distance by."""
    pr = probes.long().clamp(0, centers.shape[0] - 1)
    sub = qrot[:, None, :] - centers[pr]
    return float((sub * sub).sum(-1).max() + rsq.max())


def _jax_groups(probes, n_lists, fw, ids):
    """Groups of 128 for the JAX kernels (``build_groups`` at its default
    size) and, with ``fw``, their admission words."""
    gl, sp = grouped.build_groups(probes, n_lists)
    gl, sp = jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy())
    adm = None if fw is None else jax_bitset.group_admission_words(
        jnp.asarray(fw.numpy()), gl, sp, jnp.asarray(ids.numpy()),
        probes.shape[1], probes.numel())
    return gl, sp, adm


def _per_pair(jv, ji, sp, n_pairs, kt):
    """The JAX kernel's (n_groups, GROUP, kt) output scattered to pairs:
    (n_pairs, kt) values (+inf where no group holds a pair) and ids (-1 at
    +inf)."""
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


def _filter(nq, n_ids, selectivity, seed):
    if selectivity is None:
        return None, None
    mask = np.random.default_rng(seed).random((nq, n_ids)) < selectivity
    return mask, bitset.pack_mask(torch.from_numpy(mask))


def _assert_admitted(pi, mask):
    flat = pi.reshape(pi.shape[0], -1).numpy()
    assert mask[np.nonzero(flat >= 0)[0], flat[flat >= 0]].all()


# ---------------------------------------------------------------------------
# the grouped plain schedule against the Pallas grouped scans
# ---------------------------------------------------------------------------

CODE_CASES = {  # pq_dim, pq_len, pq_bits, kt
    "bits8-len2-kt65": (16, 2, 8, 65),
    "bits8-len1-kt128": (24, 1, 8, 128),
    "bits4-len1-kt65": (24, 1, 4, 65),
    "bits4-len2-kt128": (16, 2, 4, 128),
}


@pytest.mark.parametrize("selectivity", [None, 0.05, 0.5])
@pytest.mark.parametrize("case", sorted(CODE_CASES))
def test_code_pass_matches_the_jax_grouped_code_scan(case, selectivity):
    """D's pair-group schedule against ``grouped_code_scan``
    (interpreted, the codes lane-major), unfiltered and with
    ``adm_words``: per pair within 1e-4 of max sub_sq + max rsq, ids but
    at ties, the pairs no group holds empty; every id admitted."""
    pq_dim, pq_len, bits, kt = CODE_CASES[case]
    n_lists, cap, nq, n_probes = 5, 160, 36, 3
    centers, codes, books, rsq, ids = _code_lists(n_lists, cap, pq_dim,
                                                  pq_len, bits, kt + bits)
    rot = pq_dim * pq_len
    rng = np.random.default_rng(kt + 1)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    probes = _probes(kt + bits, nq, n_probes, n_lists)
    mask, fw = _filter(nq, int(ids.max()) + 1, selectivity, kt)
    assert pcs.codes_scan_route(cap, rot, pq_dim, bits, kt)[0] == "pair"
    layout = pcs.code_pair_list_layout(rot, pq_dim, bits, kt)
    assert layout.group == 64
    pv, pi = pcs.code_pair_list_scan(
        qrot, centers, probes,
        *grouped.build_groups(probes, n_lists, layout.group), codes, books,
        rsq, ids, bits, kt, filter_words=fw)
    assert pv.shape == pi.shape == (nq, n_probes, kt)
    gl, sp, adm = _jax_groups(probes, n_lists, fw, ids)
    jv, ji = pcp.grouped_code_scan(
        gl, sp, jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
        pcp.pack_code_lanes(jnp.asarray(codes.numpy())),
        jnp.asarray(books.numpy()), jnp.asarray(rsq.numpy()),
        jnp.asarray(ids.numpy()), kt, n_probes, bits, interpret=True,
        adm_words=adm)
    ref_v, ref_i = _per_pair(jv, ji, sp, probes.numel(), kt)
    _assert_pairs_match(pv.reshape(-1, kt).numpy(),
                        pi.reshape(-1, kt).numpy(), ref_v, ref_i,
                        1e-4 * _scale(qrot, centers, probes, rsq))
    assert np.isinf(pv[0, -1].numpy()).all() and np.isinf(
        pv[1, 0].numpy()).all()
    if mask is not None:
        _assert_admitted(pi, mask)
        if selectivity < 0.5:
            assert not np.isfinite(pv.numpy()).all()


@pytest.mark.parametrize("selectivity", [None, 0.05, 0.5])
@pytest.mark.parametrize("rot,kt", [(24, 65), (96, 128)])
def test_recon8_pass_matches_the_jax_grouped_recon8_scan(rot, kt,
                                                         selectivity):
    """E's pair-group schedule against ``grouped_recon8_scan``
    (interpreted, the int8 rows padded to its 128 lanes), unfiltered and
    with ``adm_words``: per pair within 1e-4 of max sub_sq + max rsq8, ids
    but at ties, the pairs no group holds empty; every id admitted."""
    n_lists, cap, nq, n_probes = 5, 160, 36, 3
    q8, scales, rsq8, centers, ids = _int8_lists(n_lists, cap, rot, kt)
    rng = np.random.default_rng(kt + 2)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    probes = _probes(kt + 3, nq, n_probes, n_lists)
    mask, fw = _filter(nq, int(ids.max()) + 1, selectivity, kt + 1)
    rot_pad = q8.shape[2]
    assert pcs.recon8_scan_route(cap, rot_pad, kt)[0] == "pair"
    group = pcs.recon8_pair_list_layout(rot_pad, kt).group
    assert group == 64
    pv, pi = pcs.recon8_pair_list_scan(
        qrot, centers, probes, *grouped.build_groups(probes, n_lists, group),
        q8, scales, rsq8, ids, kt, filter_words=fw)
    assert pv.shape == pi.shape == (nq, n_probes, kt)
    lanes = np.zeros((n_lists, cap, 128), np.int8)
    lanes[..., :rot_pad] = q8.numpy()
    gl, sp, adm = _jax_groups(probes, n_lists, fw, ids)
    jv, ji = pcp.grouped_recon8_scan(
        gl, sp, jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
        jnp.asarray(lanes), jnp.asarray(scales.numpy()),
        jnp.asarray(rsq8.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True, adm_words=adm)
    ref_v, ref_i = _per_pair(jv, ji, sp, probes.numel(), kt)
    _assert_pairs_match(pv.reshape(-1, kt).numpy(),
                        pi.reshape(-1, kt).numpy(), ref_v, ref_i,
                        1e-4 * _scale(qrot, centers, probes, rsq8))
    assert np.isinf(pv[0, -1].numpy()).all() and np.isinf(
        pv[1, 0].numpy()).all()
    if mask is not None:
        _assert_admitted(pi, mask)


# ---------------------------------------------------------------------------
# the grouped plain schedule against the query-major plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kt,group", [(65, 64), (100, 32), (128, 16),
                                      (128, None)])
@pytest.mark.parametrize("kernel", ["D4", "D8", "E"])
def test_grouped_plain_equals_the_query_major_plain(kernel, kt, group):
    """On CPU tensors the pair-group wrappers run the grouped schedule at
    any group size the pass takes, and it gives the query-major plain
    version (``ivf_pq_scan_codes_plain`` / ``ivf_pq_scan_recon8_plain``)
    bit for bit, exact ties kept in slot order; so do the dispatchers."""
    n_lists, cap, nq, n_probes = 6, 150, 40, 4
    probes = _probes(kt, nq, n_probes, n_lists)
    rng = np.random.default_rng(kt + 5)
    if kernel == "E":
        q8, scales, rsq8, centers, ids = _int8_lists(n_lists, cap, 36, kt)
        qrot = torch.from_numpy(rng.normal(size=(nq, 36)).astype(
            np.float32))
        size = group or pcs.recon8_pair_list_layout(48, kt).group
        gv, gi = pcs.recon8_pair_list_scan(
            qrot, centers, probes,
            *grouped.build_groups(probes, n_lists, size), q8, scales, rsq8,
            ids, kt, group=group)
        args = (qrot, centers, probes, q8, scales, rsq8, ids, kt)
        rv, ri = pcs.ivf_pq_scan_recon8_plain(*args)
        dv, di = pcs.ivf_pq_scan_recon8(*args)
    else:
        bits = int(kernel[1])
        centers, codes, books, rsq, ids = _code_lists(n_lists, cap, 12, 3,
                                                      bits, kt)
        qrot = torch.from_numpy(rng.normal(size=(nq, 36)).astype(
            np.float32))
        size = group or pcs.code_pair_list_layout(36, 12, bits, kt).group
        gv, gi = pcs.code_pair_list_scan(
            qrot, centers, probes,
            *grouped.build_groups(probes, n_lists, size), codes, books, rsq,
            ids, bits, kt, group=group)
        args = (qrot, centers, probes, codes, books, rsq, ids, bits, kt)
        rv, ri = pcs.ivf_pq_scan_codes_plain(*args)
        dv, di = pcs.ivf_pq_scan_codes(*args)
    assert torch.equal(gv, rv) and torch.equal(gi, ri)
    assert torch.equal(dv, rv) and torch.equal(di, ri)


# ---------------------------------------------------------------------------
# routes, gates and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kt,route", [(1, "list"), (64, "list"),
                                      (65, "pair"), (100, "pair"),
                                      (128, "pair"), (129, "query")])
def test_routes_by_kt_name_their_reason(kt, route):
    """At the deep shape (rot 96, 48 8-bit subspaces, int8 rows of 96
    bytes) kt up to 64 takes the list-major passes, 65 to 128 the
    pair-group pass, past 128 the query-major kernels' gates (which refuse
    it too: the search runs its composition); each route past the first
    names the refusals before it."""
    d_route, d_why = pcs.codes_scan_route(2368, 96, 48, 8, kt)
    e_route, e_why = pcs.recon8_scan_route(2368, 96, kt)
    assert d_route == e_route == route
    if route == "list":
        assert d_why == e_why == ""
    else:
        for why in (d_why, e_why):
            assert "outside 1..64 (the list-major route)" in why
    if route == "query":
        for why in (d_why, e_why):
            assert "pair-group route: kt=129 outside 1..128" in why
        assert "kt=129" in pcs.codes_reject_reason(2368, 96, 48, 8, kt)
        assert "kt=129" in pcs.recon8_reject_reason(2368, 96, kt)
    else:
        assert not pcs.codes_reject_reason(2368, 96, 48, 8, kt)
        assert not pcs.recon8_reject_reason(2368, 96, kt)


def test_shapes_past_the_pass_take_the_query_major_kernels():
    """D's raw code stages and keep past shared memory (1,024 dims of 8-bit
    codes at pq_len 1 or 2: rows of 512 or 1,024 bytes), D's rot past 1,024
    and E's rows past 1,024 bytes leave the query-major kernels, the
    reason named; rot 256 at 8 bits (pq_dim 128, 256) stays on the pass,
    its books in global memory; a capacity past the query-major kernels'
    shared memory stays on the pass (its shared memory does not grow with
    it)."""
    for rot, pq_dim in ((1024, 512), (1024, 1024)):
        route, why = pcs.codes_scan_route(416, rot, pq_dim, 8, 100)
        assert route == "query"
        assert "pair-group route: kt 100 needs" in why
        assert "shared memory" in why
    route, why = pcs.codes_scan_route(64, 4096, 4096, 4, 100)
    assert route == "query" and "rot_dim 4096 past 1024" in why
    assert not pcs.codes_reject_reason(64, 4096, 4096, 4, 100)
    for pq_dim in (128, 256):
        assert pcs.codes_scan_route(416, 256, pq_dim, 8, 100)[0] == "pair"
        # with the books staged beside it the block would not fit
        lay = pcs.code_pair_list_layout(256, pq_dim, 8, 100)
        assert lay.total + pcs._books_bytes(256, 8) > LIMIT
    route, why = pcs.recon8_scan_route(64, 1104, 100)
    assert route == "query" and "1104 past 1024" in why
    assert not pcs.recon8_reject_reason(64, 1104, 100)
    big = 200_000
    assert pcs.codes_query_major_reject_reason(big, 96, 48, 8, 100)
    assert pcs.codes_scan_route(big, 96, 48, 8, 100)[0] == "pair"
    assert not pcs.codes_reject_reason(big, 96, 48, 8, 100)
    assert pcs.recon8_query_major_reject_reason(big, 96, 100)
    assert pcs.recon8_scan_route(big, 96, 100)[0] == "pair"
    # so does rot 256 at 4 bits
    assert pcs.codes_scan_route(416, 256, 128, 4, 128)[0] == "pair"


@pytest.mark.parametrize("kt", [65, 100, 128])
@pytest.mark.parametrize("rot,pq_dim,pq_bits", [
    (96, 48, 8), (128, 64, 8), (36, 12, 4), (36, 36, 8), (256, 128, 4),
    (256, 64, 8), (512, 256, 4), (1024, 512, 4), (1024, 1024, 8)])
def test_code_layout_fits_wherever_the_gate_admits(rot, pq_dim, pq_bits,
                                                   kt):
    """Wherever D's gate takes a shape its layout fits the card at the
    group it picks (64, else 32), every part in order and on its
    alignment: two raw stages of 128 rows' codes after G's pass (the books
    stay in global memory); the deep and flagship shapes at 64 pairs,
    where the books staged beside the keep would not fit (245,920 B at the
    deep shape)."""
    reason = pcs.code_pair_list_reject_reason(rot, pq_dim, pq_bits, kt)
    if reason:
        assert "shared memory" in reason
        with pytest.raises(LogicError, match="shared memory"):
            pcs.code_pair_list_layout(rot, pq_dim, pq_bits, kt)
        return
    lay = pcs.code_pair_list_layout(rot, pq_dim, pq_bits, kt)
    assert lay.total <= LIMIT and lay.group in (64, 32)
    books = 2 * (rot << pq_bits)
    W = -(-pq_dim * pq_bits // 8)
    assert lay.raw_step == -(-128 * W // 16) * 16 + 16
    assert lay.raw == lay.sub + 128 and lay.raw % 16 == 0
    assert lay.raw + 2 * lay.raw_step + 1024 == lay.total
    assert lay.resident == (-(-rot // 16) * 16 <= 128)
    g = ps.pair_list_layout(rot - rot % 8 or 8, kt, False, group=lay.group)
    assert lay.keep_v - lay.key == g.keep_v - g.key
    if (rot, pq_dim, pq_bits) in ((96, 48, 8), (128, 64, 8)):
        assert lay.group == 64 and lay.total + books > LIMIT
        if (rot, kt) == (96, 128):
            assert lay.total + books == 245_920


@pytest.mark.parametrize("rot_pad", [16, 32, 96, 128, 144, 256, 1008, 1024])
@pytest.mark.parametrize("kt", [65, 128])
def test_recon8_layout_fits_at_every_width_the_gate_admits(rot_pad, kt):
    """E's layout fits the card at every row width up to 1,024 bytes: G's
    pass over rot_pad dims and two raw stages of 128 int8 rows padded to
    an odd number of 16-byte chunks; 64 pairs a group up to 128 bytes
    (the deep shape at about 213 KB), 32 past it where 64 does not fit."""
    assert not pcs.recon8_pair_list_reject_reason(rot_pad, kt)
    lay = pcs.recon8_pair_list_layout(rot_pad, kt)
    kc = min(rot_pad, 128)
    assert lay.total <= LIMIT and lay.raw == lay.sub + 128
    assert lay.raw_step == 128 * (kc if (kc // 16) % 2 else kc + 16)
    assert lay.resident == (rot_pad <= 128)
    if rot_pad <= 128:
        assert lay.group == 64
    if rot_pad == 96 and kt == 128:
        assert lay.total == 213_120
    assert "multiple of 16" in pcs.recon8_pair_list_reject_reason(100, kt)


def test_pass_gates_name_their_refusals():
    """kt 0 and 129, a width past 1,024, pq_bits 5 and a rot pq_dim does
    not divide each name their reason; the pass's layout is G's with
    none of D's parts where it takes no raw stages."""
    assert "kt=0 outside 1..128" in pcs.code_pair_list_reject_reason(
        96, 48, 8, 0)
    assert "kt=129 outside 1..128" in pcs.code_pair_list_reject_reason(
        96, 48, 8, 129)
    assert "past 1024" in pcs.code_pair_list_reject_reason(2048, 1024, 4,
                                                           100)
    assert "pq_bits=5" in pcs.code_pair_list_reject_reason(32, 8, 5, 100)
    assert "multiple of pq_dim" in pcs.code_pair_list_reject_reason(
        30, 8, 8, 100)
    assert "kt=129 outside 1..128" in pcs.recon8_pair_list_reject_reason(
        96, 129)
    assert "past 1024" in pcs.recon8_pair_list_reject_reason(1040, 100)
    g = ps.pair_list_layout(96, 128, False)
    assert g.raw == g.sub + 128 and g.raw_step == 0
    assert g.total == 184_448


def test_pass_source_states_the_row_sources():
    """The pass's source has D and E's entry points, its widest built rows
    at ``PAIR_MAX_WIDTH``, and the kernel's row-source switch; the shared
    decode and conversion live in ``row_source.cuh``, which the list-major
    codes pass includes too."""
    src = (ps._cuda.SRC_DIR / "pair_list_scan.cu").read_text()
    assert f"kBuiltMax = {pcs.PAIR_MAX_WIDTH};" in src
    for name in ("raft_pair_list_scan_codes", "raft_pair_list_scan_recon8"):
        assert f'extern "C" int {name}(' in src
        assert name in ps._cuda.SIGNATURES
    assert "template <int kSrc, bool kResident, bool kExtract, bool kFilter>" \
        in src
    for f in ("pair_list_scan.cu", "pq_code_list_scan.cu"):
        assert '#include "row_source.cuh"' in (ps._cuda.SRC_DIR
                                               / f).read_text()
    assert pgs.KT_LIST_MAX == 64 and pcs.KT_MAX == 128

"""raft_tpu_torch's list-major pass over the PQ codes (Kernels C and D's
list-major route), on the CPU.

``code_list_scan``'s plain version emulates the kernel's schedule: each
group of ``neighbors/grouped.build_groups`` scans its list once for its
pairs, the list decoded through ``decode_codes``.  It is held to the JAX
package's grouped code scans (Pallas, interpreted) on the same groups:
``grouped_code_scan`` per pair (Kernel D) and, followed by the merge,
``grouped_code_scan_fused`` per query (Kernel C), within 1e-4 of max
sub_sq + max rsq, ids equal but at distance ties; and to Kernel G's
list-major plain pass over the decoded rows bit for bit.  With a filter,
the port's filtered plain passes of C and D (the list-major pass at kt
10, the query-major routes at kt 80) are held to the same Pallas kernels
run with ``adm_words``.  Then the two-route gates and the shared-memory
formula.  Inputs are numpy draws
from a seed: random codes and codebooks, ids with padding (-1) and
tombstones (<= -2), probes with a hot list past one group, probes >=
n_lists (the JAX sentinels) and, for the port alone, a negative probe."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.ops import pq_code_scan_pallas as pcp
from raft_tpu.ops.pq_group_scan_pallas import _ACC_WORST
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops import pq_group_scan as pgs
from raft_tpu_torch.profiles import code_scan_decomp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test, as the other port test files:
    a parallel test run otherwise oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _code_index(n_lists, cap, pq_dim, pq_len, pq_bits, seed):
    """Random packed codes, codebooks, centers, ids with padding (-1) and
    tombstones (<= -2), and the norms of the rows' bf16 reconstructions."""
    rng = np.random.default_rng(seed)
    W = -(-pq_dim * pq_bits // 8)
    codes = torch.from_numpy(rng.integers(0, 256, (n_lists, cap, W)).astype(
        np.uint8))
    books = torch.from_numpy(rng.normal(
        size=(pq_dim, 1 << pq_bits, pq_len)).astype(np.float32))
    centers = torch.from_numpy(rng.normal(
        size=(n_lists, pq_dim * pq_len)).astype(np.float32))
    sizes = rng.integers(cap // 3, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for lst, s in enumerate(sizes):
        ids[lst, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 1::7] = np.where(ids[:, 1::7] >= 0, -(ids[:, 1::7] + 2), -1)
    rsq = (pcs.decode_codes(codes, books, pq_bits).float() ** 2).sum(-1)
    return centers, codes, books, rsq, torch.from_numpy(ids)


def _probes(seed, nq, n_probes, n_lists, hot=0, sentinels=0.0):
    """(nq, n_probes) int32 probes: distinct lists per query; the first
    ``hot`` queries probe list 3 first (a list past one group of 128 when
    hot > 128); a ``sentinels`` share set to n_lists or above."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.choice(n_lists, n_probes, replace=False)
                  for _ in range(nq)]).astype(np.int32)
    for q in range(hot):
        row = p[q]
        row[row == 3] = row[0]
        row[0] = 3
    off = rng.random(p.shape) < sentinels
    p[off] = n_lists + rng.integers(0, 3, int(off.sum()))
    return p


CASES = {  # n_lists, cap, pq_dim, pq_len, pq_bits, nq, n_probes, hot, kt
    "bits8-len2-kt4": (6, 48, 16, 2, 8, 40, 3, 0, 4),
    "bits4-len2-kt20": (6, 48, 16, 2, 4, 40, 3, 0, 20),
    "bits8-len3-rot36-kt1": (5, 32, 12, 3, 8, 30, 2, 0, 1),
    "bits4-len3-rot36-kt20": (5, 32, 12, 3, 4, 30, 2, 0, 20),
    "bits8-len2-kt64": (4, 80, 8, 2, 8, 24, 2, 0, 64),
    "bits8-hot-list-kt10": (6, 48, 8, 2, 8, 200, 2, 160, 10),
}


def _inputs(case):
    n_lists, cap, pq_dim, pq_len, pq_bits, nq, n_probes, hot, kt = \
        CASES[case]
    centers, codes, books, rsq, ids = _code_index(
        n_lists, cap, pq_dim, pq_len, pq_bits, cap + pq_dim + kt)
    rng = np.random.default_rng(kt)
    qrot = torch.from_numpy(rng.normal(size=(nq, pq_dim * pq_len)).astype(
        np.float32))
    p = _probes(kt + 1, nq, n_probes, n_lists, hot, 0.1)
    return (qrot, centers, p, codes, books, rsq, ids, pq_bits), kt


def _jax_args(qrot, centers, codes, books, rsq, ids, gl, sp):
    return (jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()),
            jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
            pcp.pack_code_lanes(jnp.asarray(codes.numpy())),
            jnp.asarray(books.numpy()), jnp.asarray(rsq.numpy()),
            jnp.asarray(ids.numpy()))


def _scale(qrot, centers, probes, rsq):
    """max sub_sq + max rsq over the batch's in-range pairs: the scale the
    fp32 sums of the two versions move a distance by."""
    pr = probes.long().clamp(0, centers.shape[0] - 1)
    sub = qrot[:, None, :] - centers[pr]
    return float((sub * sub).sum(-1).max() + rsq.max())


def _assert_close_but_ties(got_v, got_i, ref_v, ref_i, tol):
    """Values within tol at every rank, the same exhausted ranks, ids equal
    except where neighbouring values tie within tol."""
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_array_equal(got_i < 0, ~fin)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=0, atol=tol)
    tie = np.zeros(got_v.shape, bool)
    with np.errstate(invalid="ignore"):
        near = np.abs(np.diff(got_v, axis=-1)) <= tol
    tie[..., 1:] |= near
    tie[..., :-1] |= near
    last = fin & ~np.concatenate(
        [fin[..., 1:], np.zeros_like(fin[..., :1])], -1)
    assert not ((got_i != ref_i) & ~tie & ~last).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_code_list_scan_matches_the_jax_grouped_code_scan(case):
    """Pass 1 on the codes against ``grouped_code_scan`` (Pallas,
    interpreted) on the same ``(group_list, slot_pairs)``: per live slot,
    values within 1e-4 of max sub_sq + max rsq, ids equal but at ties; the
    pairs no group holds (sentinel and negative probes) are empty."""
    (qrot, centers, p, codes, books, rsq, ids, bits), kt = _inputs(case)
    p[0, -1] = -1                      # the port's empty pair
    probes = torch.from_numpy(p)
    n_lists, cap = ids.shape
    gl, sp = grouped.build_groups(probes, n_lists)
    if CASES[case][7] > grouped.GROUP:
        assert int((gl == 3).sum()) >= 2         # one list, two groups
    kt = min(kt, cap)
    pv, pi = pcs.code_list_scan(qrot, centers, probes, gl, sp, codes, books,
                                rsq, ids, bits, kt)
    assert pv.shape == pi.shape == (*probes.shape, kt)
    jv, ji = pcp.grouped_code_scan(
        *_jax_args(qrot, centers, codes, books, rsq, ids, gl, sp), kt,
        probes.shape[1], bits, interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    slots = sp.numpy().reshape(-1)
    live = slots < p.size
    ref_v = jv.reshape(-1, kt)[live]
    ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
    got_v = pv.reshape(-1, kt).numpy()[slots[live]]
    got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    _assert_close_but_ties(got_v, got_i, ref_v, ref_i,
                           1e-4 * _scale(qrot, centers, probes, rsq))
    out = ~np.isin(np.arange(p.size), slots[live])
    assert out[p.shape[1] - 1]
    assert np.isinf(pv.reshape(-1, kt).numpy()[out]).all()
    assert (pi.reshape(-1, kt).numpy()[out] == -1).all()


@pytest.mark.parametrize("case", ["bits8-len2-kt4", "bits4-len3-rot36-kt20",
                                  "bits8-hot-list-kt10"])
@pytest.mark.parametrize("k", [5, 20])
def test_kernel_c_schedule_matches_the_jax_fused_code_scan(case, k):
    """Kernel C's list-major schedule — pass 1 at kt' = min(kt, k), then
    the merge (``merge_pairs``' plain version) — against
    ``grouped_code_scan_fused`` (Pallas, interpreted) on the same groups,
    its finite worst sentinel read as (+inf, -1)."""
    (qrot, centers, p, codes, books, rsq, ids, bits), kt = _inputs(case)
    probes = torch.from_numpy(p)
    n_lists, cap = ids.shape
    gl, sp = grouped.build_groups(probes, n_lists)
    kt = min(kt, cap, k)
    pv, pi = pcs.code_list_scan(qrot, centers, probes, gl, sp, codes, books,
                                rsq, ids, bits, kt)
    mv, mi = pgs.merge_pairs(pv, pi, k)
    jv, ji = pcp.grouped_code_scan_fused(
        *_jax_args(qrot, centers, codes, books, rsq, ids, gl, sp), kt, k,
        probes.shape[1], bits, interpret=True)
    nq = probes.shape[0]
    ref_v = np.asarray(jv)[:, :nq].T
    ref_i = np.asarray(ji)[:, :nq].T
    worst = ref_v >= _ACC_WORST
    ref_v = np.where(worst, np.inf, ref_v)
    ref_i = np.where(worst, -1, ref_i)
    _assert_close_but_ties(mv.numpy(), mi.numpy(), ref_v, ref_i,
                           1e-4 * _scale(qrot, centers, probes, rsq))


@pytest.mark.parametrize("selectivity", [0.05, 0.5])
@pytest.mark.parametrize("kt", [10, 80])
@pytest.mark.parametrize("kernel", ["C", "D"])
def test_filtered_passes_match_the_pallas_code_scans_with_adm_words(
        kernel, kt, selectivity):
    """The port's filtered plain passes against the Pallas code scans run
    with ``adm_words`` (the JAX package's ``group_admission_words`` of the
    same groups; interpreted), at a list-major kt (10: ``code_list_scan``,
    for C followed by ``merge_pairs``) and past ``KT_LIST_MAX`` (80:
    ``codes_scan_query_major`` for D, ``codes_fused_query_major`` for C, k
    100): D per pair, C per query (the finite worst sentinel read as
    (+inf, -1)), within 1e-4 of max sub_sq + max rsq, ids equal but at
    ties; every id admitted by its query."""
    n_lists, cap, pq_dim, pq_len, bits, nq, n_probes, k = \
        6, 112, 16, 2, 8, 40, 3, 100
    centers, codes, books, rsq, ids = _code_index(n_lists, cap, pq_dim,
                                                  pq_len, bits, 21)
    rng = np.random.default_rng(22)
    qrot = torch.from_numpy(rng.normal(size=(nq, pq_dim * pq_len)).astype(
        np.float32))
    p = _probes(23, nq, n_probes, n_lists, 0, 0.1)
    probes = torch.from_numpy(p)
    gl, sp = grouped.build_groups(probes, n_lists)
    mask = np.random.default_rng(kt).random((nq, int(ids.max()) + 1)) \
        < selectivity
    fw = bitset.pack_mask(torch.from_numpy(mask))
    adm = jax_bitset.group_admission_words(
        jnp.asarray(fw.numpy()), jnp.asarray(gl.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(ids.numpy()), n_probes, p.size)
    jargs = _jax_args(qrot, centers, codes, books, rsq, ids, gl, sp)
    args = (qrot, centers, probes, codes, books, rsq, ids, bits)
    tol = 1e-4 * _scale(qrot, centers, probes, rsq)
    listed = kt <= pgs.KT_LIST_MAX
    if kernel == "D":
        pv, pi = (pcs.code_list_scan(qrot, centers, probes, gl, sp,
                                     *args[3:], kt, filter_words=fw)
                  if listed else
                  pcs.codes_scan_query_major(*args, kt, filter_words=fw))
        jv, ji = pcp.grouped_code_scan(*jargs, kt, n_probes, bits,
                                       interpret=True, adm_words=adm)
        jv, ji = np.asarray(jv), np.asarray(ji)
        slots = sp.numpy().reshape(-1)
        live = slots < p.size
        ref_v = jv.reshape(-1, kt)[live]
        ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
        got_v = pv.reshape(-1, kt).numpy()[slots[live]]
        got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    else:
        if listed:
            pair_v, pair_i = pcs.code_list_scan(
                qrot, centers, probes, gl, sp, *args[3:], kt,
                filter_words=fw)
            mv, mi = pgs.merge_pairs(pair_v, pair_i, k)
        else:
            mv, mi = pcs.codes_fused_query_major(*args, k, kt,
                                                 filter_words=fw)
        jv, ji = pcp.grouped_code_scan_fused(*jargs, kt, k, n_probes, bits,
                                             interpret=True, merge_window=2,
                                             adm_words=adm)
        ref_v = np.asarray(jv)[:, :nq].T
        worst = ref_v >= _ACC_WORST
        ref_v = np.where(worst, np.inf, ref_v)
        ref_i = np.where(worst, -1, np.asarray(ji)[:, :nq].T)
        got_v, got_i, pi = mv.numpy(), mi.numpy(), mi
    _assert_close_but_ties(got_v, got_i, ref_v, ref_i, tol)
    if selectivity < 0.5:                      # exhausted slots occur
        assert not np.isfinite(ref_v).all()
    flat = pi.reshape(nq, -1)
    got = flat[flat >= 0].long().numpy()
    assert mask[np.nonzero(flat.numpy() >= 0)[0], got].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_code_list_scan_equals_the_recon_pass_over_decoded_rows(case):
    """The codes pass's plain version equals Kernel G's list-major plain
    pass over ``decode_codes(list_codes)`` with the same norms bit for bit
    (on the card, the kernels are held to each other bit for bit too);
    the wrappers on CPU tensors are those plain versions."""
    (qrot, centers, p, codes, books, rsq, ids, bits), kt = _inputs(case)
    p[0, -1] = -1
    probes = torch.from_numpy(p)
    groups = grouped.build_groups(probes, ids.shape[0])
    cv, ci = pcs.code_list_scan_plain(qrot, centers, probes, *groups, codes,
                                      books, rsq, ids, bits, kt)
    recon = pcs.decode_codes(codes, books, bits)
    rv, ri = pgs.list_scan_plain(qrot, centers, probes, *groups, recon, rsq,
                                 ids, kt)
    assert torch.equal(cv, rv) and torch.equal(ci, ri)
    wv, wi = pcs.code_list_scan(qrot, centers, probes, *groups, codes, books,
                                rsq, ids, bits, kt)
    assert torch.equal(wv, cv) and torch.equal(wi, ci)
    # and Kernel D's query-major plain version gives the same pairs
    dv, di = pcs.ivf_pq_scan_codes_plain(qrot, centers, probes, codes, books,
                                         rsq, ids, bits, kt)
    assert torch.equal(dv, cv) and torch.equal(di, ci)


@pytest.mark.parametrize("case", ["bits8-len2-kt4", "bits4-len2-kt20",
                                  "bits8-hot-list-kt10"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_kernel_c_schedule_equals_kernel_c_plain(case, k):
    """The merge of the pair output at kt (>= k: bit for bit) and at the
    per-pair kt' = min(kt, k) the card route runs (values the same bits,
    ids but at ties) against ``ivf_pq_scan_codes_fused_plain``."""
    (qrot, centers, p, codes, books, rsq, ids, bits), kt = _inputs(case)
    probes = torch.from_numpy(p)
    groups = grouped.build_groups(probes, ids.shape[0])
    kt = min(kt, ids.shape[1])
    fv, fi = pcs.ivf_pq_scan_codes_fused_plain(qrot, centers, probes, codes,
                                               books, rsq, ids, bits, k, kt)
    pv, pi = pcs.code_list_scan(qrot, centers, probes, *groups, codes, books,
                                rsq, ids, bits, kt)
    mv, mi = pgs.merge_pairs(pv, pi, k)
    assert torch.equal(mv, fv) and torch.equal(mi, fi)
    pv, pi = pcs.code_list_scan(qrot, centers, probes, *groups, codes, books,
                                rsq, ids, bits, min(kt, k))
    mv, mi = pgs.merge_pairs(pv, pi, k)
    assert torch.equal(mv, fv)
    _assert_close_but_ties(mv.numpy(), mi.numpy(), fv.numpy(), fi.numpy(),
                           0.0)
    # the public wrapper on CPU tensors is the plain version
    wv, wi = pcs.ivf_pq_scan_codes_fused(qrot, centers, probes, codes, books,
                                         rsq, ids, bits, k, kt)
    assert torch.equal(wv, fv) and torch.equal(wi, fi)


def _layout_bytes(rot, pq_dim, pq_bits, kt):
    """``code_layout``'s parts summed one by one (a second reading of
    csrc/pq_code_list_scan.cu): residuals, row stages, keys, top kt,
    sub_sq and pair indices, books, raw code stages, alignment."""
    kp = -(-rot // 16) * 16
    atoms = -(-min(kp, 128) // 64)
    residuals = atoms * 16384 * (1 if kp <= 128 else 2)
    rows = 2 * max(atoms * 16384, 32768)
    keys = 2 * 128 * 8
    top = 2 * 128 * (-(-kt // 8) * 8) * 4
    books = pq_dim * (1 << pq_bits) * (rot // pq_dim) * 2
    raw = 2 * (-(-128 * -(-pq_dim * pq_bits // 8) // 16) * 16 + 16)
    return residuals + rows + keys + top + 2 * 512 + books + raw + 1024


@pytest.mark.parametrize("rot,pq_dim,pq_bits", [
    (96, 48, 8), (128, 64, 8), (36, 12, 8), (36, 12, 4), (256, 128, 4),
    (256, 64, 8), (24, 24, 8)])
def test_code_list_scan_smem_bytes_mirrors_the_layout(rot, pq_dim, pq_bits):
    """The one formula against the layout's parts at every kt; the deep
    shape (rot 96, 8 bits) fits the card's 232,448 B at every kt up to 64,
    the flagship's (rot 128, 8 bits) up to kt 40 (24 with room), rot 256
    at 8 bits nowhere (its 128 KB of books)."""
    for kt in range(1, pgs.KT_LIST_MAX + 1):
        need = pcs.code_list_scan_smem_bytes(rot, pq_dim, pq_bits, kt)
        assert need == _layout_bytes(rot, pq_dim, pq_bits, kt)
        fits = need <= pgs._SMEM_LIMIT
        assert fits == (not pcs.code_list_scan_reject_reason(
            rot, pq_dim, pq_bits, kt))
        if (rot, pq_bits) == (96, 8):
            assert fits
        if (rot, pq_bits) == (128, 8):
            assert fits == (kt <= 40)
        if (rot, pq_bits) == (256, 8):
            assert not fits


def test_code_gates_route_by_kt_and_name_their_reason():
    """The list-major pass takes a pair kt up to 64 at any capacity and
    any rot that pq_dim divides; C's and D's three-route gates refuse
    only where all three routes do (the pair-group pass takes a pair kt of
    65-128 at any capacity), naming all three; no shape the query-major
    kernels took is refused."""
    assert not pcs.code_list_scan_reject_reason(96, 48, 8, 64)
    assert "outside 1..64" in pcs.code_list_scan_reject_reason(96, 48, 8, 65)
    assert not pcs.code_list_scan_reject_reason(36, 12, 4, 4)   # rot % 8
    assert "multiple of pq_dim" in pcs.code_list_scan_reject_reason(
        30, 8, 8, 4)
    assert "pq_bits=5" in pcs.code_list_scan_reject_reason(32, 8, 5, 4)
    assert "shared memory" in pcs.code_list_scan_reject_reason(128, 64, 8, 64)
    # a capacity no query-major block could hold: list-major at kt' <= 64
    big = 200_000
    assert pcs.codes_fused_query_major_reject_reason(big, 96, 48, 8, 20, 20)
    assert not pcs.codes_fused_reject_reason(big, 96, 48, 8, 20, 20)
    assert not pcs.codes_fused_reject_reason(big, 96, 48, 8, 20, 256)
    assert not pcs.codes_reject_reason(big, 96, 48, 8, 64)
    assert not pcs.codes_reject_reason(big, 96, 48, 8, 65)
    assert pcs.codes_scan_route(big, 96, 48, 8, 65)[0] == "pair"
    reason = pcs.codes_reject_reason(big, 96, 48, 8, 129)
    assert "list-major" in reason and "pair-group route" in reason
    assert "query-major route" in reason
    assert not pcs.codes_fused_reject_reason(big, 96, 48, 8, 100, 100)
    assert pcs.codes_fused_route(big, 96, 48, 8, 100, 100)[0] == "pair"
    reason = pcs.codes_fused_reject_reason(big, 96, 48, 8, 200, 200)
    assert "list-major" in reason and "pair-group route" in reason
    assert "shared memory" in reason
    # the flagship at kt 64: the query-major kernels take it
    assert not pcs.codes_reject_reason(416, 128, 64, 8, 64)
    assert not pcs.codes_fused_reject_reason(416, 128, 64, 8, 64, 64)
    assert "k=300" in pcs.codes_fused_reject_reason(64, 32, 8, 8, 300, 4)
    # every shape the query-major gates take, the three-route gates take
    for cap in (40, 416, 2368, 20_000):
        for rot, pq_dim, bits in ((96, 48, 8), (128, 64, 8), (36, 12, 4),
                                  (256, 64, 8)):
            for k, kt in ((20, 4), (20, 20), (10, 64), (128, 128),
                          (256, 100)):
                if not pcs.codes_fused_query_major_reject_reason(
                        cap, rot, pq_dim, bits, k, kt):
                    assert not pcs.codes_fused_reject_reason(
                        cap, rot, pq_dim, bits, k, kt)
                if not pcs.codes_query_major_reject_reason(
                        cap, rot, pq_dim, bits, kt):
                    assert not pcs.codes_reject_reason(cap, rot, pq_dim,
                                                       bits, kt)


@pytest.mark.parametrize("name", list(code_scan_decomp.VARIANTS))
def test_code_scan_decomp_variants_apply_to_the_scan_source(name):
    """Each profile variant's substitutions match ``pq_code_list_scan.cu``
    or the decode it includes (``row_source.cuh``) exactly once (the
    profile raises otherwise), and only ``as built`` leaves the sources as
    they are."""
    base = {f: (code_scan_decomp._cuda.SRC_DIR / f).read_text()
            for f in code_scan_decomp.SCAN_SOURCES}
    texts = code_scan_decomp.variant_sources(name)
    assert (texts == base) == (name == "as built")


def test_code_scan_decomp_needs_the_card(monkeypatch):
    """Off the card the profile stops before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(code_scan_decomp, "build", lambda *a: pytest.fail(
        "built without a card"))
    with pytest.raises(SystemExit):
        code_scan_decomp.main()

"""Kernel F's list-major route in raft_tpu_torch, on the CPU.

The list-major schedule (``pair_scan.flat_list_scan``'s plain version:
each pair group's pairs against its tile, their top kt scattered by
``slot_pairs``) is held to the JAX package's grouped Pallas scan
``grouped_flat_l2_scan`` (interpreted) on the same groups, within 1e-5 of
‖q‖² + max ‖x‖² (the two sum the fp32 products in their own orders), ids
equal but at distance ties; and to the query-major plain version of
Kernel F, L2 and InnerProduct: the same ids, values within 1e-6 of that
scale (the two batch the same fp32 products differently, which moves the
last bit of a sum).  With a filter, the port's filtered plain passes
(the list-major pass at kt 10, the query-major route at kt 80) are held
to ``grouped_flat_l2_scan`` run with ``adm_words``.  Inputs are numpy
draws from a seed: random fp32 rows with padding (-1) and tombstones
(<= -2), probes
with a hot list past one group, super-tiled views of F adjacent lists
with their dedupe sentinels, probes past the lists and negative probes.
The dispatch gate and the shared-memory formula are checked at the
shapes the card takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.ops import pq_group_scan_pallas as pqp
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped, ivf_flat
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_group_scan as pgs
from raft_tpu_torch.profiles import flat_scan_decomp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test, as the other port test files:
    a parallel test run otherwise oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists(n_lists, cap, dim, seed):
    """Random fp32 rows, their squared norms, and ids with padding (-1)
    past each list's size and tombstones (<= -2)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_lists, cap, dim)).astype(np.float32)
    sizes = rng.integers(cap // 3, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for lst, s in enumerate(sizes):
        ids[lst, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 1::7] = np.where(ids[:, 1::7] >= 0, -(ids[:, 1::7] + 2), -1)
    return (torch.from_numpy(data), torch.from_numpy((data ** 2).sum(-1)),
            torch.from_numpy(ids))


def _probes(seed, nq, n_probes, n_lists, hot=0, sentinels=0.0):
    """(nq, n_probes) int32 probes, distinct lists per query; the first
    ``hot`` queries probe list 3 first; a ``sentinels`` share set past the
    lists; one negative probe."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.choice(n_lists, n_probes, replace=False)
                  for _ in range(nq)]).astype(np.int32)
    for q in range(hot):
        row = p[q]
        row[row == 3] = row[0]
        row[0] = 3
    off = rng.random(p.shape) < sentinels
    p[off] = n_lists + rng.integers(0, 3, int(off.sum()))
    p[0, -1] = -1
    return torch.from_numpy(p)


CASES = {  # n_lists, cap, dim, nq, n_probes, F, hot, sentinels, kt
    "l2": (8, 48, 32, 30, 4, 1, 0, 0.0, 5),
    "dim-128": (6, 48, 128, 24, 3, 1, 0, 0.1, 10),
    "super-F2": (16, 32, 32, 40, 6, 2, 0, 0.0, 8),
    "super-F4": (16, 32, 24, 40, 8, 4, 0, 0.0, 10),
    "sentinels-kt-past-live": (10, 30, 16, 40, 5, 1, 0, 0.2, 30),
    "hot-tile": (6, 40, 16, 200, 3, 1, 160, 0.0, 6),
    "hot-super-tile": (8, 32, 16, 300, 4, 2, 280, 0.05, 12),
    "odd-dim-25": (8, 40, 25, 30, 4, 1, 0, 0.1, 7),
    "odd-dim-50-F2": (12, 24, 50, 40, 6, 2, 0, 0.0, 9),
}


def _inputs(case):
    """A case's scan inputs as ivf_flat.search hands them to Kernel F:
    the (super-tile) view of the lists, the (deduplicated super-) probes,
    kt and F."""
    n_lists, cap, dim, nq, n_probes, F, hot, sentinels, kt = CASES[case]
    data, dsq, ids = _lists(n_lists, cap, dim, cap + dim + F)
    rng = np.random.default_rng(nq + dim)
    q = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32))
    probes = _probes(nq + n_probes, nq, n_probes, n_lists, hot, sentinels)
    n_eff = n_lists // F
    if F > 1:
        probes = torch.where(probes < 0, torch.full_like(probes, n_lists),
                             probes)
        probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
    return (q, probes, data.reshape(n_eff, F * cap, dim),
            dsq.reshape(n_eff, F * cap), ids.reshape(n_eff, F * cap)), kt, F


def _scale(q, dsq):
    return float((q * q).sum(1).max() + dsq.max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_list_major_schedule_matches_the_jax_grouped_flat_scan(case):
    """The plain list-major pass on the port's groups against
    ``grouped_flat_l2_scan`` (Pallas, interpreted) on the same
    ``(group_list, slot_pairs)``: per pair, distances within 1e-5 of ‖q‖² +
    max ‖x‖² and the same ids but at distance ties; the pairs no group
    holds (sentinels, negative probes) empty."""
    (q, probes, data, dsq, ids), kt, F = _inputs(case)
    n_tiles, rows, _ = data.shape
    nq, n_probes = probes.shape
    gl, sp = grouped.build_groups(probes, n_tiles)
    if CASES[case][6] > grouped.GROUP:
        assert int((gl == gl[torch.bincount(gl.long()).argmax()]).sum()) >= 2
    pv, pi = ps.flat_list_scan(q, probes, gl, sp, data, dsq, ids, kt,
                               sub_lists=F)
    kt = min(kt, rows)
    jv, ji = pqp.grouped_flat_l2_scan(
        jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()),
        jnp.asarray(q.numpy()), jnp.asarray(data.numpy()),
        jnp.asarray(dsq.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    slots = sp.numpy().reshape(-1)
    live = slots < probes.numel()
    ref_v = jv.reshape(-1, kt)[live]
    ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
    got_v = pv.reshape(-1, kt).numpy()[slots[live]]
    got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    tol = 1e-5 * _scale(q, dsq)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=0, atol=tol)
    differ = got_i != ref_i
    tie = np.zeros_like(differ)
    with np.errstate(invalid="ignore"):          # inf - inf past the live
        near = np.abs(np.diff(got_v, axis=1)) <= 2 * tol
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    assert not (differ & ~tie).any()
    out = ~np.isin(np.arange(probes.numel()), slots[live])
    assert out.any()
    assert np.isinf(pv.reshape(-1, kt).numpy()[out]).all()
    assert (pi.reshape(-1, kt).numpy()[out] == -1).all()


@pytest.mark.parametrize("selectivity", [0.05, 0.5])
@pytest.mark.parametrize("kt", [10, 80])
def test_filtered_passes_match_the_pallas_flat_scan_with_adm_words(
        kt, selectivity):
    """The port's filtered plain passes against ``grouped_flat_l2_scan``
    run with ``adm_words`` (the JAX package's ``group_admission_words`` of
    the same groups; interpreted), at a list-major kt (10:
    ``flat_list_scan``) and past ``KT_LIST_MAX`` (80:
    ``flat_scan_query_major``): per pair, distances within 1e-5 of ‖q‖² +
    max ‖x‖², the same exhausted slots (-1 exactly there), ids equal but
    at ties; every id admitted by its query."""
    n_lists, cap, dim, nq, n_probes = 6, 112, 32, 40, 3
    data, dsq, ids = _lists(n_lists, cap, dim, 41)
    rng = np.random.default_rng(42)
    q = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32))
    probes = _probes(43, nq, n_probes, n_lists, 0, 0.1)
    gl, sp = grouped.build_groups(probes, n_lists)
    mask = np.random.default_rng(kt).random((nq, int(ids.max()) + 1)) \
        < selectivity
    fw = bitset.pack_mask(torch.from_numpy(mask))
    adm = jax_bitset.group_admission_words(
        jnp.asarray(fw.numpy()), jnp.asarray(gl.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(ids.numpy()), n_probes,
        probes.numel())
    if kt <= pgs.KT_LIST_MAX:
        pv, pi = ps.flat_list_scan(q, probes, gl, sp, data, dsq, ids, kt,
                                   filter_words=fw)
    else:
        pv, pi = ps.flat_scan_query_major(q, probes, data, dsq, ids, kt,
                                          filter_words=fw)
    jv, ji = pqp.grouped_flat_l2_scan(
        jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()),
        jnp.asarray(q.numpy()), jnp.asarray(data.numpy()),
        jnp.asarray(dsq.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True, adm_words=adm)
    jv, ji = np.asarray(jv), np.asarray(ji)
    slots = sp.numpy().reshape(-1)
    live = slots < probes.numel()
    ref_v = jv.reshape(-1, kt)[live]
    ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
    got_v = pv.reshape(-1, kt).numpy()[slots[live]]
    got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_array_equal(got_i < 0, ~fin)
    tol = 1e-5 * _scale(q, dsq)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=0, atol=tol)
    tie = np.zeros(got_v.shape, bool)
    with np.errstate(invalid="ignore"):          # inf - inf past the live
        near = np.abs(np.diff(got_v, axis=1)) <= 2 * tol
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    assert not ((got_i != ref_i) & ~tie).any()
    if selectivity < 0.5:                      # exhausted slots occur
        assert not fin.all()
    flat = pi.reshape(nq, -1).numpy()
    assert mask[np.nonzero(flat >= 0)[0], flat[flat >= 0]].all()


@pytest.mark.parametrize("ip", [False, True], ids=["l2", "ip"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_list_major_schedule_equals_the_query_major_plain_scan(case, ip):
    """The plain list-major pass gives ``ivf_flat_scan``'s plain
    (query-major) output: the same ids and exhausted ranks, values within
    1e-6 of ‖q‖² + max ‖x‖² (a GEMV over another batch may round its last
    bit otherwise), empty pairs included — (+inf, -1), or (-inf, -1) and
    descending products in the InnerProduct form; the public wrapper on
    CPU tensors is that plain version bit for bit, whatever
    ``sub_lists``."""
    (q, probes, data, dsq, ids), kt, F = _inputs(case)
    groups = grouped.build_groups(probes, data.shape[0])
    lv, li = ps.flat_list_scan(q, probes, *groups, data, dsq, ids, kt, ip,
                               sub_lists=F)
    rv, ri = ps.ivf_flat_scan_plain(q, probes, data, dsq, ids, kt, ip)
    assert lv.shape == rv.shape == (*probes.shape, min(kt, data.shape[1]))
    assert torch.equal(li, ri)
    assert torch.equal(torch.isfinite(lv), torch.isfinite(rv))
    torch.testing.assert_close(lv, rv, rtol=0, atol=1e-6 * _scale(q, dsq))
    worst = float("-inf") if ip else float("inf")
    assert bool((lv[0, -1] == worst).all()) and bool((li[0, -1] == -1).all())
    fin = torch.isfinite(lv)
    assert bool(((lv[..., 1:] <= lv[..., :-1]) if ip
                 else (lv[..., 1:] >= lv[..., :-1]))[fin[..., 1:]].all())
    wv, wi = ps.ivf_flat_scan(q, probes, data, dsq, ids, kt, ip,
                              sub_lists=F)
    assert torch.equal(wv, rv) and torch.equal(wi, ri)


def test_flat_gate_routes_by_kt_and_names_its_reason():
    """kt up to KT_LIST_MAX takes the list-major pass at any capacity,
    any row width from 1 (GloVe's 25 and 50 among them) and super-tile
    factor up to 8; kt 65, a width of 0 and a tile that F equal sub-lists
    cannot split each name their reason (the dispatcher then runs the
    query-major kernel, whose own gate decides)."""
    kmax = pgs.KT_LIST_MAX
    assert kmax == 64
    for rows, dim, kt, sub in ((832, 128, 10, 2), (640, 128, 10, 4),
                               (200_000, 128, kmax, 1), (40, 12, 3, 1),
                               (768, 1024, 1, 8), (40, 10, 4, 1),
                               (300, 25, kmax, 1), (600, 50, 10, 2),
                               (64, 1, 1, 1)):
        assert not ps.flat_list_scan_reject_reason(rows, dim, kt, sub)
    assert "outside 1..64" in ps.flat_list_scan_reject_reason(
        300, 128, kmax + 1)
    assert "outside 1..64" in ps.flat_list_scan_reject_reason(300, 128, 0)
    assert "< 1" in ps.flat_list_scan_reject_reason(40, 0, 4)
    assert "sub-lists" in ps.flat_list_scan_reject_reason(100, 128, 10, 3)
    assert "sub-lists" in ps.flat_list_scan_reject_reason(1600, 128, 10, 16)
    # the query-major route takes what the list-major gate leaves
    assert not ps.pair_scan_reject_reason(300, 128, kmax + 1, 4)


@pytest.mark.parametrize("dim", [12, 25, 96, 128, 1024])
@pytest.mark.parametrize("kt", [1, 10, 20, 32, 33, 64])
def test_flat_layout_fits_the_card(dim, kt):
    """The list-major block's shared memory (``flat_list_scan_layout``,
    the one copy of the layout, which the kernel reads) stays within the
    H100's 232,448 B at every dim and kt: the queries stay resident where
    everything fits, else they stream in two 32-dim stages (a fixed
    200,832 B at kt 64); the offsets ascend, the swizzled operands' on
    1024-byte atoms, and a top-kt row holds kt."""
    need = ps.flat_list_scan_smem_bytes(dim, kt)
    assert need <= 232_448 == pgs._SMEM_LIMIT
    op = 128 * 128                     # one 128-row, 32-dim fp32 operand
    streamed = ps.flat_list_scan_smem_bytes(4096, kt)
    resident = streamed - 2 * 2 * op + 2 * -(-dim // 32) * op
    assert need == (resident if resident <= 232_448 else streamed)
    assert ps.flat_list_scan_smem_bytes(4096, 64) == 200_832
    # the main path's shape (dim 128, k 10) keeps its queries resident
    assert ps.flat_list_scan_smem_bytes(128, 10) == 217_216
    assert not ps.flat_list_scan_reject_reason(128 * 8, dim, kt)
    lay = ps.flat_list_scan_layout(dim, kt)
    assert bool(lay.resident) == (resident <= 232_448) and lay.stride >= kt
    offsets = lay[3:]
    assert list(offsets) == sorted(offsets) and offsets[0] > 0
    assert lay.a_step % 1024 == lay.a_lo % 1024 == lay.b % 1024 == 0
    assert list(lay.as_c()) == list(lay)


def test_super_tile_sub_lists_do_not_change_the_plain_result():
    """``sub_lists`` only says which slots the card streams: the plain
    pass gives the same result at F 1 and at the tile's true F."""
    (q, probes, data, dsq, ids), kt, F = _inputs("super-F4")
    groups = grouped.build_groups(probes, data.shape[0])
    a = ps.flat_list_scan(q, probes, *groups, data, dsq, ids, kt,
                          sub_lists=F)
    b = ps.flat_list_scan(q, probes, *groups, data, dsq, ids, kt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", list(flat_scan_decomp.VARIANTS))
def test_flat_scan_decomp_variants_apply_to_the_scan_source(name):
    """Each profile variant's substitutions match ``flat_list_scan.cu``
    and the fold header it includes exactly once in all (the profile
    raises otherwise), and only ``as built`` leaves the sources as they
    are."""
    base = {f: (flat_scan_decomp._cuda.SRC_DIR / f).read_text()
            for f in flat_scan_decomp.SCAN_SOURCES}
    texts = flat_scan_decomp.variant_sources(name)
    assert (texts == base) == (name == "as built")


def test_flat_scan_decomp_needs_the_card(monkeypatch):
    """Off the card the profile stops before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(flat_scan_decomp, "build", lambda *a: pytest.fail(
        "built without a card"))
    with pytest.raises(SystemExit):
        flat_scan_decomp.main()

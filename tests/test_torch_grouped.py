"""raft_tpu_torch's pair grouping and the list-major recon scans, on the CPU.

The port's ``neighbors/grouped.build_groups`` is held to the JAX module's
bit for bit (at the exact group count, and as the prefix of the JAX
package's rounded count); the list-major schedule, emulated by
``list_scan``'s plain version, is held to the query-major plain version of
Kernel G bit for bit, and to the JAX package's grouped Pallas scan
(interpreted, on the same groups) at the recon scans' 1e-4; the merge of
its output to Kernel B's plain version bit for bit.  With a filter, the
port's filtered plain passes of Kernels B and G (the list-major pass at
kt 10, the query-major route at kt 80) are held to the Pallas kernels run
with ``adm_words`` (interpreted).  Inputs are numpy draws from a seed:
random recon rows with padding (-1) and tombstones (<= -2), probes with a
hot list past one group, probes ``>= n_lists`` (the JAX sentinels) and,
for the port, negative probes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.neighbors import grouped as jax_grouped
from raft_tpu.ops import pq_group_scan_pallas as pqp
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_group_scan as pgs
from raft_tpu_torch.profiles import list_scan_decomp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test, as the other port test files:
    a parallel test run otherwise oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probes(seed, nq, n_probes, n_lists, hot=0, sentinels=0.0):
    """(nq, n_probes) int32 probes: distinct lists per query; the first
    ``hot`` queries all probe list 3 first (one list past 128 pairs when
    hot > 128); a ``sentinels`` share of the rest set to n_lists or
    above."""
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


PROBE_CASES = {
    "uniform": dict(nq=40, n_probes=6, n_lists=16),
    "hot-list": dict(nq=300, n_probes=4, n_lists=16, hot=200),
    "sentinels": dict(nq=60, n_probes=5, n_lists=12, sentinels=0.2),
    "hot-and-sentinels": dict(nq=280, n_probes=3, n_lists=8, hot=140,
                              sentinels=0.1),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_build_groups_matches_the_jax_grouping_bit_for_bit(case):
    """group_list and every slot of slot_pairs, at the exact group count;
    the JAX package's rounded count has the port's groups as its prefix."""
    p = _probes(1, **PROBE_CASES[case])
    n_lists = PROBE_CASES[case]["n_lists"]
    gl, sp = grouped.build_groups(torch.from_numpy(p), n_lists)
    exact = int(jax_grouped.num_groups(jnp.asarray(p), n_lists))
    assert gl.shape == (exact,) and sp.shape == (exact, grouped.GROUP)
    assert gl.dtype == sp.dtype == torch.int32
    jgl, jsp = jax_grouped.build_groups(jnp.asarray(p), n_lists, exact)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(jgl))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    rounded = jax_grouped.round_groups(exact)
    rgl, rsp = jax_grouped.build_groups(jnp.asarray(p), n_lists, rounded)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rgl)[:exact])
    np.testing.assert_array_equal(sp.numpy(), np.asarray(rsp)[:exact])
    assert (np.asarray(rsp)[exact:] == p.size).all()
    if PROBE_CASES[case].get("hot", 0) > grouped.GROUP:
        assert int((gl == 3).sum()) >= 2          # one list, two groups


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_num_groups_and_touched_lists_match_jax(case):
    p = _probes(2, **PROBE_CASES[case])
    n_lists = PROBE_CASES[case]["n_lists"]
    t = torch.from_numpy(p)
    assert int(grouped.num_groups(t, n_lists)) == int(
        jax_grouped.num_groups(jnp.asarray(p), n_lists))
    assert int(grouped.touched_lists(t, n_lists)) == int(
        jax_grouped.touched_lists(jnp.asarray(p), n_lists))


def test_negative_probes_are_in_no_group():
    """A negative probe groups as the sentinel n_lists does: its pair is in
    no slot, and the other pairs keep their groups."""
    p = _probes(3, nq=50, n_probes=4, n_lists=10)
    neg, sent = p.copy(), p.copy()
    neg[::7, 1] = -1
    sent[::7, 1] = 10
    gl, sp = grouped.build_groups(torch.from_numpy(neg), 10)
    rgl, rsp = grouped.build_groups(torch.from_numpy(sent), 10)
    assert torch.equal(gl, rgl) and torch.equal(sp, rsp)
    dropped = np.flatnonzero(neg.reshape(-1) < 0)
    assert not np.isin(dropped, sp.numpy()).any()


def test_build_groups_of_an_empty_batch():
    gl, sp = grouped.build_groups(torch.zeros(0, 4, dtype=torch.int32), 8)
    assert gl.shape == (0,) and sp.shape == (0, grouped.GROUP)


def _recon_index(n_lists, cap, rot, seed, duplicate_lists=False):
    """Random bf16 recon rows, their norms, ids with padding (-1) and
    tombstones (<= -2), and centers; ``duplicate_lists`` makes list 1 an
    exact copy of list 0 (rows, norms and center) under other ids, so a
    query probing both meets equal distances in two probes."""
    rng = np.random.default_rng(seed)
    recon = torch.from_numpy(rng.normal(size=(n_lists, cap, rot)).astype(
        np.float32)).to(torch.bfloat16)
    centers = torch.from_numpy(rng.normal(size=(n_lists, rot)).astype(
        np.float32))
    sizes = rng.integers(cap // 3, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for lst, s in enumerate(sizes):
        ids[lst, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 1::7] = np.where(ids[:, 1::7] >= 0, -(ids[:, 1::7] + 2), -1)
    if duplicate_lists:
        recon[1], centers[1] = recon[0], centers[0]
        ids[1] = np.where(ids[0] >= 0, ids[0] + nxt, ids[0])
    rsq = (recon.float() ** 2).sum(-1)
    return centers, recon, rsq, torch.from_numpy(ids)


SCAN_CASES = {  # n_lists, cap, rot, nq, n_probes, hot, sentinels, kt
    "small": (8, 40, 24, 30, 4, 0, 0.0, 5),
    "hot-list": (6, 70, 32, 200, 3, 160, 0.0, 8),
    "sentinels-kt-past-live": (10, 30, 16, 40, 5, 0, 0.15, 30),
}


def _scan_inputs(case, duplicate_lists=False):
    n_lists, cap, rot, nq, n_probes, hot, sentinels, kt = SCAN_CASES[case]
    centers, recon, rsq, ids = _recon_index(n_lists, cap, rot, cap + rot,
                                            duplicate_lists)
    rng = np.random.default_rng(5)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    p = _probes(4, nq, n_probes, n_lists, hot, sentinels)
    p[0, -1] = -1                       # a negative probe: an empty pair
    return (qrot, centers, torch.from_numpy(p), recon, rsq, ids), kt


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_list_major_schedule_equals_the_query_major_plain_scan(case):
    """The list-major schedule (each group's pairs against its list, the
    pairs' top kt scattered by slot_pairs) gives ``ivf_pq_scan_recon``'s
    plain output bit for bit, empty pairs included."""
    (qrot, centers, probes, recon, rsq, ids), kt = _scan_inputs(case)
    groups = grouped.build_groups(probes, centers.shape[0])
    lv, li = pgs.list_scan(qrot, centers, probes, *groups, recon, rsq, ids,
                           kt)
    rv, ri = ps.ivf_pq_scan_recon_plain(qrot, centers, probes, recon, rsq,
                                        ids, kt)
    assert lv.shape == rv.shape == (*probes.shape, min(kt, recon.shape[1]))
    assert torch.equal(lv, rv) and torch.equal(li, ri)
    assert bool(torch.isinf(lv[0, -1]).all()) and bool((li[0, -1] == -1).all())
    # and the public wrapper on CPU tensors is that plain version
    wv, wi = ps.ivf_pq_scan_recon(qrot, centers, probes, recon, rsq, ids, kt)
    assert torch.equal(wv, rv) and torch.equal(wi, ri)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("k", [1, 10, 64])
def test_merge_of_the_grouped_output_equals_kernel_b_plain(case, k):
    """``merge_pairs`` (its plain version, ``query_topk``) over the
    list-major pair output gives ``ivf_pq_scan_fused_plain`` bit for bit;
    list 1 duplicates list 0, so distance ties cross probes.  At the
    per-pair kt' = min(kt, k) that Kernel B's card route runs, the values
    are the same bits and the ids differ only where ``torch.topk`` picks
    another of equal distances."""
    (qrot, centers, probes, recon, rsq, ids), kt = _scan_inputs(
        case, duplicate_lists=True)
    kt = min(kt, recon.shape[1])
    groups = grouped.build_groups(probes, centers.shape[0])
    fv, fi = pgs.ivf_pq_scan_fused_plain(qrot, centers, probes, recon, rsq,
                                         ids, k, kt)
    pv, pi = pgs.list_scan(qrot, centers, probes, *groups, recon, rsq, ids,
                           kt)
    mv, mi = pgs.merge_pairs(pv, pi, k)
    assert torch.equal(mv, fv) and torch.equal(mi, fi)
    assert bool(((probes == 0).any(1) & (probes == 1).any(1)).any())
    pv, pi = pgs.list_scan(qrot, centers, probes, *groups, recon, rsq, ids,
                           min(kt, k))
    mv, mi = pgs.merge_pairs(pv, pi, k)
    assert torch.equal(mv, fv) and torch.equal(mi >= 0, fi >= 0)
    tie = torch.zeros_like(mv, dtype=torch.bool)
    if k > 1:
        near = mv[:, 1:] == mv[:, :-1]
        tie[:, 1:] |= near
        tie[:, :-1] |= near
    last = torch.isfinite(mv) & ~torch.isfinite(torch.cat(
        [mv[:, 1:], torch.full_like(mv[:, :1], float("inf"))], 1))
    assert bool(((mi == fi) | tie | last).all())


@pytest.mark.parametrize("kt", [3, 10])
def test_list_scan_matches_the_jax_grouped_scan_on_the_same_groups(kt):
    """Pass 1 on the port's groups against ``grouped_l2_scan`` (Pallas,
    interpreted) on the same ``(group_list, slot_pairs)``: per pair,
    distances within 1e-4 and the same ids but at distance ties.  rot 128
    and a capacity that is a multiple of 16, as the JAX kernel takes."""
    n_lists, cap, rot, nq, n_probes = 6, 48, 128, 40, 3
    centers, recon, rsq, ids = _recon_index(n_lists, cap, rot, 11)
    rng = np.random.default_rng(12)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    p = _probes(13, nq, n_probes, n_lists, sentinels=0.1)
    probes = torch.from_numpy(p)
    gl, sp = grouped.build_groups(probes, n_lists)
    pv, pi = pgs.list_scan(qrot, centers, probes, gl, sp, recon, rsq, ids,
                           kt)
    jv, ji = pqp.grouped_l2_scan(
        jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()),
        jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
        jnp.asarray(recon.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rsq.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    slots = sp.numpy().reshape(-1)
    live = slots < p.size
    ref_v = jv.reshape(-1, kt)[live]
    ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
    got_v = pv.reshape(-1, kt).numpy()[slots[live]]
    got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=1e-4, atol=1e-4)
    differ = got_i != ref_i
    tie = np.zeros_like(differ)
    near = np.abs(np.diff(got_v, axis=1)) <= 1e-4 * (1 + np.abs(got_v[:, 1:]))
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    assert not (differ & ~tie).any()
    # the pairs no group holds are empty
    out = ~np.isin(np.arange(p.size), slots[live])
    assert np.isinf(pv.reshape(-1, kt).numpy()[out]).all()


def _filter_words(nq, n_ids, selectivity, seed):
    """A per-query filter admitting each id with probability
    ``selectivity``: the port's packed words (nq, n_words) int32."""
    mask = np.random.default_rng(seed).random((nq, n_ids)) < selectivity
    return bitset.pack_mask(torch.from_numpy(mask))


def _admission(words, gl, sp, ids, n_probes, n_pairs):
    """The Pallas kernels' ``adm_words`` for the same groups: the JAX
    package's ``group_admission_words``."""
    return jax_bitset.group_admission_words(
        jnp.asarray(words.numpy()), jnp.asarray(gl.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(ids.numpy()), n_probes,
        n_pairs)


def _assert_close_but_ties(got_v, got_i, ref_v, ref_i):
    """The recon scans' tolerance: the same exhausted ranks (-1 exactly
    there), values within 1e-4, ids equal but at distance ties (a
    neighbouring value within 1e-4 relative, or the row's last finite
    rank)."""
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_array_equal(got_i < 0, ~fin)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=1e-4, atol=1e-4)
    tie = np.zeros(got_v.shape, bool)
    with np.errstate(invalid="ignore"):
        near = np.abs(np.diff(got_v, axis=1)) <= 1e-4 * (
            1 + np.abs(got_v[:, 1:]))
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    last = fin & ~np.concatenate([fin[:, 1:], np.zeros_like(fin[:, :1])], 1)
    assert not ((got_i != ref_i) & ~tie & ~last).any()


@pytest.mark.parametrize("selectivity", [0.05, 0.5])
@pytest.mark.parametrize("kt", [10, 80])
@pytest.mark.parametrize("kernel", ["B", "G"])
def test_filtered_passes_match_the_pallas_scans_with_adm_words(
        kernel, kt, selectivity):
    """The port's filtered plain passes against the Pallas kernels run with
    ``adm_words`` (interpreted) on the same groups, at a list-major kt (10:
    ``list_scan``, for B followed by ``merge_pairs``) and past
    ``KT_LIST_MAX`` (80: ``recon_scan_query_major`` for G,
    ``scan_query_major`` for B, k 100): G per pair, B per query (the
    finite worst sentinel read as (+inf, -1)), at the recon scans'
    tolerance; every id admitted by its query."""
    n_lists, cap, rot, nq, n_probes, k = 6, 112, 128, 40, 3, 100
    centers, recon, rsq, ids = _recon_index(n_lists, cap, rot, 11)
    rng = np.random.default_rng(12)
    qrot = torch.from_numpy(rng.normal(size=(nq, rot)).astype(np.float32))
    p = _probes(13, nq, n_probes, n_lists, sentinels=0.1)
    probes = torch.from_numpy(p)
    gl, sp = grouped.build_groups(probes, n_lists)
    fw = _filter_words(nq, int(ids.max()) + 1, selectivity, kt)
    adm = _admission(fw, gl, sp, ids, n_probes, p.size)
    jargs = (jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()),
             jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
             jnp.asarray(recon.float().numpy()).astype(jnp.bfloat16),
             jnp.asarray(rsq.numpy()), jnp.asarray(ids.numpy()))
    listed = kt <= pgs.KT_LIST_MAX
    common = (qrot, centers, probes)
    lists = (recon, rsq, ids)
    if kernel == "G":
        if listed:
            pv, pi = pgs.list_scan(*common, gl, sp, *lists, kt,
                                   filter_words=fw)
        else:
            pv, pi = ps.recon_scan_query_major(*common, *lists, kt,
                                               filter_words=fw)
        jv, ji = pqp.grouped_l2_scan(*jargs, kt, n_probes, interpret=True,
                                     adm_words=adm)
        jv, ji = np.asarray(jv), np.asarray(ji)
        slots = sp.numpy().reshape(-1)
        live = slots < p.size
        ref_v = jv.reshape(-1, kt)[live]
        ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
        got_v = pv.reshape(-1, kt).numpy()[slots[live]]
        got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    else:
        if listed:
            mv, mi = pgs.merge_pairs(*pgs.list_scan(
                *common, gl, sp, *lists, kt, filter_words=fw), k)
        else:
            mv, mi = pgs.scan_query_major(*common, *lists, k, kt,
                                          filter_words=fw)
        jv, ji = pqp.grouped_l2_scan_fused(*jargs, kt, k, n_probes,
                                           interpret=True, merge_window=2,
                                           adm_words=adm)
        ref_v = np.asarray(jv)[:, :nq].T
        worst = ref_v >= pqp._ACC_WORST
        ref_v = np.where(worst, np.inf, ref_v)
        ref_i = np.where(worst, -1, np.asarray(ji)[:, :nq].T)
        got_v, got_i = mv.numpy(), mi.numpy()
        pi = mi
    _assert_close_but_ties(got_v, got_i, ref_v, ref_i)
    if selectivity < 0.5:                      # exhausted slots occur
        assert not np.isfinite(ref_v).all()
    flat = pi.reshape(nq, -1)
    bits = bitset.query_bits(fw, torch.arange(nq), flat)
    assert bool((bits[flat >= 0] == 1).all())


def test_gate_routes_by_kt_and_names_its_reason():
    """kt' = min(kt, k) up to KT_LIST_MAX takes the list-major route at any
    capacity; past it the query-major gate decides; k past K_MAX is
    refused; the shared-memory formula fits the card past 128 dims, where
    the residuals stream in two stages."""
    kmax = pgs.KT_LIST_MAX
    assert not pgs.list_scan_reject_reason(1024, kmax)
    assert pgs.list_scan_smem_bytes(96) < pgs.list_scan_smem_bytes(1024)
    assert pgs.list_scan_smem_bytes(1024) <= pgs._SMEM_LIMIT
    assert "outside 1..64" in pgs.list_scan_reject_reason(128, kmax + 1)
    assert "multiple of 8" in pgs.list_scan_reject_reason(100, 4)
    # a capacity whose candidate buffer no query-major block could hold
    assert not pgs.scan_reject_reason(200_000, 128, 20, 20)
    assert not pgs.scan_reject_reason(200_000, 128, 20, 256)  # kt' = 20
    reason = pgs.scan_reject_reason(200_000, 128, 256, 256)
    assert "list-major" in reason and "shared memory" in reason
    assert not pgs.scan_reject_reason(64, 32, 256, 256)       # query-major
    assert "k=300" in pgs.scan_reject_reason(64, 128, 300, 10)


@pytest.mark.parametrize("name", list(list_scan_decomp.VARIANTS))
def test_list_scan_decomp_variants_apply_to_the_scan_source(name):
    """Each profile variant's substitutions match ``pq_list_scan.cu`` and
    the fold header it includes exactly once in all (the profile raises
    otherwise), and only ``as built`` leaves the sources as they are."""
    base = {f: (list_scan_decomp._cuda.SRC_DIR / f).read_text()
            for f in list_scan_decomp.SCAN_SOURCES}
    texts = list_scan_decomp.variant_sources(name)
    assert (texts == base) == (name == "as built")

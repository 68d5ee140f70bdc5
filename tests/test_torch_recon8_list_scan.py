"""Kernel E's list-major route (``recon8_list_scan``) on the CPU.

Its plain twin emulates the kernel's schedule: each group of
``neighbors/grouped.build_groups`` scans its list's int8 rows once for its
pairs, the dot of ``bf16(sub)`` with the int8 values summed in fp32 and
then multiplied by the list's scale.  It is held to the JAX package's
``grouped_recon8_scan`` (Pallas, interpreted) on the same groups, and to
the query-major plain version of Kernel E, within 1e-4 of max sub_sq +
max rsq8 (the two packages sum the same exact products in another order;
the two port versions sum them in the same one and agree bit for bit),
ids equal but at distance ties.  Inputs are numpy draws from a seed:
int8 rows zero past rot (rot 24 in rows of 32 bytes, rot 96), per-list
scales, ids with padding (-1) and tombstones (<= -2), probes with JAX's
sentinels (>= n_lists) and, for the port alone, a negative probe; kt 1,
4 and 64.  With a filter, the port's filtered plain passes (the
list-major pass at kt 10, the query-major route at kt 80) are held to
``grouped_recon8_scan`` run with ``adm_words``.  Then the route's gate and
shared-memory formula.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.ops import pq_code_scan_pallas as pcp
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops import pq_group_scan as pgs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test, as the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int8_index(n_lists, cap, rot, seed):
    """int8 rows of round16(rot) bytes (zeros past rot), the lists'
    scales, the dequantized row norms, centers, and ids with padding and
    tombstones."""
    rng = np.random.default_rng(seed)
    rot_pad = -(-rot // 16) * 16
    q8 = rng.integers(-127, 128, (n_lists, cap, rot_pad)).astype(np.int8)
    q8[:, :, rot:] = 0
    scales = rng.uniform(0.01, 0.1, n_lists).astype(np.float32)
    rsq8 = (scales[:, None] ** 2
            * (q8.astype(np.float32) ** 2).sum(-1)).astype(np.float32)
    centers = rng.normal(size=(n_lists, rot)).astype(np.float32)
    sizes = rng.integers(cap // 3, cap + 1, n_lists)
    ids = np.full((n_lists, cap), -1, np.int32)
    nxt = 0
    for lst, s in enumerate(sizes):
        ids[lst, :s] = np.arange(nxt, nxt + s)
        nxt += s
    ids[:, 2::9] = np.where(ids[:, 2::9] >= 0, -(ids[:, 2::9] + 2), -1)
    return q8, scales, rsq8, centers, ids


CASES = {  # n_lists, cap, rot, nq, n_probes, kt
    "rot24-kt1": (6, 60, 24, 40, 3, 1),
    "rot24-kt4": (6, 60, 24, 40, 3, 4),
    "rot24-kt64": (5, 90, 24, 30, 2, 64),
    "rot96-kt1": (6, 48, 96, 40, 3, 1),
    "rot96-kt4": (6, 48, 96, 40, 3, 4),
    "rot96-kt64": (4, 80, 96, 24, 2, 64),
}


def _inputs(case):
    n_lists, cap, rot, nq, n_probes, kt = CASES[case]
    q8, scales, rsq8, centers, ids = _int8_index(n_lists, cap, rot,
                                                 cap + rot + kt)
    rng = np.random.default_rng(kt + rot)
    qrot = rng.normal(size=(nq, rot)).astype(np.float32)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    off = rng.random(probes.shape) < 0.1
    probes[off] = n_lists + rng.integers(0, 3, int(off.sum()))
    return qrot, centers, probes, q8, scales, rsq8, ids, kt


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _scale(qrot, centers, probes, rsq8):
    """max sub_sq + max rsq8 over the in-range pairs: the scale a change
    of summation order moves a distance by."""
    pr = np.clip(probes, 0, centers.shape[0] - 1)
    sub = qrot[:, None, :] - centers[pr]
    return float((sub * sub).sum(-1).max() + rsq8.max())


def _assert_close_but_ties(got_v, got_i, ref_v, ref_i, tol):
    """Values within tol at every rank, the same exhausted ranks, ids
    equal except where neighbouring values tie within tol or at a pair's
    last finite rank."""
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
def test_list_scan_plain_matches_the_jax_grouped_recon8_scan(case):
    """The plain twin on the port's groups against ``grouped_recon8_scan``
    (interpreted) on the same ``(group_list, slot_pairs)``, the JAX
    kernel given the same int8 rows padded to its 128 lanes: per live
    slot, values within 1e-4 of max sub_sq + max rsq8, ids equal but at
    ties; the pairs no group holds are empty."""
    qrot, centers, probes, q8, scales, rsq8, ids, kt = _inputs(case)
    probes[0, -1] = -1                 # the port's empty pair
    tq, tc, tp, tq8, ts, tr, ti = _torch(qrot, centers, probes, q8, scales,
                                         rsq8, ids)
    n_lists, cap = ids.shape
    gl, sp = grouped.build_groups(tp, n_lists)
    kt = min(kt, cap)
    pv, pi = pcs.recon8_list_scan(tq, tc, tp, gl, sp, tq8, ts, tr, ti, kt)
    assert pv.shape == pi.shape == (*probes.shape, kt)
    lanes = np.zeros((n_lists, cap, 128), np.int8)
    lanes[..., :q8.shape[2]] = q8
    jv, ji = pcp.grouped_recon8_scan(
        jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()), jnp.asarray(qrot),
        jnp.asarray(centers), jnp.asarray(lanes), jnp.asarray(scales),
        jnp.asarray(rsq8), jnp.asarray(ids), kt, probes.shape[1],
        interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    slots = sp.numpy().reshape(-1)
    live = slots < probes.size
    ref_v = jv.reshape(-1, kt)[live]
    ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
    got_v = pv.reshape(-1, kt).numpy()[slots[live]]
    got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    _assert_close_but_ties(got_v, got_i, ref_v, ref_i,
                           1e-4 * _scale(qrot, centers, probes, rsq8))
    out = ~np.isin(np.arange(probes.size), slots[live])
    assert out[probes.shape[1] - 1]
    assert np.isinf(pv.reshape(-1, kt).numpy()[out]).all()
    assert (pi.reshape(-1, kt).numpy()[out] == -1).all()
    assert not np.isin(pi.numpy(), -(ids[ids <= -2] + 2)).any()


@pytest.mark.parametrize("selectivity", [0.05, 0.5])
@pytest.mark.parametrize("kt", [10, 80])
def test_filtered_passes_match_the_pallas_recon8_scan_with_adm_words(
        kt, selectivity):
    """The port's filtered plain passes against ``grouped_recon8_scan`` run
    with ``adm_words`` (the JAX package's ``group_admission_words`` of the
    same groups; interpreted; the int8 rows padded to its 128 lanes), at a
    list-major kt (10: ``recon8_list_scan``) and past ``KT_LIST_MAX`` (80:
    ``recon8_scan_query_major``): per live slot, values within 1e-4 of max
    sub_sq + max rsq8, ids equal but at ties; every id admitted by its
    query."""
    n_lists, cap, rot, nq, n_probes = 6, 112, 96, 40, 3
    q8, scales, rsq8, centers, ids = _int8_index(n_lists, cap, rot, 31)
    rng = np.random.default_rng(32)
    qrot = rng.normal(size=(nq, rot)).astype(np.float32)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    off = rng.random(probes.shape) < 0.1
    probes[off] = n_lists + rng.integers(0, 3, int(off.sum()))
    tq, tc, tp, tq8, ts, tr, ti = _torch(qrot, centers, probes, q8, scales,
                                         rsq8, ids)
    gl, sp = grouped.build_groups(tp, n_lists)
    mask = np.random.default_rng(kt).random((nq, int(ids.max()) + 1)) \
        < selectivity
    fw = bitset.pack_mask(torch.from_numpy(mask))
    adm = jax_bitset.group_admission_words(
        jnp.asarray(fw.numpy()), jnp.asarray(gl.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(ids), n_probes, probes.size)
    if kt <= pgs.KT_LIST_MAX:
        pv, pi = pcs.recon8_list_scan(tq, tc, tp, gl, sp, tq8, ts, tr, ti,
                                      kt, filter_words=fw)
    else:
        pv, pi = pcs.recon8_scan_query_major(tq, tc, tp, tq8, ts, tr, ti,
                                             kt, filter_words=fw)
    lanes = np.zeros((n_lists, cap, 128), np.int8)
    lanes[..., :q8.shape[2]] = q8
    jv, ji = pcp.grouped_recon8_scan(
        jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy()), jnp.asarray(qrot),
        jnp.asarray(centers), jnp.asarray(lanes), jnp.asarray(scales),
        jnp.asarray(rsq8), jnp.asarray(ids), kt, n_probes, interpret=True,
        adm_words=adm)
    jv, ji = np.asarray(jv), np.asarray(ji)
    slots = sp.numpy().reshape(-1)
    live = slots < probes.size
    ref_v = jv.reshape(-1, kt)[live]
    ref_i = np.where(np.isfinite(ref_v), ji.reshape(-1, kt)[live], -1)
    got_v = pv.reshape(-1, kt).numpy()[slots[live]]
    got_i = pi.reshape(-1, kt).numpy()[slots[live]]
    _assert_close_but_ties(got_v, got_i, ref_v, ref_i,
                           1e-4 * _scale(qrot, centers, probes, rsq8))
    if selectivity < 0.5:                      # exhausted slots occur
        assert not np.isfinite(ref_v).all()
    flat = pi.reshape(nq, -1).numpy()
    assert mask[np.nonzero(flat >= 0)[0], flat[flat >= 0]].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_list_scan_plain_matches_the_query_major_plain_version(case):
    """The list-major twin against Kernel E's query-major plain version
    (the two routes' CPU versions) within 1e-4 (here bit for bit: the
    same products summed in the same order); the dispatch on CPU tensors
    is that plain version."""
    qrot, centers, probes, q8, scales, rsq8, ids, kt = _inputs(case)
    probes[0, -1] = -1
    args = _torch(qrot, centers, probes, q8, scales, rsq8, ids)
    groups = grouped.build_groups(args[2], ids.shape[0])
    lv, li = pcs.recon8_list_scan_plain(*args[:3], *groups, *args[3:], kt)
    qv, qi = pcs.recon8_scan_query_major(*args, kt)
    _assert_close_but_ties(lv.numpy(), li.numpy(), qv.numpy(), qi.numpy(),
                           1e-4 * _scale(qrot, centers, probes, rsq8))
    assert torch.equal(lv, qv) and torch.equal(li, qi)
    wv, wi = pcs.ivf_pq_scan_recon8(*args, kt)
    assert torch.equal(wv, qv) and torch.equal(wi, qi)


@pytest.mark.parametrize("rot", [24, 96])
def test_list_scan_plain_at_scale_one_equals_the_recon_pass(rot):
    """With every scale 1 the int8 twin equals Kernel G's list-major
    plain pass over the same rows as bf16 (exact) on the same norms, bit
    for bit, as the kernels are held on the card."""
    qrot, centers, probes, q8, _, _, ids, kt = _inputs(f"rot{rot}-kt4")
    ones = np.ones(ids.shape[0], np.float32)
    rsq = (q8.astype(np.float32) ** 2).sum(-1)
    tq, tc, tp, tq8, ts, tr, ti = _torch(qrot, centers, probes, q8, ones,
                                         rsq, ids)
    groups = grouped.build_groups(tp, ids.shape[0])
    ev, ei = pcs.recon8_list_scan(tq, tc, tp, *groups, tq8, ts, tr, ti, kt)
    gv, gi = pgs.list_scan_plain(tq, tc, tp, *groups,
                                 tq8[..., :rot].to(torch.bfloat16), tr, ti,
                                 kt)
    assert torch.equal(ev, gv) and torch.equal(ei, gi)


def _layout_bytes(rot_pad, kt):
    """``code_layout``'s parts for int8 rows summed one by one (a second
    reading of csrc/pq_code_list_scan.cu): residuals, row stages, keys,
    top kt, sub_sq and pair indices, raw int8 stages (rows of an odd
    number of 16-byte chunks), alignment."""
    kc = min(rot_pad, 128)
    atoms = -(-kc // 64)
    residuals = atoms * 16384 * (1 if rot_pad <= 128 else 2)
    rows = 2 * max(atoms * 16384, 32768)
    keys = 2 * 128 * 8
    top = 2 * 128 * (-(-kt // 8) * 8) * 4
    row = kc + (0 if (kc // 16) % 2 else 16)
    return residuals + rows + keys + top + 2 * 512 + 2 * 128 * row + 1024


@pytest.mark.parametrize("rot_pad", [16, 32, 48, 96, 128, 144, 256, 1008])
def test_recon8_list_scan_smem_bytes_mirrors_the_layout(rot_pad):
    """The one formula against the layout's parts at every kt; the deep
    (96) and flagship (128) widths fit the card's 232,448 B at every kt up
    to 64, widths past 128 up to kt 56."""
    for kt in range(1, pgs.KT_LIST_MAX + 1):
        need = pcs.recon8_list_scan_smem_bytes(rot_pad, kt)
        assert need == _layout_bytes(rot_pad, kt)
        fits = need <= pgs._SMEM_LIMIT
        assert fits == (not pcs.recon8_list_scan_reject_reason(rot_pad, kt))
        assert fits == (rot_pad <= 128 or kt <= 56)


def test_recon8_gates_route_by_kt_and_name_their_reason():
    """The list-major pass takes kt up to 64 at any capacity; the
    two-route gate refuses only where both routes do, naming both; no
    shape the query-major kernel took is refused, and rows past 1,024
    bytes are taken."""
    big = 200_000
    assert pcs.recon8_query_major_reject_reason(big, 96, 4)
    assert not pcs.recon8_list_scan_reject_reason(96, 64)
    assert not pcs.recon8_reject_reason(big, 96, 64)
    reason = pcs.recon8_reject_reason(big, 96, 65)
    assert "list-major" in reason and "query-major route" in reason
    assert "outside 1..64" in pcs.recon8_list_scan_reject_reason(96, 65)
    assert "multiple of 16" in pcs.recon8_reject_reason(64, 24, 4)
    # rows past 1,024 bytes read the residual from shared memory: the
    # query-major route takes every width the Pallas gate takes
    assert not pcs.recon8_query_major_reject_reason(64, 1040, 100)
    assert not pcs.recon8_reject_reason(64, 1040, 4)      # list-major
    assert not pcs.recon8_reject_reason(64, 1040, 100)    # query-major
    for cap in (40, 416, 2368, 20_000, big):
        for rot_pad in (16, 96, 128, 1024):
            for kt in (1, 4, 64, 100, 128, 129):
                if not pcs.recon8_query_major_reject_reason(cap, rot_pad,
                                                            kt):
                    assert not pcs.recon8_reject_reason(cap, rot_pad, kt)

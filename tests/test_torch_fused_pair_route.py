"""Kernels C and B past kt 64 in raft_tpu_torch: the pair-group pass of
Kernel D (C) or Kernel G (B) followed by ``merge_pairs``, on the CPU.

The kernels run on the card only.  Here their plain versions are driven
through the route's own schedule — ``pq_group_scan.list_major_topk`` with
``code_pair_list_scan`` / ``recon_pair_list_scan`` as pass 1 (their
grouped plain schedules on groups of 64 or 32 pairs) and ``merge_pairs``
(on CPU tensors ``query_topk``) — and held:

- to the query-major plain versions ``ivf_pq_scan_codes_fused_plain`` /
  ``ivf_pq_scan_fused_plain``, bit for bit, at kt 65 and 128 (and 200 for
  B), 4- and 8-bit codes, unfiltered and with a per-query filter;
- to the JAX package's grouped Pallas scans ``grouped_code_scan`` /
  ``grouped_l2_scan`` (interpreted, on its groups of 128), each query's
  top k taken from their pairs: values within 1e-4 of max sub_sq + max
  rsq, the same exhausted ranks, ids equal but at distance ties;

and ``codes_fused_route`` / ``scan_route`` and the three-route gates
are checked by shape.  Inputs are numpy draws from a seed."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.ops import pq_code_scan_pallas as pcp
from raft_tpu.ops import pq_group_scan_pallas as pqp
from raft_tpu_torch.filters import bitset
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops import pq_group_scan as pgs


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
    return torch.from_numpy(ids)


def _code_lists(n_lists, cap, pq_dim, pq_len, pq_bits, seed):
    """Packed codes with exact ties (rows 20-29 repeat rows 0-9), books,
    centers, the norms of the rows' bf16 reconstructions, ids."""
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
    return centers, codes, books, rsq, _ids(rng, n_lists, cap)


def _recon_lists(n_lists, cap, rot, seed):
    """bf16 recon rows with the same exact ties, their norms, centers,
    ids."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_lists, cap, rot)).astype(np.float32)
    x[:, 20:30] = x[:, 0:10]
    recon = torch.from_numpy(x).to(torch.bfloat16)
    centers = torch.from_numpy(rng.normal(size=(n_lists, rot)).astype(
        np.float32))
    return centers, recon, (recon.float() ** 2).sum(-1), _ids(rng, n_lists,
                                                              cap)


def _probes(seed, nq, n_probes, n_lists):
    """Distinct lists per query, a sentinel past the lists and a negative
    probe (pairs in no group)."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.choice(n_lists, n_probes, replace=False)
                  for _ in range(nq)]).astype(np.int32)
    p[1, 0] = n_lists
    p[0, -1] = -1
    return torch.from_numpy(p)


def _filter(nq, ids, selectivity, seed):
    if selectivity is None:
        return None, None
    mask = np.random.default_rng(seed).random(
        (nq, int(ids.max()) + 1)) < selectivity
    return mask, bitset.pack_mask(torch.from_numpy(mask))


def _scale(qrot, centers, probes, rsq):
    """max sub_sq + max rsq over the in-range pairs: the scale a change of
    summation order moves a distance by."""
    pr = probes.long().clamp(0, centers.shape[0] - 1)
    sub = qrot[:, None, :] - centers[pr]
    return float((sub * sub).sum(-1).max() + rsq.max())


def _codes_route(qrot, centers, probes, codes, books, rsq, ids, bits, kt,
                 fw, group):
    """Kernel C's pair-group route on CPU tensors: ``list_major_topk`` over
    ``code_pair_list_scan``'s grouped schedule at ``group`` pairs, then
    ``merge_pairs``."""
    n_lists = centers.shape[0]

    def pass1(rows, p, gl, sp):
        return pcs.code_pair_list_scan(
            qrot[rows], centers, p, gl, sp, codes, books, rsq, ids, bits,
            kt, None if fw is None else fw[rows], group=group)
    return pgs.list_major_topk(probes, n_lists, kt, kt, pass1, group)


def _recon_route(qrot, centers, probes, recon, rsq, ids, kt, fw, group):
    """Kernel B's pair-group route on CPU tensors, as
    :func:`_codes_route` over ``recon_pair_list_scan``."""
    n_lists = centers.shape[0]

    def pass1(rows, p, gl, sp):
        return ps.recon_pair_list_scan(
            qrot[rows], centers, p, gl, sp, recon, rsq, ids, kt,
            None if fw is None else fw[rows], group=group)
    return pgs.list_major_topk(probes, n_lists, kt, kt, pass1, group)


# ---------------------------------------------------------------------------
# the route's schedule against the query-major plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("kt,group", [(65, 64), (65, 32), (128, 64),
                                      (128, 32)])
@pytest.mark.parametrize("bits", [4, 8])
def test_kernel_c_pair_route_equals_the_plain_version(bits, kt, group,
                                                      filtered):
    """C past kt 64 (k = kt): D's grouped schedule and the merge give
    ``ivf_pq_scan_codes_fused_plain`` bit for bit, exact ties included; so
    does the public wrapper on CPU tensors."""
    n_lists, cap, nq, n_probes = 6, 150, 40, 4
    centers, codes, books, rsq, ids = _code_lists(n_lists, cap, 12, 3, bits,
                                                  kt + bits)
    qrot = torch.from_numpy(np.random.default_rng(kt).normal(
        size=(nq, 36)).astype(np.float32))
    probes = _probes(kt + group, nq, n_probes, n_lists)
    _, fw = _filter(nq, ids, 0.5 if filtered else None, kt)
    assert pcs.codes_fused_route(cap, 36, 12, bits, kt, kt)[0] == "pair"
    got = _codes_route(qrot, centers, probes, codes, books, rsq, ids, bits,
                       kt, fw, group)
    args = (qrot, centers, probes, codes, books, rsq, ids, bits, kt, kt)
    ref = pcs.ivf_pq_scan_codes_fused_plain(*args, filter_words=fw)
    assert got[0].shape == got[1].shape == (nq, kt)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    wrap = pcs.ivf_pq_scan_codes_fused(*args, filter_words=fw)
    assert torch.equal(wrap[0], ref[0]) and torch.equal(wrap[1], ref[1])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("kt,group", [(65, 64), (65, 32), (128, 64),
                                      (200, 32)])
def test_kernel_b_pair_route_equals_the_plain_version(kt, group, filtered):
    """B past kt 64 (k = kt): G's grouped schedule and the merge give
    ``ivf_pq_scan_fused_plain`` bit for bit, exact ties included; so does
    the public wrapper on CPU tensors."""
    n_lists, cap, rot, nq, n_probes = 6, 260, 24, 40, 4
    centers, recon, rsq, ids = _recon_lists(n_lists, cap, rot, kt)
    qrot = torch.from_numpy(np.random.default_rng(kt + 1).normal(
        size=(nq, rot)).astype(np.float32))
    probes = _probes(kt + group, nq, n_probes, n_lists)
    _, fw = _filter(nq, ids, 0.5 if filtered else None, kt + 1)
    assert pgs.scan_route(cap, rot, kt, kt)[0] == "pair"
    assert ps.pair_list_layout(rot, kt, False).group == (
        64 if kt <= 128 else 32)
    got = _recon_route(qrot, centers, probes, recon, rsq, ids, kt, fw, group)
    args = (qrot, centers, probes, recon, rsq, ids, kt, kt)
    ref = pgs.ivf_pq_scan_fused_plain(*args, filter_words=fw)
    assert got[0].shape == got[1].shape == (nq, kt)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    wrap = pgs.ivf_pq_scan_fused(*args, filter_words=fw)
    assert torch.equal(wrap[0], ref[0]) and torch.equal(wrap[1], ref[1])


def test_pair_buffer_chunks_leave_the_result_unchanged(monkeypatch):
    """A batch whose pair buffer passes ``PAIR_BUFFER_BYTES`` runs in query
    chunks, each grouped on its own: the same top k."""
    n_lists, cap, rot, nq, n_probes, kt = 6, 260, 24, 40, 4, 100
    centers, recon, rsq, ids = _recon_lists(n_lists, cap, rot, 3)
    qrot = torch.from_numpy(np.random.default_rng(4).normal(
        size=(nq, rot)).astype(np.float32))
    probes = _probes(5, nq, n_probes, n_lists)
    whole = _recon_route(qrot, centers, probes, recon, rsq, ids, kt, None,
                         64)
    calls = []
    real = pgs.merge_pairs

    def counted(v, i, k):
        calls.append(v.shape[0])
        return real(v, i, k)
    monkeypatch.setattr(pgs, "merge_pairs", counted)
    monkeypatch.setattr(pgs, "PAIR_BUFFER_BYTES", 16 * n_probes * kt * 8)
    part = _recon_route(qrot, centers, probes, recon, rsq, ids, kt, None,
                        64)
    assert calls == [16, 16, 8]
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


# ---------------------------------------------------------------------------
# the route against the JAX grouped scans, each query's top k
# ---------------------------------------------------------------------------

def _jax_topk(jv, ji, sp, nq, n_probes, kt, k):
    """The JAX kernel's (n_groups, GROUP, kt) output scattered to its pairs
    (+inf, -1 where no group holds one), then each query's top k of its
    n_probes * kt candidates by a stable sort."""
    P = nq * n_probes
    slots = np.asarray(sp).reshape(-1)
    live = slots < P
    v = np.full((P, kt), np.inf, np.float32)
    i = np.full((P, kt), -1, np.int32)
    v[slots[live]] = np.asarray(jv).reshape(-1, kt)[live]
    i[slots[live]] = np.asarray(ji).reshape(-1, kt)[live]
    v, i = v.reshape(nq, -1), i.reshape(nq, -1)
    order = np.argsort(v, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(v, order, 1)
    i = np.take_along_axis(i, order, 1)
    return v, np.where(np.isfinite(v), i, -1)


def _jax_groups(probes, n_lists, fw, ids):
    """Groups of 128 for the JAX kernels and, with ``fw``, their admission
    words."""
    gl, sp = grouped.build_groups(probes, n_lists)
    gl, sp = jnp.asarray(gl.numpy()), jnp.asarray(sp.numpy())
    adm = None if fw is None else jax_bitset.group_admission_words(
        jnp.asarray(fw.numpy()), gl, sp, jnp.asarray(ids.numpy()),
        probes.shape[1], probes.numel())
    return gl, sp, adm


def _assert_topk_match(got_v, got_i, ref_v, ref_i, tol, mask):
    """Per query: the same exhausted ranks (-1 exactly there), values
    within ``tol`` at every rank, the same ids below the row's last kept
    value less 2 ``tol`` (at and near the k-th value a tie may keep
    another id); every id admitted by its query."""
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_array_equal(got_i < 0, ~fin)
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=0, atol=tol)
    for prow, pids, rrow, rids, f in zip(got_v, got_i, ref_v, ref_i, fin):
        if f.any():
            cut = rrow[f][-1] - 2 * tol
            assert set(pids[prow < cut]) == set(rids[rrow < cut])
    if mask is not None:
        rows, cols = np.nonzero(got_i >= 0)
        assert mask[rows, got_i[rows, cols]].all()


@pytest.mark.parametrize("selectivity", [None, 0.5])
@pytest.mark.parametrize("bits,kt", [(8, 65), (4, 128)])
def test_kernel_c_pair_route_matches_the_jax_grouped_code_scan(bits, kt,
                                                               selectivity):
    """C's pair-group route against ``grouped_code_scan`` (interpreted,
    the codes lane-major) and each query's top k of its pairs, unfiltered
    and with ``adm_words``: within 1e-4 of the scale, ids but at ties."""
    n_lists, cap, pq_dim, pq_len, nq, n_probes = 5, 160, 16, 2, 36, 3
    centers, codes, books, rsq, ids = _code_lists(n_lists, cap, pq_dim,
                                                  pq_len, bits, kt)
    rot = pq_dim * pq_len
    qrot = torch.from_numpy(np.random.default_rng(kt + 1).normal(
        size=(nq, rot)).astype(np.float32))
    probes = _probes(kt + bits, nq, n_probes, n_lists)
    mask, fw = _filter(nq, ids, selectivity, kt)
    group = pcs.code_pair_list_layout(rot, pq_dim, bits, kt).group
    pv, pi = _codes_route(qrot, centers, probes, codes, books, rsq, ids,
                          bits, kt, fw, group)
    gl, sp, adm = _jax_groups(probes, n_lists, fw, ids)
    jv, ji = pcp.grouped_code_scan(
        gl, sp, jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
        pcp.pack_code_lanes(jnp.asarray(codes.numpy())),
        jnp.asarray(books.numpy()), jnp.asarray(rsq.numpy()),
        jnp.asarray(ids.numpy()), kt, n_probes, bits, interpret=True,
        adm_words=adm)
    rv, ri = _jax_topk(jv, ji, sp, nq, n_probes, kt, kt)
    _assert_topk_match(pv.numpy(), pi.numpy(), rv, ri,
                       1e-4 * _scale(qrot, centers, probes, rsq), mask)


@pytest.mark.parametrize("selectivity", [None, 0.5])
@pytest.mark.parametrize("kt", [65, 128])
def test_kernel_b_pair_route_matches_the_jax_grouped_scan(kt, selectivity):
    """B's pair-group route against ``grouped_l2_scan`` (interpreted, rot
    128 and a capacity a multiple of 16, as the JAX kernel takes) and each
    query's top k of its pairs, unfiltered and with ``adm_words``: within
    1e-4 of the scale, ids but at ties."""
    n_lists, cap, rot, nq, n_probes = 6, 144, 128, 40, 3
    centers, recon, rsq, ids = _recon_lists(n_lists, cap, rot, kt)
    qrot = torch.from_numpy(np.random.default_rng(kt + 3).normal(
        size=(nq, rot)).astype(np.float32))
    probes = _probes(kt + 4, nq, n_probes, n_lists)
    mask, fw = _filter(nq, ids, selectivity, kt + 1)
    group = ps.pair_list_layout(rot, kt, False).group
    pv, pi = _recon_route(qrot, centers, probes, recon, rsq, ids, kt, fw,
                          group)
    gl, sp, adm = _jax_groups(probes, n_lists, fw, ids)
    jv, ji = pqp.grouped_l2_scan(
        gl, sp, jnp.asarray(qrot.numpy()), jnp.asarray(centers.numpy()),
        jnp.asarray(recon.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rsq.numpy()), jnp.asarray(ids.numpy()), kt, n_probes,
        interpret=True, adm_words=adm)
    rv, ri = _jax_topk(jv, ji, sp, nq, n_probes, kt, kt)
    _assert_topk_match(pv.numpy(), pi.numpy(), rv, ri,
                       1e-4 * _scale(qrot, centers, probes, rsq), mask)


# ---------------------------------------------------------------------------
# routes and gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,route", [(1, "list"), (64, "list"),
                                     (65, "pair"), (128, "pair"),
                                     (129, "query"), (256, "query")])
def test_kernel_c_routes_by_pair_kt_and_names_its_reason(k, route):
    """At the deep shape (capacity 2,368, rot 96, 48 8-bit subspaces, k =
    kt) a pair kt up to 64 takes the list-major pass, 65 to 128 D's
    pair-group pass, past it the query-major kernel; each route past the
    first names the refusals before it, and the gate refuses none."""
    got, why = pcs.codes_fused_route(2368, 96, 48, 8, k, k)
    assert got == route
    assert (why == "") == (route == "list")
    if route != "list":
        assert "outside 1..64 (the list-major route)" in why
    if route == "query":
        assert f"pair-group route: kt={k} outside 1..128" in why
    assert not pcs.codes_fused_reject_reason(2368, 96, 48, 8, k, k)
    # the pair kt is min(kt, cap, k)
    assert pcs.codes_fused_route(2368, 96, 48, 8, 20, k)[0] == "list"
    assert pcs.codes_fused_route(40, 96, 48, 8, k, k)[0] == "list"


@pytest.mark.parametrize("k,route", [(1, "list"), (64, "list"),
                                     (65, "pair"), (200, "pair"),
                                     (256, "pair")])
def test_kernel_b_routes_by_pair_kt_and_names_its_reason(k, route):
    """At the flagship shape (capacity 416, rot 128, k = kt) a pair kt up
    to 64 takes the list-major pass, 65 to 256 G's pair-group pass
    (groups of 64, of 32 past kt 128)."""
    got, why = pgs.scan_route(416, 128, k, k)
    assert got == route
    assert (why == "") == (route == "list")
    if route == "pair":
        assert "outside 1..64 (the list-major route)" in why
        assert ps.pair_list_layout(128, k, False).group == (
            64 if k <= 128 else 32)
    assert not pgs.scan_reject_reason(416, 128, k, k)
    assert pgs.scan_route(416, 128, 20, k)[0] == "list"


def test_three_route_gates_name_every_refusal():
    """Only a shape all three routes refuse is refused, and then each
    route's reason is named: C past kt 128 at a capacity past its
    query-major shared memory; B at rows past 1,024 dims past kt 64 (the
    query-major kernel stops there too); rows the pass takes at any
    capacity; k past 256 before anything."""
    reason = pcs.codes_fused_reject_reason(40_000, 96, 48, 8, 200, 200)
    assert "list-major" in reason and "pair-group route: kt=200" in reason
    assert "query-major route" in reason and "shared memory" in reason
    assert not pcs.codes_fused_reject_reason(40_000, 96, 48, 8, 128, 128)
    assert pcs.codes_fused_route(40_000, 96, 48, 8, 128, 128)[0] == "pair"
    # rot 128 at 8 bits: the list-major books outgrow shared memory past
    # kt 40, and the pass (books in global memory) takes the shape
    route, why = pcs.codes_fused_route(416, 128, 64, 8, 64, 64)
    assert route == "pair" and "shared memory" in why
    # D's wide raw code stages: the query-major kernel is left
    route, why = pcs.codes_fused_route(416, 1024, 512, 8, 100, 100)
    assert route == "query" and "pair-group route: kt 100 needs" in why
    reason = pgs.scan_reject_reason(300, 1032, 100, 100)
    assert "list-major" in reason and "pair-group route: row width 1032" \
        in reason and "query-major route: rot_dim=1032" in reason
    assert pgs.scan_route(300, 1032, 100, 100)[0] == "query"
    assert not pgs.scan_reject_reason(200_000, 128, 256, 256)
    assert "k=300" in pgs.scan_reject_reason(416, 128, 300, 300)
    assert "k=300" in pcs.codes_fused_reject_reason(416, 96, 48, 8, 300, 4)


def test_pair_list_turns_fused_mode_needs_the_card(monkeypatch):
    """Off the card the turns profile's ``fused`` mode (B and C's route
    beside their query-major kernels) stops before it draws or times
    anything."""
    from raft_tpu_torch.profiles import pair_list_turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["pair_list_turns.py", "fused"])
    for name in ("fused_b_turns", "fused_c_turns"):
        monkeypatch.setattr(pair_list_turns, name, lambda *a: pytest.fail(
            "drew lists without a card"))
    with pytest.raises(SystemExit):
        pair_list_turns.main()


@pytest.mark.parametrize("kernel,rot,pq_dim,kt,fits", [
    ("B", 128, 0, 65, [64, 32]), ("B", 128, 0, 200, [32]),
    ("B", 128, 0, 256, [32]), ("C", 96, 48, 128, [64, 32]),
    ("C", 128, 64, 64, [64, 32])])
def test_pair_list_turns_times_the_groups_that_fit(kernel, rot, pq_dim, kt,
                                                   fits):
    """The ``fused`` mode times the route at each group size whose layout
    fits shared memory, and the size the layout picks is among them: 32
    alone for B past kt 128 at the flagship's rot 128, 64 and 32 for C at
    the deep and flagship shapes."""
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.profiles import pair_list_turns

    if kernel == "B":
        groups = pair_list_turns.fitting(
            lambda g: ps.pair_list_layout(rot, kt, False, group=g))
        picked = ps.pair_list_layout(rot, kt, False).group
    else:
        groups = pair_list_turns.fitting(
            lambda g: pcs.code_pair_list_layout(rot, pq_dim, 8, kt, g))
        picked = pcs.code_pair_list_layout(rot, pq_dim, 8, kt).group
    assert groups == fits and picked in groups

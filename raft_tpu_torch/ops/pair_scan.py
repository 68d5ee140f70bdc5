"""Kernels F and G: per-(query, probe) top-kt scans over full-width rows.

- Kernel F, :func:`ivf_flat_scan`: replaces
  ``raft_tpu/ops/pq_group_scan_pallas.py:637 grouped_flat_l2_scan``, the
  IVF-Flat scan over raw fp32 list rows (exact ``‖q‖² + ‖x‖² − 2q·x`` with
  the dot product in fp32, or the InnerProduct form).  Up to kt
  ``KT_LIST_MAX`` it is list-major: the pairs grouped by (super-)tile,
  then :func:`flat_list_scan` (``csrc/flat_list_scan.cu``, 3xTF32
  ``wgmma``); from kt 65 to ``PAIR_KT_MAX`` the pair-group pass
  :func:`flat_pair_list_scan` (``csrc/pair_list_scan.cu``); past it,
  :func:`flat_scan_query_major`.
- Kernel G, :func:`ivf_pq_scan_recon`: replaces ``:566 grouped_l2_scan``,
  the IVF-PQ scan over the bf16 reconstruction cache (Kernel B's row
  arithmetic with a per-pair output).  Up to kt ``KT_LIST_MAX`` it is
  Kernel B's list-major pass 1 (``csrc/pq_list_scan.cu``, pairs grouped by
  list, bf16 ``wgmma``); from kt 65 the pair-group pass
  :func:`recon_pair_list_scan`; past what that takes,
  :func:`recon_scan_query_major`.

The pair-group pass (``csrc/pair_list_scan.cu``) groups the pairs by list
in groups of up to 64 (:func:`pair_list_layout` sizes them), reads each
probed list once per group on tensor cores and keeps each pair's top kt
(up to 256) through a threshold and a per-pair candidate buffer merged by
bitonic sorts.  The query-major kernels (``csrc/pair_scan.cu``) stay as
the route past its gate and as a same-run yardstick; each source note
says what bounds its kernel on an H100 and what the design does about it.
No TPU layout comes over: no one-hot query gathers, no f32 id lanes.

- :func:`pair_scan_variant`: the profile variants of F and G (the
  switches of ``profiles/group_kernel_decomp_r5.py:50 run_var``): the raw
  per-slot distance block with no selection, and queries pre-gathered per
  pair, on the pair-group pass (:func:`pair_scan_variant_query_major`:
  the same on the query-major kernel, a yardstick); ``raft_tpu_torch.
  profiles.group_kernel_decomp_r5`` times them.

Each kernel wrapper launches its kernel for CUDA tensors and runs its
``_plain`` version for CPU tensors — nothing else picks between them, and
a failed build or launch raises.  ``<wrapper>.launches`` counts kernel
launches; the ``*_reject_reason`` functions say why a kernel cannot take a
shape, and :func:`flat_scan_route` / :func:`recon_scan_route` which route
a shape takes.

Contract (per pair, out ``(nq, n_probes, kt)`` f32 / i32 each): rows with
a negative id never enter, a probe outside ``[0, n_lists)`` is an empty
pair, each pair keeps its top kt by (distance, slot), ties to the lowest
slot, and exhausted slots are ``(+inf, −1)`` — ``(−inf, −1)`` in Kernel
F's InnerProduct form, whose kept values are the largest dot products in
descending order.  With ``filter_words`` (every route; see
:mod:`raft_tpu_torch.ops.pq_group_scan`), a pair keeps only the rows its
query admits; the profile variants take no filter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects, fail
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops.pq_group_scan import (
    _PLAIN_CHUNK, _SMEM_LIMIT, K_MAX, KT_LIST_MAX, _check, _next_pow2,
    admit, cat_parts, cuda_operands, filter_operand, grouped_pair_topk,
    list_scan, list_scan_reject_reason, pair_topk, plain_chunks,
    probe_distances, recon_dot)

_MAX_WIDTH = 1024                # 32 lanes * the chunks a lane holds
MAX_SUB_LISTS = 8                # kMaxSub in csrc/flat_list_scan.cu
PAIR_KT_MAX = K_MAX              # kKtMax in csrc/pair_list_scan.cu
# the pair-group pass's group sizes, largest first: pair_list_layout takes
# the first whose shared memory fits (32 fits every shape the gates admit);
# the kernel also takes 16, which only an explicit ``group`` asks for
PAIR_GROUPS = (64, 32)


def pair_scan_smem_bytes(cap: int, width: int) -> int:
    """Dynamic shared memory of one block of Kernel F or G: the pair's
    ``cap`` distances and the staged ``width``-wide query or residual, as
    ``pair_scan_kernel`` lays them out.  The one copy of the formula: the
    gate tests it and the launch passes it."""
    return 4 * (cap + width)


def pair_scan_reject_reason(cap: int, width: int, kt: int,
                            per_chunk: int) -> str:
    """Why Kernel F (``per_chunk`` 4 fp32 values a 16-byte load) or G (8
    bf16 values) cannot take this shape ('' when it can).  fp32 rows of
    any width from 1 are taken (off a multiple of 4 the kernel loads one
    value at a time); bf16 rows need a multiple of 8."""
    if kt < 1:
        return f"kt={kt} < 1"
    if width < 1 or width > _MAX_WIDTH:
        return f"row width {width} outside 1..{_MAX_WIDTH}"
    if per_chunk == 8 and width % 8:
        return (f"row width {width} must be a multiple of 8 (16-byte bf16 "
                f"row loads)")
    need = pair_scan_smem_bytes(cap, width)
    if need > _SMEM_LIMIT:
        return (f"list capacity {cap} needs {need} B of shared memory "
                f"(limit {_SMEM_LIMIT})")
    return ""


def _outputs(nq, n_probes, kt, device):
    return (torch.empty(nq, n_probes, kt, dtype=torch.float32, device=device),
            torch.empty(nq, n_probes, kt, dtype=torch.int32, device=device))


def _aligned(t: torch.Tensor, what: str) -> torch.Tensor:
    t = t.contiguous()
    expects(t.data_ptr() % 16 == 0, f"{what} must be 16-byte aligned")
    return t


# ---------------------------------------------------------------------------
# the pair-group pass (csrc/pair_list_scan.cu): layout and gates
# ---------------------------------------------------------------------------

class PairLayout(NamedTuple):
    """The dynamic shared memory of one block of the pair-group pass, in
    the field order of ``csrc/pair_list_scan.cu``'s ``PairLayout``: the one
    copy of the formula (the gates test it, the launch passes it and the
    kernel reads it).  ``group``: pairs a block (a group of
    :func:`raft_tpu_torch.neighbors.grouped.build_groups`); ``keep``: a
    pair's kept entries (a power of two >= kt, >= 32); ``buf``: its
    candidate buffer (32 or 64 entries); ``resident``: the group's queries
    (F) or residuals (G, D, E) keep every dim in shared memory; then byte
    offsets from the 1024-byte aligned base (see the source): ``raw``
    and ``raw_step`` (D and E's two raw stages; F and G have none:
    ``raw_step`` 0), ending with ``total``, the bytes a block
    requests."""
    group: int
    keep: int
    buf: int
    resident: int
    a: int
    a_step: int
    a_lo: int
    b: int
    b_step: int
    op: int
    key: int
    keep_v: int
    keep_s: int
    buf_v: int
    buf_s: int
    cnt: int
    thr: int
    ssq: int
    pair: int
    sub: int
    raw: int
    raw_step: int
    total: int

    def as_c(self):
        """The layout as the C entry point reads it: a ctypes array of
        ints in field order."""
        return (ctypes.c_int * len(self))(*self)


def _align(b: int) -> int:
    return -(-b // 1024) * 1024


def _pair_layout(width: int, kt: int, fp32: bool, extract: bool,
                 group: int, resident: bool,
                 raw_step: int = 0) -> PairLayout:
    keep = max(32, _next_pow2(kt)) if extract else 0
    buf = (64 if keep >= 64 else 32) if extract else 0
    if fp32:
        # TF32 hi and lo parts of 64 query rows x 32 dims (8 KB each) an
        # atom column; a ring of three raw stages of 128 rows x 32 dims
        # (16 KB) with their norms and ids (1 KB); the split operand, hi
        # and lo (32 KB, also the window's distances); the window's keys
        chunk = 64 * 128
        atoms = -(-width // 32)
        a_size = 2 * atoms * chunk if resident else 2 * chunk
        a_step = chunk if resident else 0
        a_lo = atoms * chunk if resident else chunk
        b, b_step = a_size, 128 * 128 + 1024
        op = b + 3 * b_step
        key = op + 2 * 128 * 128
        keep_v = key + 1024
    else:
        # bf16(sub) of 64 rows (resident up to 128 dims, else two 128-dim
        # stages); two operand stages of 128 rows (at least the window's
        # 32 KB of distances each) and their norms and ids (1 KB each)
        kc = -(-width // 16) * 16 if resident else 128
        ab = _align(-(-kc // 64) * 64 * 128)
        a_size, a_step, a_lo = (ab, 0, 0) if resident else (2 * ab, ab, 0)
        b = a_size
        b_step = _align(max(-(-kc // 64) * 128 * 128, 64 * 128 * 4))
        op = key = b + 2 * b_step
        keep_v = key + 2 * 1024
    keep_s = keep_v + group * keep * 4
    buf_v = keep_s + group * keep * 4
    buf_s = buf_v + group * buf * 4
    cnt = buf_s + group * buf * 4
    thr = cnt + 64 * 4
    ssq = thr + 64 * 4
    pair = ssq + 64 * 4
    sub = pair + 64 * 4
    # the two raw stages of D and E (``raw_step`` bytes each), 16-byte
    # aligned
    raw = sub + 128
    return PairLayout(group, keep, buf, int(resident), 0, a_step, a_lo, b,
                      b_step, op, key, keep_v, keep_s, buf_v, buf_s, cnt,
                      thr, ssq, pair, sub, raw, raw_step,
                      raw + 2 * raw_step + 1024)


def _fitting_layout(width: int, kt: int, fp32: bool, extract: bool,
                    groups, raw_step: int
                    ) -> Tuple[Optional[PairLayout], PairLayout]:
    """``(fits, last)``: the first layout of ``groups`` within the card's
    shared memory (None when none is) and the last one tried."""
    for g in groups:
        if fp32:
            options = (True, False)
        else:
            options = (-(-width // 16) * 16 <= 128,)
        for resident in options:
            layout = _pair_layout(width, kt, fp32, extract, g, resident,
                                  raw_step)
            if layout.total <= _SMEM_LIMIT:
                return layout, layout
    return None, layout


def pair_list_layout(width: int, kt: int, fp32: bool, extract: bool = True,
                     group: Optional[int] = None,
                     raw_step: int = 0) -> PairLayout:
    """:class:`PairLayout` of the pair-group pass over ``width``-wide rows
    keeping ``kt`` (``fp32``: Kernel F's rows, else bf16 products: G's
    rows, or D and E's rows built from two raw stages of ``raw_step``
    bytes;
    ``extract`` False: the raw variant, no keep).  The group is ``group``
    where given (64, 32 or 16: the sizes the kernel takes), else the first
    of ``PAIR_GROUPS`` that fits the card's shared memory (64: one
    warpgroup's wgmma M; 32 where a pair's kept rows outgrow it, kt past
    128); F's queries stay resident where that fits at the group's size,
    the bf16 residuals up to 128 dims.  At 32 pairs every shape the F and
    G gates admit fits (about 186 KB at kt 256 and width 1,024); D and
    E's gates test the fit themselves."""
    expects(group in (None, 64, 32, 16),
            f"pair_list_layout: group {group} not one of 64, 32, 16")
    layout, last = _fitting_layout(
        width, kt, fp32, extract, PAIR_GROUPS if group is None else (group,),
        raw_step)
    if layout is not None:
        return layout
    fail(f"pair_list_layout: {last.group} pairs a group at width "
         f"{width}, kt {kt} need {last.total} B of shared memory (limit "
         f"{_SMEM_LIMIT})")


def pair_list_fit(width: int, kt: int, raw_step: int = 0
                  ) -> Tuple[Optional[PairLayout], PairLayout]:
    """``(fits, last)``: the bf16 pass's :func:`pair_list_layout` at the
    first group of ``PAIR_GROUPS`` that fits (None where none does: D's
    wide raw code stages) and the last layout tried (its ``total``, what
    the smallest group needs)."""
    return _fitting_layout(width, kt, False, True, PAIR_GROUPS, raw_step)


def _pair_list_reason(width: int, kt: int, fp32: bool,
                      extract: bool = True) -> str:
    if extract and not 0 < kt <= PAIR_KT_MAX:
        return f"kt={kt} outside 1..{PAIR_KT_MAX} (the pair-group route)"
    if width < 1 or width > _MAX_WIDTH:
        return f"row width {width} outside 1..{_MAX_WIDTH}"
    if not fp32 and width % 8:
        return (f"row width {width} must be a multiple of 8 (16-byte bf16 "
                f"row loads)")
    return ""


def flat_pair_list_reject_reason(rows: int, dim: int, kt: int,
                                 sub_lists: int = 1) -> str:
    """Why Kernel F's pair-group pass cannot take this shape ('' when it
    can): a tile of ``rows`` slots made of ``sub_lists`` sub-lists, rows
    of any width from 1 to 1,024, kt up to ``PAIR_KT_MAX``; the capacity
    sizes no shared memory."""
    if not 0 < sub_lists <= MAX_SUB_LISTS or rows % sub_lists:
        return (f"a tile of {rows} slots cannot hold {sub_lists} equal "
                f"sub-lists (1..{MAX_SUB_LISTS})")
    return _pair_list_reason(dim, kt, True)


def recon_pair_list_reject_reason(rot: int, kt: int) -> str:
    """Why Kernel G's pair-group pass cannot take this shape ('' when it
    can): bf16 rows a multiple of 8 wide up to 1,024, kt up to
    ``PAIR_KT_MAX``, and a layout within the card's shared memory (at 32
    pairs a group every such shape fits; the gate tests it, as D and E's
    gates test theirs, so a lowered limit refuses the shape here)."""
    reason = _pair_list_reason(rot, kt, False)
    if reason:
        return reason
    fits, last = pair_list_fit(rot, kt)
    if fits is None:
        return (f"kt {kt} needs {last.total} B of shared memory at "
                f"{last.group} pairs a group (limit {_SMEM_LIMIT})")
    return ""


def flat_scan_route(rows: int, dim: int, kt: int, sub_lists: int = 1
                    ) -> Tuple[str, str]:
    """``(route, why)``: the kernel :func:`ivf_flat_scan` runs for this
    shape on the card — ``"list"`` (:func:`flat_list_scan`), ``"pair"``
    (:func:`flat_pair_list_scan`) or ``"query"``
    (:func:`flat_scan_query_major`) — and the refusals of the routes
    before it ('' for the list-major pass); ``kt`` is the pair's kt,
    min(k, rows)."""
    listed = flat_list_scan_reject_reason(rows, dim, kt, sub_lists)
    if not listed:
        return "list", ""
    paired = flat_pair_list_reject_reason(rows, dim, kt, sub_lists)
    if not paired:
        return "pair", listed
    return "query", f"{listed}; {paired}"


def recon_scan_route(rot: int, kt: int) -> Tuple[str, str]:
    """``(route, why)`` of :func:`ivf_pq_scan_recon` as
    :func:`flat_scan_route` gives it for Kernel F: ``"list"``
    (:func:`raft_tpu_torch.ops.pq_group_scan.list_scan`), ``"pair"``
    (:func:`recon_pair_list_scan`) or ``"query"``
    (:func:`recon_scan_query_major`)."""
    listed = list_scan_reject_reason(rot, kt)
    if not listed:
        return "list", ""
    paired = recon_pair_list_reject_reason(rot, kt)
    if not paired:
        return "pair", listed
    return "query", f"{listed}; {paired}"


def _groups_of(group_list, slot_pairs, device, group: int, what: str):
    expects(slot_pairs.ndim == 2 and slot_pairs.shape[1] == group
            and group_list.shape == (slot_pairs.shape[0],)
            and group_list.device == slot_pairs.device == device,
            f"{what}: group_list (n_groups,) and slot_pairs (n_groups, "
            f"{group}) on the queries' device required (build_groups with "
            f"group={group})")
    return (group_list.to(torch.int32).contiguous(),
            slot_pairs.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Kernel F: IVF-Flat, exact fp32 rows
# ---------------------------------------------------------------------------

def _check_flat(queries, probes, list_data, list_data_sq, list_indices,
                ip: bool):
    expects(queries.ndim == 2 and probes.ndim == 2 and list_data.ndim == 3
            and list_indices.ndim == 2,
            "ivf_flat_scan: queries (nq, dim), probes (nq, n_probes), "
            "list_data (L, cap, dim), list_indices (L, cap) required")
    n_lists, cap, dim = list_data.shape
    expects(queries.shape[1] == dim and probes.shape[0] == queries.shape[0]
            and list_indices.shape == (n_lists, cap)
            and (ip or (list_data_sq is not None
                        and list_data_sq.shape == (n_lists, cap))),
            "ivf_flat_scan: shape mismatch (L2 needs list_data_sq (L, cap))")
    devs = {t.device for t in (queries, probes, list_data, list_indices)}
    expects(len(devs) == 1, "ivf_flat_scan: tensors on different devices")
    return n_lists, cap, dim


def ivf_flat_scan_plain(queries, probes, list_data, list_data_sq,
                        list_indices, kt: int, ip: bool = False,
                        filter_words=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel F: every (query, probe, row) value
    (``max(q_sq + d_sq − 2·q·x, 0)``, or ``−q·x`` for InnerProduct; +inf
    where ``filter_words`` rejects the row), each pair's top kt
    (:func:`pair_topk`), the InnerProduct values negated back.  Same
    arithmetic as the kernel except the order of the fp32 sums."""
    n_lists, cap, _ = _check_flat(queries, probes, list_data, list_data_sq,
                                  list_indices, ip)
    kt = min(kt, cap)
    qf = queries.float()
    parts = []
    for q, p, f in plain_chunks(qf, probes, filter_words):
        pr = p.long()
        ok = (pr >= 0) & (pr < n_lists)
        pr = torch.where(ok, pr, torch.zeros_like(pr))
        dot = torch.matmul(list_data[pr].float(), q[:, None, :, None])[..., 0]
        if ip:
            d = -dot
        else:
            q_sq = (q * q).sum(-1)
            d = torch.clamp_min(q_sq[:, None, None] + list_data_sq[pr]
                                - 2.0 * dot, 0.0)
        cid = list_indices[pr]
        d = torch.where((cid >= 0) & ok[..., None], d,
                        torch.full_like(d, float("inf")))
        v, i = pair_topk(admit(d, cid, f), cid, kt)
        parts.append((-v if ip else v, i))
    return cat_parts(parts, (probes.shape[1], kt), queries.device)


def flat_scan_query_major(queries, probes, list_data, list_data_sq,
                          list_indices, kt: int, ip: bool = False,
                          filter_words=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's query-major route (``csrc/pair_scan.cu`` ``Fp32Rows``):
    one block per query walks its probes, the products in fp32 FFMA, rows
    of any width (16-byte loads where the width is a multiple of 4 and the
    rows are 16-byte aligned, else one value at a time), with
    ``filter_words`` only the rows the query admits; :func:`ivf_flat_scan`
    takes it where both grouped routes refuse the shape
    (:func:`flat_scan_route`), and chip_smoke times it beside them.  CUDA
    tensors launch it; CPU tensors run the plain version."""
    if not queries.is_cuda:
        return ivf_flat_scan_plain(queries, probes, list_data, list_data_sq,
                                   list_indices, kt, ip, filter_words)
    n_lists, cap, dim = _check_flat(queries, probes, list_data,
                                    list_data_sq, list_indices, ip)
    kt = min(kt, cap)
    reason = pair_scan_reject_reason(cap, dim, kt, 4)
    expects(not reason, f"flat_scan_query_major: {reason}")
    queries, probes, data, norms, ids = _flat_operands(
        queries, probes, list_data, list_data_sq, list_indices, ip,
        "flat_scan_query_major")
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, queries.device,
                               "flat_scan_query_major")
    vals, out_ids = _outputs(nq, n_probes, kt, queries.device)
    status = _cuda.library().raft_ivf_flat_scan(
        queries.data_ptr(), probes.data_ptr(), data.data_ptr(),
        None if norms is None else norms.data_ptr(), ids.data_ptr(), nq,
        n_probes, n_lists, cap, dim, kt, int(ip),
        pair_scan_smem_bytes(cap, dim), vals.data_ptr(), out_ids.data_ptr(),
        *fargs, torch.cuda.current_stream(queries.device).cuda_stream)
    _cuda.check(status, "flat_scan_query_major")
    flat_scan_query_major.launches += 1
    return (-vals if ip else vals), out_ids


flat_scan_query_major.launches = 0


def _flat_operands(queries, probes, list_data, list_data_sq, list_indices,
                   ip: bool, what: str):
    """A flat scan's operands for a kernel launch: dtypes checked,
    contiguous, the probes int32 (the norms None for InnerProduct).  Both
    routes take rows at any alignment."""
    expects(queries.dtype == list_data.dtype == torch.float32
            and list_indices.dtype == torch.int32
            and (ip or list_data_sq.dtype == torch.float32),
            f"{what}: queries / list_data / list_data_sq float32 and "
            f"list_indices int32 required")
    return (queries.contiguous(), probes.to(torch.int32).contiguous(),
            list_data.contiguous(),
            None if ip else list_data_sq.contiguous(),
            list_indices.contiguous())


class FlatLayout(NamedTuple):
    """The dynamic shared memory of one block of :func:`flat_list_scan`,
    in the field order of ``csrc/flat_list_scan.cu``'s ``FlatLayout``:
    the one copy of the formula (the gate tests it, the launch passes it
    and the kernel reads it).  ``resident``: the group's queries keep every
    dim in shared memory; ``stride``: the entries of a pair's top-kt row;
    then byte offsets from the 1024-byte aligned base (the queries' hi
    parts at 0 and their lo parts at ``a_lo``, atom columns or stages
    ``a_step`` apart), ending with ``total``, the bytes a block requests."""
    resident: int
    stride: int
    a_step: int
    a_lo: int
    b: int
    key: int
    top_v: int
    top_s: int
    ssq: int
    pair: int
    sub: int
    total: int

    def as_c(self):
        """The layout as the C entry point reads it: a ctypes array of
        ints in field order."""
        return (ctypes.c_int * len(self))(*self)


def flat_list_scan_layout(dim: int, kt: int) -> FlatLayout:
    """:class:`FlatLayout` of a ``dim``-wide scan keeping ``kt``: the
    group's 128 queries as TF32 hi and lo parts (16 KB each per 32 dims:
    resident when everything fits the card's limit, else two 32-dim
    stages), two stages of 128 tile rows x 32 dims, hi and lo (each also
    holds a 32 KB distance half), two windows' row norms and ids, the top
    kt of 128 pairs in rows of ``round8(kt)`` entries, ``q_sq``, the pair
    indices, the sub-lists' ends and windows (128 B), and 1 KB to align the
    base for the swizzle atoms."""
    op = 128 * 128                       # 128 rows x 32 fp32 dims
    atoms = -(-dim // 32)
    stride = -(-kt // 8) * 8
    rest = (2 * 2 * op + 2 * 128 * 8 + 2 * 128 * stride * 4 + 2 * 128 * 4
            + 128 + 1024)
    resident = 2 * atoms * op + rest <= _SMEM_LIMIT
    b = 2 * atoms * op if resident else 2 * 2 * op
    key = b + 2 * 2 * op
    top_v = key + 2 * 128 * 8
    top_s = top_v + 128 * stride * 4
    ssq = top_s + 128 * stride * 4
    return FlatLayout(int(resident), stride, op if resident else 2 * op,
                      atoms * op if resident else op, b, key, top_v, top_s,
                      ssq, ssq + 128 * 4, ssq + 2 * 128 * 4,
                      ssq + 2 * 128 * 4 + 128 + 1024)


def flat_list_scan_smem_bytes(dim: int, kt: int) -> int:
    """Dynamic shared memory of one block of :func:`flat_list_scan`:
    :func:`flat_list_scan_layout`'s ``total``."""
    return flat_list_scan_layout(dim, kt).total


def flat_list_scan_reject_reason(rows: int, dim: int, kt: int,
                                 sub_lists: int = 1) -> str:
    """Why Kernel F's list-major pass cannot take this shape ('' when it
    can): a tile of ``rows`` slots made of ``sub_lists`` sub-lists.  Any
    row width from 1 is taken."""
    if not 0 < kt <= KT_LIST_MAX:
        return f"kt={kt} outside 1..{KT_LIST_MAX} (the list-major route)"
    if dim < 1:
        return f"row width {dim} < 1"
    if not 0 < sub_lists <= MAX_SUB_LISTS or rows % sub_lists:
        return (f"a tile of {rows} slots cannot hold {sub_lists} equal "
                f"sub-lists (1..{MAX_SUB_LISTS})")
    need = flat_list_scan_smem_bytes(dim, kt)
    if need > _SMEM_LIMIT:
        return (f"the list-major route needs {need} B of shared memory "
                f"(limit {_SMEM_LIMIT})")
    return ""


def flat_list_scan_plain(queries, probes, group_list, slot_pairs,
                         list_data, list_data_sq, list_indices, kt: int,
                         ip: bool = False, filter_words=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flat_list_scan`: the list-major
    schedule emulated.  For each group's live slot, its pair's top kt over
    the group's tile (:func:`ivf_flat_scan_plain` with that one probe),
    scattered to the pair's place; a pair no group holds (its probe outside
    ``[0, n_lists)``) stays empty.  It takes no ``sub_lists``: they change
    which slots the kernel streams, never the result."""
    _, cap, _ = _check_flat(queries, probes, list_data, list_data_sq,
                            list_indices, ip)
    nq, n_probes = probes.shape
    P, kt = nq * n_probes, min(kt, cap)
    worst = float("-inf") if ip else float("inf")
    vals = torch.full((P, kt), worst, dtype=torch.float32,
                      device=queries.device)
    ids = torch.full((P, kt), -1, dtype=torch.int32, device=queries.device)
    for lst, slots in zip(group_list.long(), slot_pairs.long()):
        p = slots[slots < P]
        q = p // n_probes
        v, i = ivf_flat_scan_plain(
            queries[q], lst.expand(p.numel(), 1), list_data, list_data_sq,
            list_indices, kt, ip,
            None if filter_words is None else filter_words[q])
        vals[p], ids[p] = v[:, 0], i[:, 0]
    return vals.reshape(nq, n_probes, kt), ids.reshape(nq, n_probes, kt)


def flat_list_scan(queries, probes, group_list, slot_pairs, list_data,
                   list_data_sq, list_indices, kt: int, ip: bool = False,
                   sub_lists: int = 1, filter_words=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's list-major pass: ``(vals, ids)``, each (nq, n_probes,
    kt), as :func:`ivf_flat_scan` returns them (with ``filter_words``,
    only the rows each pair's query admits).  ``group_list`` /
    ``slot_pairs`` are :func:`raft_tpu_torch.neighbors.grouped.
    build_groups` of ``probes``; one block scans one group's tile once for
    its pairs, each of the tile's ``sub_lists`` sub-lists up to its last
    live row.  CUDA tensors launch ``csrc/flat_list_scan.cu`` (kt up to
    ``KT_LIST_MAX``); CPU tensors run :func:`flat_list_scan_plain`."""
    if not queries.is_cuda:
        return flat_list_scan_plain(queries, probes, group_list, slot_pairs,
                                    list_data, list_data_sq, list_indices,
                                    kt, ip, filter_words)
    n_lists, cap, dim = _check_flat(queries, probes, list_data,
                                    list_data_sq, list_indices, ip)
    kt = min(kt, cap)
    reason = flat_list_scan_reject_reason(cap, dim, kt, sub_lists)
    expects(not reason, f"flat_list_scan: {reason}")
    expects(slot_pairs.ndim == 2 and slot_pairs.shape[1] == grouped.GROUP
            and group_list.shape == (slot_pairs.shape[0],)
            and group_list.device == slot_pairs.device == queries.device,
            f"flat_list_scan: group_list (n_groups,) and slot_pairs "
            f"(n_groups, {grouped.GROUP}) on the queries' device required")
    queries, probes, data, norms, ids = _flat_operands(
        queries, probes, list_data, list_data_sq, list_indices, ip,
        "flat_list_scan")
    group_list = group_list.to(torch.int32).contiguous()
    slot_pairs = slot_pairs.to(torch.int32).contiguous()
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, queries.device,
                               "flat_list_scan")
    vals, out_ids = _outputs(nq, n_probes, kt, queries.device)
    layout = flat_list_scan_layout(dim, kt).as_c()
    status = _cuda.library().raft_ivf_flat_list_scan(
        queries.data_ptr(), probes.data_ptr(), group_list.data_ptr(),
        slot_pairs.data_ptr(), data.data_ptr(),
        None if norms is None else norms.data_ptr(), ids.data_ptr(),
        group_list.shape[0], nq, n_probes, n_lists, cap, sub_lists, dim, kt,
        int(ip), ctypes.addressof(layout), vals.data_ptr(),
        out_ids.data_ptr(), *fargs,
        torch.cuda.current_stream(queries.device).cuda_stream)
    _cuda.check(status, "flat_list_scan")
    flat_list_scan.launches += 1
    return (-vals if ip else vals), out_ids


flat_list_scan.launches = 0


def flat_pair_list_scan(queries, probes, group_list, slot_pairs, list_data,
                        list_data_sq, list_indices, kt: int,
                        ip: bool = False, sub_lists: int = 1,
                        filter_words=None, group: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's pair-group pass: ``(vals, ids)``, each (nq, n_probes,
    kt), as :func:`ivf_flat_scan` returns them (with ``filter_words``, only
    the rows each pair's query admits).  ``group_list`` / ``slot_pairs``
    are :func:`raft_tpu_torch.neighbors.grouped.build_groups` of
    ``probes`` at :func:`pair_list_layout`'s group size (``group`` where
    given, which only tests and profiles set); one block reads
    one group's tile once for its pairs and keeps each pair's top kt (up
    to ``PAIR_KT_MAX``).  CUDA tensors launch ``csrc/pair_list_scan.cu``;
    CPU tensors run :func:`flat_list_scan_plain`, the same grouped
    schedule."""
    if not queries.is_cuda:
        return flat_list_scan_plain(queries, probes, group_list, slot_pairs,
                                    list_data, list_data_sq, list_indices,
                                    kt, ip, filter_words)
    n_lists, cap, dim = _check_flat(queries, probes, list_data,
                                    list_data_sq, list_indices, ip)
    kt = min(kt, cap)
    reason = flat_pair_list_reject_reason(cap, dim, kt, sub_lists)
    expects(not reason, f"flat_pair_list_scan: {reason}")
    layout = pair_list_layout(dim, kt, True, group=group)
    group_list, slot_pairs = _groups_of(group_list, slot_pairs,
                                        queries.device, layout.group,
                                        "flat_pair_list_scan")
    queries, probes, data, norms, ids = _flat_operands(
        queries, probes, list_data, list_data_sq, list_indices, ip,
        "flat_pair_list_scan")
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, queries.device,
                               "flat_pair_list_scan")
    vals, out_ids = _outputs(nq, n_probes, kt, queries.device)
    c_layout = layout.as_c()
    status = _cuda.library().raft_pair_list_scan_flat(
        queries.data_ptr(), probes.data_ptr(), group_list.data_ptr(),
        slot_pairs.data_ptr(), data.data_ptr(),
        None if norms is None else norms.data_ptr(), ids.data_ptr(),
        group_list.shape[0], nq, n_probes, n_lists, cap, sub_lists, dim, kt,
        int(ip), 1, 1, ctypes.addressof(c_layout), vals.data_ptr(),
        out_ids.data_ptr(), *fargs,
        torch.cuda.current_stream(queries.device).cuda_stream)
    _cuda.check(status, "flat_pair_list_scan")
    flat_pair_list_scan.launches += 1
    return (-vals if ip else vals), out_ids


flat_pair_list_scan.launches = 0


def ivf_flat_scan(queries, probes, list_data, list_data_sq: Optional[
        torch.Tensor], list_indices, kt: int, ip: bool = False,
        sub_lists: int = 1, filter_words=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt over raw fp32 list rows.  ``list_data_sq`` (L, cap) holds
    the rows' squared norms (unused for InnerProduct).  A super-tiled index
    passes its (L/F, F·cap, dim) view, super-probes and ``sub_lists`` = F.
    CUDA tensors run Kernel F on the route :func:`flat_scan_route` picks by
    shape: kt up to ``KT_LIST_MAX``, the pairs grouped by tile and
    :func:`flat_list_scan`; up to ``PAIR_KT_MAX``, grouped in
    :func:`pair_list_layout`'s groups and :func:`flat_pair_list_scan`;
    else :func:`flat_scan_query_major` (each kernel counted on its own
    ``launches``).  CPU tensors run the plain version.  With
    ``filter_words``, each pair keeps only the rows its query admits, on
    every route."""
    n_lists, cap, dim = _check_flat(queries, probes, list_data,
                                    list_data_sq, list_indices, ip)
    kt = min(kt, cap)
    if not queries.is_cuda:
        return ivf_flat_scan_plain(queries, probes, list_data, list_data_sq,
                                   list_indices, kt, ip, filter_words)
    route, _ = flat_scan_route(cap, dim, kt, sub_lists)
    if route == "query":
        return flat_scan_query_major(queries, probes, list_data,
                                     list_data_sq, list_indices, kt, ip,
                                     filter_words)
    if route == "pair":
        group = pair_list_layout(dim, kt, True).group
        return flat_pair_list_scan(
            queries, probes, *grouped.groups_of(probes, n_lists, group),
            list_data, list_data_sq, list_indices, kt, ip, sub_lists,
            filter_words)
    return flat_list_scan(queries, probes,
                          *grouped.groups_of(probes, n_lists), list_data,
                          list_data_sq, list_indices, kt, ip, sub_lists,
                          filter_words)


# ---------------------------------------------------------------------------
# Kernel G: IVF-PQ, bf16 reconstruction rows
# ---------------------------------------------------------------------------

def ivf_pq_scan_recon_plain(qrot, centers, probes, list_recon, list_recon_sq,
                            list_indices, kt: int, filter_words=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel G: Kernel B's distances
    (:func:`probe_distances` over the bf16 rows), each pair's top kt."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices,
                               "ivf_pq_scan_recon")
    kt = min(kt, cap)
    dot = recon_dot(list_recon)
    parts = [pair_topk(*probe_distances(q, centers, p, list_indices,
                                        list_recon_sq, dot, f), kt)
             for q, p, f in plain_chunks(qrot, probes, filter_words)]
    return cat_parts(parts, (probes.shape[1], kt), qrot.device)


def recon_scan_query_major(qrot, centers, probes, list_recon, list_recon_sq,
                           list_indices, kt: int, filter_words=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's query-major route (``csrc/pair_scan.cu`` ``Bf16Rows``):
    one block per query walks its probes (with ``filter_words``, over the
    rows it admits); :func:`ivf_pq_scan_recon` takes it where both grouped
    routes refuse the shape (:func:`recon_scan_route`).  CUDA tensors
    launch it; CPU tensors run the plain version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_recon_plain(qrot, centers, probes, list_recon,
                                       list_recon_sq, list_indices, kt,
                                       filter_words)
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices,
                               "recon_scan_query_major")
    kt = min(kt, cap)
    reason = pair_scan_reject_reason(cap, rot, kt, 8)
    expects(not reason, f"recon_scan_query_major: {reason}")
    qrot, centers, probes, recon, rsq, ids = cuda_operands(
        qrot, centers, probes, list_recon, list_recon_sq, list_indices,
        "recon_scan_query_major")
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device,
                               "recon_scan_query_major")
    vals, out_ids = _outputs(nq, n_probes, kt, qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_recon(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        recon.data_ptr(), rsq.data_ptr(), ids.data_ptr(), nq, n_probes,
        n_lists, cap, rot, kt, pair_scan_smem_bytes(cap, rot),
        vals.data_ptr(), out_ids.data_ptr(), *fargs,
        torch.cuda.current_stream(qrot.device).cuda_stream)
    _cuda.check(status, "recon_scan_query_major")
    recon_scan_query_major.launches += 1
    return vals, out_ids


recon_scan_query_major.launches = 0


def recon_pair_list_scan(qrot, centers, probes, group_list, slot_pairs,
                         list_recon, list_recon_sq, list_indices, kt: int,
                         filter_words=None, group: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's pair-group pass: ``(vals, ids)``, each (nq, n_probes,
    kt), every pair's top kt (up to ``PAIR_KT_MAX``) over the bf16 recon
    cache, with ``filter_words`` only the rows its query admits.
    ``group_list`` / ``slot_pairs``: :func:`raft_tpu_torch.neighbors.
    grouped.build_groups` of ``probes`` at :func:`pair_list_layout`'s group
    size (``group`` as in :func:`flat_pair_list_scan`).  CUDA tensors
    launch ``csrc/pair_list_scan.cu``; CPU tensors run
    :func:`raft_tpu_torch.ops.pq_group_scan.list_scan_plain`'s grouped
    schedule."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices,
                               "recon_pair_list_scan")
    kt = min(kt, cap)
    if not qrot.is_cuda:
        return grouped_pair_topk(qrot, centers, probes, group_list,
                                 slot_pairs, list_recon_sq, list_indices, kt,
                                 recon_dot(list_recon), filter_words)
    reason = recon_pair_list_reject_reason(rot, kt)
    expects(not reason, f"recon_pair_list_scan: {reason}")
    layout = pair_list_layout(rot, kt, False, group=group)
    group_list, slot_pairs = _groups_of(group_list, slot_pairs, qrot.device,
                                        layout.group, "recon_pair_list_scan")
    qrot, centers, probes, recon, rsq, ids = cuda_operands(
        qrot, centers, probes, list_recon, list_recon_sq, list_indices,
        "recon_pair_list_scan")
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device,
                               "recon_pair_list_scan")
    vals, out_ids = _outputs(nq, n_probes, kt, qrot.device)
    c_layout = layout.as_c()
    status = _cuda.library().raft_pair_list_scan_recon(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        group_list.data_ptr(), slot_pairs.data_ptr(), recon.data_ptr(),
        rsq.data_ptr(), ids.data_ptr(), group_list.shape[0], nq, n_probes,
        n_lists, cap, rot, kt, 1, 1, ctypes.addressof(c_layout),
        vals.data_ptr(), out_ids.data_ptr(), *fargs,
        torch.cuda.current_stream(qrot.device).cuda_stream)
    _cuda.check(status, "recon_pair_list_scan")
    recon_pair_list_scan.launches += 1
    return vals, out_ids


recon_pair_list_scan.launches = 0


def ivf_pq_scan_recon(qrot, centers, probes, list_recon, list_recon_sq,
                      list_indices, kt: int, filter_words=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt over the bf16 reconstruction cache.  CUDA tensors run
    Kernel G on the route :func:`recon_scan_route` picks by shape: kt up to
    ``KT_LIST_MAX``, the pairs grouped by list and
    :func:`raft_tpu_torch.ops.pq_group_scan.list_scan`
    (``csrc/pq_list_scan.cu``); up to ``PAIR_KT_MAX``,
    :func:`recon_pair_list_scan` on :func:`pair_list_layout`'s groups;
    else :func:`recon_scan_query_major` (each kernel counted on its own
    ``launches``).  CPU tensors run the plain version.  ``filter_words``
    as in :func:`ivf_flat_scan`."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices,
                               "ivf_pq_scan_recon")
    kt = min(kt, cap)
    if not qrot.is_cuda:
        return ivf_pq_scan_recon_plain(qrot, centers, probes, list_recon,
                                       list_recon_sq, list_indices, kt,
                                       filter_words)
    route, _ = recon_scan_route(rot, kt)
    if route == "query":
        return recon_scan_query_major(qrot, centers, probes, list_recon,
                                      list_recon_sq, list_indices, kt,
                                      filter_words)
    if route == "pair":
        group = pair_list_layout(rot, kt, False).group
        return recon_pair_list_scan(
            qrot, centers, probes,
            *grouped.groups_of(probes, n_lists, group), list_recon,
            list_recon_sq, list_indices, kt, filter_words)
    return list_scan(qrot, centers, probes,
                     *grouped.groups_of(probes, n_lists), list_recon,
                     list_recon_sq, list_indices, kt, filter_words)


# ---------------------------------------------------------------------------
# the profile variants of F and G: raw distances, pre-gathered queries
# ---------------------------------------------------------------------------

def _check_variant(queries, probes, list_data, list_data_sq, list_indices,
                   gather: bool, extract: bool, centers):
    expects(probes.ndim == 2 and list_data.ndim == 3
            and queries.ndim == 2,
            "pair_scan_variant: queries 2-D, probes (nq, n_probes), "
            "list_data (L, cap, width) required")
    nq, n_probes = probes.shape
    n_lists, cap, width = list_data.shape
    expects(queries.shape == ((nq, width) if gather
                              else (nq * n_probes, width)),
            "pair_scan_variant: queries must be (nq, width), or (nq * "
            "n_probes, width) pre-gathered per pair")
    expects(list_data_sq.shape == (n_lists, cap)
            and (not extract or list_indices.shape == (n_lists, cap))
            and (centers is None or centers.shape == (n_lists, width)),
            "pair_scan_variant: shape mismatch")
    expects(centers is not None or list_data.dtype == torch.float32,
            "pair_scan_variant: fp32 rows without centers (Kernel F), "
            "bf16 rows with centers (Kernel G)")
    expects(centers is None or list_data.dtype == torch.bfloat16,
            "pair_scan_variant: the recon rows (with centers) must be "
            "bfloat16")
    return nq, n_probes, n_lists, cap, width


def pair_scan_variant_plain(queries, probes, list_data, list_data_sq,
                            list_indices, kt: int, *, gather: bool = True,
                            extract: bool = True, centers=None):
    """Plain PyTorch version of :func:`pair_scan_variant`, the same
    arithmetic as Kernels F (``centers`` None: ``max(‖q‖² + ‖x‖² − 2q·x,
    0)`` over fp32 rows) and G (``sub = q − center``, ``max(‖sub‖² + rsq −
    2·bf16(sub)·x, 0)`` over bf16 rows) except the order of the fp32 sums.
    Raw (``extract`` False): the formula at every slot, +inf for a probe
    outside ``[0, n_lists)``; extract: each pair's top kt as F's plain
    version keeps it."""
    nq, n_probes, n_lists, cap, width = _check_variant(
        queries, probes, list_data, list_data_sq, list_indices, gather,
        extract, centers)
    kt = min(kt, cap)
    qf = queries.float()
    if not gather:
        qf = qf.reshape(nq, n_probes, width)
    parts = []
    for s in range(0, nq, _PLAIN_CHUNK):
        p = probes[s:s + _PLAIN_CHUNK].long()
        ok = (p >= 0) & (p < n_lists)
        pr = torch.where(ok, p, torch.zeros_like(p))
        q = qf[s:s + _PLAIN_CHUNK]
        q = q[:, None, :].expand(-1, n_probes, -1) if gather else q
        if centers is not None:
            q = q - centers[pr].float()
        q_sq = (q * q).sum(-1)
        if centers is not None:
            q = q.to(torch.bfloat16).float()
        dot = torch.matmul(list_data[pr].float(), q[..., None])[..., 0]
        d = torch.clamp_min(q_sq[..., None] + list_data_sq[pr] - 2.0 * dot,
                            0.0)
        d = torch.where(ok[..., None], d, torch.full_like(d, float("inf")))
        if extract:
            cid = list_indices[pr]
            d = torch.where(cid >= 0, d, torch.full_like(d, float("inf")))
            parts.append(pair_topk(d, cid, kt))
        else:
            parts.append(d)
    if extract:
        return cat_parts(parts, (n_probes, kt), queries.device)
    return (torch.cat(parts) if parts else
            torch.empty(0, n_probes, cap, device=queries.device))


def pair_scan_variant_grouped_plain(queries, probes, group_list, slot_pairs,
                                    list_data, list_data_sq, list_indices,
                                    kt: int, *, gather: bool = True,
                                    extract: bool = True, centers=None):
    """:func:`pair_scan_variant` on the pair-group pass's schedule,
    emulated: for each group's live slots, their pairs against the group's
    list (:func:`pair_scan_variant_plain` of those pairs, their query rows
    gathered), scattered to the pairs' places; a pair no group holds (its
    probe outside ``[0, n_lists)``) stays +inf (raw) or ``(+inf, −1)``.
    ``group_list`` / ``slot_pairs``: ``build_groups`` of ``probes``."""
    nq, n_probes, _, cap, width = _check_variant(
        queries, probes, list_data, list_data_sq, list_indices, gather,
        extract, centers)
    P, dev = nq * n_probes, queries.device
    kt = min(kt, cap)
    tail = kt if extract else cap
    vals = torch.full((P, tail), float("inf"), dtype=torch.float32,
                      device=dev)
    ids = torch.full((P, tail), -1, dtype=torch.int32, device=dev)
    for lst, slots in zip(group_list.long(), slot_pairs.long()):
        p = slots[slots < P]
        rows = queries[p // n_probes] if gather else queries[p]
        out = pair_scan_variant_plain(
            rows, lst.expand(p.numel(), 1), list_data, list_data_sq,
            list_indices, kt, gather=False, extract=extract, centers=centers)
        if extract:
            vals[p], ids[p] = out[0][:, 0], out[1][:, 0]
        else:
            vals[p] = out[:, 0]
    vals = vals.reshape(nq, n_probes, tail)
    return (vals, ids.reshape(nq, n_probes, tail)) if extract else vals


def _variant_operands(queries, probes, list_data, list_data_sq,
                      list_indices, extract: bool, centers, what: str):
    bf16 = centers is not None
    expects(queries.dtype == list_data_sq.dtype == torch.float32
            and (not extract or list_indices.dtype == torch.int32)
            and (not bf16 or centers.dtype == torch.float32),
            f"{what}: queries / norms / centers float32 and list_indices "
            f"int32 required")
    tensors = [queries, probes, list_data, list_data_sq]
    tensors += [list_indices] if extract else []
    tensors += [centers] if bf16 else []
    expects(len({t.device for t in tensors}) == 1,
            f"{what}: tensors on different devices")
    return (queries.contiguous(), probes.to(torch.int32).contiguous(),
            _aligned(list_data, f"{what}: list_data"),
            list_data_sq.contiguous(),
            list_indices.contiguous() if extract else None,
            centers.contiguous() if bf16 else None)


def _variant_outputs(nq, n_probes, kt, cap, extract: bool, device):
    if extract:
        return _outputs(nq, n_probes, kt, device)
    return torch.empty(nq, n_probes, cap, dtype=torch.float32,
                       device=device), None


def pair_scan_variant(queries, probes, list_data, list_data_sq,
                      list_indices, kt: int, *, gather: bool = True,
                      extract: bool = True, centers=None):
    """One (query, probe) pair scan with the profile's switches: Kernel
    F's arithmetic over fp32 rows (``centers`` None) or Kernel G's over
    bf16 recon rows (``centers`` the lists' centers, queries rotated).

    ``gather`` False: ``queries`` is (nq·n_probes, width), the pair's own
    query row by pair index.  ``extract`` True: ``(vals, ids)``, each (nq,
    n_probes, kt), as Kernels F and G return them; False: the raw (nq,
    n_probes, cap) distances at every slot, empty slots included (a zero
    row: ``‖q‖²``), +inf for a probe outside ``[0, n_lists)``.  L2 only.
    CUDA tensors group the pairs by list (``build_groups`` at
    :func:`pair_list_layout`'s group size, one host sync) and launch the
    pair-group pass ``csrc/pair_list_scan.cu`` (``pair_scan_variant.
    launches`` counts them); CPU tensors run the plain version."""
    if not queries.is_cuda:
        return pair_scan_variant_plain(
            queries, probes, list_data, list_data_sq, list_indices, kt,
            gather=gather, extract=extract, centers=centers)
    nq, n_probes, n_lists, cap, width = _check_variant(
        queries, probes, list_data, list_data_sq, list_indices, gather,
        extract, centers)
    kt = min(kt, cap)
    bf16 = centers is not None
    reason = _pair_list_reason(width, kt, not bf16, extract)
    expects(not reason, f"pair_scan_variant: {reason}")
    queries, probes, data, norms, ids, cen = _variant_operands(
        queries, probes, list_data, list_data_sq, list_indices, extract,
        centers, "pair_scan_variant")
    layout = pair_list_layout(width, kt, not bf16, extract)
    group_list, slot_pairs = grouped.build_groups(probes, n_lists,
                                                  layout.group)
    vals, out_ids = _variant_outputs(nq, n_probes, kt, cap, extract,
                                     queries.device)
    c_layout = layout.as_c()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    outs = (vals.data_ptr(), None if out_ids is None else out_ids.data_ptr())
    lib = _cuda.library()
    if bf16:
        status = lib.raft_pair_list_scan_recon(
            queries.data_ptr(), cen.data_ptr(), probes.data_ptr(),
            group_list.data_ptr(), slot_pairs.data_ptr(), data.data_ptr(),
            norms.data_ptr(), None if ids is None else ids.data_ptr(),
            group_list.shape[0], nq, n_probes, n_lists, cap, width, kt,
            int(gather), int(extract), ctypes.addressof(c_layout), *outs,
            None, 0, 0, stream)
    else:
        status = lib.raft_pair_list_scan_flat(
            queries.data_ptr(), probes.data_ptr(), group_list.data_ptr(),
            slot_pairs.data_ptr(), data.data_ptr(), norms.data_ptr(),
            None if ids is None else ids.data_ptr(), group_list.shape[0],
            nq, n_probes, n_lists, cap, 1, width, kt, 0, int(gather),
            int(extract), ctypes.addressof(c_layout), *outs, None, 0, 0,
            stream)
    _cuda.check(status, "pair_scan_variant")
    pair_scan_variant.launches += 1
    return (vals, out_ids) if extract else vals


pair_scan_variant.launches = 0


def pair_scan_variant_query_major(queries, probes, list_data, list_data_sq,
                                  list_indices, kt: int, *,
                                  gather: bool = True, extract: bool = True,
                                  centers=None):
    """:func:`pair_scan_variant` on the query-major kernel
    (``csrc/pair_scan.cu``'s ``kExtract`` / ``kGather`` switches, one block
    per query walking its probes): the yardstick chip_smoke times beside
    the pair-group pass.  CUDA tensors launch it
    (``pair_scan_variant_query_major.launches``); CPU tensors run the plain
    version."""
    if not queries.is_cuda:
        return pair_scan_variant_plain(
            queries, probes, list_data, list_data_sq, list_indices, kt,
            gather=gather, extract=extract, centers=centers)
    nq, n_probes, n_lists, cap, width = _check_variant(
        queries, probes, list_data, list_data_sq, list_indices, gather,
        extract, centers)
    kt = min(kt, cap)
    bf16 = centers is not None
    reason = pair_scan_reject_reason(cap, width, kt, 8 if bf16 else 4)
    expects(not reason, f"pair_scan_variant_query_major: {reason}")
    queries, probes, data, norms, ids, cen = _variant_operands(
        queries, probes, list_data, list_data_sq, list_indices, extract,
        centers, "pair_scan_variant_query_major")
    vals, out_ids = _variant_outputs(nq, n_probes, kt, cap, extract,
                                     queries.device)
    status = _cuda.library().raft_pair_scan_variant(
        int(bf16), int(gather), int(extract), queries.data_ptr(),
        None if cen is None else cen.data_ptr(), probes.data_ptr(),
        data.data_ptr(), norms.data_ptr(),
        None if ids is None else ids.data_ptr(), nq, n_probes, n_lists, cap,
        width, kt, pair_scan_smem_bytes(cap, width), vals.data_ptr(),
        None if out_ids is None else out_ids.data_ptr(),
        torch.cuda.current_stream(queries.device).cuda_stream)
    _cuda.check(status, "pair_scan_variant_query_major")
    pair_scan_variant_query_major.launches += 1
    return (vals, out_ids) if extract else vals


pair_scan_variant_query_major.launches = 0

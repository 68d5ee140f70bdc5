"""Kernels C, D and E: IVF-PQ scans over the compact codes and over the
int8 reconstruction cache.

They replace the three kernels of ``raft_tpu/ops/pq_code_scan_pallas.py``:

- Kernel C, :func:`ivf_pq_scan_codes_fused`: ``:282
  grouped_code_scan_fused``, each query's top k;
- Kernel D, :func:`ivf_pq_scan_codes`: ``:367 grouped_code_scan``, each
  (query, probe) pair's top kt;
- Kernel E, :func:`ivf_pq_scan_recon8`: ``:441 grouped_recon8_scan``, each
  pair's top kt over the int8 cache.

C and D have two routes each, chosen by shape and counted apart, as
Kernels B and G have (E's below):

- **list-major** (a pair keeps at most ``KT_LIST_MAX`` candidates:
  ``min(kt, k)`` for C, kt for D): the pairs grouped by list
  (:func:`raft_tpu_torch.neighbors.grouped.build_groups`), then
  :func:`code_list_scan` (``csrc/pq_code_list_scan.cu``: pass 1 of
  Kernels B and G with each list's codes decoded in shared memory into
  its bf16 ``wgmma`` operand, one read of a list per group; alone it is
  D), and for C :func:`raft_tpu_torch.ops.pq_group_scan.merge_pairs`
  (pass 2), in query chunks within ``PAIR_BUFFER_BYTES``;
- **query-major** (larger kt): :func:`codes_fused_query_major` (C) and
  :func:`codes_scan_query_major` (D), ``csrc/pq_code_scan.cu``, one block
  per query walking its probes through a per-pair LUT.  Where D's LUT and
  books do not fit in shared memory together, it reads the books from
  global memory and sums the LUT in chunks (:func:`codes_layout`), so D
  takes every shape the Pallas ``supported_codes`` gate admits.

Kernel E, :func:`ivf_pq_scan_recon8`, has the same two routes: at kt <=
``KT_LIST_MAX`` the pairs grouped by list and :func:`recon8_list_scan`
(the same pass as :func:`code_list_scan` with the int8 rows converted to
bf16 in shared memory and the list's scale applied in the fold), else
:func:`recon8_scan_query_major` (``csrc/pq_recon8_scan.cu``).  The source
notes say what bounds each kernel on an H100 (bytes) and what its design
does about it.  C and D read ``list_codes`` (n_lists, cap, W) uint8 as the
index holds it: the TPU's lane-major (n_lists, Wi, cap) int32 words and
its one-hot decode do not come over.

Each kernel wrapper launches its kernel for CUDA tensors and runs its
plain version for CPU tensors — nothing else picks between them, and a
failed build or launch raises.  ``<wrapper>.launches`` counts kernel
launches (the dispatchers C and D launch nothing themselves);
``*_reject_reason`` says why a kernel cannot take a shape ('' when it
can).  ``filter_words`` (the admission operand, as
:mod:`raft_tpu_torch.ops.pq_group_scan` describes it) reaches both
routes: the list-major pass tests the bit in its fold, the query-major
kernels where a row would become a candidate (C) or before its codes
are read (D, E).

Contracts (``_kernel_codes`` / ``_kernel_recon8``,
``pq_code_scan_pallas.py:195-233``): ``sub = qrot[q] − centers[list]`` and
``sub_sq = Σ sub²`` in fp32; the product always takes ``bf16(sub)``.
Codes: ``d = max(sub_sq + rsq − 2·bf16(sub)·decode(codes), 0)``, decoded
against the bf16-rounded codebook, so ``rsq`` must be the row norms of
the bf16 reconstructions.  int8: ``d = max(sub_sq + rsq8 −
2·scale[list]·(bf16(sub)·q8), 0)``, the scale applied after the dot.
Rows with a negative id never enter a result, nor do probes outside
``[0, n_lists)``; each pair keeps at most its own top kt by (distance,
slot), ties to the lowest slot.  Per-pair outputs are (nq, n_probes, kt)
with (+inf, −1) in exhausted slots.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops.pq_group_scan import (K_MAX, KT_LIST_MAX,
                                              _SMEM_LIMIT, _next_pow2,
                                              cat_parts, filter_operand,
                                              grouped_pair_topk,
                                              list_major_topk, merge_pairs,
                                              pair_topk, plain_chunks,
                                              probe_distances, query_topk)

KT_MAX = 128                     # per-pair kt, as the JAX package's _KT_MAX
LUT_STEP = 32                    # kLutStep in csrc/pq_code_scan.cu


def code_field(packed: torch.Tensor, j: int, pq_bits: int) -> torch.Tensor:
    """Subspace j's code (int64) out of (..., W) LSB-first packed bytes; a
    field spans at most two bytes."""
    W = packed.shape[-1]
    b0, shift = divmod(j * pq_bits, 8)
    lo = packed[..., b0].long()
    hi = packed[..., min(b0 + 1, W - 1)].long()
    return ((lo | (hi << 8)) >> shift) & ((1 << pq_bits) - 1)


def decode_codes(codes: torch.Tensor, codebooks: torch.Tensor,
                 pq_bits: int) -> torch.Tensor:
    """(..., W) packed codes -> (..., pq_dim·pq_len) bf16 residual
    reconstructions ``concat_j bf16(codebook_j[code_j])``, one subspace at
    a time."""
    pq_dim, _, pq_len = codebooks.shape
    books = codebooks.to(torch.bfloat16)
    out = torch.empty(*codes.shape[:-1], pq_dim * pq_len,
                      dtype=torch.bfloat16, device=codes.device)
    for j in range(pq_dim):
        out[..., j * pq_len:(j + 1) * pq_len] = books[j][
            code_field(codes, j, pq_bits)]
    return out


# ---------------------------------------------------------------------------
# shared memory and gates: the one copy of each kernel's shared-memory
# formula, tested by its gate and passed to its launch
# ---------------------------------------------------------------------------

def _books_bytes(rot: int, pq_bits: int) -> int:
    return 2 * (rot << pq_bits)            # bf16 (pq_dim, book, pq_len)


def code_list_scan_smem_bytes(rot: int, pq_dim: int, pq_bits: int,
                              kt: int) -> int:
    """Dynamic shared memory of one block of :func:`code_list_scan`, as
    ``csrc/pq_code_list_scan.cu``'s ``code_layout`` lays it out: the
    group's bf16 residuals (resident up to 128 dims, else two 128-dim
    stages), two stages of 128 decoded rows (at least the 32 KB distance
    half each), their norms and ids, the top kt of 128 pairs in rows of
    round8(kt) entries, ``sub_sq``, the pair indices, the bf16 books, two
    raw stages of 128 rows' packed codes (+ a 16-byte head each), and 1 KB
    to align the swizzle atoms.  The gate tests it and the launch passes
    it; it mirrors ``code_layout``, and the entry point refuses a size
    below what ``code_layout`` needs."""
    def align(b):
        return -(-b // 1024) * 1024

    kp = -(-rot // 16) * 16
    kc = min(kp, 128)
    a = align(-(-kc // 64) * 128 * 128)
    b = align(max(-(-kc // 64) * 128 * 128, 128 * 64 * 4))
    stride = -(-kt // 8) * 8
    W = -(-pq_dim * pq_bits // 8)
    raw_step = -(-128 * W // 16) * 16 + 16
    return ((a if kp <= 128 else 2 * a) + 2 * b + 2 * 128 * 8
            + 2 * 128 * stride * 4 + 2 * 128 * 4 + _books_bytes(rot, pq_bits)
            + 2 * raw_step + 1024)


def codes_fused_smem_bytes(cap: int, rot: int, pq_dim: int,
                           pq_bits: int) -> int:
    """Kernel C's query-major route: top-k, the next_pow2(cap) candidate
    buffer, LUT, residual and bf16 books, as ``codes_fused_kernel`` lays
    them out."""
    return (4 * (4 * K_MAX + 3 * _next_pow2(cap) + (pq_dim << pq_bits)
                 + rot) + _books_bytes(rot, pq_bits))


def codes_layout(cap: int, rot: int, pq_dim: int, pq_bits: int
                 ) -> Tuple[int, int, bool]:
    """Kernel D's query-major route, as ``codes_pair_kernel`` lays it out:
    ``(shared-memory bytes, subspaces a LUT chunk holds, books staged)``.
    The pair's distances, the LUT, the residual and, where they fit, the
    bf16 books (``(smem, pq_dim, True)``); else the books stay in global
    memory and the LUT is built and summed in chunks of a multiple of
    ``LUT_STEP`` subspaces, as many as fit (0 when not even one does)."""
    full = 4 * (cap + (pq_dim << pq_bits) + rot) + _books_bytes(rot, pq_bits)
    if full <= _SMEM_LIMIT:
        return full, pq_dim, True
    fit = (_SMEM_LIMIT - 4 * (cap + rot)) // (4 * (LUT_STEP << pq_bits))
    lut_sub = min(pq_dim, max(fit, 0) * LUT_STEP)
    return 4 * (cap + (lut_sub << pq_bits) + rot), lut_sub, False


def recon8_list_scan_smem_bytes(rot_pad: int, kt: int) -> int:
    """Dynamic shared memory of one block of :func:`recon8_list_scan`, as
    ``code_layout`` lays it out for int8 rows: the layout of
    :func:`code_list_scan_smem_bytes` over ``rot_pad`` dims with no books,
    and raw stages of 128 rows of ``kc`` int8 dims each (``kc`` = min(
    rot_pad, 128)), a row padded to an odd number of 16-byte chunks."""
    def align(b):
        return -(-b // 1024) * 1024

    kc = min(rot_pad, 128)
    a = align(-(-kc // 64) * 128 * 128)
    b = align(max(-(-kc // 64) * 128 * 128, 128 * 64 * 4))
    stride = -(-kt // 8) * 8
    row = kc if (kc // 16) % 2 else kc + 16
    return ((a if rot_pad <= 128 else 2 * a) + 2 * b + 2 * 128 * 8
            + 2 * 128 * stride * 4 + 2 * 128 * 4 + 2 * 128 * row + 1024)


def recon8_smem_bytes(cap: int, rot_pad: int) -> int:
    """Kernel E's query-major route: the pair's distances and residual, as
    ``recon8_kernel`` lays them out."""
    return 4 * (cap + rot_pad)


def _codes_layout_reason(rot: int, pq_dim: int, pq_bits: int) -> str:
    if pq_bits not in (4, 8):
        return (f"pq_bits={pq_bits}: the code scans read 4- or 8-bit fields "
                f"that never cross a byte")
    if pq_dim < 1 or rot % pq_dim:
        return f"rot_dim={rot} is not a multiple of pq_dim={pq_dim}"
    return ""


def _smem_reason(need: int, what: str) -> str:
    if need > _SMEM_LIMIT:
        return (f"{what} needs {need} B of shared memory (limit "
                f"{_SMEM_LIMIT})")
    return ""


def code_list_scan_reject_reason(rot: int, pq_dim: int, pq_bits: int,
                                 kt: int) -> str:
    """Why the list-major codes pass (:func:`code_list_scan`) cannot take
    this shape ('' when it can).  Any rot that pq_dim divides is taken."""
    reason = _codes_layout_reason(rot, pq_dim, pq_bits)
    if reason:
        return reason
    if not 0 < kt <= KT_LIST_MAX:
        return f"kt={kt} outside 1..{KT_LIST_MAX} (the list-major route)"
    return _smem_reason(code_list_scan_smem_bytes(rot, pq_dim, pq_bits, kt),
                        f"the list-major route at kt {kt} with a {pq_dim}x"
                        f"{1 << pq_bits} codebook")


def codes_fused_query_major_reject_reason(cap: int, rot: int, pq_dim: int,
                                          pq_bits: int, k: int,
                                          kt: int) -> str:
    """Why Kernel C's query-major route cannot take this shape ('' when
    it can)."""
    reason = _codes_layout_reason(rot, pq_dim, pq_bits)
    if reason:
        return reason
    if not 0 < k <= K_MAX:
        return f"k={k} outside 1..{K_MAX}"
    if kt < 1:
        return f"kt={kt} < 1"
    return _smem_reason(codes_fused_smem_bytes(cap, rot, pq_dim, pq_bits),
                        f"list capacity {cap} with a {pq_dim}x{1 << pq_bits} "
                        f"LUT")


def codes_query_major_reject_reason(cap: int, rot: int, pq_dim: int,
                                    pq_bits: int, kt: int) -> str:
    """Why Kernel D's query-major route cannot take this shape ('' when
    it can)."""
    reason = _codes_layout_reason(rot, pq_dim, pq_bits)
    if reason:
        return reason
    if not 0 < kt <= KT_MAX:
        return f"kt={kt} outside 1..{KT_MAX}"
    if not codes_layout(cap, rot, pq_dim, pq_bits)[1]:
        return (f"list capacity {cap} leaves no room in shared memory (limit "
                f"{_SMEM_LIMIT}) for a LUT of {LUT_STEP} subspaces")
    return ""


def _either_route(listed: str, walked: str) -> str:
    """A two-route gate's reason: '' when either route takes the shape,
    else both routes' reasons."""
    if not listed or not walked:
        return ""
    return f"{listed}; query-major route: {walked}"


def codes_fused_reject_reason(cap: int, rot: int, pq_dim: int, pq_bits: int,
                              k: int, kt: int) -> str:
    """Why Kernel C cannot take this shape ('' when it can): the
    list-major route takes ``min(kt, k) <= KT_LIST_MAX``, the query-major
    route what its gate admits."""
    reason = _codes_layout_reason(rot, pq_dim, pq_bits)
    if reason:
        return reason
    if not 0 < k <= K_MAX:       # the merge's bound, which pass 1 lacks
        return f"k={k} outside 1..{K_MAX}"
    return _either_route(
        code_list_scan_reject_reason(rot, pq_dim, pq_bits, min(kt, k)),
        codes_fused_query_major_reject_reason(cap, rot, pq_dim, pq_bits, k,
                                              kt))


def codes_reject_reason(cap: int, rot: int, pq_dim: int, pq_bits: int,
                        kt: int) -> str:
    """Why Kernel D cannot take this shape ('' when it can): the
    list-major route takes ``kt <= KT_LIST_MAX``, the query-major route
    what its gate admits."""
    reason = _codes_layout_reason(rot, pq_dim, pq_bits)
    if reason:
        return reason
    return _either_route(
        code_list_scan_reject_reason(rot, pq_dim, pq_bits, kt),
        codes_query_major_reject_reason(cap, rot, pq_dim, pq_bits, kt))


def _recon8_width_reason(rot_pad: int) -> str:
    if rot_pad < 16 or rot_pad % 16:
        return (f"int8 row width {rot_pad} must be a positive multiple of "
                f"16 (16-byte row loads)")
    return ""


def recon8_list_scan_reject_reason(rot_pad: int, kt: int) -> str:
    """Why Kernel E's list-major pass (:func:`recon8_list_scan`) cannot
    take this shape ('' when it can).  Any capacity is taken."""
    reason = _recon8_width_reason(rot_pad)
    if reason:
        return reason
    if not 0 < kt <= KT_LIST_MAX:
        return f"kt={kt} outside 1..{KT_LIST_MAX} (the list-major route)"
    return _smem_reason(recon8_list_scan_smem_bytes(rot_pad, kt),
                        f"the list-major route at kt {kt} with int8 rows "
                        f"of {rot_pad} B")


def recon8_query_major_reject_reason(cap: int, rot_pad: int, kt: int) -> str:
    """Why Kernel E's query-major route cannot take this shape ('' when it
    can)."""
    reason = _recon8_width_reason(rot_pad)
    if reason:
        return reason
    if not 0 < kt <= KT_MAX:
        return f"kt={kt} outside 1..{KT_MAX}"
    return _smem_reason(recon8_smem_bytes(cap, rot_pad),
                        f"list capacity {cap}")


def recon8_reject_reason(cap: int, rot_pad: int, kt: int) -> str:
    """Why Kernel E cannot take this shape ('' when it can): the
    list-major route takes kt <= ``KT_LIST_MAX`` at any capacity, the
    query-major route what its gate admits."""
    reason = _recon8_width_reason(rot_pad)
    if reason:
        return reason
    return _either_route(recon8_list_scan_reject_reason(rot_pad, kt),
                         recon8_query_major_reject_reason(cap, rot_pad, kt))


# ---------------------------------------------------------------------------
# checks shared by the plain versions and the launches
# ---------------------------------------------------------------------------

def _check_common(what, qrot, centers, probes, list_rsq, list_indices):
    expects(qrot.ndim == 2 and centers.ndim == 2 and probes.ndim == 2
            and list_indices.ndim == 2,
            f"{what}: qrot (nq, rot), centers (L, rot), probes (nq, "
            f"n_probes), list_indices (L, cap) required")
    n_lists, cap = list_indices.shape
    expects(qrot.shape[1] == centers.shape[1]
            and centers.shape[0] == n_lists
            and probes.shape[0] == qrot.shape[0]
            and list_rsq.shape == (n_lists, cap),
            f"{what}: shape mismatch")
    devs = {t.device for t in (qrot, centers, probes, list_rsq,
                               list_indices)}
    expects(len(devs) == 1, f"{what}: tensors on different devices")
    return n_lists, cap


def _check_codes(what, qrot, centers, probes, list_codes, codebooks,
                 list_rsq, list_indices, pq_bits):
    n_lists, cap = _check_common(what, qrot, centers, probes, list_rsq,
                                 list_indices)
    expects(list_codes.ndim == 3 and list_codes.shape[:2] == (n_lists, cap)
            and list_codes.dtype == torch.uint8,
            f"{what}: list_codes (L, cap, W) uint8 required")
    expects(codebooks.ndim == 3 and codebooks.shape[1] == 1 << pq_bits,
            f"{what}: codebooks (pq_dim, 2**pq_bits, pq_len) required")
    pq_dim, _, pq_len = codebooks.shape
    rot = qrot.shape[1]
    expects(pq_dim * pq_len == rot
            and list_codes.shape[2] == -(-pq_dim * pq_bits // 8),
            f"{what}: codebooks / code width do not match rot_dim {rot}")
    expects(list_codes.device == codebooks.device == qrot.device,
            f"{what}: tensors on different devices")
    return cap, rot, pq_dim


def _codes_dot(list_codes, codebooks, pq_bits):
    def dot(subb, pr):
        rows = decode_codes(list_codes[pr], codebooks, pq_bits).float()
        return torch.matmul(rows, subb[..., None])[..., 0]
    return dot


def _check_groups(what, group_list, slot_pairs, qrot):
    expects(slot_pairs.ndim == 2 and slot_pairs.shape[1] == grouped.GROUP
            and group_list.shape == (slot_pairs.shape[0],)
            and group_list.device == slot_pairs.device == qrot.device,
            f"{what}: group_list (n_groups,) and slot_pairs (n_groups, "
            f"{grouped.GROUP}) on the queries' device required")
    return (group_list.to(torch.int32).contiguous(),
            slot_pairs.to(torch.int32).contiguous())


def _launch_args(qrot, centers, probes, list_rsq, list_indices):
    expects(qrot.dtype == centers.dtype == list_rsq.dtype == torch.float32
            and list_indices.dtype == torch.int32,
            "qrot/centers/row norms float32 and list_indices int32 "
            "required")
    return (qrot.contiguous(), centers.contiguous(),
            probes.to(torch.int32).contiguous(), list_rsq.contiguous(),
            list_indices.contiguous())


def _codes_operands(list_codes, codebooks):
    """The packed codes and the bf16 books for a launch, contiguous and
    16-byte aligned (copied where they are not), and the code width W."""
    def aligned(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    codes = aligned(list_codes)
    return codes, aligned(codebooks.to(torch.bfloat16)), codes.shape[2]


def _outputs(shape, device):
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# the list-major pass over the codes (Kernel D; with merge_pairs, Kernel C)
# ---------------------------------------------------------------------------

def code_list_scan_plain(qrot, centers, probes, group_list, slot_pairs,
                         list_codes, codebooks, list_rsq, list_indices,
                         pq_bits: int, kt: int, filter_words=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`code_list_scan`: the list-major
    schedule emulated (``pq_group_scan.grouped_pair_topk``), each group's
    list decoded through :func:`decode_codes`."""
    cap, _, _ = _check_codes("code_list_scan", qrot, centers, probes,
                             list_codes, codebooks, list_rsq, list_indices,
                             pq_bits)
    return grouped_pair_topk(qrot, centers, probes, group_list, slot_pairs,
                             list_rsq, list_indices, min(kt, cap),
                             _codes_dot(list_codes, codebooks, pq_bits),
                             filter_words)


def code_list_scan(qrot, centers, probes, group_list, slot_pairs,
                   list_codes, codebooks, list_rsq, list_indices,
                   pq_bits: int, kt: int, filter_words=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list-major pass over the packed codes: ``(vals, ids)``, each
    (nq, n_probes, kt), every (query, probe) pair's top kt by (distance,
    slot), ``(+inf, −1)`` past its live rows and on a probe outside ``[0,
    n_lists)``; with ``filter_words`` only the rows each pair's query
    admits.  ``group_list`` / ``slot_pairs`` are
    :func:`raft_tpu_torch.neighbors.grouped.build_groups` of ``probes``;
    one block decodes one group's list once for its pairs.  CUDA tensors
    launch ``csrc/pq_code_list_scan.cu`` (kt up to ``KT_LIST_MAX``); CPU
    tensors run :func:`code_list_scan_plain`."""
    if not qrot.is_cuda:
        return code_list_scan_plain(qrot, centers, probes, group_list,
                                    slot_pairs, list_codes, codebooks,
                                    list_rsq, list_indices, pq_bits, kt,
                                    filter_words)
    cap, rot, pq_dim = _check_codes(
        "code_list_scan", qrot, centers, probes, list_codes, codebooks,
        list_rsq, list_indices, pq_bits)
    kt = min(kt, cap)
    reason = code_list_scan_reject_reason(rot, pq_dim, pq_bits, kt)
    expects(not reason, f"code_list_scan: {reason}")
    group_list, slot_pairs = _check_groups("code_list_scan", group_list,
                                           slot_pairs, qrot)
    qrot, centers, probes, list_rsq, list_indices = _launch_args(
        qrot, centers, probes, list_rsq, list_indices)
    codes, books, _ = _codes_operands(list_codes, codebooks)
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device,
                               "code_list_scan")
    vals, ids = _outputs((nq, n_probes, kt), qrot.device)
    status = _cuda.library().raft_ivf_pq_code_list_scan(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        group_list.data_ptr(), slot_pairs.data_ptr(), codes.data_ptr(),
        books.data_ptr(), list_rsq.data_ptr(), list_indices.data_ptr(),
        group_list.shape[0], nq, n_probes, centers.shape[0], cap, rot,
        pq_dim, pq_bits, kt,
        code_list_scan_smem_bytes(rot, pq_dim, pq_bits, kt),
        vals.data_ptr(), ids.data_ptr(), *fargs, _stream(qrot.device))
    _cuda.check(status, "code_list_scan")
    code_list_scan.launches += 1
    return vals, ids


code_list_scan.launches = 0


# ---------------------------------------------------------------------------
# Kernel C: fused codes scan, per-query top k
# ---------------------------------------------------------------------------

def ivf_pq_scan_codes_fused_plain(qrot, centers, probes, list_codes,
                                  codebooks, list_rsq, list_indices,
                                  pq_bits: int, k: int, kt: int,
                                  filter_words=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel C: decode the probed lists, every
    (query, probe, row) distance, each pair's top kt, the query's top k.
    The kernels sum the same exact products in another order."""
    cap, _, _ = _check_codes("ivf_pq_scan_codes_fused", qrot, centers,
                             probes, list_codes, codebooks, list_rsq,
                             list_indices, pq_bits)
    dot = _codes_dot(list_codes, codebooks, pq_bits)
    parts = [query_topk(*pair_topk(*probe_distances(
        q, centers, p, list_indices, list_rsq, dot, f), min(kt, cap)), k)
        for q, p, f in plain_chunks(qrot, probes, filter_words)]
    return cat_parts(parts, (k,), qrot.device)


def codes_fused_query_major(qrot, centers, probes, list_codes, codebooks,
                            list_rsq, list_indices, pq_bits: int, k: int,
                            kt: int, filter_words=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's query-major route (``csrc/pq_code_scan.cu``
    ``codes_fused_kernel``): one block per query walks its probes with the
    query's top k in shared memory (with ``filter_words``, over the rows
    it admits); :func:`ivf_pq_scan_codes_fused` takes it where ``min(kt,
    k)`` exceeds ``KT_LIST_MAX`` or the list-major gate refuses the shape.
    CUDA tensors launch it; CPU tensors run the plain version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_codes_fused_plain(
            qrot, centers, probes, list_codes, codebooks, list_rsq,
            list_indices, pq_bits, k, kt, filter_words)
    cap, rot, pq_dim = _check_codes(
        "codes_fused_query_major", qrot, centers, probes, list_codes,
        codebooks, list_rsq, list_indices, pq_bits)
    kt = min(kt, cap)
    reason = codes_fused_query_major_reject_reason(cap, rot, pq_dim,
                                                   pq_bits, k, kt)
    expects(not reason, f"codes_fused_query_major: {reason}")
    qrot, centers, probes, list_rsq, list_indices = _launch_args(
        qrot, centers, probes, list_rsq, list_indices)
    codes, books, W = _codes_operands(list_codes, codebooks)
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device,
                               "codes_fused_query_major")
    vals, ids = _outputs((nq, k), qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_codes_fused(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        codes.data_ptr(), books.data_ptr(), list_rsq.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, centers.shape[0], cap, rot,
        pq_dim, pq_bits, W, int(W % 16 == 0), k, kt,
        codes_fused_smem_bytes(cap, rot, pq_dim, pq_bits), vals.data_ptr(),
        ids.data_ptr(), *fargs, _stream(qrot.device))
    _cuda.check(status, "codes_fused_query_major")
    codes_fused_query_major.launches += 1
    return vals, ids


codes_fused_query_major.launches = 0


def ivf_pq_scan_codes_fused(qrot, centers, probes, list_codes, codebooks,
                            list_rsq, list_indices, pq_bits: int, k: int,
                            kt: int, filter_words=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals (nq, k) f32, ids (nq, k) i32)``: each query's top k over its
    probed lists, scanned from the packed codes.  CUDA tensors run Kernel
    C: at ``min(kt, k) <= KT_LIST_MAX`` the list-major route — the pairs
    grouped by list, :func:`code_list_scan` and ``merge_pairs``, in query
    chunks within ``PAIR_BUFFER_BYTES`` — else
    :func:`codes_fused_query_major` (a dispatch by shape between two
    kernels, each counted on its own ``launches``).  CPU tensors run the
    plain version.  A shape neither route can hold raises with its
    reason; with ``filter_words``, each query's top k over the rows it
    admits, on either route."""
    cap, rot, pq_dim = _check_codes(
        "ivf_pq_scan_codes_fused", qrot, centers, probes, list_codes,
        codebooks, list_rsq, list_indices, pq_bits)
    pair_kt = min(kt, cap, k)
    if not qrot.is_cuda:
        return ivf_pq_scan_codes_fused_plain(
            qrot, centers, probes, list_codes, codebooks, list_rsq,
            list_indices, pq_bits, k, kt, filter_words)
    kt = min(kt, cap)
    reason = codes_fused_reject_reason(cap, rot, pq_dim, pq_bits, k, kt)
    expects(not reason, f"ivf_pq_scan_codes_fused: {reason}")
    if code_list_scan_reject_reason(rot, pq_dim, pq_bits, pair_kt):
        return codes_fused_query_major(qrot, centers, probes, list_codes,
                                       codebooks, list_rsq, list_indices,
                                       pq_bits, k, kt, filter_words)
    return list_major_topk(
        probes, centers.shape[0], pair_kt, k,
        lambda rows, p, gl, sp: code_list_scan(
            qrot[rows], centers, p, gl, sp, list_codes, codebooks, list_rsq,
            list_indices, pq_bits, pair_kt,
            None if filter_words is None else filter_words[rows]))


# ---------------------------------------------------------------------------
# Kernel D: codes scan, per-pair top kt
# ---------------------------------------------------------------------------

def ivf_pq_scan_codes_plain(qrot, centers, probes, list_codes, codebooks,
                            list_rsq, list_indices, pq_bits: int, kt: int,
                            filter_words=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel D: decode the probed lists, every
    (query, probe, row) distance, each pair's top kt."""
    cap, _, _ = _check_codes("ivf_pq_scan_codes", qrot, centers, probes,
                             list_codes, codebooks, list_rsq, list_indices,
                             pq_bits)
    kt = min(kt, cap)
    dot = _codes_dot(list_codes, codebooks, pq_bits)
    parts = [pair_topk(*probe_distances(q, centers, p, list_indices,
                                        list_rsq, dot, f), kt)
             for q, p, f in plain_chunks(qrot, probes, filter_words)]
    return cat_parts(parts, (probes.shape[1], kt), qrot.device)


def codes_scan_query_major(qrot, centers, probes, list_codes, codebooks,
                           list_rsq, list_indices, pq_bits: int, kt: int,
                           filter_words=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's query-major route (``csrc/pq_code_scan.cu``
    ``codes_pair_kernel``): one block per query walks its probes (with
    ``filter_words``, over the rows it admits); :func:`ivf_pq_scan_codes`
    takes it where kt exceeds ``KT_LIST_MAX`` or the list-major gate
    refuses the shape.  CUDA tensors launch it; CPU tensors run the plain
    version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_codes_plain(qrot, centers, probes, list_codes,
                                       codebooks, list_rsq, list_indices,
                                       pq_bits, kt, filter_words)
    cap, rot, pq_dim = _check_codes(
        "codes_scan_query_major", qrot, centers, probes, list_codes,
        codebooks, list_rsq, list_indices, pq_bits)
    kt = min(kt, cap)
    reason = codes_query_major_reject_reason(cap, rot, pq_dim, pq_bits, kt)
    expects(not reason, f"codes_scan_query_major: {reason}")
    qrot, centers, probes, list_rsq, list_indices = _launch_args(
        qrot, centers, probes, list_rsq, list_indices)
    codes, books, W = _codes_operands(list_codes, codebooks)
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device,
                               "codes_scan_query_major")
    vals, ids = _outputs((nq, n_probes, kt), qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_codes(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        codes.data_ptr(), books.data_ptr(), list_rsq.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, centers.shape[0], cap, rot,
        pq_dim, pq_bits, W, int(W % 16 == 0), kt,
        *codes_layout(cap, rot, pq_dim, pq_bits), vals.data_ptr(),
        ids.data_ptr(), *fargs, _stream(qrot.device))
    _cuda.check(status, "codes_scan_query_major")
    codes_scan_query_major.launches += 1
    return vals, ids


codes_scan_query_major.launches = 0


def ivf_pq_scan_codes(qrot, centers, probes, list_codes, codebooks,
                      list_rsq, list_indices, pq_bits: int, kt: int,
                      filter_words=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt, scanned from the packed codes.  CUDA tensors run Kernel
    D: at kt <= ``KT_LIST_MAX`` the pairs grouped by list and
    :func:`code_list_scan`, else :func:`codes_scan_query_major` (a
    dispatch by shape between two kernels, each counted on its own
    ``launches``).  CPU tensors run the plain version.  A shape neither
    route can hold raises with its reason; ``filter_words`` as in
    :func:`ivf_pq_scan_codes_fused`."""
    cap, rot, pq_dim = _check_codes(
        "ivf_pq_scan_codes", qrot, centers, probes, list_codes, codebooks,
        list_rsq, list_indices, pq_bits)
    kt = min(kt, cap)
    if not qrot.is_cuda:
        return ivf_pq_scan_codes_plain(qrot, centers, probes, list_codes,
                                       codebooks, list_rsq, list_indices,
                                       pq_bits, kt, filter_words)
    reason = codes_reject_reason(cap, rot, pq_dim, pq_bits, kt)
    expects(not reason, f"ivf_pq_scan_codes: {reason}")
    if code_list_scan_reject_reason(rot, pq_dim, pq_bits, kt):
        return codes_scan_query_major(qrot, centers, probes, list_codes,
                                      codebooks, list_rsq, list_indices,
                                      pq_bits, kt, filter_words)
    return code_list_scan(qrot, centers, probes,
                          *grouped.build_groups(probes, centers.shape[0]),
                          list_codes, codebooks, list_rsq, list_indices,
                          pq_bits, kt, filter_words)


# ---------------------------------------------------------------------------
# Kernel E: int8 recon scan, per-pair top kt
# ---------------------------------------------------------------------------

def _check_recon8(what, qrot, centers, probes, recon_i8, scales, rsq8,
                  list_indices):
    n_lists, cap = _check_common(what, qrot, centers, probes, rsq8,
                                 list_indices)
    expects(recon_i8.ndim == 3 and recon_i8.shape[:2] == (n_lists, cap)
            and recon_i8.dtype == torch.int8
            and recon_i8.shape[2] >= qrot.shape[1],
            f"{what}: recon_i8 (L, cap, rot_pad >= rot) int8 required")
    expects(scales.shape == (n_lists,), f"{what}: scales (L,) required")
    expects(recon_i8.device == scales.device == qrot.device,
            f"{what}: tensors on different devices")
    return cap, recon_i8.shape[2]


def recon8_plain_args(qrot, centers, recon_i8, scales):
    """The plain versions' (and the wide recon8 composition's) queries and
    centers zero-padded to the cache's row width, and their ``dot``: the fp32 dot of the int8 rows with
    ``bf16(sub)``, scaled by the list's scale after it is summed."""
    pad = recon_i8.shape[2] - qrot.shape[1]

    def dot(subb, pr):
        ip = torch.matmul(recon_i8[pr].float(), subb[..., None])[..., 0]
        return scales[pr][..., None] * ip

    return (torch.nn.functional.pad(qrot.float(), (0, pad)),
            torch.nn.functional.pad(centers.float(), (0, pad)), dot)


def _recon8_operands(recon_i8, scales, what):
    data = recon_i8.contiguous()
    expects(data.data_ptr() % 16 == 0,
            f"{what}: recon_i8 must be 16-byte aligned")
    return data, scales.float().contiguous()


def ivf_pq_scan_recon8_plain(qrot, centers, probes, recon_i8, scales, rsq8,
                             list_indices, kt: int, filter_words=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel E: queries and centers zero-padded
    to the cache's row width, every (query, probe, row) distance with the
    dot scaled after it is summed, each pair's top kt."""
    cap, _ = _check_recon8("ivf_pq_scan_recon8", qrot, centers, probes,
                           recon_i8, scales, rsq8, list_indices)
    qrot, centers, dot = recon8_plain_args(qrot, centers, recon_i8, scales)
    kt = min(kt, cap)
    parts = [pair_topk(*probe_distances(q, centers, p, list_indices, rsq8,
                                        dot, f), kt)
             for q, p, f in plain_chunks(qrot, probes, filter_words)]
    return cat_parts(parts, (probes.shape[1], kt), qrot.device)


def recon8_list_scan_plain(qrot, centers, probes, group_list, slot_pairs,
                           recon_i8, scales, rsq8, list_indices, kt: int,
                           filter_words=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`recon8_list_scan`: the list-major
    schedule emulated (``pq_group_scan.grouped_pair_topk``) with the plain
    version's padded queries and scaled int8 dot."""
    cap, _ = _check_recon8("recon8_list_scan", qrot, centers, probes,
                           recon_i8, scales, rsq8, list_indices)
    qrot, centers, dot = recon8_plain_args(qrot, centers, recon_i8, scales)
    return grouped_pair_topk(qrot, centers, probes, group_list, slot_pairs,
                             rsq8, list_indices, min(kt, cap), dot,
                             filter_words)


def recon8_list_scan(qrot, centers, probes, group_list, slot_pairs,
                     recon_i8, scales, rsq8, list_indices, kt: int,
                     filter_words=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's list-major pass: ``(vals, ids)``, each (nq, n_probes,
    kt), every (query, probe) pair's top kt by (distance, slot) over the
    int8 cache ``recon_i8`` (L, cap, rot_pad) with per-list ``scales`` and
    dequantized row norms ``rsq8``, ``(+inf, −1)`` past its live rows and
    on a probe outside ``[0, n_lists)``; with ``filter_words`` only the
    rows each pair's query admits.  ``group_list`` / ``slot_pairs``
    are :func:`raft_tpu_torch.neighbors.grouped.build_groups` of
    ``probes``; one block reads one group's list once for its pairs,
    converting its int8 rows to bf16 in shared memory.  CUDA tensors
    launch ``csrc/pq_code_list_scan.cu``'s int8 row source (kt up to
    ``KT_LIST_MAX``); CPU tensors run :func:`recon8_list_scan_plain`."""
    if not qrot.is_cuda:
        return recon8_list_scan_plain(qrot, centers, probes, group_list,
                                      slot_pairs, recon_i8, scales, rsq8,
                                      list_indices, kt, filter_words)
    what = "recon8_list_scan"
    cap, rot_pad = _check_recon8(what, qrot, centers, probes, recon_i8,
                                 scales, rsq8, list_indices)
    kt = min(kt, cap)
    reason = recon8_list_scan_reject_reason(rot_pad, kt)
    expects(not reason, f"{what}: {reason}")
    group_list, slot_pairs = _check_groups(what, group_list, slot_pairs,
                                           qrot)
    qrot, centers, probes, rsq8, list_indices = _launch_args(
        qrot, centers, probes, rsq8, list_indices)
    data, scales = _recon8_operands(recon_i8, scales, what)
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device, what)
    vals, ids = _outputs((nq, n_probes, kt), qrot.device)
    status = _cuda.library().raft_ivf_pq_recon8_list_scan(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        group_list.data_ptr(), slot_pairs.data_ptr(), data.data_ptr(),
        scales.data_ptr(), rsq8.data_ptr(), list_indices.data_ptr(),
        group_list.shape[0], nq, n_probes, centers.shape[0], cap,
        qrot.shape[1], rot_pad, kt, recon8_list_scan_smem_bytes(rot_pad, kt),
        vals.data_ptr(), ids.data_ptr(), *fargs, _stream(qrot.device))
    _cuda.check(status, what)
    recon8_list_scan.launches += 1
    return vals, ids


recon8_list_scan.launches = 0


def recon8_scan_query_major(qrot, centers, probes, recon_i8, scales, rsq8,
                            list_indices, kt: int, filter_words=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's query-major route (``csrc/pq_recon8_scan.cu``): one block
    per query walks its probes, re-reading each list it probes (with
    ``filter_words``, only the rows it admits);
    :func:`ivf_pq_scan_recon8` takes it where kt exceeds ``KT_LIST_MAX``
    or the list-major gate refuses the shape.  CUDA tensors launch it; CPU
    tensors run the plain version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_recon8_plain(qrot, centers, probes, recon_i8,
                                        scales, rsq8, list_indices, kt,
                                        filter_words)
    what = "recon8_scan_query_major"
    cap, rot_pad = _check_recon8(what, qrot, centers, probes, recon_i8,
                                 scales, rsq8, list_indices)
    kt = min(kt, cap)
    reason = recon8_query_major_reject_reason(cap, rot_pad, kt)
    expects(not reason, f"{what}: {reason}")
    qrot, centers, probes, rsq8, list_indices = _launch_args(
        qrot, centers, probes, rsq8, list_indices)
    data, scales = _recon8_operands(recon_i8, scales, what)
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device, what)
    vals, ids = _outputs((nq, n_probes, kt), qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_recon8(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        data.data_ptr(), scales.data_ptr(), rsq8.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, centers.shape[0], cap,
        qrot.shape[1], rot_pad, kt, recon8_smem_bytes(cap, rot_pad),
        vals.data_ptr(), ids.data_ptr(), *fargs, _stream(qrot.device))
    _cuda.check(status, what)
    recon8_scan_query_major.launches += 1
    return vals, ids


recon8_scan_query_major.launches = 0


def ivf_pq_scan_recon8(qrot, centers, probes, recon_i8, scales, rsq8,
                       list_indices, kt: int, filter_words=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt over the int8 cache ``recon_i8`` (L, cap, rot_pad) with
    per-list ``scales`` (L,) and dequantized row norms ``rsq8`` (L, cap).
    CUDA tensors run Kernel E: at kt <= ``KT_LIST_MAX`` the pairs grouped
    by list and :func:`recon8_list_scan`, else
    :func:`recon8_scan_query_major` (a dispatch by shape between two
    kernels, each counted on its own ``launches``).  CPU tensors run the
    plain version.  A shape neither route can hold raises with its
    reason; ``filter_words`` as in :func:`ivf_pq_scan_codes_fused`."""
    cap, rot_pad = _check_recon8("ivf_pq_scan_recon8", qrot, centers,
                                 probes, recon_i8, scales, rsq8,
                                 list_indices)
    kt = min(kt, cap)
    if not qrot.is_cuda:
        return ivf_pq_scan_recon8_plain(qrot, centers, probes, recon_i8,
                                        scales, rsq8, list_indices, kt,
                                        filter_words)
    reason = recon8_reject_reason(cap, rot_pad, kt)
    expects(not reason, f"ivf_pq_scan_recon8: {reason}")
    if recon8_list_scan_reject_reason(rot_pad, kt):
        return recon8_scan_query_major(qrot, centers, probes, recon_i8,
                                       scales, rsq8, list_indices, kt,
                                       filter_words)
    return recon8_list_scan(qrot, centers, probes,
                            *grouped.build_groups(probes, centers.shape[0]),
                            recon_i8, scales, rsq8, list_indices, kt,
                            filter_words)

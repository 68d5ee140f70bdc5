"""Kernels C, D and E: IVF-PQ scans over the compact codes and over the
int8 reconstruction cache.

They replace the three kernels of ``raft_tpu/ops/pq_code_scan_pallas.py``:

- Kernel C, :func:`ivf_pq_scan_codes_fused`: ``:282
  grouped_code_scan_fused``, each query's top k kept in the kernel;
- Kernel D, :func:`ivf_pq_scan_codes`: ``:367 grouped_code_scan``, each
  (query, probe) pair's top kt;
- Kernel E, :func:`ivf_pq_scan_recon8`: ``:441 grouped_recon8_scan``, each
  pair's top kt over the int8 cache.

The CUDA kernels are ``csrc/pq_code_scan.cu`` (C, D) and
``csrc/pq_recon8_scan.cu`` (E); their source notes say what bounds them on
an H100 (bytes) and what the query-major designs do about it.  C and D
read ``list_codes`` (n_lists, cap, W) uint8 as the index holds it: the
TPU's lane-major (n_lists, Wi, cap) int32 words, its one-hot decode and
its pair groups do not come over.

Each wrapper launches its kernel for CUDA tensors and runs its ``_plain``
version for CPU tensors — nothing else picks between them, and a failed
build or launch raises.  ``<wrapper>.launches`` counts kernel launches;
``*_reject_reason`` says why a kernel cannot take a shape ('' when it can).

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
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops.pq_group_scan import (K_MAX, _SMEM_LIMIT,
                                              _next_pow2, cat_parts,
                                              pair_topk, plain_chunks,
                                              probe_distances, query_topk)

KT_MAX = 128                     # per-pair kt, as the JAX package's _KT_MAX
_MAX_ROT_PAD8 = 1024             # 32 lanes * kMaxChunksPerLane * 16


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


def codes_fused_smem_bytes(cap: int, rot: int, pq_dim: int,
                           pq_bits: int) -> int:
    """Kernel C: top-k, the next_pow2(cap) candidate buffer, LUT, residual
    and bf16 books, as ``codes_fused_kernel`` lays them out."""
    return (4 * (4 * K_MAX + 3 * _next_pow2(cap) + (pq_dim << pq_bits)
                 + rot) + _books_bytes(rot, pq_bits))


def codes_smem_bytes(cap: int, rot: int, pq_dim: int, pq_bits: int) -> int:
    """Kernel D: the pair's distances, LUT, residual and bf16 books, as
    ``codes_pair_kernel`` lays them out."""
    return (4 * (cap + (pq_dim << pq_bits) + rot)
            + _books_bytes(rot, pq_bits))


def recon8_smem_bytes(cap: int, rot_pad: int) -> int:
    """Kernel E: the pair's distances and residual, as ``recon8_kernel``
    lays them out."""
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


def codes_fused_reject_reason(cap: int, rot: int, pq_dim: int, pq_bits: int,
                              k: int, kt: int) -> str:
    """Why Kernel C cannot take this shape ('' when it can)."""
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


def codes_reject_reason(cap: int, rot: int, pq_dim: int, pq_bits: int,
                        kt: int) -> str:
    """Why Kernel D cannot take this shape ('' when it can)."""
    reason = _codes_layout_reason(rot, pq_dim, pq_bits)
    if reason:
        return reason
    if not 0 < kt <= KT_MAX:
        return f"kt={kt} outside 1..{KT_MAX}"
    return _smem_reason(codes_smem_bytes(cap, rot, pq_dim, pq_bits),
                        f"list capacity {cap} with a {pq_dim}x{1 << pq_bits} "
                        f"LUT")


def recon8_reject_reason(cap: int, rot_pad: int, kt: int) -> str:
    """Why Kernel E cannot take this shape ('' when it can)."""
    if rot_pad % 16 or rot_pad > _MAX_ROT_PAD8:
        return (f"int8 row width {rot_pad} must be a multiple of 16 and at "
                f"most {_MAX_ROT_PAD8} (16-byte row loads)")
    if not 0 < kt <= KT_MAX:
        return f"kt={kt} outside 1..{KT_MAX}"
    return _smem_reason(recon8_smem_bytes(cap, rot_pad),
                        f"list capacity {cap}")


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


def _launch_args(qrot, centers, probes, list_rsq, list_indices):
    expects(qrot.dtype == centers.dtype == list_rsq.dtype == torch.float32
            and list_indices.dtype == torch.int32,
            "qrot/centers/row norms float32 and list_indices int32 "
            "required")
    return (qrot.contiguous(), centers.contiguous(),
            probes.to(torch.int32).contiguous(), list_rsq.contiguous(),
            list_indices.contiguous())


def _outputs(shape, device):
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Kernel C: fused codes scan, per-query top k
# ---------------------------------------------------------------------------

def ivf_pq_scan_codes_fused_plain(qrot, centers, probes, list_codes,
                                  codebooks, list_rsq, list_indices,
                                  pq_bits: int, k: int, kt: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel C: decode the probed lists, every
    (query, probe, row) distance, each pair's top kt, the query's top k.
    The kernel sums the same exact products through its LUT, in another
    order."""
    cap, _, _ = _check_codes("ivf_pq_scan_codes_fused", qrot, centers,
                             probes, list_codes, codebooks, list_rsq,
                             list_indices, pq_bits)
    dot = _codes_dot(list_codes, codebooks, pq_bits)
    parts = [query_topk(*pair_topk(*probe_distances(
        q, centers, p, list_indices, list_rsq, dot), min(kt, cap)), k)
        for q, p in plain_chunks(qrot, probes)]
    return cat_parts(parts, (k,), qrot.device)


def ivf_pq_scan_codes_fused(qrot, centers, probes, list_codes, codebooks,
                            list_rsq, list_indices, pq_bits: int, k: int,
                            kt: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals (nq, k) f32, ids (nq, k) i32)``: each query's top k over its
    probed lists, scanned from the packed codes.  CUDA tensors launch
    Kernel C; CPU tensors run the plain version.  A shape the kernel
    cannot hold raises with its reason."""
    if not qrot.is_cuda:
        return ivf_pq_scan_codes_fused_plain(
            qrot, centers, probes, list_codes, codebooks, list_rsq,
            list_indices, pq_bits, k, kt)
    cap, rot, pq_dim = _check_codes(
        "ivf_pq_scan_codes_fused", qrot, centers, probes, list_codes,
        codebooks, list_rsq, list_indices, pq_bits)
    kt = min(kt, cap)
    reason = codes_fused_reject_reason(cap, rot, pq_dim, pq_bits, k, kt)
    expects(not reason, f"ivf_pq_scan_codes_fused: {reason}")
    qrot, centers, probes, list_rsq, list_indices = _launch_args(
        qrot, centers, probes, list_rsq, list_indices)
    codes = list_codes.contiguous()
    books = codebooks.to(torch.bfloat16).contiguous()
    W = codes.shape[2]
    vec16 = int(W % 16 == 0 and codes.data_ptr() % 16 == 0)
    nq, n_probes = probes.shape
    vals, ids = _outputs((nq, k), qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_codes_fused(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        codes.data_ptr(), books.data_ptr(), list_rsq.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, centers.shape[0], cap, rot,
        pq_dim, pq_bits, W, vec16, k, kt,
        codes_fused_smem_bytes(cap, rot, pq_dim, pq_bits), vals.data_ptr(),
        ids.data_ptr(), _stream(qrot.device))
    _cuda.check(status, "ivf_pq_scan_codes_fused")
    ivf_pq_scan_codes_fused.launches += 1
    return vals, ids


ivf_pq_scan_codes_fused.launches = 0


# ---------------------------------------------------------------------------
# Kernel D: codes scan, per-pair top kt
# ---------------------------------------------------------------------------

def ivf_pq_scan_codes_plain(qrot, centers, probes, list_codes, codebooks,
                            list_rsq, list_indices, pq_bits: int, kt: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel D: decode the probed lists, every
    (query, probe, row) distance, each pair's top kt."""
    cap, _, _ = _check_codes("ivf_pq_scan_codes", qrot, centers, probes,
                             list_codes, codebooks, list_rsq, list_indices,
                             pq_bits)
    kt = min(kt, cap)
    dot = _codes_dot(list_codes, codebooks, pq_bits)
    parts = [pair_topk(*probe_distances(q, centers, p, list_indices,
                                        list_rsq, dot), kt)
             for q, p in plain_chunks(qrot, probes)]
    return cat_parts(parts, (probes.shape[1], kt), qrot.device)


def ivf_pq_scan_codes(qrot, centers, probes, list_codes, codebooks,
                      list_rsq, list_indices, pq_bits: int, kt: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt, scanned from the packed codes.  CUDA tensors launch
    Kernel D; CPU tensors run the plain version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_codes_plain(qrot, centers, probes, list_codes,
                                       codebooks, list_rsq, list_indices,
                                       pq_bits, kt)
    cap, rot, pq_dim = _check_codes(
        "ivf_pq_scan_codes", qrot, centers, probes, list_codes, codebooks,
        list_rsq, list_indices, pq_bits)
    kt = min(kt, cap)
    reason = codes_reject_reason(cap, rot, pq_dim, pq_bits, kt)
    expects(not reason, f"ivf_pq_scan_codes: {reason}")
    qrot, centers, probes, list_rsq, list_indices = _launch_args(
        qrot, centers, probes, list_rsq, list_indices)
    codes = list_codes.contiguous()
    books = codebooks.to(torch.bfloat16).contiguous()
    W = codes.shape[2]
    vec16 = int(W % 16 == 0 and codes.data_ptr() % 16 == 0)
    nq, n_probes = probes.shape
    vals, ids = _outputs((nq, n_probes, kt), qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_codes(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        codes.data_ptr(), books.data_ptr(), list_rsq.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, centers.shape[0], cap, rot,
        pq_dim, pq_bits, W, vec16, kt,
        codes_smem_bytes(cap, rot, pq_dim, pq_bits), vals.data_ptr(),
        ids.data_ptr(), _stream(qrot.device))
    _cuda.check(status, "ivf_pq_scan_codes")
    ivf_pq_scan_codes.launches += 1
    return vals, ids


ivf_pq_scan_codes.launches = 0


# ---------------------------------------------------------------------------
# Kernel E: int8 recon scan, per-pair top kt
# ---------------------------------------------------------------------------

def _check_recon8(qrot, centers, probes, recon_i8, scales, rsq8,
                  list_indices):
    n_lists, cap = _check_common("ivf_pq_scan_recon8", qrot, centers,
                                 probes, rsq8, list_indices)
    expects(recon_i8.ndim == 3 and recon_i8.shape[:2] == (n_lists, cap)
            and recon_i8.dtype == torch.int8
            and recon_i8.shape[2] >= qrot.shape[1],
            "ivf_pq_scan_recon8: recon_i8 (L, cap, rot_pad >= rot) int8 "
            "required")
    expects(scales.shape == (n_lists,),
            "ivf_pq_scan_recon8: scales (L,) required")
    expects(recon_i8.device == scales.device == qrot.device,
            "ivf_pq_scan_recon8: tensors on different devices")
    return cap, recon_i8.shape[2]


def ivf_pq_scan_recon8_plain(qrot, centers, probes, recon_i8, scales, rsq8,
                             list_indices, kt: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel E: queries and centers zero-padded
    to the cache's row width, every (query, probe, row) distance with the
    dot scaled after it is summed, each pair's top kt."""
    cap, rot_pad = _check_recon8(qrot, centers, probes, recon_i8, scales,
                                 rsq8, list_indices)
    pad = rot_pad - qrot.shape[1]
    qrot = torch.nn.functional.pad(qrot.float(), (0, pad))
    centers = torch.nn.functional.pad(centers.float(), (0, pad))
    kt = min(kt, cap)

    def dot(subb, pr):
        ip = torch.matmul(recon_i8[pr].float(), subb[..., None])[..., 0]
        return scales[pr][..., None] * ip

    parts = [pair_topk(*probe_distances(q, centers, p, list_indices, rsq8,
                                        dot), kt)
             for q, p in plain_chunks(qrot, probes)]
    return cat_parts(parts, (probes.shape[1], kt), qrot.device)


def ivf_pq_scan_recon8(qrot, centers, probes, recon_i8, scales, rsq8,
                       list_indices, kt: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt over the int8 cache ``recon_i8`` (L, cap, rot_pad) with
    per-list ``scales`` (L,) and dequantized row norms ``rsq8`` (L, cap).
    CUDA tensors launch Kernel E; CPU tensors run the plain version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_recon8_plain(qrot, centers, probes, recon_i8,
                                        scales, rsq8, list_indices, kt)
    cap, rot_pad = _check_recon8(qrot, centers, probes, recon_i8, scales,
                                 rsq8, list_indices)
    kt = min(kt, cap)
    reason = recon8_reject_reason(cap, rot_pad, kt)
    expects(not reason, f"ivf_pq_scan_recon8: {reason}")
    qrot, centers, probes, rsq8, list_indices = _launch_args(
        qrot, centers, probes, rsq8, list_indices)
    data = recon_i8.contiguous()
    expects(data.data_ptr() % 16 == 0,
            "ivf_pq_scan_recon8: recon_i8 must be 16-byte aligned")
    scales = scales.float().contiguous()
    nq, n_probes = probes.shape
    vals, ids = _outputs((nq, n_probes, kt), qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_recon8(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        data.data_ptr(), scales.data_ptr(), rsq8.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, centers.shape[0], cap,
        qrot.shape[1], rot_pad, kt, recon8_smem_bytes(cap, rot_pad),
        vals.data_ptr(), ids.data_ptr(), _stream(qrot.device))
    _cuda.check(status, "ivf_pq_scan_recon8")
    ivf_pq_scan_recon8.launches += 1
    return vals, ids


ivf_pq_scan_recon8.launches = 0

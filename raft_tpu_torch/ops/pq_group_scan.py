"""Kernel B: the fused IVF-PQ reconstruction-cache scan with in-kernel
per-query top-k.

Replaces ``raft_tpu/ops/pq_group_scan_pallas.py:410 grouped_l2_scan_fused``
(body ``_kernel_fused``).  The CUDA kernel is ``csrc/pq_group_scan.cu``;
its source note says what bounds it on an H100 (bytes) and what the
query-major design does about it.  None of the TPU layout comes over: no
pair groups, no one-hot gathers, no finite worst-distance sentinel, no
merge window — exhausted ranks are ``(+inf, -1)`` straight from the
kernel.

:func:`ivf_pq_scan_fused` launches the kernel for CUDA tensors and runs
:func:`ivf_pq_scan_fused_plain` for CPU tensors — nothing else picks
between them, and a failed build or launch raises.
``ivf_pq_scan_fused.launches`` counts kernel launches.

Contract: ``sub = qrot[q] − centers[list]`` and ``sub_sq = Σ sub²`` in
fp32; ``ip = bf16(sub)·recon`` accumulated in fp32;
``d = max(sub_sq + recon_sq − 2·ip, 0)``.  Rows with a negative id never
enter the result, nor do probes outside ``[0, n_lists)``.  Each (query,
probe) pair contributes at most its own top ``kt`` rows; the output is each
query's top ``k`` ascending, ``(+inf, −1)`` on exhausted ranks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda

K_MAX = 256                      # kMaxK in csrc/pq_group_scan.cu
_MAX_ROT = 1024                  # 32 lanes * kMaxChunksPerLane * 8
_SMEM_LIMIT = 232_448            # an H100 block's dynamic shared memory
# queries per chunk of the plain version's (chunk, n_probes, cap, rot)
# fp32 transient
_PLAIN_CHUNK = 16


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def scan_smem_bytes(cap: int, rot: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source)."""
    return 4 * (4 * K_MAX + 3 * _next_pow2(cap) + rot)


def scan_reject_reason(cap: int, rot: int, k: int, kt: int) -> str:
    """Why the kernel cannot take this shape ('' when it can)."""
    if not 0 < k <= K_MAX:
        return f"k={k} outside 1..{K_MAX}"
    if kt < 1:
        return f"kt={kt} < 1"
    if rot % 8 or rot > _MAX_ROT:
        return (f"rot_dim={rot} must be a multiple of 8 and at most "
                f"{_MAX_ROT} (16-byte bf16 row loads)")
    if scan_smem_bytes(cap, rot) > _SMEM_LIMIT:
        return (f"list capacity {cap} needs {scan_smem_bytes(cap, rot)} B "
                f"of shared memory for its candidate buffer (limit "
                f"{_SMEM_LIMIT})")
    return ""


def _check(qrot, centers, probes, list_recon, list_recon_sq, list_indices):
    expects(qrot.ndim == 2 and centers.ndim == 2 and probes.ndim == 2
            and list_recon.ndim == 3,
            "ivf_pq_scan_fused: qrot (nq, rot), centers (L, rot), probes "
            "(nq, n_probes), list_recon (L, cap, rot) required")
    n_lists, cap, rot = list_recon.shape
    expects(qrot.shape[1] == rot and centers.shape == (n_lists, rot)
            and probes.shape[0] == qrot.shape[0]
            and list_recon_sq.shape == (n_lists, cap)
            and list_indices.shape == (n_lists, cap),
            "ivf_pq_scan_fused: shape mismatch")
    expects(list_recon.dtype == torch.bfloat16,
            "ivf_pq_scan_fused: list_recon must be bfloat16")
    devs = {t.device for t in (qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)}
    expects(len(devs) == 1, "ivf_pq_scan_fused: tensors on different "
            "devices")
    return n_lists, cap, rot


def ivf_pq_scan_fused_plain(qrot, centers, probes, list_recon,
                            list_recon_sq, list_indices, k: int, kt: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: every (query, probe, row) distance, a
    per-probe top-kt, then the query's top-k of the kept candidates.  Same
    arithmetic as the kernel except the order of the fp32 sums."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)
    nq, n_probes = probes.shape
    dev = qrot.device
    kt = min(kt, cap)
    vals = torch.full((nq, k), float("inf"), dtype=torch.float32,
                      device=dev)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for s in range(0, nq, _PLAIN_CHUNK):
        pr = probes[s:s + _PLAIN_CHUNK].long()                 # (c, P)
        ok = (pr >= 0) & (pr < n_lists)       # the kernel skips the rest
        pr = torch.where(ok, pr, torch.zeros_like(pr))
        sub = qrot[s:s + _PLAIN_CHUNK, None, :].float() - centers[pr]
        sub_sq = (sub * sub).sum(-1)                            # (c, P)
        subb = sub.to(torch.bfloat16).float()
        ip = torch.matmul(list_recon[pr].float(),
                          subb[..., None])[..., 0]              # (c, P, cap)
        d = torch.clamp_min(sub_sq[..., None] + list_recon_sq[pr]
                            - 2.0 * ip, 0.0)
        cid = list_indices[pr]
        d = torch.where((cid >= 0) & ok[..., None], d,
                        torch.full_like(d, float("inf")))
        if kt < cap:
            d, pos = torch.topk(d, kt, dim=-1, largest=False, sorted=True)
            cid = torch.gather(cid, -1, pos)
        d = d.reshape(d.shape[0], -1)
        cid = cid.reshape(cid.shape[0], -1)
        kk = min(k, d.shape[1])
        v, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        i = torch.gather(cid, 1, pos)
        vals[s:s + v.shape[0], :kk] = v
        ids[s:s + v.shape[0], :kk] = torch.where(
            torch.isinf(v), torch.full_like(i, -1), i).int()
    return vals, ids


def ivf_pq_scan_fused(qrot, centers, probes, list_recon, list_recon_sq,
                      list_indices, k: int, kt: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals (nq, k) f32, ids (nq, k) i32)``: each query's top-k over its
    probed lists.  CUDA tensors launch Kernel B; CPU tensors run the plain
    version.  A shape the kernel cannot hold raises with its reason."""
    if not qrot.is_cuda:
        return ivf_pq_scan_fused_plain(qrot, centers, probes, list_recon,
                                       list_recon_sq, list_indices, k, kt)
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)
    kt = min(kt, cap)
    reason = scan_reject_reason(cap, rot, k, kt)
    expects(not reason, f"ivf_pq_scan_fused: {reason}")
    expects(qrot.dtype == centers.dtype == list_recon_sq.dtype
            == torch.float32 and list_indices.dtype == torch.int32,
            "ivf_pq_scan_fused: qrot/centers/list_recon_sq float32 and "
            "list_indices int32 required")
    probes = probes.to(torch.int32).contiguous()
    qrot, centers = qrot.contiguous(), centers.contiguous()
    list_recon = list_recon.contiguous()
    list_recon_sq = list_recon_sq.contiguous()
    list_indices = list_indices.contiguous()
    expects(list_recon.data_ptr() % 16 == 0,
            "ivf_pq_scan_fused: list_recon must be 16-byte aligned")
    nq, n_probes = probes.shape
    dev = qrot.device
    vals = torch.empty(nq, k, dtype=torch.float32, device=dev)
    ids = torch.empty(nq, k, dtype=torch.int32, device=dev)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.raft_ivf_pq_scan_fused(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        list_recon.data_ptr(), list_recon_sq.data_ptr(),
        list_indices.data_ptr(), nq, n_probes, n_lists, cap, rot, k, kt,
        vals.data_ptr(), ids.data_ptr(), stream)
    _cuda.check(status, "ivf_pq_scan_fused")
    ivf_pq_scan_fused.launches += 1
    return vals, ids


ivf_pq_scan_fused.launches = 0

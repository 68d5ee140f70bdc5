"""Kernels F and G: per-(query, probe) top-kt scans over full-width rows.

- Kernel F, :func:`ivf_flat_scan`: replaces
  ``raft_tpu/ops/pq_group_scan_pallas.py:637 grouped_flat_l2_scan``, the
  IVF-Flat scan over raw fp32 list rows (exact ``‖q‖² + ‖x‖² − 2q·x`` with
  the dot product in fp32, or the InnerProduct form).
- Kernel G, :func:`ivf_pq_scan_recon`: replaces ``:566 grouped_l2_scan``,
  the IVF-PQ scan over the bf16 reconstruction cache (Kernel B's row
  arithmetic with a per-pair output).

Both are ``csrc/pair_scan.cu``; its source note says what bounds them on an
H100 (bytes) and what the query-major design does about it.  No TPU layout
comes over: no pair groups, no one-hot query gathers, no f32 id lanes.

Each wrapper launches its kernel for CUDA tensors and runs its ``_plain``
version for CPU tensors — nothing else picks between them, and a failed
build or launch raises.  ``<wrapper>.launches`` counts kernel launches;
:func:`pair_scan_reject_reason` says why a kernel cannot take a shape.

Contract (per pair, out ``(nq, n_probes, kt)`` f32 / i32 each): rows with
a negative id never enter, a probe outside ``[0, n_lists)`` is an empty
pair, each pair keeps its top kt by (distance, slot), ties to the lowest
slot, and exhausted slots are ``(+inf, −1)`` — ``(−inf, −1)`` in Kernel
F's InnerProduct form, whose kept values are the largest dot products in
descending order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops.pq_group_scan import (_SMEM_LIMIT, _check, cat_parts,
                                              pair_topk, plain_chunks,
                                              probe_distances)

_MAX_WIDTH = 1024                # 32 lanes * the chunks a lane holds


def pair_scan_smem_bytes(cap: int, width: int) -> int:
    """Dynamic shared memory of one block of Kernel F or G: the pair's
    ``cap`` distances and the staged ``width``-wide query or residual, as
    ``pair_scan_kernel`` lays them out.  The one copy of the formula: the
    gate tests it and the launch passes it."""
    return 4 * (cap + width)


def pair_scan_reject_reason(cap: int, width: int, kt: int,
                            per_chunk: int) -> str:
    """Why Kernel F (``per_chunk`` 4 fp32 values a 16-byte load) or G (8
    bf16 values) cannot take this shape ('' when it can)."""
    if kt < 1:
        return f"kt={kt} < 1"
    if width % per_chunk or width > _MAX_WIDTH:
        return (f"row width {width} must be a multiple of {per_chunk} and "
                f"at most {_MAX_WIDTH} (16-byte row loads)")
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
                        list_indices, kt: int, ip: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel F: every (query, probe, row) value
    (``max(q_sq + d_sq − 2·q·x, 0)``, or ``−q·x`` for InnerProduct), each
    pair's top kt (:func:`pair_topk`), the InnerProduct values negated
    back.  Same arithmetic as the kernel except the order of the fp32
    sums."""
    n_lists, cap, _ = _check_flat(queries, probes, list_data, list_data_sq,
                                  list_indices, ip)
    kt = min(kt, cap)
    qf = queries.float()
    parts = []
    for q, p in plain_chunks(qf, probes):
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
        v, i = pair_topk(d, cid, kt)
        parts.append((-v if ip else v, i))
    return cat_parts(parts, (probes.shape[1], kt), queries.device)


def ivf_flat_scan(queries, probes, list_data, list_data_sq: Optional[
        torch.Tensor], list_indices, kt: int, ip: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt over raw fp32 list rows.  ``list_data_sq`` (L, cap) holds
    the rows' squared norms (unused for InnerProduct).  A super-tiled index
    passes its (L/F, F·cap, dim) view and super-probes.  CUDA tensors
    launch Kernel F; CPU tensors run the plain version."""
    if not queries.is_cuda:
        return ivf_flat_scan_plain(queries, probes, list_data, list_data_sq,
                                   list_indices, kt, ip)
    n_lists, cap, dim = _check_flat(queries, probes, list_data,
                                    list_data_sq, list_indices, ip)
    kt = min(kt, cap)
    reason = pair_scan_reject_reason(cap, dim, kt, 4)
    expects(not reason, f"ivf_flat_scan: {reason}")
    expects(queries.dtype == list_data.dtype == torch.float32
            and list_indices.dtype == torch.int32
            and (ip or list_data_sq.dtype == torch.float32),
            "ivf_flat_scan: queries / list_data / list_data_sq float32 and "
            "list_indices int32 required")
    queries = queries.contiguous()
    probes = probes.to(torch.int32).contiguous()
    data = _aligned(list_data, "ivf_flat_scan: list_data")
    norms = None if ip else list_data_sq.contiguous()
    ids = list_indices.contiguous()
    nq, n_probes = probes.shape
    vals, out_ids = _outputs(nq, n_probes, kt, queries.device)
    status = _cuda.library().raft_ivf_flat_scan(
        queries.data_ptr(), probes.data_ptr(), data.data_ptr(),
        None if norms is None else norms.data_ptr(), ids.data_ptr(), nq,
        n_probes, n_lists, cap, dim, kt, int(ip),
        pair_scan_smem_bytes(cap, dim), vals.data_ptr(), out_ids.data_ptr(),
        torch.cuda.current_stream(queries.device).cuda_stream)
    _cuda.check(status, "ivf_flat_scan")
    ivf_flat_scan.launches += 1
    return (-vals if ip else vals), out_ids


ivf_flat_scan.launches = 0


# ---------------------------------------------------------------------------
# Kernel G: IVF-PQ, bf16 reconstruction rows
# ---------------------------------------------------------------------------

def ivf_pq_scan_recon_plain(qrot, centers, probes, list_recon, list_recon_sq,
                            list_indices, kt: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of Kernel G: Kernel B's distances
    (:func:`probe_distances` over the bf16 rows), each pair's top kt."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices,
                               "ivf_pq_scan_recon")
    kt = min(kt, cap)

    def dot(subb, pr):
        return torch.matmul(list_recon[pr].float(), subb[..., None])[..., 0]

    parts = [pair_topk(*probe_distances(q, centers, p, list_indices,
                                        list_recon_sq, dot), kt)
             for q, p in plain_chunks(qrot, probes)]
    return cat_parts(parts, (probes.shape[1], kt), qrot.device)


def ivf_pq_scan_recon(qrot, centers, probes, list_recon, list_recon_sq,
                      list_indices, kt: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)``, each (nq, n_probes, kt): every (query, probe)
    pair's top kt over the bf16 reconstruction cache.  CUDA tensors launch
    Kernel G; CPU tensors run the plain version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_recon_plain(qrot, centers, probes, list_recon,
                                       list_recon_sq, list_indices, kt)
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices,
                               "ivf_pq_scan_recon")
    kt = min(kt, cap)
    reason = pair_scan_reject_reason(cap, rot, kt, 8)
    expects(not reason, f"ivf_pq_scan_recon: {reason}")
    expects(qrot.dtype == centers.dtype == list_recon_sq.dtype
            == torch.float32 and list_indices.dtype == torch.int32,
            "ivf_pq_scan_recon: qrot/centers/list_recon_sq float32 and "
            "list_indices int32 required")
    recon = _aligned(list_recon, "ivf_pq_scan_recon: list_recon")
    probes = probes.to(torch.int32).contiguous()
    qrot, centers = qrot.contiguous(), centers.contiguous()
    rsq, ids = list_recon_sq.contiguous(), list_indices.contiguous()
    nq, n_probes = probes.shape
    vals, out_ids = _outputs(nq, n_probes, kt, qrot.device)
    status = _cuda.library().raft_ivf_pq_scan_recon(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        recon.data_ptr(), rsq.data_ptr(), ids.data_ptr(), nq, n_probes,
        n_lists, cap, rot, kt, pair_scan_smem_bytes(cap, rot),
        vals.data_ptr(), out_ids.data_ptr(),
        torch.cuda.current_stream(qrot.device).cuda_stream)
    _cuda.check(status, "ivf_pq_scan_recon")
    ivf_pq_scan_recon.launches += 1
    return vals, out_ids


ivf_pq_scan_recon.launches = 0

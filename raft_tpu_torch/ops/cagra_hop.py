"""Kernel I: one CAGRA graph-walk hop — score, dedupe and merge.

Replaces ``raft_tpu/ops/cagra_hop_pallas.py:257 fused_hop`` (bodies
``_kernel_hop`` :129 and ``_kernel_hop_staged`` :167 over ``_hop_scores``
:103).  The CUDA kernel is ``csrc/cagra_hop.cu``; its source note says what
bounds it on an H100 (bytes) and how the query-major design lays the hop
out.  None of the TPU layout comes over: no 128-lane query padding, no
f32 id lanes (ids stay int32, so there is no 2^24 cap), no batch cap of
64 and no VMEM-sized variant choice — one merge serves every shape the
gate admits.

:func:`cagra_hop` launches the kernel for CUDA tensors and runs
:func:`cagra_hop_plain` for CPU tensors — nothing else picks between them,
and a gate miss, a failed build or a failed launch raises.
``cagra_hop.launches`` counts kernel launches.

Contract, per query (inputs in the walk's natural layout):

- ``key[j] = (q_sq + nb_sq[j]) − 2·Σ_d qp[d]·nb_p[j, d]`` (L2) or
  ``−Σ_d qp[d]·nb_p[j, d]`` (InnerProduct), bf16 values multiplied
  exactly and summed in fp32 in dimension order; a candidate with id < 0
  scores ``(+inf, −1)``;
- a candidate whose id is already in the buffer, or carried by an earlier
  candidate, is killed (``(+inf, −1)``): the buffer copy keeps its visited
  flag, and among candidates the first copy wins;
- the candidates, sorted by (key, position), merge into the sorted buffer
  through :func:`bitonic_merge`'s compare-exchange network (strict ``>``:
  ties keep their places), and the best ``itopk`` come out — the result
  of ``raft_tpu.neighbors.cagra._merge_candidates``.

The merge helpers (:func:`merge_candidates`, :func:`bitonic_merge`) live
here so the plain version can use them; ``neighbors/cagra`` re-exports
them under the JAX package's private names.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda

ITOPK_MAX = 256                  # buffer width the gate admits
WD_MAX = 256                     # candidates per hop (search_width * degree)
PDIM_MAX = 4096                  # projected width (the build merge: dim)
_SMEM_LIMIT = 48 * 1024          # static-launch shared memory, no opt-in


def hop_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def hop_merge_rows(itopk: int, wd: int) -> int:
    """Height of the merge network: buffer + candidates, padded to a power
    of two (``_bitonic_merge``'s ``size``)."""
    return hop_pow2(itopk + wd)


def hop_smem_bytes(itopk: int, wd: int, pdim: int) -> int:
    """Dynamic shared memory of one block, as ``hop_kernel`` lays it out:
    the query (pdim f32), the scored candidates (wd keys + ids) and the
    merge network (keys, ids, visited flags).  The one copy of the
    formula: the gate tests it and the launch passes it."""
    return 4 * (pdim + 2 * wd + 3 * hop_merge_rows(itopk, wd))


def hop_reject_reason(nq: int, itopk: int, wd: int, pdim: int,
                      merge_window: int = 0) -> str:
    """Why Kernel I cannot take this hop ('' when it can)."""
    if merge_window < 0:
        return f"merge_window={merge_window} < 0"
    if not 0 < nq < 2 ** 31:
        return f"nq={nq} outside 1..2^31-1"
    if not 0 < itopk <= ITOPK_MAX:
        return f"itopk={itopk} outside 1..{ITOPK_MAX}"
    if not 0 < wd <= WD_MAX:
        return f"search_width*degree={wd} outside 1..{WD_MAX}"
    if not 0 < pdim <= PDIM_MAX:
        return f"pdim={pdim} outside 1..{PDIM_MAX}"
    if hop_smem_bytes(itopk, wd, pdim) > _SMEM_LIMIT:
        return (f"shared memory {hop_smem_bytes(itopk, wd, pdim)} B above "
                f"{_SMEM_LIMIT}")
    return ""


def supported_hop(nq: int, itopk: int, wd: int, pdim: int,
                  merge_window: int = 0) -> bool:
    """Static shape gate of Kernel I."""
    return not hop_reject_reason(nq, itopk, wd, pdim, merge_window)


# ---------------------------------------------------------------------------
# plain version (the JAX package's XLA twin, _merge_candidates)
# ---------------------------------------------------------------------------

def bitonic_merge(a_k, a_i, a_v, b_k, b_i, itopk: int):
    """Merge sorted-ascending (a_k, a_i, a_v) with sorted-ascending
    (b_k, b_i, unvisited) and keep the best ``itopk``
    (``raft_tpu/neighbors/cagra.py:1639``): [a | reverse(b padded with
    (+inf, −1))] is bitonic, and log2(size) strict-``>`` compare-exchange
    passes sort it."""
    nq, A = a_k.shape
    B = b_k.shape[1]
    size = hop_pow2(A + B)
    pad = size - A - B
    if pad:
        b_k = torch.cat([b_k, torch.full((nq, pad), float("inf"),
                                         dtype=b_k.dtype, device=b_k.device)],
                        1)
        b_i = torch.cat([b_i, torch.full((nq, pad), -1, dtype=b_i.dtype,
                                         device=b_i.device)], 1)
    k = torch.cat([a_k, b_k.flip(1)], 1)
    i = torch.cat([a_i, b_i.flip(1)], 1)
    v = torch.cat([a_v, torch.zeros(nq, b_k.shape[1], dtype=torch.bool,
                                    device=a_v.device)], 1)
    stride = size // 2
    while stride >= 1:
        shp = (nq, size // (2 * stride), 2, stride)
        ks, is_, vs = k.reshape(shp), i.reshape(shp), v.reshape(shp)
        swap = ks[:, :, 0] > ks[:, :, 1]

        def cx(x):
            return torch.stack(
                [torch.where(swap, x[:, :, 1], x[:, :, 0]),
                 torch.where(swap, x[:, :, 0], x[:, :, 1])], 2
            ).reshape(nq, size)

        k, i, v = cx(ks), cx(is_), cx(vs)
        stride //= 2
    return k[:, :itopk], i[:, :itopk], v[:, :itopk]


def merge_candidates(buf_d, buf_i, visited, cand_d, cand_i, itopk: int):
    """Dedupe candidates against the buffer and themselves, sort them by
    (key, position) and merge (``raft_tpu/neighbors/cagra.py:1614``).
    Keys are ascending-better (d for L2, −score for InnerProduct)."""
    wd = cand_i.shape[1]
    dup_buf = (cand_i[:, :, None] == buf_i[:, None, :]).any(-1)
    earlier = torch.ones(wd, wd, dtype=torch.bool,
                         device=cand_i.device).tril(-1)
    dup_self = ((cand_i[:, :, None] == cand_i[:, None, :])
                & earlier[None]).any(-1)
    keep = (cand_i >= 0) & ~dup_buf & ~dup_self
    cand_d = torch.where(keep, cand_d, torch.full_like(cand_d, float("inf")))
    cand_i = torch.where(keep, cand_i, torch.full_like(cand_i, -1))
    sk, order = torch.sort(cand_d, dim=1, stable=True)
    si = torch.gather(cand_i, 1, order)
    return bitonic_merge(buf_d, buf_i, visited, sk, si, itopk)


def hop_keys(qp_t, q_sq, nb_p, nb_sq, nb_id, ip_metric: bool):
    """Candidate keys and ids of one hop, (nq, wd) each: bf16 values
    multiplied exactly in fp32 and summed in dimension order (the kernel's
    order, so the two agree bit for bit); id < 0 scores (+inf, −1)."""
    q = qp_t.to(torch.bfloat16).float()
    nb = nb_p.to(torch.bfloat16).float()
    acc = torch.zeros(nb.shape[:2], dtype=torch.float32, device=nb.device)
    for d in range(nb.shape[2]):
        acc = acc + q[:, None, d] * nb[:, :, d]
    if ip_metric:
        key = -acc
    else:
        key = (q_sq.float()[:, None] + nb_sq.float()) - 2.0 * acc
    ok = nb_id >= 0
    return (torch.where(ok, key, torch.full_like(key, float("inf"))),
            torch.where(ok, nb_id.int(), torch.full_like(nb_id, -1).int()))


def cagra_hop_plain(qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited,
                    *, ip_metric: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: :func:`hop_keys`, then
    :func:`merge_candidates`."""
    _check(qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited)
    key, ids = hop_keys(qp_t, q_sq, nb_p, nb_sq, nb_id, ip_metric)
    return merge_candidates(buf_d.float(), buf_i.int(), visited.bool(), key,
                            ids, buf_d.shape[1])


def _check(qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited):
    expects(nb_p.ndim == 3 and qp_t.ndim == 2 and buf_d.ndim == 2,
            "cagra_hop: qp_t (nq, pdim), nb_p (nq, wd, pdim), buffers "
            "(nq, itopk) required")
    nq, wd, pdim = nb_p.shape
    itopk = buf_d.shape[1]
    expects(qp_t.shape == (nq, pdim) and q_sq.shape == (nq,)
            and nb_sq.shape == (nq, wd) and nb_id.shape == (nq, wd)
            and buf_d.shape == (nq, itopk) and buf_i.shape == (nq, itopk)
            and visited.shape == (nq, itopk), "cagra_hop: shape mismatch")
    devs = {t.device for t in (qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i,
                               visited)}
    expects(len(devs) == 1, "cagra_hop: tensors on different devices")
    return nq, wd, pdim, itopk


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def cagra_hop(qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited, *,
              ip_metric: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One walk hop: ``(buf_d f32, buf_i int32, visited bool)``, each
    (nq, itopk), sorted ascending-better and deduplicated.

    Args (nq queries): ``qp_t`` (nq, pdim) bf16 query projections (table
    scale folded in), ``q_sq`` (nq,) f32, ``nb_p`` (nq, wd, pdim) bf16
    decoded neighbors, ``nb_sq`` (nq, wd) f32, ``nb_id`` (nq, wd) int32
    (−1 = masked), and the sorted buffer ``buf_d`` / ``buf_i`` /
    ``visited`` (nq, itopk).  CUDA tensors launch Kernel I; CPU tensors
    run :func:`cagra_hop_plain`."""
    if not nb_p.is_cuda:
        return cagra_hop_plain(qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i,
                               visited, ip_metric=ip_metric)
    nq, wd, pdim, itopk = _check(qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d,
                                 buf_i, visited)
    why = hop_reject_reason(nq, itopk, wd, pdim)
    expects(not why, f"cagra_hop: {why}")
    qp_t = qp_t.to(torch.bfloat16).contiguous()
    nb_p = nb_p.to(torch.bfloat16).contiguous()
    q_sq = q_sq.float().contiguous()
    nb_sq = nb_sq.float().contiguous()
    nb_id = nb_id.int().contiguous()
    buf_d = buf_d.float().contiguous()
    buf_i = buf_i.int().contiguous()
    visited = visited.bool().contiguous()
    out_d = torch.empty_like(buf_d)
    out_i = torch.empty_like(buf_i)
    out_v = torch.empty_like(visited)
    status = _cuda.library().raft_cagra_hop(
        qp_t.data_ptr(), q_sq.data_ptr(), nb_p.data_ptr(), nb_sq.data_ptr(),
        nb_id.data_ptr(), buf_d.data_ptr(), buf_i.data_ptr(),
        visited.data_ptr(), nq, itopk, wd, pdim, int(ip_metric),
        hop_smem_bytes(itopk, wd, pdim), out_d.data_ptr(), out_i.data_ptr(),
        out_v.data_ptr(), torch.cuda.current_stream(nb_p.device).cuda_stream)
    _cuda.check(status, "cagra_hop")
    cagra_hop.launches += 1
    return out_d, out_i, out_v


cagra_hop.launches = 0

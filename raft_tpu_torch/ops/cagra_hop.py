"""Kernel I: one CAGRA graph-walk hop — score, dedupe and merge.

Replaces ``raft_tpu/ops/cagra_hop_pallas.py:257 fused_hop`` (bodies
``_kernel_hop`` :129 and ``_kernel_hop_staged`` :167 over ``_hop_scores``
:103).  The CUDA kernel is ``csrc/cagra_hop.cu``; its source note says what
bounds it on an H100 (bytes) and how the query-major design lays the hop
out.  None of the TPU layout comes over: no 128-lane query padding, no
f32 id lanes (ids stay int32, so there is no 2^24 cap), no batch cap of
64 and no VMEM-sized variant choice — one merge serves every shape the
gate admits, and only shared memory bounds it (``SMEM_MAX``, opted in
past 48 KB): the block's threads (at most 1,024) take every
``blockDim``-th candidate and compare-exchange pair where they are
outnumbered.

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

Walks run on Kernel I's walk route (:mod:`raft_tpu_torch.ops.cagra_walk`,
``csrc/cagra_walk.cu``, the same merge through ``csrc/hop_merge.cuh``);
this hop kernel serves the build's exact merge, whose full-width rows have
no packed table.

The merge helpers (:func:`merge_candidates`, :func:`bitonic_merge`) live
here so the plain version can use them; ``neighbors/cagra`` re-exports
them under the JAX package's private names.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda

SMEM_MAX = 232_448               # an H100 block's opt-in shared memory
# candidates at most this many dedupe by compare, more by a hash table in
# shared memory (csrc/hop_merge.cuh kCompareMaxWd)
COMPARE_MAX_WD = 32


def hop_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def hop_merge_rows(itopk: int, wd: int) -> int:
    """Height of the merge network: buffer + candidates, padded to a power
    of two (``_bitonic_merge``'s ``size``)."""
    return hop_pow2(itopk + wd)


def hash_slots(itopk: int, wd: int) -> int:
    """Slots of the dedupe's hash table: a power of two at least twice the
    ids it takes (the buffer's and the candidates')."""
    return hop_pow2(2 * (itopk + wd))


def hash_bytes(itopk: int, wd: int, base: int, smem_max: int) -> int:
    """The hash table's bytes (8 a slot) where a hop of wd candidates
    dedupes by hash (wd > ``COMPARE_MAX_WD``) and they fit beside ``base``
    bytes within ``smem_max``, else 0: the compare dedupe needs none."""
    nbytes = 8 * hash_slots(itopk, wd)
    return nbytes if wd > COMPARE_MAX_WD and base + nbytes <= smem_max else 0


def hop_smem_bytes(itopk: int, wd: int, pdim: int) -> int:
    """Dynamic shared memory of one block, as ``hop_kernel`` lays it out:
    the dedupe's hash table (where it is used and fits), the merge network
    (8 bytes an entry: key, id and visited flag), the query (pdim f32)
    and the scored candidates (wd keys + ids).  The one copy of the
    formula: the gate tests it and the launch passes it."""
    base = 8 * hop_merge_rows(itopk, wd) + 4 * (pdim + 2 * wd)
    return base + hash_bytes(itopk, wd, base, SMEM_MAX)


def hop_reject_reason(nq: int, itopk: int, wd: int, pdim: int,
                      merge_window: int = 0) -> str:
    """Why Kernel I cannot take this hop ('' when it can)."""
    if merge_window < 0:
        return f"merge_window={merge_window} < 0"
    if not 0 < nq < 2 ** 31:
        return f"nq={nq} outside 1..2^31-1"
    if itopk < 1:
        return f"itopk={itopk} < 1"
    if wd < 1:
        return f"search_width*degree={wd} < 1"
    if pdim < 1:
        return f"pdim={pdim} < 1"
    if hop_smem_bytes(itopk, wd, pdim) > SMEM_MAX:
        return (f"shared memory {hop_smem_bytes(itopk, wd, pdim)} B above "
                f"{SMEM_MAX}")
    return ""


def supported_hop(nq: int, itopk: int, wd: int, pdim: int,
                  merge_window: int = 0) -> bool:
    """Static shape gate of Kernel I."""
    return not hop_reject_reason(nq, itopk, wd, pdim, merge_window)


def hop_resident(itopk: int, wd: int, pdim: int) -> Tuple[int, int]:
    """(threads a block, resident blocks per SM) of a hop launch of this
    shape on the current card (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    the card only."""
    out = (ctypes.c_int * 2)()
    _cuda.check(_cuda.library().raft_cagra_hop_resident(
        itopk, wd, pdim, hop_smem_bytes(itopk, wd, pdim),
        ctypes.addressof(out)), "hop_resident")
    return out[0], out[1]


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

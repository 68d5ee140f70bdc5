"""Kernel B: the fused IVF-PQ reconstruction-cache scan with in-kernel
per-query top-k.

Replaces ``raft_tpu/ops/pq_group_scan_pallas.py:410 grouped_l2_scan_fused``
(body ``_kernel_fused``).  Two routes, chosen by shape:

- **list-major** (``min(kt, k) <= KT_LIST_MAX``): the pairs grouped by
  list (:func:`raft_tpu_torch.neighbors.grouped.build_groups`), then two
  kernels of ``csrc/pq_list_scan.cu`` — :func:`list_scan` (pass 1, each
  pair's top kt on bf16 ``wgmma``, one read of a list per group; alone it
  is Kernel G) and :func:`merge_pairs` (pass 2, each query's top k of its
  pairs, in probe order);
- **query-major** (larger kt, up to ``K_MAX``): :func:`scan_query_major`,
  ``csrc/pq_group_scan.cu``, one block per query walking its probes.

The source notes say what bounds each on an H100 (bytes) and what the
design does about it.  None of the TPU layout comes over: no one-hot
gathers, no finite worst-distance sentinel, no merge window — exhausted
ranks are ``(+inf, -1)`` straight from the kernels.

Each kernel wrapper launches its kernel for CUDA tensors and runs its
plain version for CPU tensors — nothing else picks between them, and a
failed build or launch raises.  ``<wrapper>.launches`` counts each
kernel's launches.

Contract: ``sub = qrot[q] − centers[list]`` and ``sub_sq = Σ sub²`` in
fp32; ``ip = bf16(sub)·recon`` accumulated in fp32;
``d = max(sub_sq + recon_sq − 2·ip, 0)``.  Rows with a negative id never
enter the result, nor do probes outside ``[0, n_lists)``.  Each (query,
probe) pair contributes at most its own top ``kt`` rows; the output is each
query's top ``k`` ascending, ``(+inf, −1)`` on exhausted ranks.

Filters (the TPU kernels' admission operand ``adm_words``): both routes
take ``filter_words`` (nq, n_words) int32, the packed admission words of
:mod:`raft_tpu_torch.filters` (a row's query stride may be 0: one row
broadcast); a row whose id the pair's query rejects never enters the
pair's top kt.  The list-major pass tests the bit in its fold
(``csrc/list_fold.cuh``), the query-major kernel at its candidate gate
(``csrc/pq_group_scan.cu``), both by ``csrc/scan_common.cuh``'s
``admits``; the plain versions give the row +inf before the top kt
(:func:`admit`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.filters.bitset import query_bits, words_on_device
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.ops import _cuda

K_MAX = 256                      # kMaxK in csrc/pq_group_scan.cu
_MAX_ROT = 1024                  # 32 lanes * kMaxChunksPerLane * 8
_SMEM_LIMIT = 232_448            # an H100 block's dynamic shared memory
KT_LIST_MAX = 64                 # kKtMax in csrc/pq_list_scan.cu
# the most bytes Kernel B's (queries, n_probes, kt) pair buffer may take;
# a larger batch goes through the list-major route in query chunks
PAIR_BUFFER_BYTES = 512 << 20
# queries per chunk of the plain version's (chunk, n_probes, cap, rot)
# fp32 transient
_PLAIN_CHUNK = 16


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def scan_smem_bytes(cap: int, rot: int) -> int:
    """Dynamic shared memory of one block of the query-major kernel:
    top-k, the next_pow2(cap) candidate buffer and the residual, as
    ``scan_kernel`` lays them out.  The one copy of the formula: the gate
    tests it and the launch passes it."""
    return 4 * (4 * K_MAX + 3 * _next_pow2(cap) + rot)


def list_scan_smem_bytes(rot: int) -> int:
    """Dynamic shared memory of one block of :func:`list_scan`, as
    ``csrc/pq_list_scan.cu``'s ``scan_layout`` lays it out: the group's
    bf16 residuals (resident up to 128 dims, else two 128-dim stages), two
    stages of 128 list rows (at least the 32 KB distance half each), their
    norms and ids, the top ``KT_LIST_MAX`` of 128 pairs, ``sub_sq``, the pair
    indices, and 1 KB to align the swizzle atoms.  The gate tests it and
    the launch passes it; it mirrors ``scan_layout``, and the entry point
    refuses a size below what ``scan_layout`` needs."""
    def align(b):
        return -(-b // 1024) * 1024

    kp = -(-rot // 16) * 16
    kc = min(kp, 128)
    a = align(-(-kc // 64) * 128 * 128)
    b = align(max(-(-kc // 64) * 128 * 128, 128 * 64 * 4))
    return ((a if kp <= 128 else 2 * a) + 2 * b + 2 * 128 * 8
            + 2 * 128 * KT_LIST_MAX * 4 + 2 * 128 * 4 + 1024)


def list_scan_reject_reason(rot: int, kt: int) -> str:
    """Why the list-major kernel cannot take this shape ('' when it can)."""
    if not 0 < kt <= KT_LIST_MAX:
        return f"kt={kt} outside 1..{KT_LIST_MAX} (the list-major route)"
    if rot % 8:
        return f"rot_dim={rot} must be a multiple of 8 (16-byte bf16 rows)"
    if list_scan_smem_bytes(rot) > _SMEM_LIMIT:
        return (f"the list-major route needs {list_scan_smem_bytes(rot)} B "
                f"of shared memory (limit {_SMEM_LIMIT})")
    return ""


def query_major_reject_reason(cap: int, rot: int, k: int, kt: int) -> str:
    """Why the query-major kernel cannot take this shape ('' when it
    can)."""
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


def scan_reject_reason(cap: int, rot: int, k: int, kt: int) -> str:
    """Why Kernel B cannot take this shape ('' when it can): the
    list-major route takes ``min(kt, k) <= KT_LIST_MAX``, the query-major
    route the rest of what its gate admits."""
    if not 0 < k <= K_MAX:       # the merge's bound, which pass 1 lacks
        return f"k={k} outside 1..{K_MAX}"
    listed = list_scan_reject_reason(rot, min(kt, k))
    if not listed:
        return ""
    walked = query_major_reject_reason(cap, rot, k, kt)
    return walked and f"{listed}; query-major route: {walked}"


def _check(qrot, centers, probes, list_recon, list_recon_sq, list_indices,
           what: str = "ivf_pq_scan_fused"):
    expects(qrot.ndim == 2 and centers.ndim == 2 and probes.ndim == 2
            and list_recon.ndim == 3,
            f"{what}: qrot (nq, rot), centers (L, rot), probes "
            f"(nq, n_probes), list_recon (L, cap, rot) required")
    n_lists, cap, rot = list_recon.shape
    expects(qrot.shape[1] == rot and centers.shape == (n_lists, rot)
            and probes.shape[0] == qrot.shape[0]
            and list_recon_sq.shape == (n_lists, cap)
            and list_indices.shape == (n_lists, cap),
            f"{what}: shape mismatch")
    expects(list_recon.dtype == torch.bfloat16,
            f"{what}: list_recon must be bfloat16")
    devs = {t.device for t in (qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)}
    expects(len(devs) == 1, f"{what}: tensors on different devices")
    return n_lists, cap, rot


def filter_operand(filter_words, nq: int, device, what: str):
    """A filter's kernel operands: ``(words, (pointer, query stride,
    words a row))`` — ``words`` (nq, n_words) int32 on ``device`` with
    contiguous rows (a broadcast row stays one row, query stride 0),
    which the caller keeps alive over the launch — or ``(None, (None, 0,
    0))`` when unfiltered."""
    if filter_words is None:
        return None, (None, 0, 0)
    expects(filter_words.ndim == 2 and filter_words.shape[0] == nq
            and filter_words.shape[1] >= 1,
            f"{what}: filter_words (nq, n_words) required")
    w = words_on_device(filter_words, device)
    return w, (w.data_ptr(), w.stride(0) if w.shape[0] > 1 else 0,
               w.shape[1])


def admit(d, cid, fw):
    """``d`` with +inf where the query of each row of a chunk rejects the
    candidate id ``cid`` (``fw`` the chunk's (chunk, n_words) rows, query
    i for row i; None: ``d`` unchanged).  The plain versions' admission,
    before any top kt, as the JAX package applies ``query_bits``."""
    if fw is None:
        return d
    q = torch.arange(cid.shape[0], device=cid.device).reshape(
        -1, *([1] * (cid.ndim - 2)))
    return torch.where(query_bits(fw, q, cid) > 0, d,
                       torch.full_like(d, float("inf")))


def probe_distances(qrot, centers, probes, list_indices, list_rsq, dot,
                    fw=None):
    """Every (query, probe, slot) distance of a chunk of queries: ``(d,
    ids)``, each (chunk, n_probes, cap).  ``d = max(sub_sq + rsq −
    2·dot(bf16(sub), lists), 0)`` with ``sub = qrot − centers[list]``;
    ``dot(subb (chunk, n_probes, rot) f32, lists (chunk, n_probes))``
    returns the (chunk, n_probes, cap) products of the probed rows.  Rows
    with a negative id, probes outside ``[0, n_lists)`` and, with ``fw``
    (the chunk's filter rows), rows the query rejects are +inf."""
    n_lists = centers.shape[0]
    pr = probes.long()
    ok = (pr >= 0) & (pr < n_lists)       # the kernels skip the rest
    pr = torch.where(ok, pr, torch.zeros_like(pr))
    sub = qrot[:, None, :].float() - centers[pr]
    sub_sq = (sub * sub).sum(-1)                                # (c, P)
    ip = dot(sub.to(torch.bfloat16).float(), pr)                # (c, P, cap)
    d = torch.clamp_min(sub_sq[..., None] + list_rsq[pr] - 2.0 * ip, 0.0)
    cid = list_indices[pr]
    d = torch.where((cid >= 0) & ok[..., None], d,
                    torch.full_like(d, float("inf")))
    return admit(d, cid, fw), cid


def recon_dot(list_recon):
    """:func:`probe_distances`'s ``dot`` over bf16 recon rows: the fp32
    products of the probed rows with ``bf16(sub)``."""
    def dot(subb, pr):
        return torch.matmul(list_recon[pr].float(), subb[..., None])[..., 0]
    return dot


def pair_topk(d, cid, kt: int):
    """Each (query, probe) pair's top kt by (distance, slot) — a stable
    sort, so ties go to the lowest slot — with (+inf, −1) past its live
    rows: (chunk, n_probes, kt) each."""
    d, pos = torch.sort(d, dim=-1, stable=True)
    d, pos = d[..., :kt], pos[..., :kt]
    i = torch.gather(cid, -1, pos)
    return d, torch.where(torch.isinf(d), torch.full_like(i, -1), i).int()


def query_topk(d, cid, k: int):
    """Each query's top k of its (chunk, n_probes, kt) kept candidates,
    ascending, (+inf, −1) on exhausted ranks."""
    d = d.reshape(d.shape[0], -1)
    cid = cid.reshape(cid.shape[0], -1)
    kk = min(k, d.shape[1])
    v, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    i = torch.gather(cid, 1, pos)
    vals = torch.full((d.shape[0], k), float("inf"), dtype=torch.float32,
                      device=d.device)
    ids = torch.full((d.shape[0], k), -1, dtype=torch.int32, device=d.device)
    vals[:, :kk] = v
    ids[:, :kk] = torch.where(torch.isinf(v), torch.full_like(i, -1), i)
    return vals, ids


def plain_chunks(qrot, probes, filter_words=None):
    """The plain versions' query chunks: ``(qrot, probes, filter rows)``
    slices of _PLAIN_CHUNK queries (filter rows None when unfiltered)."""
    for s in range(0, probes.shape[0], _PLAIN_CHUNK):
        f = (None if filter_words is None
             else filter_words[s:s + _PLAIN_CHUNK])
        yield qrot[s:s + _PLAIN_CHUNK], probes[s:s + _PLAIN_CHUNK], f


def cat_parts(parts, tail, device):
    """Concatenate per-chunk ``(vals, ids)`` along the queries; an empty
    batch gives empty (0, *tail) outputs."""
    if not parts:
        return (torch.empty(0, *tail, dtype=torch.float32, device=device),
                torch.empty(0, *tail, dtype=torch.int32, device=device))
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


def ivf_pq_scan_fused_plain(qrot, centers, probes, list_recon,
                            list_recon_sq, list_indices, k: int, kt: int,
                            filter_words=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: every (query, probe, row) distance (+inf
    where ``filter_words`` rejects the row), a per-probe top-kt, then the
    query's top-k of the kept candidates.  Same arithmetic as the kernel
    except the order of the fp32 sums."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)
    kt = min(kt, cap)

    dot = recon_dot(list_recon)
    parts = [query_topk(*pair_topk(*probe_distances(
        q, centers, p, list_indices, list_recon_sq, dot, f), kt), k)
        for q, p, f in plain_chunks(qrot, probes, filter_words)]
    return cat_parts(parts, (k,), qrot.device)


def cuda_operands(qrot, centers, probes, list_recon, list_recon_sq,
                  list_indices, what: str):
    """A recon scan's operands for a kernel launch: dtypes checked,
    contiguous, the recon rows 16-byte aligned, the probes int32."""
    expects(qrot.dtype == centers.dtype == list_recon_sq.dtype
            == torch.float32 and list_indices.dtype == torch.int32,
            f"{what}: qrot/centers/list_recon_sq float32 and list_indices "
            f"int32 required")
    list_recon = list_recon.contiguous()
    expects(list_recon.data_ptr() % 16 == 0,
            f"{what}: list_recon must be 16-byte aligned")
    return (qrot.contiguous(), centers.contiguous(),
            probes.to(torch.int32).contiguous(), list_recon,
            list_recon_sq.contiguous(), list_indices.contiguous())


# ---------------------------------------------------------------------------
# the list-major route: pass 1 (each pair's top kt) and pass 2 (the merge)
# ---------------------------------------------------------------------------

def grouped_pair_topk(qrot, centers, probes, group_list, slot_pairs,
                      list_rsq, list_indices, kt: int, dot,
                      filter_words=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list-major schedule of pass 1, emulated: for each group's live
    slot, its pair's distances to the group's list (:func:`probe_distances`
    with ``dot``, the rows its query rejects +inf) and the pair's top kt
    (:func:`pair_topk`), scattered to the pair's place; a pair no group
    holds (its probe outside ``[0, n_lists)``) stays ``(+inf, −1)``.
    (nq, n_probes, kt) each."""
    nq, n_probes = probes.shape
    P = nq * n_probes
    vals = torch.full((P, kt), float("inf"), dtype=torch.float32,
                      device=qrot.device)
    ids = torch.full((P, kt), -1, dtype=torch.int32, device=qrot.device)
    for lst, slots in zip(group_list.long(), slot_pairs.long()):
        p = slots[slots < P]
        q = p // n_probes
        v, i = pair_topk(*probe_distances(
            qrot[q], centers, lst.expand(p.numel(), 1), list_indices,
            list_rsq, dot, None if filter_words is None
            else filter_words[q]), kt)
        vals[p], ids[p] = v[:, 0], i[:, 0]
    return vals.reshape(nq, n_probes, kt), ids.reshape(nq, n_probes, kt)


def list_scan_plain(qrot, centers, probes, group_list, slot_pairs,
                    list_recon, list_recon_sq, list_indices, kt: int,
                    filter_words=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`list_scan`: the list-major schedule
    emulated over the recon rows (:func:`grouped_pair_topk`)."""
    _, cap, _ = _check(qrot, centers, probes, list_recon, list_recon_sq,
                       list_indices, "list_scan")
    return grouped_pair_topk(qrot, centers, probes, group_list, slot_pairs,
                             list_recon_sq, list_indices, min(kt, cap),
                             recon_dot(list_recon), filter_words)


def list_scan(qrot, centers, probes, group_list, slot_pairs, list_recon,
              list_recon_sq, list_indices, kt: int, filter_words=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the list-major route, and Kernel G's kernel: ``(vals,
    ids)``, each (nq, n_probes, kt), every (query, probe) pair's top kt by
    (distance, slot), ``(+inf, −1)`` past its live rows and on a probe
    outside ``[0, n_lists)``; with ``filter_words`` (nq, n_words) int32
    only the rows each pair's query admits.  ``group_list`` /
    ``slot_pairs`` are :func:`raft_tpu_torch.neighbors.grouped.
    build_groups` of ``probes``; one block scans one group's list once for
    its pairs.  CUDA tensors launch ``csrc/pq_list_scan.cu``'s pass 1 (kt
    up to ``KT_LIST_MAX``); CPU tensors run :func:`list_scan_plain`."""
    if not qrot.is_cuda:
        return list_scan_plain(qrot, centers, probes, group_list,
                               slot_pairs, list_recon, list_recon_sq,
                               list_indices, kt, filter_words)
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices, "list_scan")
    kt = min(kt, cap)
    reason = list_scan_reject_reason(rot, kt)
    expects(not reason, f"list_scan: {reason}")
    expects(slot_pairs.ndim == 2 and slot_pairs.shape[1] == grouped.GROUP
            and group_list.shape == (slot_pairs.shape[0],)
            and group_list.device == slot_pairs.device == qrot.device,
            f"list_scan: group_list (n_groups,) and slot_pairs (n_groups, "
            f"{grouped.GROUP}) on the queries' device required")
    qrot, centers, probes, recon, rsq, ids = cuda_operands(
        qrot, centers, probes, list_recon, list_recon_sq, list_indices,
        "list_scan")
    group_list = group_list.to(torch.int32).contiguous()
    slot_pairs = slot_pairs.to(torch.int32).contiguous()
    nq, n_probes = probes.shape
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, qrot.device, "list_scan")
    vals = torch.empty(nq, n_probes, kt, dtype=torch.float32,
                       device=qrot.device)
    out_ids = torch.empty(nq, n_probes, kt, dtype=torch.int32,
                          device=qrot.device)
    status = _cuda.library().raft_ivf_pq_list_scan(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        group_list.data_ptr(), slot_pairs.data_ptr(), recon.data_ptr(),
        rsq.data_ptr(), ids.data_ptr(), group_list.shape[0], nq, n_probes,
        n_lists, cap, rot, kt, list_scan_smem_bytes(rot),
        vals.data_ptr(), out_ids.data_ptr(), *fargs,
        torch.cuda.current_stream(qrot.device).cuda_stream)
    _cuda.check(status, "list_scan")
    list_scan.launches += 1
    return vals, out_ids


list_scan.launches = 0


def merge_pairs(vals, ids, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of the list-major route: each query's top k of its pairs'
    sorted top kt (``vals`` / ``ids`` (nq, n_probes, kt), as
    :func:`list_scan` gives them), ascending, ties to the earlier probe and
    then to the pair's own rank, ``(+inf, −1)`` on exhausted ranks: (nq, k)
    each.  CUDA tensors launch ``csrc/pq_list_scan.cu``'s pass 2 (kt <= k
    <= ``K_MAX``); CPU tensors run :func:`query_topk`."""
    expects(vals.ndim == 3 and ids.shape == vals.shape,
            "merge_pairs: vals and ids (nq, n_probes, kt) required")
    if not vals.is_cuda:
        return query_topk(vals, ids, k)
    nq, n_probes, kt = vals.shape
    expects(0 < kt <= k <= K_MAX and vals.dtype == torch.float32
            and ids.dtype == torch.int32 and ids.device == vals.device,
            f"merge_pairs: float32 / int32 pair lists with 0 < kt <= k <= "
            f"{K_MAX} required (kt {kt}, k {k})")
    vals, ids = vals.contiguous(), ids.contiguous()
    out_v = torch.empty(nq, k, dtype=torch.float32, device=vals.device)
    out_i = torch.empty(nq, k, dtype=torch.int32, device=vals.device)
    status = _cuda.library().raft_ivf_pq_merge_pairs(
        vals.data_ptr(), ids.data_ptr(), nq, n_probes, kt, k,
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream)
    _cuda.check(status, "merge_pairs")
    merge_pairs.launches += 1
    return out_v, out_i


merge_pairs.launches = 0


def scan_query_major(qrot, centers, probes, list_recon, list_recon_sq,
                     list_indices, k: int, kt: int, filter_words=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's query-major route (``csrc/pq_group_scan.cu``): one block
    per query walks its probes with the query's top k in shared memory
    (with ``filter_words``, over the rows it admits);
    :func:`ivf_pq_scan_fused` takes it where ``min(kt, k)`` exceeds
    ``KT_LIST_MAX``.  CUDA tensors launch it; CPU tensors run the plain
    version."""
    if not qrot.is_cuda:
        return ivf_pq_scan_fused_plain(qrot, centers, probes, list_recon,
                                       list_recon_sq, list_indices, k, kt,
                                       filter_words)
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)
    kt = min(kt, cap)
    reason = query_major_reject_reason(cap, rot, k, kt)
    expects(not reason, f"scan_query_major: {reason}")
    qrot, centers, probes, recon, rsq, ids = cuda_operands(
        qrot, centers, probes, list_recon, list_recon_sq, list_indices,
        "scan_query_major")
    nq, n_probes = probes.shape
    dev = qrot.device
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, dev, "scan_query_major")
    vals = torch.empty(nq, k, dtype=torch.float32, device=dev)
    out_ids = torch.empty(nq, k, dtype=torch.int32, device=dev)
    status = _cuda.library().raft_ivf_pq_scan_fused(
        qrot.data_ptr(), centers.data_ptr(), probes.data_ptr(),
        recon.data_ptr(), rsq.data_ptr(), ids.data_ptr(), nq, n_probes,
        n_lists, cap, rot, k, kt, scan_smem_bytes(cap, rot),
        vals.data_ptr(), out_ids.data_ptr(), *fargs,
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "scan_query_major")
    scan_query_major.launches += 1
    return vals, out_ids


scan_query_major.launches = 0


def ivf_pq_scan_fused(qrot, centers, probes, list_recon, list_recon_sq,
                      list_indices, k: int, kt: int, filter_words=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals (nq, k) f32, ids (nq, k) i32)``: each query's top-k over its
    probed lists (with ``filter_words``, over the rows it admits).  CUDA
    tensors run Kernel B: at ``min(kt, k) <= KT_LIST_MAX`` the list-major
    route — the pairs grouped by list, then :func:`list_scan` and
    :func:`merge_pairs`, in query chunks whose pair buffer stays within
    ``PAIR_BUFFER_BYTES`` — else :func:`scan_query_major` (a dispatch by
    shape between two kernels, each counted on its own ``launches``; both
    take the filter).  CPU tensors run the plain version.  A shape neither
    route can hold raises with its reason."""
    n_lists, cap, rot = _check(qrot, centers, probes, list_recon,
                               list_recon_sq, list_indices)
    pair_kt = min(kt, cap, k)
    if not qrot.is_cuda:
        return ivf_pq_scan_fused_plain(qrot, centers, probes, list_recon,
                                       list_recon_sq, list_indices, k, kt,
                                       filter_words)
    kt = min(kt, cap)
    reason = scan_reject_reason(cap, rot, k, kt)
    expects(not reason, f"ivf_pq_scan_fused: {reason}")
    if list_scan_reject_reason(rot, pair_kt):
        return scan_query_major(qrot, centers, probes, list_recon,
                                list_recon_sq, list_indices, k, kt,
                                filter_words)
    return list_major_topk(
        probes, n_lists, pair_kt, k,
        lambda rows, p, gl, sp: list_scan(
            qrot[rows], centers, p, gl, sp, list_recon, list_recon_sq,
            list_indices, pair_kt,
            None if filter_words is None else filter_words[rows]))


def list_major_topk(probes, n_lists: int, pair_kt: int, k: int, pass1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top k through a list-major route (Kernels B and C):
    per chunk of queries whose (chunk, n_probes, pair_kt) pair buffer stays
    within ``PAIR_BUFFER_BYTES``, the chunk's pairs grouped by list
    (:func:`raft_tpu_torch.neighbors.grouped.build_groups`), ``pass1(rows,
    probes, group_list, slot_pairs)`` — ``rows`` the chunk's slice of the
    queries — for the pairs' top ``pair_kt``, then :func:`merge_pairs`."""
    nq, n_probes = probes.shape
    step = max(1, PAIR_BUFFER_BYTES // max(1, n_probes * pair_kt * 8))
    parts = []
    for s in range(0, nq, step):
        p = probes[s:s + step]
        pair_v, pair_i = pass1(slice(s, s + step), p,
                               *grouped.build_groups(p, n_lists))
        parts.append(merge_pairs(pair_v, pair_i, k))
    return cat_parts(parts, (k,), probes.device)

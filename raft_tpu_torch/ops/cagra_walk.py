"""Kernel I, the walk route: a whole CAGRA graph walk in one launch.

Replaces ``raft_tpu/ops/cagra_hop_pallas.py:257 fused_hop`` together with
the loop around it, ``raft_tpu/neighbors/cagra.py``'s ``_search_impl_walk``
``while_loop`` (1775-1828): the JAX package runs a walk as one device
program, and so does this kernel, ``csrc/cagra_walk.cu`` — one block per
query for the whole walk, the buffer in shared memory across hops, each
hop's parents chosen, fat rows fetched and decoded, candidates scored,
deduplicated and merged inside the kernel.  Its source note says what
bounds it on an H100 and how the hops are laid out.  Kernel I's hop
kernel (:mod:`raft_tpu_torch.ops.cagra_hop`) keeps the build's exact
merge, whose full-width rows have no table.

:func:`cagra_walk` launches the kernel for CUDA tensors and runs
:func:`cagra_walk_plain` for CPU tensors — nothing else picks between
them, and a gate miss, a failed build or a failed launch raises.
``cagra_walk.launches`` counts kernel launches (one per walk).

The exact-row source (:func:`cagra_walk_exact`, ``raft_cagra_walk_exact``:
the same kernel's ``kExact`` instantiation) walks the graph itself, each
candidate scored on its fp32 dataset row — the direct walk of
``raft_tpu/neighbors/cagra.py:1857 _search_impl``, which the JAX package
runs in XLA.  Its plain version :func:`cagra_walk_exact_plain` is that
loop in torch (TF32 off: a sequential dimension loop, each product and
sum rounded, as the kernel does), and ``cagra_walk_exact.launches``
counts its launches.  Both routes refuse a shape only for shared memory
(:func:`walk_reject_reason`, :func:`walk_exact_reject_reason`), and a
refused CUDA call raises.

Contract, per query, from the seeded sorted buffer ``buf_d`` / ``buf_i`` /
``visited`` (nq, itopk), for at most ``max_iterations`` hops, each hop
:func:`select_parents` → :func:`expand` → ``cagra_hop_plain``; the plain
version checks the all-visited exit every ``exit_every`` hops (0: never),
the kernel before every hop of each query.  A fully visited buffer is a
fixed point of the hop, so both give the fixed hop count's result, and
the kernel equals the plain version bit for bit.  With ``filter_words``
(nq, n_words) int32, the packed admission words of
:mod:`raft_tpu_torch.filters` (query stride 0 for one row broadcast), a
hop's candidate whose id the query rejects becomes id −1, as under a
dead parent (:func:`expand`; the kernel where it reads the ids): it is
neither kept nor expanded.

The walk helpers (:func:`select_parents`, :func:`expand`,
:func:`decode_neighborhood`) live here so the plain version can use them;
``neighbors/cagra`` re-exports them under the JAX package's private names.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.filters.bitset import query_bits
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops import cagra_hop as _hop
from raft_tpu_torch.ops.pq_group_scan import filter_operand

EXIT_CHECK_EVERY = 8             # the plain walk's all(visited) check
SMEM_MAX = 232_448               # an H100 block's opt-in shared memory


def quant_unit(pdim: int) -> int:
    """int16 lanes per neighbor in the int8 format: pdim/2 + norm + 2 id."""
    return pdim // 2 + 3


def walk_unit(pdim: int, quant: bool) -> int:
    """int16 lanes per neighbor: pdim bf16 + 2 norm + 2 id, or the int8
    format's :func:`quant_unit`."""
    return quant_unit(pdim) if quant else pdim + 4


def exact_stride(dim: int) -> int:
    """f32 values a staged exact row takes: dim rounded up to 16 bytes, to
    an odd count of 16-byte units (so quarter-warps' 16-byte reads meet
    no bank conflict)."""
    r = -(-dim // 4) * 4
    return r if (r // 4) % 2 else r + 4


def _walk_base_bytes(itopk: int, width: int, deg: int, pdim: int,
                     quant: bool, staged: bool, exact: bool) -> int:
    """A block's bytes without the dedupe's hash table: the staged rows
    (``width`` fat rows of deg·unit lanes, each rounded up to 16 bytes, or
    the exact-row source's wd fp32 rows of :func:`exact_stride`; none
    when ``staged`` is off), the merge network (8 bytes an entry: key, id
    and visited flag), the query (pdim f32), the candidates (keys, ids),
    the parents (ids, live flags) and an exit flag."""
    wd = width * deg
    rows = 0
    if staged and exact:
        rows = wd * exact_stride(pdim) * 4
    elif staged:
        rows = width * (-(-(deg * walk_unit(pdim, quant)) // 8) * 8) * 2
    return (rows + 8 * _hop.hop_merge_rows(itopk, wd)
            + 4 * (pdim + 2 * wd + 2 * width + 1))


def walk_smem_bytes(itopk: int, width: int, deg: int, pdim: int,
                    quant: bool = False, staged: bool = True) -> int:
    """Dynamic shared memory of one block, as ``walk_kernel`` lays it out:
    :func:`_walk_base_bytes` and, where the walk dedupes by hash and it
    fits, the hash table (``cagra_hop.hash_bytes``).  The one copy of the
    formula: the gate tests it and the launch passes it."""
    base = _walk_base_bytes(itopk, width, deg, pdim, quant, staged, False)
    return base + _hop.hash_bytes(itopk, width * deg, base, SMEM_MAX)


def walk_staged(itopk: int, width: int, deg: int, pdim: int,
                quant: bool = False) -> bool:
    """Whether the kernel stages the parents' fat rows in shared memory
    (else it scores straight from the table)."""
    return _walk_base_bytes(itopk, width, deg, pdim, quant, True,
                            False) <= SMEM_MAX


def _shape_reason(nq: int, itopk: int, width: int, deg: int,
                  pdim: int) -> str:
    if not 0 < nq < 2 ** 31:
        return f"nq={nq} outside 1..2^31-1"
    if itopk < 1:
        return f"itopk={itopk} < 1"
    if width < 1:
        return f"search_width={width} < 1"
    if deg < 1:
        return f"degree={deg} < 1"
    if pdim < 1:
        return f"pdim={pdim} < 1"
    return ""


def walk_reject_reason(nq: int, itopk: int, width: int, deg: int, pdim: int,
                       quant: bool = False) -> str:
    """Why the walk kernel cannot take this walk ('' when it can): only
    shared memory (with the fat rows scored from the table where staging
    them does not fit) and, in the int8 format, an odd pdim."""
    why = _shape_reason(nq, itopk, width, deg, pdim)
    if why:
        return why
    if quant and pdim % 2:
        return f"pdim={pdim} odd in the int8 table format"
    need = walk_smem_bytes(itopk, width, deg, pdim, quant,
                           walk_staged(itopk, width, deg, pdim, quant))
    if need > SMEM_MAX:
        return f"shared memory {need} B above {SMEM_MAX}"
    return ""


def supported_walk(nq: int, itopk: int, width: int, deg: int, pdim: int,
                   quant: bool = False) -> bool:
    """Static shape gate of the walk kernel."""
    return not walk_reject_reason(nq, itopk, width, deg, pdim, quant)


def walk_exact_staged(itopk: int, width: int, deg: int, dim: int) -> bool:
    """Whether the exact-row source stages its candidates' fp32 rows in
    shared memory (else each is read from device memory by its
    candidate's thread)."""
    return _walk_base_bytes(itopk, width, deg, dim, False, True,
                            True) <= SMEM_MAX


def walk_exact_smem_bytes(itopk: int, width: int, deg: int, dim: int) -> int:
    """Dynamic shared memory of the exact-row source: the candidates' rows
    where they fit (:func:`walk_exact_staged`), the query's fp32 row, the
    merge network and, where it is used and fits, the hash table."""
    base = _walk_base_bytes(itopk, width, deg, dim, False,
                            walk_exact_staged(itopk, width, deg, dim), True)
    return base + _hop.hash_bytes(itopk, width * deg, base, SMEM_MAX)


def walk_exact_reject_reason(nq: int, itopk: int, width: int, deg: int,
                             dim: int) -> str:
    """Why the exact-row source cannot take this walk ('' when it can): the
    query's fp32 row and the merge network must fit shared memory."""
    why = _shape_reason(nq, itopk, width, deg, dim)
    if why:
        return why
    need = walk_exact_smem_bytes(itopk, width, deg, dim)
    if need > SMEM_MAX:
        return f"shared memory {need} B above {SMEM_MAX}"
    return ""


def walk_resident(itopk: int, width: int, deg: int, pdim: int,
                  quant: bool = False, exact: bool = False,
                  filtered: bool = False) -> Tuple[int, int]:
    """(threads a block, resident blocks per SM) of a walk launch of this
    shape on the current card (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    on the instantiation the launch takes); the card only.  ``exact``: the
    exact-row source, ``pdim`` its dim."""
    if exact:
        staged = walk_exact_staged(itopk, width, deg, pdim)
        smem = walk_exact_smem_bytes(itopk, width, deg, pdim)
    else:
        staged = walk_staged(itopk, width, deg, pdim, quant)
        smem = walk_smem_bytes(itopk, width, deg, pdim, quant, staged)
    out = (ctypes.c_int * 2)()
    _cuda.check(_cuda.library().raft_cagra_walk_resident(
        itopk, width, deg, pdim, int(quant), int(staged), int(exact),
        int(filtered), smem, ctypes.addressof(out)), "walk_resident")
    return out[0], out[1]


# ---------------------------------------------------------------------------
# the walk's pieces (raft_tpu/neighbors/cagra.py's, same names less "_")
# ---------------------------------------------------------------------------

def decode_neighborhood(rows, pdim: int, deg: int, quant: bool, scales):
    """(..., deg, unit) int16 rows -> (nb_p bf16 (..., deg, pdim), nb_sq f32,
    nb_id int32).  int8 lanes decode exactly into bf16; the query side
    carries the a/127 scale."""
    if not quant:
        nb_p = rows[..., :pdim].contiguous().view(torch.bfloat16)
        nb_sq = rows[..., pdim:pdim + 2].contiguous().view(
            torch.float32)[..., 0]
        nb_id = rows[..., pdim + 2:pdim + 4].contiguous().view(
            torch.int32)[..., 0]
        return nb_p, nb_sq, nb_id
    h = pdim // 2
    v = rows[..., :h].int()
    lo = ((v & 0xFF) ^ 0x80) - 0x80                    # sign-extended bytes
    hi = (((v >> 8) & 0xFF) ^ 0x80) - 0x80
    nb_p = torch.stack([lo, hi], -1).reshape(*rows.shape[:-1], pdim).to(
        torch.bfloat16)
    uq = rows[..., h].int() & 0xFFFF
    nb_sq = scales[1] + scales[2] * uq.float()
    nb_id = rows[..., h + 1:h + 3].contiguous().view(torch.int32)[..., 0]
    return nb_p, nb_sq, nb_id


def select_parents(buf_d, buf_i, visited, search_width: int):
    """Best ``search_width`` unvisited buffer entries, marked visited:
    (sel_ids, parent_ok, visited).  With no valid unvisited entry left, an
    arbitrary unvisited slot is consumed (dead slots fill up, so the
    all(visited) exit fires)."""
    nq, A = buf_d.shape
    iota = torch.arange(A, device=buf_d.device).expand(nq, A)
    full = torch.full_like(iota, A)
    rows = torch.arange(nq, device=buf_d.device)
    visited = visited.clone()
    ids, oks = [], []
    for _ in range(search_width):
        pos = torch.where(visited | (buf_i < 0) | torch.isinf(buf_d), full,
                          iota).min(1).values
        ok = pos < A
        pos_any = torch.where(visited, full, iota).min(1).values
        pc = torch.clamp_max(torch.where(ok, pos, pos_any), A - 1)
        sel = torch.gather(buf_i, 1, pc[:, None])[:, 0]
        ids.append(torch.where(ok, sel, torch.full_like(sel, -1)))
        oks.append(ok)
        visited[rows, pc] = True
    return torch.stack(ids, 1), torch.stack(oks, 1), visited


def expand(table, sel_ids, parent_ok, deg: int, pdim: int, quant: bool,
           scales, filter_words=None):
    """The parents' packed rows, decoded: (nb_p (nq, w*deg, pdim) bf16,
    nb_sq (nq, w*deg) f32, nb_id (nq, w*deg) int32, masked parents -1, and
    with ``filter_words`` each id the query rejects -1) — one fat row per
    parent."""
    nq, w = sel_ids.shape
    unit = walk_unit(pdim, quant)
    safe = torch.where(parent_ok, sel_ids, torch.zeros_like(sel_ids))
    rows = table[safe.long()][..., :deg * unit].reshape(nq, w, deg, unit)
    nb_p, nb_sq, nb_id = decode_neighborhood(rows, pdim, deg, quant, scales)
    nb_id = torch.where(parent_ok[:, :, None], nb_id,
                        torch.full_like(nb_id, -1)).reshape(nq, w * deg)
    if filter_words is not None:
        rows = torch.arange(nq, device=nb_id.device)
        nb_id = torch.where(query_bits(filter_words, rows, nb_id) > 0,
                            nb_id, torch.full_like(nb_id, -1))
    return (nb_p.reshape(nq, w * deg, pdim), nb_sq.reshape(nq, w * deg),
            nb_id)


# ---------------------------------------------------------------------------
# plain version (today's loop of the pieces, the JAX while_loop's twin)
# ---------------------------------------------------------------------------

def _check(qp_t, q_sq, table, buf_d, buf_i, visited, deg, pdim, quant,
           scales, max_iterations):
    expects(qp_t.ndim == 2 and table.ndim == 2 and buf_d.ndim == 2,
            "cagra_walk: qp_t (nq, pdim), table (n, W), buffers (nq, itopk) "
            "required")
    nq, itopk = buf_d.shape
    expects(qp_t.shape == (nq, pdim) and q_sq.shape == (nq,)
            and buf_i.shape == (nq, itopk) and visited.shape == (nq, itopk),
            "cagra_walk: shape mismatch")
    expects(table.dtype == torch.int16, "cagra_walk: table must be int16")
    expects(table.shape[1] >= deg * walk_unit(pdim, quant),
            "cagra_walk: table rows narrower than deg * unit")
    expects(not quant or (scales is not None and scales.numel() == 3),
            "cagra_walk: the int8 format needs its 3 scales")
    expects(max_iterations >= 0, "cagra_walk: max_iterations < 0")
    tensors = [qp_t, q_sq, table, buf_d, buf_i, visited]
    if quant:
        tensors.append(scales)
    expects(len({x.device for x in tensors}) == 1,
            "cagra_walk: tensors on different devices")
    return nq, itopk


def cagra_walk_plain(qp_t, q_sq, table, buf_d, buf_i, visited, *, deg: int,
                     search_width: int, max_iterations: int, ip_metric: bool,
                     quant: bool = False, scales=None,
                     exit_every: int = EXIT_CHECK_EVERY,
                     return_hops: bool = False, filter_words=None):
    """Plain PyTorch version: per hop :func:`select_parents`,
    :func:`expand` (with ``filter_words``) and ``cagra_hop_plain``; the
    all(visited) exit checked every ``exit_every`` hops (0: never — the
    same result).  With ``return_hops``, also each query's hops before its
    buffer was all visited (int32)."""
    pdim = qp_t.shape[1]
    nq, _ = _check(qp_t, q_sq, table, buf_d, buf_i, visited, deg, pdim,
                   quant, scales, max_iterations)
    hops = torch.zeros(nq, dtype=torch.int32, device=buf_d.device)
    for it in range(max_iterations):
        if exit_every and it % exit_every == 0 and it and bool(visited.all()):
            break
        if return_hops:
            hops += (~visited.all(1)).int()
        sel_ids, parent_ok, visited = select_parents(buf_d, buf_i, visited,
                                                     search_width)
        nb_p, nb_sq, nb_id = expand(table, sel_ids, parent_ok, deg, pdim,
                                    quant, scales, filter_words)
        buf_d, buf_i, visited = _hop.cagra_hop_plain(
            qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited,
            ip_metric=ip_metric)
    out = (buf_d.float(), buf_i.int(), visited.bool())
    return out + (hops,) if return_hops else out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def cagra_walk(qp_t, q_sq, table, buf_d, buf_i, visited, *, deg: int,
               search_width: int, max_iterations: int, ip_metric: bool,
               quant: bool = False, scales=None,
               exit_every: int = EXIT_CHECK_EVERY, return_hops: bool = False,
               filter_words=None) -> Tuple[torch.Tensor, ...]:
    """A whole walk: ``(buf_d f32, buf_i int32, visited bool)``, each
    (nq, itopk), sorted ascending-better (+ the hops of each query with
    ``return_hops``).

    Args (nq queries): ``qp_t`` (nq, pdim) bf16 table-side query
    projections (the int8 format's a/127 folded in), ``q_sq`` (nq,) f32,
    ``table`` (n, W) int16 packed neighborhoods (bf16 format, or int8 with
    ``quant`` and its ``scales`` (3,) f32), ``deg`` neighbors a row, and
    the seeded sorted buffer ``buf_d`` / ``buf_i`` / ``visited`` (nq,
    itopk); ``filter_words`` (nq, n_words) int32 or None.  CUDA tensors
    launch the walk kernel (``exit_every`` does not apply: each query
    exits when its buffer is all visited); CPU tensors run
    :func:`cagra_walk_plain`."""
    kw = dict(deg=deg, search_width=search_width,
              max_iterations=max_iterations, ip_metric=ip_metric,
              quant=quant, scales=scales, filter_words=filter_words)
    if not table.is_cuda:
        return cagra_walk_plain(qp_t, q_sq, table, buf_d, buf_i, visited,
                                exit_every=exit_every,
                                return_hops=return_hops, **kw)
    pdim = qp_t.shape[1]
    nq, itopk = _check(qp_t, q_sq, table, buf_d, buf_i, visited, deg, pdim,
                       quant, scales, max_iterations)
    why = walk_reject_reason(nq, itopk, search_width, deg, pdim, quant)
    expects(not why, f"cagra_walk: {why}")
    staged = walk_staged(itopk, search_width, deg, pdim, quant)
    qp_t = qp_t.to(torch.bfloat16).contiguous()
    q_sq = q_sq.float().contiguous()
    table = table.contiguous()
    buf_d = buf_d.float().contiguous()
    buf_i = buf_i.int().contiguous()
    visited = visited.bool().contiguous()
    sc = scales.float().contiguous() if quant else None
    out_d = torch.empty_like(buf_d)
    out_i = torch.empty_like(buf_i)
    out_v = torch.empty_like(visited)
    hops = torch.empty(nq, dtype=torch.int32, device=buf_d.device)
    # fw holds the words the kernel reads until the launch is queued
    fw, fargs = filter_operand(filter_words, nq, table.device, "cagra_walk")
    status = _cuda.library().raft_cagra_walk(
        qp_t.data_ptr(), q_sq.data_ptr(), table.data_ptr(), table.shape[1],
        sc.data_ptr() if quant else None, buf_d.data_ptr(), buf_i.data_ptr(),
        visited.data_ptr(), nq, itopk, search_width, deg, pdim, int(quant),
        max_iterations, int(ip_metric), int(staged),
        walk_smem_bytes(itopk, search_width, deg, pdim, quant, staged),
        out_d.data_ptr(), out_i.data_ptr(), out_v.data_ptr(),
        hops.data_ptr(), *fargs,
        torch.cuda.current_stream(table.device).cuda_stream)
    _cuda.check(status, "cagra_walk")
    cagra_walk.launches += 1
    out = (out_d, out_i, out_v)
    return out + (hops,) if return_hops else out


cagra_walk.launches = 0


# ---------------------------------------------------------------------------
# the exact-row source: the direct walk (raft_tpu/neighbors/cagra.py:1857)
# ---------------------------------------------------------------------------

# bytes of gathered rows one chunk of exact_keys may hold
_EXACT_CHUNK_BYTES = 1 << 28


def exact_keys(qf, q_sq, rows, rows_sq, ids, ip_metric: bool):
    """Keys of candidates ``ids`` (nq, m) against the fp32 queries ``qf``
    (nq, dim): max((q_sq + rows_sq[id]) − 2⟨q, x⟩, 0) (L2) or −⟨q, x⟩
    (InnerProduct), ⟨q, x⟩ summed in dimension order with each product
    and sum rounded (the exact-row kernel's arithmetic, so the two agree
    bit for bit); id < 0 scores +inf.  Chunked over queries."""
    nq, m = ids.shape
    dim = qf.shape[1]
    ok = ids >= 0
    safe = torch.where(ok, ids, torch.zeros_like(ids)).long()
    step = max(1, _EXACT_CHUNK_BYTES // max(m * dim * 4, 1))
    out = torch.empty(nq, m, dtype=torch.float32, device=qf.device)
    for s in range(0, nq, step):
        x = rows[safe[s:s + step]].float()             # (c, m, dim)
        q = qf[s:s + step].float()
        acc = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
        for d in range(dim):
            acc = acc + q[:, None, d] * x[:, :, d]
        if ip_metric:
            out[s:s + step] = -acc
        else:
            key = (q_sq[s:s + step].float()[:, None]
                   + rows_sq[safe[s:s + step]].float()) - 2.0 * acc
            out[s:s + step] = torch.clamp_min(key, 0.0)
    return torch.where(ok, out, torch.full_like(out, float("inf")))


def expand_exact(graph, sel_ids, parent_ok, filter_words=None):
    """The parents' graph rows: (nq, w * deg) candidate ids, -1 under a
    dead parent and, with ``filter_words``, where the query rejects the
    id."""
    nq, w = sel_ids.shape
    deg = graph.shape[1]
    safe = torch.where(parent_ok, sel_ids, torch.zeros_like(sel_ids))
    nb = graph[safe.long()].int()                        # (nq, w, deg)
    nb = torch.where(parent_ok[:, :, None], nb,
                     torch.full_like(nb, -1)).reshape(nq, w * deg)
    if filter_words is not None:
        rows = torch.arange(nq, device=nb.device)
        nb = torch.where(query_bits(filter_words, rows, nb) > 0, nb,
                         torch.full_like(nb, -1))
    return nb


def _check_exact(qf, q_sq, graph, rows, rows_sq, buf_d, buf_i, visited,
                 max_iterations):
    expects(qf.ndim == 2 and graph.ndim == 2 and rows.ndim == 2
            and buf_d.ndim == 2, "cagra_walk_exact: q (nq, dim), graph "
            "(n, deg), rows (n, dim), buffers (nq, itopk) required")
    nq, itopk = buf_d.shape
    n, dim = rows.shape
    expects(qf.shape == (nq, dim) and q_sq.shape == (nq,)
            and rows_sq.shape == (n,) and graph.shape[0] == n
            and buf_i.shape == (nq, itopk) and visited.shape == (nq, itopk),
            "cagra_walk_exact: shape mismatch")
    expects(max_iterations >= 0, "cagra_walk_exact: max_iterations < 0")
    expects(len({x.device for x in (qf, q_sq, graph, rows, rows_sq, buf_d,
                                    buf_i, visited)}) == 1,
            "cagra_walk_exact: tensors on different devices")
    return nq, itopk, graph.shape[1], dim


def cagra_walk_exact_plain(qf, q_sq, graph, rows, rows_sq, buf_d, buf_i,
                           visited, *, search_width: int,
                           max_iterations: int, ip_metric: bool,
                           exit_every: int = EXIT_CHECK_EVERY,
                           return_hops: bool = False, filter_words=None):
    """Plain PyTorch version of the direct walk (``_search_impl``'s loop):
    per hop :func:`select_parents`, :func:`expand_exact` (with
    ``filter_words``), :func:`exact_keys` and ``merge_candidates``; the
    all(visited) exit checked every ``exit_every`` hops (0: never — the
    same result).  With ``return_hops``, also each query's hops before its
    buffer was all visited (int32)."""
    nq, itopk, _, _ = _check_exact(qf, q_sq, graph, rows, rows_sq, buf_d,
                                   buf_i, visited, max_iterations)
    buf_d, buf_i, visited = buf_d.float(), buf_i.int(), visited.bool()
    hops = torch.zeros(nq, dtype=torch.int32, device=buf_d.device)
    for it in range(max_iterations):
        if exit_every and it % exit_every == 0 and it and bool(visited.all()):
            break
        if return_hops:
            hops += (~visited.all(1)).int()
        sel_ids, parent_ok, visited = select_parents(buf_d, buf_i, visited,
                                                     search_width)
        nb = expand_exact(graph, sel_ids, parent_ok, filter_words)
        key = exact_keys(qf, q_sq, rows, rows_sq, nb, ip_metric)
        buf_d, buf_i, visited = _hop.merge_candidates(buf_d, buf_i, visited,
                                                      key, nb, itopk)
    out = (buf_d.float(), buf_i.int(), visited.bool())
    return out + (hops,) if return_hops else out


def cagra_walk_exact(qf, q_sq, graph, rows, rows_sq, buf_d, buf_i, visited,
                     *, search_width: int, max_iterations: int,
                     ip_metric: bool, exit_every: int = EXIT_CHECK_EVERY,
                     return_hops: bool = False, filter_words=None
                     ) -> Tuple[torch.Tensor, ...]:
    """A whole direct walk over the graph: ``(buf_d f32, buf_i int32,
    visited bool)``, each (nq, itopk), sorted ascending by key (+ the hops
    of each query with ``return_hops``).

    Args (nq queries): ``qf`` (nq, dim) f32 queries, ``q_sq`` (nq,) f32,
    ``graph`` (n, deg) int32, ``rows`` (n, dim) f32 dataset rows and
    ``rows_sq`` (n,) f32 their squared norms, the seeded sorted buffer
    ``buf_d`` / ``buf_i`` / ``visited`` (nq, itopk); ``filter_words``
    (nq, n_words) int32 or None.  CUDA tensors launch the walk kernel's
    exact-row instantiation (``exit_every`` does not apply); CPU tensors
    run :func:`cagra_walk_exact_plain`."""
    kw = dict(search_width=search_width, max_iterations=max_iterations,
              ip_metric=ip_metric, filter_words=filter_words)
    if not rows.is_cuda:
        return cagra_walk_exact_plain(qf, q_sq, graph, rows, rows_sq, buf_d,
                                      buf_i, visited, exit_every=exit_every,
                                      return_hops=return_hops, **kw)
    nq, itopk, deg, dim = _check_exact(qf, q_sq, graph, rows, rows_sq, buf_d,
                                       buf_i, visited, max_iterations)
    why = walk_exact_reject_reason(nq, itopk, search_width, deg, dim)
    expects(not why, f"cagra_walk_exact: {why}")
    qf = qf.float().contiguous()
    q_sq = q_sq.float().contiguous()
    graph = graph.int().contiguous()
    rows = rows.float().contiguous()
    rows_sq = rows_sq.float().contiguous()
    buf_d = buf_d.float().contiguous()
    buf_i = buf_i.int().contiguous()
    visited = visited.bool().contiguous()
    out_d = torch.empty_like(buf_d)
    out_i = torch.empty_like(buf_i)
    out_v = torch.empty_like(visited)
    hops = torch.empty(nq, dtype=torch.int32, device=buf_d.device)
    fw, fargs = filter_operand(filter_words, nq, rows.device,
                               "cagra_walk_exact")
    status = _cuda.library().raft_cagra_walk_exact(
        qf.data_ptr(), q_sq.data_ptr(), graph.data_ptr(), rows.data_ptr(),
        rows_sq.data_ptr(), buf_d.data_ptr(), buf_i.data_ptr(),
        visited.data_ptr(), nq, itopk, search_width, deg, dim,
        max_iterations, int(ip_metric),
        walk_exact_smem_bytes(itopk, search_width, deg, dim),
        out_d.data_ptr(), out_i.data_ptr(), out_v.data_ptr(),
        hops.data_ptr(), *fargs,
        torch.cuda.current_stream(rows.device).cuda_stream)
    _cuda.check(status, "cagra_walk_exact")
    cagra_walk_exact.launches += 1
    out = (out_d, out_i, out_v)
    return out + (hops,) if return_hops else out


cagra_walk_exact.launches = 0

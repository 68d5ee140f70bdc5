"""CAGRA: graph-based ANN — build a kNN graph, prune it to a fixed-degree
search graph, answer queries by greedy graph walk (port of
``raft_tpu.neighbors.cagra``).

Reference: raft/neighbors/cagra.cuh:77 ``build_knn_graph``, :109 ``prune``,
:205 ``search``; cagra_types.hpp:41 / :55 / :114 for the params and the
index.  Same ``IndexParams`` / ``SearchParams`` fields and defaults as the
JAX package, the same ``(distances, ids)`` contract, tensors on the
handle's device (the card unless the handle asks for the CPU).

Build (n < ``_DEEP_SCALE_ROWS``): the exact all-pairs graph up to
``_BRUTE_BUILD_MAX`` rows, else the list-major clustered pass — a
calibrated PCA projection, balanced k-means lists in that space
(:mod:`raft_tpu_torch.cluster.kmeans_balanced`: Kernel H, and Kernel A
from pdim 32), a projected scan of each list block's neighbor-list tile,
reverse edges, then graph-walk refinement rounds: pack the current graph
into a walk table, self-walk every node (every hop on Kernel I), and
exact-rerank.  ``prune`` orders edges by detour count and fills half the
degree with reverse edges.

Search: a dense entry-set scoring seeds each query's sorted buffer, then
greedy hops over the packed-neighborhood table (one fat row per parent:
projected bf16 vectors, norms and ids in int16 lanes), each hop's score +
dedupe + merge on Kernel I (:mod:`raft_tpu_torch.ops.cagra_hop`), and an
exact rerank of the buffer's best ``rerank`` entries.

Where the port differs from the JAX package, by design:

- every hop goes through Kernel I on the card, at any batch size; the JAX
  package sends a hop through its Pallas kernel only on a TPU for batches
  of <= 64 and otherwise runs the kernel's XLA twin (``_merge_candidates``),
  which is the plain version here.  The exact merge of the build's
  refinement rounds is the same hop with the full rows as its "projected"
  vectors and a zero query norm, so it runs on Kernel I too;
- ``approx_max_k`` (the build scan and its calibration) is an exact top-k:
  on the TPU it is approximate, on the CPU exact;
- the walk's ``all(visited)`` exit is checked every ``_EXIT_CHECK_EVERY``
  hops, not every hop (one host sync each): a fully visited buffer is a
  fixed point of the hop, so the result is the same;
- chunks are sized by device memory (``_hbm_bytes``), not by the TPU
  watchdog's dispatch limits; every chunked result is row-wise, so the
  result does not change;
- the entry set is drawn with ``torch.randperm`` on the handle's generator
  (Philox, not threefry): carry a ``raft_tpu`` index and its walk cache
  across with :func:`index_from_numpy` and :func:`attach_walk_cache` to
  compare searches draw for draw.

Not ported yet — each raises ``NotImplementedError`` naming its ROADMAP.md
item: ``filter=`` (filters), ``serialize`` / ``deserialize`` / ``save`` /
``load`` (serialization), ``canary_queries > 0`` (canaries),
``checkpoint=`` / ``resume=`` (checkpointing), ``delete`` (mutation), the
deep-scale build from ``_DEEP_SCALE_ROWS`` rows (CAGRA deep regime), the
direct exact walk (``walk_pdim=0``, or no walk-table format fits: CAGRA
direct walk) and hops beyond Kernel I's gate — itopk or search_width x
degree above 256 (CAGRA wide hops).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import _writable, ensure_tensor
from raft_tpu_torch.distance.types import DistanceType, SQRT_METRICS
from raft_tpu_torch.matrix.ops import row_duplicate_mask
from raft_tpu_torch.neighbors.ivf_flat import _stage
from raft_tpu_torch.ops import cagra_hop as _hop
from raft_tpu_torch.utils import precision

# the walk primitives, under the JAX package's names
_merge_candidates = _hop.merge_candidates
_bitonic_merge = _hop.bitonic_merge


def _not_ported(what: str, item: str):
    return not_ported("cagra", what, item)


@dataclasses.dataclass
class IndexParams:
    """Reference: cagra_types.hpp:41 ``index_params`` (the JAX package's
    fields and defaults; ``build_scan_recall`` is the TPU's
    ``approx_max_k`` target and has no effect: the scan's top-k is exact
    here)."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    metric: int = DistanceType.L2Expanded
    build_n_lists: int = 0
    build_n_probes: int = 32
    build_refine_rate: float = 2.0
    build_candidates: int = 8192
    build_proj_dim: int = 0
    build_scan_recall: float = 0.95
    build_reverse_rounds: int = 1
    build_walk_rounds: int = 2
    build_walk_iters: int = 8
    canary_queries: int = 0
    canary_k: int = 10
    canary_floor: float = 0.5


@dataclasses.dataclass
class SearchParams:
    """Reference: cagra_types.hpp:55 ``search_params`` plus the JAX
    package's walk knobs (``walk_pdim`` None = calibrated, >0 forced;
    ``entry_points``; ``rerank_topk`` 0 = max(32, 2k)).  ``merge_window``
    is validated and selects nothing: Kernel I has one merge.
    ``num_random_samplings`` and ``rand_xor_mask`` belong to the direct
    walk, which is not ported."""

    max_iterations: int = 0
    itopk_size: int = 64
    search_width: int = 1
    num_random_samplings: int = 1
    rand_xor_mask: int = 0x128394
    walk_pdim: Optional[int] = None
    entry_points: int = 4096
    rerank_topk: int = 0
    merge_window: object = "auto"


@dataclasses.dataclass
class Index:
    """Reference: cagra_types.hpp:114 ``index`` — dataset + fixed-degree
    graph (row i holds the neighbor ids of node i).  The first search
    attaches its walk caches as attributes (``_walk_tables``,
    ``_walk_entries``, ``_walk_auto_pdim``, ...), as the JAX index does."""

    dataset: torch.Tensor
    graph: torch.Tensor
    metric: int = DistanceType.L2Expanded
    canaries: Optional[object] = None
    generation: int = 0

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]


# ---------------------------------------------------------------------------
# sizes and thresholds (the JAX package's)
# ---------------------------------------------------------------------------

_BRUTE_BUILD_MAX = 32768
_BUILD_FIDELITY = 0.95
_CALIB_RT = 0.99
_BUILD_FIDELITY_GATE = min(_BUILD_FIDELITY + 2 * (1 - _CALIB_RT), 1.0)
_REV_HOST_EDGES = 200_000_000
_DEEP_SCALE_ROWS = 4_000_000
_REV_SRC_CAP = 48
_WALK_FIDELITY = 0.9
_WALK_CALIB_QUERIES = 256
_WALK_CALIB_POOL = 131072
_WALK_CALIB_K = 10
_WALK_TABLE_MAX_BYTES = 6 << 30
# hops between two checks of the walk's all(visited) exit (a host sync)
_EXIT_CHECK_EVERY = 8
# device memory the CPU reports as its "HBM" for chunk sizing
_CPU_MEMORY_BYTES = 16 << 30

_DEBUG_CHECKS = os.environ.get("RAFT_TPU_DEBUG_CHECKS", "0").lower() \
    not in ("0", "", "false")


def _require_hop(nq: int, itopk: int, wd: int, pdim: int) -> None:
    """Raise before a walk whose hops Kernel I's gate refuses (the JAX
    package runs its XLA twin there)."""
    why = _hop.hop_reject_reason(nq, itopk, wd, pdim)
    if why:
        raise _not_ported(f"a walk hop beyond Kernel I's gate ({why})",
                          "CAGRA wide hops")


def _hbm_bytes(device) -> int:
    """Device memory: ``torch.cuda.mem_get_info``'s total on the card, a
    stated constant (16 GiB) on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return _CPU_MEMORY_BYTES


def _chunk_budget(device) -> int:
    """Bytes one chunk's transients may take: 1/64 of device memory."""
    return _hbm_bytes(device) // 64


def _rows_per_chunk(device, bytes_per_row: int, lo: int = 256,
                    hi: int = 65536) -> int:
    return int(max(lo, min(hi, _chunk_budget(device) // max(bytes_per_row,
                                                             1))))


def _f32_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: products of such values are exact in fp32
    (the JAX package's bf16 x bf16 -> f32 products)."""
    return x.to(torch.bfloat16).float()


def _topk_smallest(d: torch.Tensor, k: int):
    """(values, positions) of each row's k smallest, ties to the lowest
    position (``lax.top_k``'s order on the negated keys)."""
    v, pos = torch.sort(d, dim=1, stable=True)
    return v[:, :k], pos[:, :k]


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation, f32 arithmetic) over
    all of x, by a sort — ``torch.quantile`` refuses inputs above ~2^24
    elements."""
    s, _ = torch.sort(x.reshape(-1).float())
    n = s.numel()
    qf = torch.tensor(q, dtype=torch.float32) / torch.tensor(
        100.0, dtype=torch.float32)
    pos = qf * torch.tensor(n - 1, dtype=torch.float32)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = torch.tensor(1.0, dtype=torch.float32) - hw
    lo = int(min(max(float(low), 0.0), n - 1))
    hi = int(min(max(float(high), 0.0), n - 1))
    return s[lo] * lw.to(s.device) + s[hi] * hw.to(s.device)


# ---------------------------------------------------------------------------
# build: exact small-n graph
# ---------------------------------------------------------------------------

def _knn_graph_exact(dataset, kg: int, metric: int, chunk: int = 4096):
    """Exact all-pairs kNN graph (self included): one fp32 product and a
    top-k per chunk of rows."""
    n = dataset.shape[0]
    xf = dataset.float()
    x_sq = (xf * xf).sum(1)
    ip_metric = metric == DistanceType.InnerProduct
    out = torch.empty(n, kg, dtype=torch.int32, device=xf.device)
    for s in range(0, n, chunk):
        ip = xf[s:s + chunk] @ xf.T
        d = -ip if ip_metric else x_sq[None, :] - 2.0 * ip
        out[s:s + chunk] = torch.topk(d, kg, dim=1, largest=False,
                                      sorted=True).indices.int()
    return out


# ---------------------------------------------------------------------------
# build: calibrated projection
# ---------------------------------------------------------------------------

def _second_moment(dataset) -> torch.Tensor:
    """Uncentered second moment of a strided sample of <= 32768 rows."""
    xf = dataset.float()
    n = xf.shape[0]
    m = min(n, 32768)
    sub = xf[::max(n // m, 1)][:m]
    return (sub.T @ sub) / sub.shape[0]


def _eig_vecs(dataset) -> torch.Tensor:
    """Eigenvectors of the second moment, ascending eigenvalue order."""
    return torch.linalg.eigh(_second_moment(dataset))[1]


def _calib_sample(dataset, pool_size: int = _WALK_CALIB_POOL):
    """Strided calibration (queries, pool, self_col): ``self_col`` is each
    query's own pool column (-1 when absent)."""
    n = dataset.shape[0]
    mq = min(n, _WALK_CALIB_QUERIES)
    mp = min(n, pool_size)
    sq_, sp_ = max(n // mq, 1), max(n // mp, 1)
    queries = dataset[::sq_][:mq].float()
    pool = dataset[::sp_][:mp].float()
    mq, mp = queries.shape[0], pool.shape[0]
    qrow = np.arange(mq, dtype=np.int64) * sq_
    col = qrow // sp_
    self_col = torch.as_tensor(
        np.where((qrow % sp_ == 0) & (col < mp), col, -1).astype(np.int32),
        device=queries.device)
    return queries, pool, self_col


def _calib_keys(queries, pool, self_col, vecs, pdim, ip_metric, quant=False):
    """(exact keys, projected keys) of the calibration queries against the
    pool, each query's own column masked to +inf."""
    dim = pool.shape[1]
    ip = queries @ pool.T
    proj = vecs[:, dim - pdim:]
    ppf = pool @ proj
    if quant:
        a = torch.clamp_min(_percentile(ppf.abs(), 99.9), 1e-12)
        pp = _f32_bf16(torch.clamp(torch.round(ppf / a * 127.0), -127, 127))
        qp = _f32_bf16((queries @ proj) * (a / 127.0))
    else:
        pp = _f32_bf16(ppf)
        qp = _f32_bf16(queries @ proj)
    ipa = qp @ pp.T
    if ip_metric:
        d_exact, d_apx = -ip, -ipa
    else:
        p_sq = (pool * pool).sum(1)
        d_exact = p_sq[None, :] - 2.0 * ip
        d_apx = p_sq[None, :] - 2.0 * ipa
    cols = torch.arange(pool.shape[0], device=pool.device)
    self_mask = cols[None, :] == self_col[:, None]
    inf = torch.tensor(float("inf"), device=pool.device)
    return (torch.where(self_mask, inf, d_exact),
            torch.where(self_mask, inf, d_apx))


def _hit_rate(d_exact, d_apx, k_exact: int, k_apx: int) -> float:
    ie = torch.topk(d_exact, k_exact, dim=1, largest=False).indices
    ia = torch.topk(d_apx, k_apx, dim=1, largest=False).indices
    return float((ie[:, :, None] == ia[:, None, :]).any(-1).float().mean())


def _calib_build_recall(queries, pool, self_col, vecs, pdim, kg, C,
                        ip_metric=False) -> float:
    """Fraction of the exact top-``kg`` inside the ``pdim``-projected
    top-``C`` (exact selects on both sides)."""
    d_exact, d_apx = _calib_keys(queries, pool, self_col, vecs, pdim,
                                 ip_metric)
    return _hit_rate(d_exact, d_apx, kg, C)


def _build_pdim(dataset, metric, kg, C) -> Tuple[int, torch.Tensor]:
    """Smallest power-of-two PCA dim from 16 whose projected top-C covers
    >= the build gate of the exact top-kg; (pdim, eigvecs)."""
    dim = dataset.shape[1]
    queries, pool, self_col = _calib_sample(dataset, _WALK_CALIB_POOL // 2)
    mp = pool.shape[0]
    ip_metric = metric == DistanceType.InnerProduct
    vecs = _eig_vecs(dataset)
    p = 16
    while p < dim:
        ov = _calib_build_recall(queries, pool, self_col, vecs, p, kg,
                                 min(C, mp), ip_metric)
        if ov >= _BUILD_FIDELITY_GATE:
            return p, vecs
        p *= 2
    return dim, vecs


def _calib_overlap(queries, pool, self_col, vecs, pdim, k, ip_metric=False,
                   quant=False) -> float:
    """Top-k overlap between exact and pdim-projected keys (the int8 table
    quantization applied to the pool side when ``quant``)."""
    d_exact, d_apx = _calib_keys(queries, pool, self_col, vecs, pdim,
                                 ip_metric, quant)
    return _hit_rate(d_exact, d_apx, k, k)


def _calib_vecs(index: Index) -> torch.Tensor:
    vecs = getattr(index, "_walk_calib_vecs", None)
    if vecs is None:
        vecs = _eig_vecs(index.dataset)
        index._walk_calib_vecs = vecs
    return vecs


def _auto_pdim(index: Index) -> int:
    """Smallest power-of-two PCA dim from 8 keeping >= _WALK_FIDELITY
    top-k overlap (dim = rotation only; 0 = no projection orders the
    data), cached on the index."""
    cached = getattr(index, "_walk_auto_pdim", None)
    if cached is None:
        dim = index.dim
        queries, pool, self_col = _calib_sample(index.dataset)
        ip_metric = index.metric == DistanceType.InnerProduct
        vecs = _calib_vecs(index)
        p, cached = 8, 0
        while p < dim:
            if _calib_overlap(queries, pool, self_col, vecs, p,
                              _WALK_CALIB_K, ip_metric) >= _WALK_FIDELITY:
                cached = p
                break
            p *= 2
        if cached == 0:
            ov = _calib_overlap(queries, pool, self_col, vecs, dim,
                                _WALK_CALIB_K, ip_metric)
            cached = dim if ov >= _WALK_FIDELITY else 0
        index._walk_auto_pdim = cached
    return cached


def _quant_calib_ok(index: Index, pdim: int) -> bool:
    cache = getattr(index, "_walk_quant_ok", None)
    if cache is None:
        cache = index._walk_quant_ok = {}
    if pdim not in cache:
        queries, pool, self_col = _calib_sample(index.dataset)
        ip_metric = index.metric == DistanceType.InnerProduct
        ov = _calib_overlap(queries, pool, self_col, _calib_vecs(index),
                            min(pdim, index.dim), _WALK_CALIB_K, ip_metric,
                            quant=True)
        cache[pdim] = ov >= _WALK_FIDELITY
    return cache[pdim]


# ---------------------------------------------------------------------------
# walk tables
# ---------------------------------------------------------------------------

def _walk_proj(dataset, pdim: int, vecs=None) -> torch.Tensor:
    """(dim, pdim) projection: the top-pdim eigenvectors of the uncentered
    second moment (identity at pdim >= dim)."""
    dim = dataset.shape[1]
    if pdim < dim:
        if vecs is None:
            vecs = _eig_vecs(dataset)
        return vecs[:, dim - pdim:]
    return torch.eye(dim, dtype=torch.float32, device=dataset.device)


def _quant_unit(pdim: int) -> int:
    """int16 lanes per neighbor in the int8 format: pdim/2 + norm + 2 id."""
    return pdim // 2 + 3


def _table_bytes(n: int, deg: int, pdim: int, quant: bool) -> int:
    unit = _quant_unit(pdim) if quant else pdim + 4
    return n * (-(-(deg * unit) // 128) * 128) * 2


def _table_plan(n, kg, pdim, budget, deep=False):
    """First (deg_t, pdim, quant) packed-table rung that fits ``budget``."""
    pde = max(pdim - pdim % 2, 8)
    rungs = [] if deep else [(min(kg, 64), pdim, False)]
    rungs += [(min(kg, 64), pde, True),
              (min(kg, 32), pde, True),
              (min(kg, 32), max(pde // 2 - (pde // 2) % 2, 8), True),
              (min(kg, 16), 8, True)]
    for deg_t, pd, q in rungs:
        if _table_bytes(n, deg_t, pd, q) <= budget:
            return deg_t, pd, q
    return None


def _search_table_format(index: Index, pdim: int):
    """(pdim, quant) of the search walk table: bf16 when it fits, else the
    int8 format at pdim then half of it (each gated on its fidelity);
    None when nothing fits."""
    deg = index.graph_degree
    pdim = min(pdim, index.dim)
    if _table_bytes(index.size, deg, pdim, False) <= _WALK_TABLE_MAX_BYTES:
        return pdim, False
    for p_try in dict.fromkeys((max(pdim - pdim % 2, 8),
                                max(pdim // 2 - (pdim // 2) % 2, 8))):
        if p_try > index.dim:
            continue
        if (_table_bytes(index.size, deg, p_try, True)
                <= _WALK_TABLE_MAX_BYTES and _quant_calib_ok(index, p_try)):
            return p_try, True
    return None


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(..., ) 32-bit values -> (..., 2) int16 lanes, low half first."""
    return x.contiguous().unsqueeze(-1).view(torch.int16)


def _build_walk_table(dataset, graph, pdim: int, vecs=None, proj=None):
    """bf16 packed-neighborhood table (n, W) int16, W = pad(deg * (pdim +
    4), 128): per neighbor its projected vector (pdim bf16), squared norm
    (f32) and id (int32) as int16 lanes.  Returns (table, proj);
    ``proj`` overrides the computed projection (a carried one)."""
    n = dataset.shape[0]
    if proj is None:
        proj = _walk_proj(dataset, pdim, vecs)
    pdim = proj.shape[1]
    xf = dataset.float()
    xp = (xf @ proj).to(torch.bfloat16)
    x_sq = (xf * xf).sum(1)
    deg = graph.shape[1]
    unit = pdim + 4
    w_pad = -(-(deg * unit) // 128) * 128
    table = torch.zeros(n, w_pad, dtype=torch.int16, device=xf.device)
    rows = _rows_per_chunk(xf.device, deg * unit * 6)
    for s in range(0, n, rows):
        nb = graph[s:s + rows].int()
        nl = nb.long()
        packed = torch.cat([xp[nl].view(torch.int16), _lanes(x_sq[nl]),
                            _lanes(nb)], 2)
        table[s:s + rows, :deg * unit] = packed.reshape(nb.shape[0], -1)
    return table, proj


def _build_walk_table_q(dataset, graph, pdim: int, deg: int = 0, vecs=None,
                        proj=None):
    """int8/uint16 packed-neighborhood table: int8 projected lanes (two
    per int16 lane, one symmetric scale at the 99.9th |value| percentile of
    a strided sample), uint16-quantized squared norms, int32 ids; ``deg``
    (0 = all) takes a prefix of ``graph``.  Returns (table, proj, scales
    (3,) f32 = [a, sq_min, sq_scale])."""
    n = dataset.shape[0]
    deg = deg or graph.shape[1]
    if proj is None:
        proj = _walk_proj(dataset, pdim, vecs)
    pdim = proj.shape[1]
    xf = dataset.float()
    xp = xf @ proj
    x_sq = (xf * xf).sum(1)
    a = torch.clamp_min(_percentile(xp[::max(n // 65536, 1)].abs(), 99.9),
                        1e-12)
    s8 = torch.clamp(torch.round(xp / a * 127.0), -127, 127).to(torch.int8)
    del xp
    sq_min = x_sq.min()
    sq_scale = torch.clamp_min(x_sq.max() - sq_min, 1e-12) / 65535.0
    # uint16 codes, carried as the int16 lanes of the same bits
    sq_q = torch.round((x_sq - sq_min) / sq_scale).to(torch.int32).to(
        torch.int16)
    unit = _quant_unit(pdim)
    w_pad = -(-(deg * unit) // 128) * 128
    table = torch.zeros(n, w_pad, dtype=torch.int16, device=xf.device)
    rows = _rows_per_chunk(xf.device, deg * unit * 6)
    for s in range(0, n, rows):
        nb = graph[s:s + rows, :deg].int()
        nl = nb.long()
        p16 = s8[nl].view(torch.int16)               # (c, deg, pdim / 2)
        packed = torch.cat([p16, sq_q[nl].unsqueeze(-1), _lanes(nb)], 2)
        table[s:s + rows, :deg * unit] = packed.reshape(nb.shape[0], -1)
    scales = torch.stack([a, sq_min, sq_scale * 1.0]).float()
    return table, proj, scales


def _decode_neighborhood(rows, pdim: int, deg: int, quant: bool, scales):
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


def _build_refine_table(dataset, knn, plan, vecs):
    """The walk table of a refinement round per ``plan``: (table, proj,
    scales-or-None, quant)."""
    deg_t, pd, q = plan
    if q:
        table, proj, scales = _build_walk_table_q(dataset, knn, pd,
                                                  deg=deg_t, vecs=vecs)
        return table, proj, scales, True
    table, proj = _build_walk_table(dataset, knn[:, :deg_t], pd, vecs=vecs)
    return table, proj, None, False


# ---------------------------------------------------------------------------
# walk cache (search)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _WalkCache:
    """Search-time state attached to the index: ``table`` (n, W) int16,
    ``proj`` (dim, pdim) f32, the entry set (``entry_proj`` (S, pdim) bf16,
    ``entry_sq`` (S,) f32, ``entry_ids`` (S,) int32), and for the int8
    format ``scales`` (3,) f32."""

    table: torch.Tensor
    proj: torch.Tensor
    entry_proj: torch.Tensor
    entry_sq: torch.Tensor
    entry_ids: torch.Tensor
    quant: bool = False
    scales: Optional[torch.Tensor] = None


def _entry_set_of(dataset, proj, entry_ids):
    rows = dataset[entry_ids.long()].float()
    return (rows @ proj).to(torch.bfloat16), (rows * rows).sum(1), \
        entry_ids.int()


def _build_entry_set(dataset, proj, generator, n_entries: int):
    """A random entry set of ``n_entries`` distinct rows, projected."""
    ids = torch.randperm(dataset.shape[0], generator=generator,
                         device=dataset.device)[:n_entries]
    return _entry_set_of(dataset, proj, ids)


def _walk_tables(index: Index):
    tables = getattr(index, "_walk_tables", None)
    if tables is None:
        tables = index._walk_tables = {}
        index._walk_entries = {}
    return tables


def _walk_cache(res, index: Index, pdim: int, n_entries: int,
                quant: bool = False) -> _WalkCache:
    """Get or build the packed table (at most one kept per index) and the
    entry set for (pdim, n_entries)."""
    pdim = min(pdim, index.dim)
    n_entries = min(n_entries, index.size)
    tables = _walk_tables(index)
    tkey = (pdim, quant)
    if tkey not in tables:
        tables.clear()
        vecs = _calib_vecs(index) if pdim < index.dim else None
        if quant:
            tables[tkey] = _build_walk_table_q(index.dataset, index.graph,
                                               pdim, vecs=vecs)
        else:
            tables[tkey] = _build_walk_table(index.dataset, index.graph,
                                             pdim, vecs=vecs) + (None,)
    table, proj, scales = tables[tkey]
    entries = index._walk_entries
    ekey = (pdim, n_entries)
    if ekey not in entries:
        entries[ekey] = _build_entry_set(index.dataset, proj, res.generator,
                                         n_entries)
    eproj, esq, eids = entries[ekey]
    return _WalkCache(table, proj, eproj, esq, eids, quant=quant,
                      scales=scales)


def attach_walk_cache(index: Index, proj, entry_ids, *,
                      quant: bool = False) -> Index:
    """Attach a carried walk cache: the table built from ``proj`` (dim,
    pdim) — e.g. a ``raft_tpu`` index's ``_walk_tables`` projection — and
    the entry set of ``entry_ids``; the index's calibrated pdim becomes
    pdim, so ``search`` at ``entry_points = len(entry_ids)`` walks exactly
    this cache.  Returns ``index``."""
    dev = index.dataset.device
    proj = torch.from_numpy(_writable(np.asarray(proj, np.float32))).to(dev)
    eids = torch.from_numpy(_writable(np.asarray(entry_ids, np.int32))).to(dev)
    pdim = proj.shape[1]
    tables = _walk_tables(index)
    tables.clear()
    if quant:
        tables[(pdim, True)] = _build_walk_table_q(
            index.dataset, index.graph, pdim, proj=proj)
    else:
        tables[(pdim, False)] = _build_walk_table(
            index.dataset, index.graph, pdim, proj=proj) + (None,)
    index._walk_entries[(pdim, eids.shape[0])] = _entry_set_of(
        index.dataset, proj, eids)
    index._walk_auto_pdim = pdim
    return index


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def _select_parents(buf_d, buf_i, visited, search_width: int):
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


def _expand(table, sel_ids, parent_ok, deg: int, pdim: int, quant: bool,
            scales):
    """The parents' packed rows, decoded: (nb_p (nq, w*deg, pdim) bf16,
    nb_sq (nq, w*deg) f32, nb_id (nq, w*deg) int32, masked parents -1) —
    one fat row per parent."""
    nq, w = sel_ids.shape
    unit = _quant_unit(pdim) if quant else pdim + 4
    safe = torch.where(parent_ok, sel_ids, torch.zeros_like(sel_ids))
    rows = table[safe.long()][..., :deg * unit].reshape(nq, w, deg, unit)
    nb_p, nb_sq, nb_id = _decode_neighborhood(rows, pdim, deg, quant, scales)
    nb_id = torch.where(parent_ok[:, :, None], nb_id,
                        torch.full_like(nb_id, -1))
    return (nb_p.reshape(nq, w * deg, pdim), nb_sq.reshape(nq, w * deg),
            nb_id.reshape(nq, w * deg))


def _query_side(qf, proj, quant: bool, scales):
    """(q_sq, qp entry-side bf16, qp_t table-side bf16): the int8 table's
    a/127 scale folds into the query side of table rows only."""
    q_sq = (qf * qf).sum(1)
    qpf = qf @ proj
    qp = qpf.to(torch.bfloat16)
    qp_t = (qpf * (scales[0] / 127.0)).to(torch.bfloat16) if quant else qp
    return q_sq, qp, qp_t


def _search_impl_walk(dataset, table, entry_proj, entry_sq, entry_ids, proj,
                      queries, k: int, itopk: int, search_width: int,
                      max_iterations: int, metric: int, rerank: int,
                      deg: int, quant: bool = False, scales=None,
                      exit_every: int = _EXIT_CHECK_EVERY):
    """Greedy walk over the packed table (``raft_tpu/neighbors/cagra.py``
    :1707):
    dense entry scoring seeds the sorted buffer, every hop runs
    :func:`raft_tpu_torch.ops.cagra_hop.cagra_hop` (Kernel I on the card),
    and the best ``rerank`` entries are re-scored exactly.  The
    all(visited) exit is checked every ``exit_every`` hops (0: never — the
    fixed hop count, the same result)."""
    nq = queries.shape[0]
    n = dataset.shape[0]
    pdim = proj.shape[1]
    _require_hop(nq, itopk, search_width * deg, pdim)
    ip_metric = metric == DistanceType.InnerProduct
    qf = queries.float()
    q_sq, qp, qp_t = _query_side(qf, proj, quant, scales)

    ip_e = _f32_bf16(qp) @ _f32_bf16(entry_proj).T
    d_e = -ip_e if ip_metric else (q_sq[:, None] + entry_sq[None, :]) \
        - 2.0 * ip_e
    ids_e = entry_ids.int()[None, :].expand(nq, -1)
    S = d_e.shape[1]
    if S < itopk:
        d_e = torch.cat([d_e, torch.full((nq, itopk - S), float("inf"),
                                         device=d_e.device)], 1)
        ids_e = torch.cat([ids_e, torch.full((nq, itopk - S), -1,
                                             dtype=torch.int32,
                                             device=d_e.device)], 1)
    buf_d, pos = torch.topk(d_e, itopk, dim=1, largest=False, sorted=True)
    buf_i = torch.gather(ids_e, 1, pos)
    buf_i = torch.where(torch.isinf(buf_d), torch.full_like(buf_i, -1),
                        buf_i)
    visited = torch.zeros(nq, itopk, dtype=torch.bool, device=d_e.device)

    for it in range(max_iterations):
        if exit_every and it % exit_every == 0 and it and bool(visited.all()):
            break
        sel_ids, parent_ok, visited = _select_parents(buf_d, buf_i, visited,
                                                      search_width)
        nb_p, nb_sq, nb_id = _expand(table, sel_ids, parent_ok, deg, pdim,
                                     quant, scales)
        buf_d, buf_i, visited = _hop.cagra_hop(
            qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited,
            ip_metric=ip_metric)

    # exact rerank of the best `rerank` buffer entries (a sorted slice)
    r_ids = buf_i[:, :rerank]
    vecs = dataset[r_ids.clamp(0, n - 1).long()].float()
    if ip_metric:
        d_r = torch.bmm(vecs, qf[:, :, None])[:, :, 0]
        d_r = torch.where(r_ids >= 0, d_r, torch.full_like(d_r, -float("inf")))
        out_d, pos = torch.sort(d_r, dim=1, descending=True, stable=True)
    else:
        diff = qf[:, None, :] - vecs
        d_r = (diff * diff).sum(-1)
        d_r = torch.where(r_ids >= 0, d_r, torch.full_like(d_r, float("inf")))
        out_d, pos = torch.sort(d_r, dim=1, stable=True)
    out_d, pos = out_d[:, :k], pos[:, :k]
    out_i = torch.gather(r_ids, 1, pos)
    if metric in SQRT_METRICS:
        out_d = torch.sqrt(torch.clamp_min(out_d, 0.0))
    return out_d, out_i


def search(res, params: SearchParams, index: Index, queries, k: int, *,
           filter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy graph-walk search (reference: cagra.cuh:205): (distances
    (nq, k) f32, ids (nq, k) int32) on the handle's device.

    .. note:: like the JAX package's, the first search builds and attaches
       the packed walk table and the entry set to ``index`` in place."""
    if filter is not None:
        raise _not_ported("filtered search (filter=)", "filters")
    with precision.highest():
        queries = ensure_tensor(queries, res, "queries").float()
        expects(queries.ndim == 2 and queries.shape[1] == index.dim,
                "cagra.search: query dim mismatch")
        return _search_checked(res, params, index, queries, k)


def _search_checked(res, params: SearchParams, index: Index, queries,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    expects(0 < k <= index.size, "cagra.search: need 0 < k <= n")
    _hop.merge_window_request(params.merge_window)
    itopk = max(params.itopk_size, k)
    max_iter = params.max_iterations or (
        10 + itopk // max(params.search_width, 1))
    if params.walk_pdim == 0:
        raise _not_ported("the direct exact walk (walk_pdim=0)",
                          "CAGRA direct walk")
    pdim = min(params.walk_pdim or _auto_pdim(index), index.dim)
    fmt = _search_table_format(index, pdim) if pdim > 0 else None
    if fmt is None:
        raise _not_ported("the direct exact walk (no walk-table projection "
                          "or format fits this index)", "CAGRA direct walk")
    pdim, quant = fmt
    cache = _walk_cache(res, index, pdim, max(params.entry_points, itopk),
                        quant=quant)
    rerank = max(min(itopk, params.rerank_topk or max(32, 2 * k)), k)
    return _search_impl_walk(
        index.dataset, cache.table, cache.entry_proj, cache.entry_sq,
        cache.entry_ids, cache.proj, queries, k, itopk, params.search_width,
        max_iter, index.metric, rerank, index.graph_degree,
        quant=cache.quant, scales=cache.scales)


# ---------------------------------------------------------------------------
# build: the clustered pass
# ---------------------------------------------------------------------------

def _build_layout(xf, xp32, labels, n_lists: int, cap: int):
    """Pack rows into the padded per-list layout the scan reads: projected
    rows (bf16), exact squared norms (f32, +inf padding) and ids (-1
    padding), each (n_lists, cap, ...)."""
    n = xf.shape[0]
    dev = xf.device
    labels = labels.long()
    order = torch.argsort(labels, stable=True)
    sl = labels[order]
    sizes = torch.bincount(labels, minlength=n_lists)
    starts = torch.cumsum(sizes, 0) - sizes
    slot = sl * cap + (torch.arange(n, device=dev) - starts[sl])
    pdim = xp32.shape[1]
    P_proj = torch.zeros(n_lists * cap, pdim, dtype=torch.bfloat16,
                         device=dev)
    P_proj[slot] = xp32[order].to(torch.bfloat16)
    P_sq = torch.full((n_lists * cap,), float("inf"), device=dev)
    P_sq[slot] = (xf * xf).sum(1)[order]
    P_id = torch.full((n_lists * cap,), -1, dtype=torch.int32, device=dev)
    P_id[slot] = order.int()
    return (P_proj.reshape(n_lists, cap, pdim), P_sq.reshape(n_lists, cap),
            P_id.reshape(n_lists, cap))


def _center_neighbors(centers, t: int, ip_metric: bool):
    """Top-``t`` nearest lists per list by center distance (self first)."""
    cf = centers.float()
    ip = cf @ cf.T
    d = -ip if ip_metric else (cf * cf).sum(1)[None, :] - 2.0 * ip
    d.fill_diagonal_(-float("inf"))
    return torch.topk(d, t, dim=1, largest=False).indices.int()


def _scan_chunk(P_proj, P_sq, P_id, center_nbrs, list_ids, cap: int,
                kg: int, ip_metric: bool):
    """Projected candidate scan of a block of lists: one batched product
    scores each list's rows against its t neighbor lists' (t·cap)-row tile
    (exact norms, bf16 projected cross term), an exact top-``kg`` keeps
    the ids.  (len(list_ids), cap, kg) int32, -1 where a tile runs out."""
    L = list_ids.shape[0]
    t = center_nbrs.shape[1]
    pdim = P_proj.shape[2]
    nb = center_nbrs[list_ids].long()
    qp = P_proj[list_ids].float()
    cp = P_proj[nb].reshape(L, t * cap, pdim).float()
    csq = P_sq[nb].reshape(L, t * cap)
    cid = P_id[nb].reshape(L, t * cap)
    ip = torch.bmm(qp, cp.transpose(1, 2))
    d = -ip if ip_metric else csq[:, None, :] - 2.0 * ip
    d = torch.where(cid[:, None, :] >= 0, d, torch.full_like(d, float("inf")))
    pos = torch.topk(d, kg, dim=2, largest=False).indices
    return torch.gather(cid[:, None, :].expand(L, cap, t * cap), 2, pos)


def _build_knn_graph_clustered(res, dataset, kg: int, p: IndexParams,
                               stages: dict):
    """The cluster-blocked kNN-graph pass: (n, kg) int32 ranked ids (self
    included).  Stage seconds land in ``stages``."""
    n, dim = dataset.shape
    if n >= _DEEP_SCALE_ROWS:
        raise _not_ported(f"the deep-scale build (n >= {_DEEP_SCALE_ROWS:,} "
                          f"rows)", "CAGRA deep regime")
    dev = dataset.device
    xf = dataset.float()
    ip_metric = p.metric == DistanceType.InnerProduct
    n_lists = p.build_n_lists or max(min(n // 64, 4 * int(np.sqrt(n))), 8)
    n_lists = min(n_lists, n)
    C = max(int(p.build_refine_rate * kg), kg)
    t0 = _stage(stages, None, time.perf_counter(), dev)

    if p.build_proj_dim:
        pdim = min(p.build_proj_dim, dim)
        vecs = _eig_vecs(dataset)
    else:
        pdim, vecs = _build_pdim(dataset, p.metric, kg, C)
    proj = (vecs[:, dim - pdim:] if pdim < dim
            else torch.eye(dim, dtype=torch.float32, device=dev))
    xp32 = xf @ proj
    build.build_pdim = pdim
    walk = pdim < dim and p.build_walk_rounds > 0
    if walk:      # the rounds' self-walk hops and their sorted merge
        _require_hop(1, _refine_itopk(kg), min(kg, 64), pdim)
        _require_hop(1, kg, _refine_itopk(kg), dim)
    elif p.build_reverse_rounds > 1:
        _require_hop(1, kg, min(kg, 64), dim)
    t0 = _stage(stages, "calibration", t0, dev)

    n_train = min(n, max(n_lists * 8, max(65536, n // 10)))
    bal = KMeansBalancedParams(
        n_iters=10, metric=p.metric if ip_metric else DistanceType.L2Expanded)
    trainset = xp32[::max(n // n_train, 1)][:n_train]
    centers = kmeans_balanced.fit(res, bal, trainset, n_lists)
    labels = kmeans_balanced.predict(res, bal, xp32, centers)
    sizes = torch.bincount(labels, minlength=n_lists)
    cap = max(-(-int(sizes.max()) // 8) * 8, 8)
    t0 = _stage(stages, "kmeans", t0, dev)

    mean = max(n / n_lists, 1.0)
    t = min(n_lists,
            max(p.build_n_probes, -(-p.build_candidates // int(mean))))
    expects(kg <= t * cap, "cagra.build: candidate pool smaller than "
            "intermediate degree — raise build_n_probes/build_candidates")
    P_proj, P_sq, P_id = _build_layout(xf, xp32, labels, n_lists, cap)
    del xp32
    nbrs = _center_neighbors(centers, t, ip_metric)
    t0 = _stage(stages, "layout", t0, dev)

    # lists per block: the (LB, cap, t*cap) f32 distances and products
    # within the chunk budget
    LB = max(1, min(n_lists, _chunk_budget(dev) // (cap * t * cap * 8)))
    knn = torch.full((n, kg), -1, dtype=torch.int32, device=dev)
    for s in range(0, n_lists, LB):
        ids = torch.arange(s, min(s + LB, n_lists), device=dev)
        out = _scan_chunk(P_proj, P_sq, P_id, nbrs, ids, cap, kg, ip_metric)
        rows = P_id[ids].reshape(-1)
        live = rows >= 0
        knn[rows[live].long()] = out.reshape(-1, kg)[live]
    del P_proj, P_sq, P_id
    t0 = _stage(stages, "scan", t0, dev)

    rev = _reverse_edges_auto(knn, n, min(kg, 64))
    t0 = _stage(stages, "reverse_edges", t0, dev)
    knn_d = None
    if walk:
        for r in range(p.build_walk_rounds):
            knn, knn_d = _graph_refine_round(
                res, dataset, knn, kg, p.metric, pdim, p.build_walk_iters,
                knn_d=knn_d, extra=rev if r == 0 else None, vecs=vecs)
            t0 = _stage(stages, f"walk_refine_{r}", t0, dev)
    else:
        for r in range(max(p.build_reverse_rounds, 1)):
            if r > 0:
                rev = _reverse_edges_auto(knn, n, min(kg, 64))
            knn, knn_d = _merge_refine_chunked(xf, knn, rev, kg, ip_metric,
                                               with_d=True)
            t0 = _stage(stages, f"reverse_merge_{r}", t0, dev)
    return knn


def _reverse_edges(fwd, n: int, rev_cap: int):
    """Reverse-edge lists: node j collects every i with an edge i -> j into
    up to ``rev_cap`` slots, strongest (lowest rank) first, -1 beyond — one
    stable sort of the rank-major edge list by destination."""
    half = fwd.shape[1]
    dev = fwd.device
    dst = fwd.T.reshape(-1).long()
    src = torch.arange(n, device=dev).repeat(half)
    dsts, order = torch.sort(dst, stable=True)
    srcs = src[order]
    e = dsts.shape[0]
    nodes = torch.arange(n, device=dev)
    starts = torch.searchsorted(dsts, nodes)
    counts = torch.searchsorted(dsts, nodes, right=True) - starts
    slot = torch.arange(rev_cap, device=dev)
    rev = srcs[(starts[:, None] + slot[None, :]).clamp(0, e - 1)]
    valid = slot[None, :] < counts[:, None]
    return torch.where(valid, rev, torch.full_like(rev, -1)).int()


def _reverse_edges_host(fwd: np.ndarray, n: int, rev_cap: int) -> np.ndarray:
    """Host twin of :func:`_reverse_edges` (numpy)."""
    kg = fwd.shape[1]
    dst = fwd.T.ravel()
    src = np.tile(np.arange(n, dtype=np.int32), kg)
    order = np.argsort(dst, kind="stable")
    dsts, srcs = dst[order], src[order]
    starts = np.searchsorted(dsts, np.arange(n))
    counts = np.searchsorted(dsts, np.arange(n), side="right") - starts
    idx = starts[:, None] + np.arange(rev_cap)[None, :]
    rev = srcs[np.clip(idx, 0, dsts.shape[0] - 1)]
    valid = np.arange(rev_cap)[None, :] < counts[:, None]
    return np.where(valid, rev, -1).astype(np.int32)


def _reverse_edges_auto(knn, n: int, rev_cap: int):
    """Reverse edges from the top-``_REV_SRC_CAP`` forward columns, on the
    device or, past ``_REV_HOST_EDGES`` edges, on the host."""
    kg = min(knn.shape[1], _REV_SRC_CAP)
    if n * kg <= _REV_HOST_EDGES:
        return _reverse_edges(knn[:, :kg], n, rev_cap)
    return torch.from_numpy(_reverse_edges_host(
        knn[:, :kg].cpu().numpy(), n, rev_cap)).to(knn.device)


# ---------------------------------------------------------------------------
# build: refinement rounds
# ---------------------------------------------------------------------------

def _merge_refine_chunked(xf, first, second, kg: int, ip_metric: bool,
                          chunk: int = 0, first_d=None, with_d=False):
    """Exact re-rank of [first | second] candidate ids per node.  With
    ``first_d`` (first's exact keys), each row of (first, first_d) must be
    sorted by key and duplicate-free: only ``second`` is scored, and it
    merges into the sorted ``first`` — checked on the host when
    ``_DEBUG_CHECKS`` is on."""
    if _DEBUG_CHECKS and first_d is not None:
        fd = first_d.double()
        expects(bool((torch.diff(fd, dim=1) >= 0).all()),
                "cagra._merge_refine_chunked: first_d rows must be "
                "sorted non-decreasing (fast-path precondition)")
        srt, _ = torch.sort(first, dim=1)
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        expects(not bool(dup.any()),
                "cagra._merge_refine_chunked: first rows must be "
                "duplicate-free (fast-path precondition)")
    return _merge_refine_chunked_impl(xf, first, second, kg, ip_metric,
                                      chunk, first_d, with_d)


def _merge_refine_chunked_impl(xf, first, second, kg: int, ip_metric: bool,
                               chunk: int = 0, first_d=None, with_d=False):
    """Chunked body of :func:`_merge_refine_chunked`: without ``first_d``
    :func:`_rerank_rows`; with it, ``second``'s rows (bf16, exact products,
    fp32 sums) are scored and merged into the sorted ``first`` by
    :func:`raft_tpu_torch.ops.cagra_hop.cagra_hop` — the hop with the full
    rows as its vectors and a zero query norm (Kernel I on the card)."""
    n, dim = xf.shape
    dev = xf.device
    xb = xf.to(torch.bfloat16)
    x_sq = (xf * xf).sum(1)
    m = first.shape[1] + second.shape[1]
    chunk = chunk or _rows_per_chunk(dev, m * dim * 12)
    if first_d is not None:
        _require_hop(min(chunk, n), kg, second.shape[1], dim)
    out = torch.empty(n, kg, dtype=torch.int32, device=dev)
    outd = torch.empty(n, kg, dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        if first_d is None:
            out[s:e], outd[s:e] = _rerank_rows(
                xb, x_sq, xb[s:e], first[s:e], second[s:e], kg, ip_metric)
            continue
        sec = second[s:e].int()
        valid = sec >= 0
        safe = torch.where(valid, sec, torch.zeros_like(sec)).long()
        bd, bi, _ = _hop.cagra_hop(
            xb[s:e], torch.zeros(e - s, device=dev), xb[safe], x_sq[safe],
            torch.where(valid, sec, torch.full_like(sec, -1)),
            first_d[s:e], first[s:e].int(),
            torch.zeros(e - s, first.shape[1], dtype=torch.bool, device=dev),
            ip_metric=ip_metric)
        out[s:e], outd[s:e] = bi, bd
    return (out, outd) if with_d else out


def _rerank_rows(dataset, x_sq_all, qf, old, cand, kg: int, ip_metric: bool):
    """Exact rerank of [old | cand] ids for a chunk of self-queries:
    duplicates keep their FIRST occurrence, bf16 rows and query, fp32
    sums, the best ``kg`` by (key, position).  (ids, keys)."""
    c = torch.cat([old.int(), cand.int()], 1)
    valid = c >= 0
    safe = torch.where(valid, c, torch.zeros_like(c)).long()
    dup = row_duplicate_mask(c)
    rows = _f32_bf16(dataset[safe])
    ip = torch.bmm(rows, _f32_bf16(qf)[:, :, None])[:, :, 0]
    d = -ip if ip_metric else x_sq_all[safe] - 2.0 * ip
    d = torch.where(valid & ~dup, d, torch.full_like(d, float("inf")))
    nd, pos = _topk_smallest(d, kg)
    return torch.gather(c, 1, pos), nd


def _walk_chunk_body(qf, ids_c, table, proj, scales, itopk: int, iters: int,
                     search_width: int, ip_metric: bool, deg: int,
                     quant: bool):
    """Warm-seeded walk for a chunk of self-queries: the buffer seeded from
    each node's OWN packed row (the node pre-marked visited), then
    ``iters`` hops, each on :func:`raft_tpu_torch.ops.cagra_hop.cagra_hop`.
    (chunk, itopk) candidate ids, best first by the projected key."""
    chunk = qf.shape[0]
    pdim = proj.shape[1]
    q_sq, _, qp = _query_side(qf, proj, quant, scales)
    dev = qf.device

    ones = torch.ones(chunk, 1, dtype=torch.bool, device=dev)
    nb_p, nb_sq, i0 = _expand(table, ids_c[:, None].int(), ones, deg, pdim,
                              quant, scales)
    ipx = torch.bmm(nb_p.float(), _f32_bf16(qp)[:, :, None])[:, :, 0]
    d0 = -ipx if ip_metric else (q_sq[:, None] + nb_sq) - 2.0 * ipx
    if d0.shape[1] < itopk:
        pad = itopk - d0.shape[1]
        d0 = torch.cat([d0, torch.full((chunk, pad), float("inf"),
                                       device=dev)], 1)
        i0 = torch.cat([i0, torch.full((chunk, pad), -1, dtype=torch.int32,
                                       device=dev)], 1)
    buf_d, pos = _topk_smallest(d0, itopk)
    buf_i = torch.gather(i0, 1, pos)
    buf_i = torch.where(torch.isinf(buf_d), torch.full_like(buf_i, -1),
                        buf_i)
    visited = buf_i == ids_c[:, None]
    for _ in range(iters):
        sel_ids, parent_ok, visited = _select_parents(buf_d, buf_i, visited,
                                                      search_width)
        nb_p, nb_sq, nb_id = _expand(table, sel_ids, parent_ok, deg, pdim,
                                     quant, scales)
        buf_d, buf_i, visited = _hop.cagra_hop(
            qp, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited,
            ip_metric=ip_metric)
    return buf_i


def _self_walk_chunked(dataset, table, proj, itopk: int, iters: int,
                       search_width: int, metric: int, deg: int,
                       chunk: int = 8192, quant: bool = False, scales=None):
    """:func:`_walk_chunk_body` with queries = the dataset itself, over
    node chunks: (n, itopk) candidate ids."""
    n = dataset.shape[0]
    _require_hop(min(chunk, n), itopk, search_width * deg, proj.shape[1])
    ip_metric = metric == DistanceType.InnerProduct
    out = torch.empty(n, itopk, dtype=torch.int32, device=dataset.device)
    for s in range(0, n, chunk):
        ids_c = torch.arange(s, min(s + chunk, n), device=dataset.device)
        out[s:s + chunk] = _walk_chunk_body(
            dataset[ids_c].float(), ids_c, table, proj, scales, itopk, iters,
            search_width, ip_metric, deg, quant)
    return out


def _refine_itopk(kg: int) -> int:
    """A refinement round's walk buffer: ~kg + 25% slack, a multiple of
    32 in [64, 256]."""
    return min(max(-(-(kg + 16) // 32) * 32, 64), 256)


def _graph_refine_round(res, dataset, knn, kg: int, metric: int, pdim: int,
                        iters: int, itopk: int = 0, knn_d=None, extra=None,
                        vecs=None):
    """One walk-refinement round: pack the graph's best edges into a walk
    table, self-walk every node, exact-rerank [knn | walk buffer (|
    extra)].  Monotone; returns (knn, exact keys)."""
    itopk = itopk or _refine_itopk(kg)
    ip_metric = metric == DistanceType.InnerProduct
    n = dataset.shape[0]
    xf = dataset.float()
    plan = _table_plan(n, kg, pdim, _WALK_TABLE_MAX_BYTES)
    if plan is None:
        second = extra if extra is not None else knn[:, :1]
        return _merge_refine_chunked(xf, knn, second, kg, ip_metric,
                                     first_d=knn_d, with_d=True)
    table, proj, scales, q = _build_refine_table(dataset, knn, plan, vecs)
    cand = _self_walk_chunked(dataset, table, proj, itopk, iters, 1, metric,
                              plan[0], quant=q, scales=scales)
    del table
    if extra is not None:
        cand = torch.cat([cand, extra.int()], 1)
    return _merge_refine_chunked(xf, knn, cand, kg, ip_metric, first_d=knn_d,
                                 with_d=True)


def build_knn_graph(res, dataset, intermediate_degree: int, *,
                    params: Optional[IndexParams] = None,
                    batch: int = 8192) -> torch.Tensor:
    """All-nodes kNN graph (reference: cagra.cuh:77), (n,
    intermediate_degree) int32 with self-edges removed: the exact pass up
    to ``_BRUTE_BUILD_MAX`` rows, the clustered pass above.  Its stage
    seconds land in ``build.stage_seconds``."""
    with precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        expects(dataset.ndim == 2 and dataset.shape[0] > 0,
                "cagra.build_knn_graph: non-empty 2-D dataset required")
        n = dataset.shape[0]
        p = params or IndexParams()
        kg = min(intermediate_degree + 1, n)
        stages = build.stage_seconds = {}
        build.build_pdim = None
        if n <= _BRUTE_BUILD_MAX:
            t0 = _stage(stages, None, time.perf_counter(), dataset.device)
            knn = _knn_graph_exact(dataset, kg, p.metric,
                                   chunk=min(batch, 4096))
            _stage(stages, "knn_exact", t0, dataset.device)
        else:
            knn = _build_knn_graph_clustered(res, dataset, kg, p, stages)
        # drop self-edges: stable partition, non-self first
        is_self = knn == torch.arange(n, device=knn.device,
                                      dtype=knn.dtype)[:, None]
        order = torch.argsort(is_self.to(torch.uint8), dim=1, stable=True)
        knn = torch.gather(knn, 1, order)
        return knn[:, :intermediate_degree].int()


# ---------------------------------------------------------------------------
# prune
# ---------------------------------------------------------------------------

def _detour_chunk(knn_graph, kb):
    """Detour-order a block of node rows ``kb`` (B, deg): edge r of node i
    is detourable through every r' < r whose adjacency holds knn[i, r];
    edges ordered by (detour count, rank).  Membership is one sort of each
    first hop's adjacency row and a batched ``searchsorted`` (the JAX
    package's sorted-merge form exists for the TPU, where searchsorted
    lowers to serial gathers; the counts are the same)."""
    n, deg = knn_graph.shape
    dev = knn_graph.device
    srt, _ = torch.sort(knn_graph[kb.clamp(0, n - 1).long()], dim=2)
    keys = kb[:, None, :].expand(-1, deg, -1).contiguous()  # (B, rp, r)
    pos = torch.searchsorted(srt, keys).clamp_max(deg - 1)
    member = torch.gather(srt, 2, pos) == keys
    rank = torch.arange(deg, device=dev)
    stronger = rank[:, None] < rank[None, :]                 # rp < r
    detours = (member & stronger[None]).sum(1)               # (B, deg)
    order = torch.argsort(detours * deg + rank[None, :], dim=1)
    return torch.gather(kb, 1, order)


def _detour_order(knn_graph, block: int = 0):
    """Rank-based detour ordering (graph_core.cuh:415 ``prune``), blocked
    over node rows sized by device memory."""
    n, deg = knn_graph.shape
    block = block or _rows_per_chunk(knn_graph.device, deg * deg * 24,
                                     hi=1 << 20)
    return torch.cat([_detour_chunk(knn_graph, knn_graph[s:s + block])
                      for s in range(0, n, block)], 0)


def prune(res, knn_graph, graph_degree: int) -> torch.Tensor:
    """Prune an intermediate kNN graph to ``graph_degree`` with detour
    counting + reverse-edge fill (reference: cagra.cuh:109 ``prune``)."""
    knn_graph = ensure_tensor(knn_graph, res, "knn_graph").int()
    n, deg = knn_graph.shape
    expects(graph_degree <= deg,
            "cagra.prune: graph_degree > intermediate degree")
    ordered = _detour_order(knn_graph)
    half = (max(graph_degree // 2, 1) if graph_degree < deg
            else graph_degree)
    fwd = ordered[:, :half]
    if half == graph_degree:
        return fwd.contiguous()
    rev_cap = graph_degree - half
    rev = _reverse_edges(fwd, n, rev_cap)
    # leftover slots: the next-best pruned-out forward edges
    cand = torch.cat([rev, ordered[:, half:half + rev_cap]], 1)
    sel = torch.argsort((cand < 0).to(torch.uint8), dim=1,
                        stable=True)[:, :rev_cap]
    return torch.cat([fwd, torch.gather(cand, 1, sel)], 1)


def build(res, params: IndexParams, dataset, *, checkpoint=None,
          resume: bool = False) -> Index:
    """Full CAGRA build (reference: cagra.cuh ``build`` = build_knn_graph +
    prune).  Stage seconds land in ``build.stage_seconds`` and the scan's
    projected dimension in ``build.build_pdim`` (None on the exact
    path)."""
    if checkpoint is not None or resume:
        raise _not_ported("checkpoint= / resume=", "checkpointing")
    if params.canary_queries > 0:
        raise _not_ported("canary_queries > 0", "canaries")
    with precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        knn = build_knn_graph(res, dataset, params.intermediate_graph_degree,
                              params=params)
        stages = build.stage_seconds
        t0 = _stage(stages, None, time.perf_counter(), dataset.device)
        graph = prune(res, knn, params.graph_degree)
        _stage(stages, "prune", t0, dataset.device)
        return Index(dataset=dataset, graph=graph, metric=params.metric)


# wall seconds of the latest build's stages (each ends with a device
# synchronisation) and the clustered pass's projected dimension
build.stage_seconds = {}
build.build_pdim = None


# ---------------------------------------------------------------------------
# carrying an index across; paths not ported yet
# ---------------------------------------------------------------------------

def index_from_numpy(dataset, graph, metric: int = DistanceType.L2Expanded,
                     *, device="cuda") -> Index:
    """The port's :class:`Index` from numpy arrays, e.g. ``np.asarray`` of
    a ``raft_tpu`` index's ``dataset`` and ``graph``; see
    :func:`attach_walk_cache` to carry its walk cache too."""
    def tensor(a):
        return torch.from_numpy(_writable(np.asarray(a))).to(device)

    return Index(dataset=tensor(dataset).float(), graph=tensor(graph).int(),
                 metric=metric)


def delete(res, index: Index, ids) -> Index:
    raise _not_ported("delete", "mutation")


def serialize(res, stream, index: Index) -> None:
    raise _not_ported("serialize", "serialization")


def deserialize(res, stream) -> Index:
    raise _not_ported("deserialize", "serialization")


def save(res, filename: str, index: Index, **kwargs) -> None:
    raise _not_ported("save", "serialization")


def load(res, filename: str, **kwargs) -> Index:
    raise _not_ported("load", "serialization")

"""Exact k-nearest-neighbour search (port of
``raft_tpu.neighbors.brute_force.knn``) — the ground truth for recall.

Reference: raft/neighbors/brute_force.cuh:150 ``knn``.  Tiled over the
database: each (n_queries, tile_n) distance block is one fp32 product, its
local top-k merges into the running top-k, so peak memory is
O(n_queries · tile_n).  Plain PyTorch; the JAX version has no Pallas
kernel.  Metrics: those :func:`~raft_tpu_torch.distance.pairwise_distance`
computes (the L2 family, InnerProduct and CosineExpanded; the L2 family
scored expanded); the others raise ``NotImplementedError``.  As in the JAX
package, the running top-k starts as k slots of ``(worst, -1)`` and each
tile keeps ``min(k, tile_n)``, so any ``tile_n`` works.  The queries
pass the boundary validator (:mod:`raft_tpu_torch.integrity.boundary`):
under ``mask`` a non-finite query row returns the worst
distance and id -1.  ``filter=`` admits rows by GLOBAL id (after the
``global_id_offset`` shift, so one filter covers a row-partitioned id
space); a query with fewer admitted rows than k gets ``(worst, -1)`` on
the rest.  ``knn_merge_parts`` merges the results of row-partitioned
parts.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.outputs import auto_convert_output, raw
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import as_tensor, ensure_tensor
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType, L2_METRICS, SQRT_METRICS
from raft_tpu_torch.filters.bitset import (BITS_PER_WORD, query_filter_words,
                                           words_on_device)
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.utils import precision

_TILE_N = 65536


def _tile_admission(fw: torch.Tensor, gid0: int, n: int) -> torch.Tensor:
    """The admission bits (nq, n) — (1, n) for a broadcast row — of global
    ids ``gid0 .. gid0 + n`` under the packed words ``fw``; ids past the
    words' coverage are not admitted."""
    if fw.shape[0] > 1 and fw.stride(0) == 0:
        fw = fw[:1]
    gids = gid0 + torch.arange(n, device=fw.device)
    col = torch.clamp_max(gids >> 5, fw.shape[1] - 1)
    bits = (fw.index_select(1, col) >> (gids & 31).to(torch.int32)) & 1
    return (bits > 0) & (gids < fw.shape[1] * BITS_PER_WORD)[None, :]


def _tile_scores(metric, qf, q_sq, tile):
    """The (nq, tile rows) distances of one tile at ``metric``."""
    ip = qf @ tile.T
    if metric == DistanceType.InnerProduct:
        return ip
    t_sq = (tile * tile).sum(1)
    if metric == DistanceType.CosineExpanded:
        denom = torch.sqrt(q_sq) * torch.sqrt(t_sq)[None, :]
        return 1.0 - ip / torch.clamp_min(denom, 1e-30)
    d = torch.clamp_min(q_sq + t_sq[None, :] - 2.0 * ip, 0.0)
    return torch.sqrt(d) if metric in SQRT_METRICS else d


@auto_convert_output
def knn(res, database, queries, k: int, *,
        metric: int = DistanceType.L2Unexpanded, metric_arg: float = 2.0,
        global_id_offset: int = 0, tile_n: int = _TILE_N, filter=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``queries`` (q, d) in ``database`` (n, d): (distances
    (q, k) f32, indices (q, k) int32), best first, equal distances in id
    order; ``global_id_offset`` shifts the returned ids.  ``metric_arg``
    is the Minkowski p of a metric not ported yet.  ``filter`` (a
    :class:`~raft_tpu_torch.filters.SampleFilter` or (q, n) bool mask)
    admits rows by global id; slots with no admitted row left are
    ``(worst, -1)``."""
    with named_range("brute_force::knn"), precision.highest():
        database = ensure_tensor(database, res, "database")
        queries = ensure_tensor(queries, res, "queries")
        expects(database.ndim == 2 and queries.ndim == 2
                and database.shape[1] == queries.shape[1],
                "knn: (n,d) database and (q,d) queries required")
        expects(0 < k <= database.shape[0], "knn: need 0 < k <= n")
        expects(tile_n > 0, "knn: tile_n must be positive")
        metric = DistanceType(metric)
        if not (metric in L2_METRICS or metric in (
                DistanceType.InnerProduct, DistanceType.CosineExpanded)):
            raise not_ported("brute_force.knn", f"metric {metric.name}",
                             "the other pairwise metrics (item 15)")
        queries, ok_rows = boundary.check_matrix(
            queries, "queries", site="brute_force.knn",
            dim=database.shape[1])
        select_min = metric != DistanceType.InnerProduct
        worst = float("inf") if select_min else float("-inf")
        fw = query_filter_words(filter, queries.shape[0], "brute_force.knn")
        if fw is not None:
            fw = words_on_device(fw, queries.device)
        qf = queries.float()
        q_sq = (qf * qf).sum(1, keepdim=True)
        nq = queries.shape[0]
        best_d = torch.full((nq, k), worst, dtype=torch.float32,
                            device=qf.device)
        best_i = torch.full((nq, k), -1, dtype=torch.int64, device=qf.device)
        for s in range(0, database.shape[0], tile_n):
            tile = database[s:s + tile_n].float()
            d = _tile_scores(metric, qf, q_sq, tile)
            if fw is not None:
                d = torch.where(_tile_admission(fw, global_id_offset + s,
                                                tile.shape[0]),
                                d, torch.full_like(d, worst))
            td, ti = raw(select_k)(d, min(k, tile.shape[0]),
                                   select_min=select_min)
            # the running entries first: on a tie they keep their place
            best_d, pos = raw(select_k)(torch.cat([best_d, td], 1), k,
                                        select_min=select_min)
            best_i = torch.gather(torch.cat([best_i, ti + s], 1), 1, pos)
        if fw is not None:
            # a query can run out of admitted rows: the (worst, -1)
            # sentinel, never a positional id
            best_i = torch.where(best_d == worst, torch.full_like(best_i, -1),
                                 best_i)
        # -1 marks a slot no row reached; keep it
        best_i = torch.where(best_i >= 0, best_i + global_id_offset, best_i)
        return boundary.mask_search_outputs(
            best_d, best_i.int(), ok_rows, select_min=select_min)


@auto_convert_output
def knn_merge_parts(in_keys, in_values, *, n_samples=None,
                    translations=None, select_min: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge kNN results of row-partitioned database parts (reference:
    neighbors/brute_force.cuh:80 ``knn_merge_parts``): ``in_keys`` /
    ``in_values`` (n_parts, q, k) distances / part-local ids; part p's ids
    are shifted by ``translations[p]`` (default ``p * n_samples``, the
    reference's uniform partition), then each query keeps the top k of the
    union.  Ids keep ``in_values``' dtype.  Tensors stay where they are;
    numpy inputs go to a tensor input's device, else to the card."""
    dev = next((t.device for t in (in_keys, in_values)
                if isinstance(t, torch.Tensor)), None)
    in_keys, in_values = as_tensor(in_keys, dev), as_tensor(in_values, dev)
    expects(in_keys.ndim == 3 and in_values.shape == in_keys.shape,
            "knn_merge_parts: (n_parts, q, k) inputs required")
    n_parts, nq, k = in_keys.shape
    idx_t = in_values.dtype
    if idx_t.is_floating_point or idx_t == torch.bool:
        # the JAX package's np.iinfo refuses a non-integer id dtype
        raise ValueError(f"knn_merge_parts: integer ids required, got "
                         f"{idx_t}")
    if translations is None:
        expects(n_samples is not None,
                "knn_merge_parts: need n_samples or translations")
        expects((n_parts - 1) * int(n_samples)
                <= torch.iinfo(idx_t).max,
                "knn_merge_parts: global ids overflow the index dtype; pass "
                "int64 in_values or explicit translations")
        translations = torch.arange(n_parts, dtype=idx_t,
                                    device=in_values.device) * n_samples
    else:
        translations = torch.as_tensor(translations).to(
            device=in_values.device, dtype=idx_t)
    ids = in_values + translations[:, None, None]
    keys = in_keys.permute(1, 0, 2).reshape(nq, n_parts * k)
    vals = ids.permute(1, 0, 2).reshape(nq, n_parts * k)
    return raw(select_k)(keys, k, in_idx=vals, select_min=select_min)


def tiled_brute_force_knn(res, database, queries, k: int, **kw
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alias for :func:`knn` (reference: detail/knn_brute_force.cuh
    ``tiled_brute_force_knn``; tiling is always on here)."""
    return knn(res, database, queries, k, **kw)

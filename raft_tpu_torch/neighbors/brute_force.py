"""Exact k-nearest-neighbour search (port of
``raft_tpu.neighbors.brute_force.knn``) — the ground truth for recall.

Reference: raft/neighbors/brute_force.cuh:150 ``knn``.  Tiled over the
database: each (n_queries, tile_n) distance block is one fp32 product, its
local top-k merges into the running top-k, so peak memory is
O(n_queries · tile_n).  Plain PyTorch; the JAX version has no Pallas
kernel.  Metrics of this slice: the L2 family and InnerProduct.  The
queries pass the boundary validator (:mod:`raft_tpu_torch.integrity.
boundary`): under ``mask`` a non-finite query row returns the worst
distance and id -1.  ``knn_merge_parts`` is not ported yet (ROADMAP.md
§1 item 5).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.outputs import auto_convert_output, raw
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.distance.types import DistanceType, L2_METRICS, SQRT_METRICS
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.utils import precision

_TILE_N = 65536


@auto_convert_output
def knn(res, database, queries, k: int, *,
        metric: int = DistanceType.L2Unexpanded, global_id_offset: int = 0,
        tile_n: int = _TILE_N) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``queries`` (q, d) in ``database`` (n, d): (distances
    (q, k) f32, indices (q, k) int32), best first; ``global_id_offset``
    shifts the returned ids."""
    with precision.highest():
        database = ensure_tensor(database, res, "database")
        queries = ensure_tensor(queries, res, "queries")
        expects(database.ndim == 2 and queries.ndim == 2
                and database.shape[1] == queries.shape[1],
                "knn: (n,d) database and (q,d) queries required")
        expects(0 < k <= database.shape[0], "knn: need 0 < k <= n")
        expects(tile_n >= k, "knn: tile_n must be at least k")
        expects(metric in L2_METRICS or metric == DistanceType.InnerProduct,
                "knn: L2 / InnerProduct metrics only in this port slice")
        queries, ok_rows = boundary.check_matrix(
            queries, "queries", site="brute_force.knn",
            dim=database.shape[1])
        select_min = metric != DistanceType.InnerProduct
        qf = queries.float()
        q_sq = (qf * qf).sum(1, keepdim=True)
        best_d = best_i = None
        for s in range(0, database.shape[0], tile_n):
            tile = database[s:s + tile_n].float()
            ip = qf @ tile.T
            if select_min:
                d = torch.clamp_min(q_sq + (tile * tile).sum(1)[None, :]
                                    - 2.0 * ip, 0.0)
            else:
                d = ip
            td, ti = raw(select_k)(d, min(k, tile.shape[0]),
                              select_min=select_min)
            ti = ti + s
            if best_d is not None:
                td = torch.cat([best_d, td], 1)
                ti = torch.cat([best_i, ti], 1)
                td, pos = raw(select_k)(td, k, select_min=select_min)
                ti = torch.gather(ti, 1, pos)
            best_d, best_i = td, ti
        if metric in SQRT_METRICS:
            best_d = torch.sqrt(best_d)
        return boundary.mask_search_outputs(
            best_d, (best_i + global_id_offset).int(), ok_rows,
            select_min=select_min)


def knn_merge_parts(in_keys, in_values, *, n_samples=None,
                    translations=None, select_min: bool = True):
    raise not_ported("brute_force", "knn_merge_parts", "primitives")


def tiled_brute_force_knn(res, database, queries, k: int, **kw
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alias for :func:`knn` (reference: detail/knn_brute_force.cuh
    ``tiled_brute_force_knn``; tiling is always on here)."""
    return knn(res, database, queries, k, **kw)

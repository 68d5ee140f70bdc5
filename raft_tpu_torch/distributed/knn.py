"""Multi-device (MNMG) brute-force kNN (port of ``raft_tpu.distributed.
knn``).

The reference's scale-out seam: shard the database row-wise, per-shard
exact kNN, then merge with per-part id translations (``knn_merge_parts``,
neighbors/brute_force.cuh:80 — SURVEY.md §5: shard → local select_k →
allgather → merge-select).

One process a rank: each rank moves only its rows to its device and
searches them with :func:`raft_tpu_torch.neighbors.brute_force.knn` (tiled,
so no rank holds a (q, n/size) distance matrix), the (q, k) candidates
are allgathered, and every rank selects the same merged top k.  As in the
JAX package, InnerProduct selects the largest; every other metric is
scored as L2 expanded, the square root taken after the merge for the two
sqrt metrics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import brute_force


def shard_rows(n: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows ``[lo, hi)`` of ``n`` split evenly over
    ``size`` ranks."""
    per = n // size
    return rank * per, (rank + 1) * per


def knn(handle, database, queries, k: int, *,
        metric: int = DistanceType.L2Expanded
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded exact kNN over the handle's communicator: ``database`` is
    the whole (n, d) array on every rank (numpy, or a tensor on the CPU
    or the rank's device), of which each rank searches its
    ``shard_rows``; returns (distances (q, k) f32, global ids (q, k)
    int32), the same on every rank."""
    with named_range("distributed::knn"):
        expects(handle.comms_initialized(),
                "distributed.knn: handle has no comms (use "
                "CommsSession.worker_handle())")
        comms = handle.get_comms()
        n = database.shape[0]
        n_dev = comms.get_size()
        expects(n % n_dev == 0,
                f"distributed.knn: n ({n}) must divide evenly over "
                f"{n_dev} devices (pad the input)")
        expects(k <= n // n_dev,
                "distributed.knn: k must be <= rows per shard")
        lo, hi = shard_rows(n, n_dev, comms.get_rank())
        shard = ensure_tensor(database[lo:hi], handle, "database")
        queries = ensure_tensor(queries, handle, "queries")
        select_min = metric != DistanceType.InnerProduct
        local = (DistanceType.L2Expanded if select_min
                 else DistanceType.InnerProduct)
        ld, li = raw(brute_force.knn)(handle, shard, queries, k,
                                      metric=local, global_id_offset=lo)
        nq = queries.shape[0]
        all_d = comms.allgather(ld)                 # (n_dev, q, k)
        all_i = comms.allgather(li)
        md, mi = raw(select_k)(
            all_d.permute(1, 0, 2).reshape(nq, -1), k,
            in_idx=all_i.permute(1, 0, 2).reshape(nq, -1),
            select_min=select_min)
        if metric in (DistanceType.L2SqrtExpanded,
                      DistanceType.L2SqrtUnexpanded):
            md = torch.sqrt(torch.clamp_min(md, 0.0))
        return md, mi.int()

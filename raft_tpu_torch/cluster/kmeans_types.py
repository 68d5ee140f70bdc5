"""k-means parameter structs (port of ``raft_tpu.cluster.kmeans_types``).

Reference: raft/cluster/kmeans_balanced_types.hpp
(``kmeans_balanced_params``).  Same fields and defaults as the JAX package.
"""

from __future__ import annotations

import dataclasses

from raft_tpu_torch.distance.types import DistanceType


@dataclasses.dataclass
class KMeansBalancedParams:
    """``metric`` must be L2Expanded or InnerProduct (as the reference)."""

    n_iters: int = 20
    metric: int = DistanceType.L2Expanded

"""k-means parameter structs (port of ``raft_tpu.cluster.kmeans_types``).

Reference: raft/cluster/kmeans_types.hpp (``KMeansParams``) and
raft/cluster/kmeans_balanced_types.hpp (``kmeans_balanced_params``).  Same
fields and defaults as the JAX package.
"""

from __future__ import annotations

import dataclasses

from raft_tpu_torch.distance.types import DistanceType


class InitMethod:
    """Reference: kmeans_types.hpp ``InitMethod`` enum."""

    KMeansPlusPlus = 0
    Random = 1
    Array = 2


@dataclasses.dataclass
class KMeansParams:
    """Reference: cluster/kmeans_types.hpp ``KMeansParams``.  ``verbosity``,
    ``oversampling_factor``, ``batch_samples``, ``batch_centroids`` and
    ``inertia_check`` are carried for parity and have no effect here, as in
    the JAX package."""

    n_clusters: int = 8
    init: int = InitMethod.KMeansPlusPlus
    max_iter: int = 300
    tol: float = 1e-4
    verbosity: int = 0
    seed: int = 0
    metric: int = DistanceType.L2Expanded
    n_init: int = 1
    oversampling_factor: float = 2.0
    batch_samples: int = 1 << 15
    batch_centroids: int = 0  # 0 == use all
    inertia_check: bool = False


@dataclasses.dataclass
class KMeansBalancedParams:
    """``metric`` must be L2Expanded or InnerProduct (as the reference)."""

    n_iters: int = 20
    metric: int = DistanceType.L2Expanded

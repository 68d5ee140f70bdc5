"""Distance metric enumeration (port of ``raft_tpu.distance.types``).

Reference: raft/distance/distance_types.hpp:23-70 — the same names and the
same integer values as the JAX package, so metrics stored with an index
mean the same thing in both.
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    """Mirror of ``raft::distance::DistanceType``."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19


L2_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded)
SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)

"""Pairwise distances and the fused L2 1-NN (port of
``raft_tpu.distance``).  ``masked_l2_nn`` and the kernel (gram) matrices
are stand-ins naming their ROADMAP item (*the tail*)."""

from raft_tpu_torch.core.error import not_ported_stub as _stub
from raft_tpu_torch.distance.types import DistanceType  # noqa: F401
from raft_tpu_torch.distance.pairwise import (  # noqa: F401
    distance,
    pairwise_distance,
)
from raft_tpu_torch.distance.fused_l2_nn import (  # noqa: F401
    fused_l2_nn,
    fused_l2_nn_min_reduce,
)

masked_l2_nn = _stub("distance", "masked_l2_nn", "the tail")
KernelParams = _stub("distance", "KernelParams", "the tail")
KernelType = _stub("distance", "KernelType", "the tail")
gram_matrix = _stub("distance", "gram_matrix", "the tail")

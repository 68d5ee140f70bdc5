"""Fused L2 distance + 1-nearest-neighbour argmin (port of
``raft_tpu.distance.fused_l2_nn``).

Reference: raft/distance/fused_l2_nn.cuh:100 ``fusedL2NN`` / :205
``fusedL2NNMinReduce``: for each row of x, the distance and index of its
nearest row of y, without materialising the (m, n) distance matrix — the
k-means and IVF assignment kernel.

On the card both values of ``use_pallas`` launch Kernel H
(:func:`raft_tpu_torch.ops.fused_l2_nn.fused_l2_nn`): the JAX flag picks
between two TPU formulations measured at parity there, and the card has
one.  ``tile_n`` sized the JAX package's XLA scan and is accepted and
ignored.  On the CPU both run the kernel's plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.outputs import auto_convert_output, raw
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_tensor
from raft_tpu_torch.ops import fused_l2_nn as _kernel


@auto_convert_output
def fused_l2_nn(x, y, *, sqrt: bool = False, tile_n: int = 2048,
                use_pallas: bool = False, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x (m, k): ``(min L2² distance (m,) f32, first argmin
    (m,) int32)`` over the rows of y (n, k), the distance clamped at 0 and
    square-rooted when ``sqrt``.  Tensors are used where they are; numpy
    arrays go to ``device`` (the card unless the caller asks for the
    CPU)."""
    x, y = as_tensor(x, device), as_tensor(y, device)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "fused_l2_nn: (m,k),(n,k) inputs required")
    return _kernel.fused_l2_nn(x, y, sqrt)


@auto_convert_output
def fused_l2_nn_min_reduce(x, y, *, sqrt: bool = False, device=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alias matching fused_l2_nn.cuh:205 ``fusedL2NNMinReduce``."""
    return raw(fused_l2_nn)(x, y, sqrt=sqrt, device=device)

"""Batched top-k selection (port of ``raft_tpu.matrix.select_k``).

Reference: raft/matrix/select_k.cuh:78.  Over ``torch.topk(sorted=True)``;
the JAX package's two-pass tiled path exists for the TPU's sort networks
and is not carried over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects


def select_k(in_val: torch.Tensor, k: int, *,
             in_idx: Optional[torch.Tensor] = None,
             select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (or largest) values of each row with their indices,
    sorted ascending when ``select_min`` else descending.  ``in_idx`` is an
    optional per-element payload gathered at the selected positions
    (positions are int64 otherwise)."""
    expects(in_val.ndim == 2, "select_k: (batch, len) input required")
    length = in_val.shape[1]
    expects(0 < k <= length,
            f"select_k: need 0 < k <= len, got k={k}, len={length}")
    if in_idx is not None:
        expects(in_idx.shape == in_val.shape,
                "select_k: in_idx shape mismatch")
    vals, idx = torch.topk(in_val, k, dim=1, largest=not select_min,
                           sorted=True)
    if in_idx is not None:
        idx = torch.gather(in_idx, 1, idx)
    return vals, idx

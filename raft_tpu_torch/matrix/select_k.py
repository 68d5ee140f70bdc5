"""Batched top-k selection (port of ``raft_tpu.matrix.select_k``).

Reference: raft/matrix/select_k.cuh:78.  Over ``torch.topk(sorted=True)``;
the JAX package's two-pass tiled path exists for the TPU's sort networks
and is not carried over.  :func:`merge_topk` is the streaming-selection
step the JAX package shares between its tiled scans.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.outputs import auto_convert_output
from raft_tpu_torch.core.error import expects


@auto_convert_output
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


@auto_convert_output
def merge_topk(best_val: torch.Tensor, best_idx: torch.Tensor,
               new_val: torch.Tensor, new_idx: torch.Tensor, *,
               select_min: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a running (batch, k) top-k with (batch, kt) new candidates:
    concatenate, select k again, gather the payloads (the role
    detail/knn_merge_parts.cuh's kernel plays in the reference).  Ties
    keep the lower position of ``[best | new]``, so a running entry wins
    over an equal new one, as ``lax.top_k`` keeps it."""
    k = best_val.shape[1]
    cat_v = torch.cat([best_val, new_val], 1)
    cat_i = torch.cat([best_idx, new_idx], 1)
    key = cat_v if select_min else -cat_v
    pos = torch.sort(key, dim=1, stable=True).indices[:, :k]
    return torch.gather(cat_v, 1, pos), torch.gather(cat_i, 1, pos)

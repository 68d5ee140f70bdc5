"""All-pairs distances (port of ``raft_tpu.distance.pairwise``, the metrics
the ported paths use).

Reference: raft/distance/distance.cuh:441 ``pairwise_distance`` (runtime
metric dispatch :398) and :70 ``distance``.  The JAX package computes these
outside any Pallas kernel; so does the port, in plain PyTorch with fp32
products (TF32 off).  Ported: L2Expanded, L2SqrtExpanded, L2Unexpanded,
L2SqrtUnexpanded, InnerProduct and CosineExpanded.  The other metrics
raise ``NotImplementedError`` naming ROADMAP.md §1 item 15.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import as_tensor
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.utils import precision

# rows of x per chunk of the unexpanded metrics' (rows, n, k) difference
_UNEXPANDED_ELEMS = 1 << 26


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(1)


def _l2_expanded(x, y):
    return torch.clamp_min(_sq_norms(x)[:, None] + _sq_norms(y)[None, :]
                           - 2.0 * (x @ y.T), 0.0)


def _l2_unexpanded(x, y):
    """Σ (x − y)² elementwise, a chunk of rows of x at a time."""
    out = torch.empty(x.shape[0], y.shape[0], dtype=torch.float32,
                      device=x.device)
    rows = max(1, _UNEXPANDED_ELEMS // max(1, y.numel()))
    for s in range(0, x.shape[0], rows):
        d = x[s:s + rows, None, :] - y[None, :, :]
        out[s:s + rows] = (d * d).sum(-1)
    return out


def _cosine(x, y):
    xn = torch.sqrt(_sq_norms(x))[:, None]
    yn = torch.sqrt(_sq_norms(y))[None, :]
    return 1.0 - (x @ y.T) / torch.clamp_min(xn * yn, 1e-30)


def pairwise_distance(x, y, metric=DistanceType.L2Unexpanded, *,
                      metric_arg: float = 2.0, device=None) -> torch.Tensor:
    """All-pairs distance matrix (m, n) f32 between rows of x (m, k) and y
    (n, k).  ``metric``: a :class:`DistanceType`, its value or a
    pylibraft-style name; ``metric_arg`` (the Minkowski p) belongs to a
    metric not ported yet.  Tensors are used where they are; numpy arrays
    go to ``device`` (the card unless the caller asks for the CPU)."""
    x, y = as_tensor(x, device), as_tensor(y, device)
    expects(x.ndim == 2 and y.ndim == 2, "pairwise_distance: rank-2 inputs")
    expects(x.shape[1] == y.shape[1],
            f"feature dims differ: {x.shape[1]} vs {y.shape[1]}")
    m = resolve_metric(metric)
    xf, yf = x.float(), y.float()
    with precision.highest():
        if m == DistanceType.L2Expanded:
            return _l2_expanded(xf, yf)
        if m == DistanceType.L2SqrtExpanded:
            return torch.sqrt(_l2_expanded(xf, yf))
        if m == DistanceType.L2Unexpanded:
            return _l2_unexpanded(xf, yf)
        if m == DistanceType.L2SqrtUnexpanded:
            return torch.sqrt(_l2_unexpanded(xf, yf))
        if m == DistanceType.CosineExpanded:
            return _cosine(xf, yf)
        if m == DistanceType.InnerProduct:
            return xf @ yf.T
    raise not_ported("pairwise_distance", f"metric {m.name}",
                     "the other pairwise metrics (item 15)")


def distance(x, y, metric=DistanceType.L2Unexpanded, *,
             metric_arg: float = 2.0, device=None) -> torch.Tensor:
    """The compile-time-metric flavour (reference: distance.cuh:70
    ``distance<T>``); identical here."""
    return pairwise_distance(x, y, metric, metric_arg=metric_arg,
                             device=device)

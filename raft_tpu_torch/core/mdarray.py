"""Tensor ingestion (port of ``raft_tpu.core.mdarray.ensure_array``).

The port has no boundary validator yet (``raft_tpu.integrity.boundary`` is
a later slice): inputs are checked for rank and shape by the entry points,
not for finiteness.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.error import expects


def ensure_tensor(x, res, name: str = "array") -> torch.Tensor:
    """numpy array or tensor in, tensor on ``res.device`` out.

    A CPU tensor or numpy array moves to the handle's device; a CUDA
    tensor is never moved to the CPU — handing one to a CPU handle
    raises."""
    if isinstance(x, torch.Tensor):
        if x.device == res.device:
            return x
        expects(x.device.type != "cuda" or res.device.type == "cuda",
                f"{name}: CUDA tensor passed to a handle on {res.device}")
        return x.to(res.device)
    return torch.from_numpy(_writable(x)).to(res.device)


def _writable(x) -> np.ndarray:
    """A contiguous numpy array torch may wrap: read-only arrays (e.g.
    views of another framework's buffers) are copied."""
    a = np.ascontiguousarray(np.asarray(x))
    return a if a.flags.writeable else a.copy()

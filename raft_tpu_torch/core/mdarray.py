"""Tensor ingestion and array contracts (port of ``raft_tpu.core.mdarray``).

The entry points check rank, shape and finiteness through
:mod:`raft_tpu_torch.integrity.boundary`.  The contract checkers
(``check_rank`` / ``check_matrix`` / ``check_vector`` / ``check_same_*``)
and the ``make_device_*`` factories keep the reference's names, arguments
and errors (:class:`~raft_tpu_torch.core.error.LogicError`, the same
messages); a ``dtype`` may be a torch dtype or anything ``numpy.dtype``
reads.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import expects

ArrayLike = Union[torch.Tensor, np.ndarray]

# Layout tags for API parity (reference: layout_c_contiguous /
# layout_f_contiguous); they document logical index order only.
row_major = "row_major"
col_major = "col_major"


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


def as_tensor(x, device=None) -> torch.Tensor:
    """For the entry points without a handle: a tensor stays where it is;
    a numpy array moves to ``device``, the card unless the caller asks for
    the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(_writable(x)).to(device or "cuda")


def ensure_array(x, name: str = "array", device=None) -> torch.Tensor:
    """Any array-like as a tensor (the reference's ``ensure_array``): a
    tensor stays where it is; anything else goes through numpy to
    ``device``, the card unless the caller asks for the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    return as_tensor(np.asarray(x), device)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = "bfloat16" if str(dtype) == "bfloat16" else np.dtype(dtype).name
    return getattr(torch, name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_rank(x: torch.Tensor, rank: int, name: str = "array") -> None:
    expects(x.ndim == rank, f"{name}: expected rank {rank}, got {x.ndim}")


def _check_dtype(x: torch.Tensor, dtype, name: str) -> None:
    if dtype is not None:
        want = _torch_dtype(dtype)
        expects(x.dtype == want, f"{name}: expected dtype "
                f"{_dtype_name(want)}, got {_dtype_name(x.dtype)}")


def check_matrix(x, name: str = "matrix", dtype=None,
                 rows: Optional[int] = None,
                 cols: Optional[int] = None) -> torch.Tensor:
    """Validate a rank-2 array (reference: device_matrix_view contract)."""
    x = ensure_array(x, name)
    check_rank(x, 2, name)
    _check_dtype(x, dtype, name)
    if rows is not None:
        expects(x.shape[0] == rows,
                f"{name}: expected {rows} rows, got {x.shape[0]}")
    if cols is not None:
        expects(x.shape[1] == cols,
                f"{name}: expected {cols} cols, got {x.shape[1]}")
    return x


def check_vector(x, name: str = "vector", dtype=None,
                 size: Optional[int] = None) -> torch.Tensor:
    """Validate a rank-1 array (reference: device_vector_view contract)."""
    x = ensure_array(x, name)
    check_rank(x, 1, name)
    _check_dtype(x, dtype, name)
    if size is not None:
        expects(x.shape[0] == size,
                f"{name}: expected size {size}, got {x.shape[0]}")
    return x


def check_same_shape(a: torch.Tensor, b: torch.Tensor,
                     names: Tuple[str, str] = ("a", "b")) -> None:
    expects(a.shape == b.shape, f"{names[0]} shape {tuple(a.shape)} != "
            f"{names[1]} shape {tuple(b.shape)}")


def check_same_dtype(*arrays: torch.Tensor) -> None:
    dts = {a.dtype for a in arrays}
    expects(len(dts) == 1,
            f"dtype mismatch: {sorted(_dtype_name(d) for d in dts)}")


# -- factories with the reference's names (device_mdarray.hpp:134-172) ----

def _device_of(res):
    return res.device if res is not None else torch.device("cuda")


def make_device_matrix(res, n_rows: int, n_cols: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Zero-initialised (n_rows, n_cols) tensor on the handle's device
    (the card without a handle)."""
    return torch.zeros(n_rows, n_cols, dtype=_torch_dtype(dtype),
                       device=_device_of(res))


def make_device_vector(res, n: int, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(n, dtype=_torch_dtype(dtype), device=_device_of(res))


def make_device_scalar(res, value, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(value, dtype=_torch_dtype(dtype),
                        device=_device_of(res))

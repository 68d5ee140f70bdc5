"""Matrix helpers (port of ``raft_tpu.matrix.ops``).

Reference: raft/matrix/{gather,argmax,argmin,slice,copy,init,linewise_op,
col_wise_sort,reverse,sign_flip,diagonal,triangular,threshold}.cuh — each
a bespoke CUDA kernel there, a fused XLA op in the JAX package, one or two
PyTorch calls here (none of them is a Pallas kernel).  Functions that
return a matrix return a new tensor, never a view of their input, as the
JAX package's immutable arrays do; indices are int32, as the JAX
package's default integer.  A tensor stays where the caller put it;
any other input goes to the device of the call's matrix, or to the card
when it has none, so the CPU is used only for CPU tensors.
"""

from __future__ import annotations

import builtins
from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects


def _t(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A tensor as it is; anything else on ``like``'s device, else on the
    card."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device="cuda" if like is None else like.device)


def gather(matrix, map_idx) -> torch.Tensor:
    """Collect rows by index: ``out[i] = matrix[map_idx[i]]`` (reference:
    gather.cuh)."""
    matrix = _t(matrix)
    map_idx = _t(map_idx, matrix)
    expects(matrix.ndim == 2 and map_idx.ndim == 1, "gather: (2d, 1d)")
    return matrix.index_select(0, map_idx.to(matrix.device).long())


def gather_if(matrix, map_idx, stencil, pred: Callable, out
              ) -> torch.Tensor:
    """Conditional row gather (reference: gather.cuh ``gather_if``): rows
    where ``pred(stencil[i])`` take ``matrix[map_idx[i]]``, the others keep
    ``out[i]``."""
    taken = gather(matrix, map_idx)
    keep = _t(pred(_t(stencil, taken)), taken).to(taken.device)
    return torch.where(keep[:, None], taken,
                       _t(out, taken).to(taken.device))


def scatter(matrix, map_idx, updates) -> torch.Tensor:
    """``out[map_idx[i]] = updates[i]`` on a copy of ``matrix`` (reference:
    matrix/scatter.cuh)."""
    out = _t(matrix).clone()
    out[_t(map_idx, out).to(out.device).long()] = _t(updates, out).to(
        device=out.device, dtype=out.dtype)
    return out


def argmax(matrix) -> torch.Tensor:
    """Per-row argmax, the first index of the maximum (reference:
    matrix/argmax.cuh)."""
    return torch.argmax(_t(matrix), dim=1).int()


def argmin(matrix) -> torch.Tensor:
    """Per-row argmin, the first index of the minimum (reference:
    matrix/argmin.cuh)."""
    return torch.argmin(_t(matrix), dim=1).int()


def slice(matrix, x1: int, y1: int, x2: int, y2: int  # noqa: A001
          ) -> torch.Tensor:
    """Copy the ``[x1:x2, y1:y2]`` submatrix (reference:
    matrix/slice.cuh)."""
    return _t(matrix)[x1:x2, y1:y2].clone()


def copy(matrix) -> torch.Tensor:
    """A copy of ``matrix`` (reference: matrix/copy.cuh)."""
    return _t(matrix).clone()


def init(shape: Tuple[int, ...], value, dtype=torch.float32, *,
         device=None) -> torch.Tensor:
    """A ``shape`` tensor of ``value`` (reference: matrix/init.cuh), on
    ``device``, the card unless the caller asks for the CPU."""
    return torch.full(tuple(shape), value, dtype=dtype,
                      device=device or "cuda")


def linewise_op(matrix, op: Callable, *vecs, along_lines: bool = True
                ) -> torch.Tensor:
    """``op(matrix, *vecs)`` with each vector broadcast along the lines
    (rows) or, with ``along_lines=False``, down the columns (reference:
    matrix/linewise_op.cuh)."""
    matrix = _t(matrix)
    vecs = [_t(v, matrix)[None, :] if along_lines else _t(v, matrix)[:, None]
            for v in vecs]
    return op(matrix, *vecs)


def col_wise_sort(matrix, *, ascending: bool = True) -> torch.Tensor:
    """Sort each column on its own (reference: matrix/col_wise_sort.cuh)."""
    out = torch.sort(_t(matrix), dim=0).values
    return out if ascending else out.flip(0)


def reverse(matrix, *, along_rows: bool = True) -> torch.Tensor:
    """Each row reversed (``along_rows``) or the rows' order reversed
    (reference: matrix/reverse.cuh)."""
    return _t(matrix).flip(1 if along_rows else 0)


def sign_flip(matrix) -> torch.Tensor:
    """Flip column signs so the largest-magnitude entry of each column
    (its first, on ties) is positive — a deterministic orientation of
    eigenvectors (reference: matrix/math.cuh ``signFlip``)."""
    m = _t(matrix)
    pivot = torch.gather(m, 0, torch.argmax(m.abs(), dim=0)[None, :])
    return m * torch.where(pivot < 0, -1.0, 1.0).to(m.dtype)


def diagonal(matrix) -> torch.Tensor:
    """The main diagonal (reference: matrix/diagonal.cuh
    ``get_diagonal``)."""
    return torch.diagonal(_t(matrix)).clone()


def set_diagonal(matrix, vec) -> torch.Tensor:
    """A copy of ``matrix`` with its main diagonal set from ``vec``
    (reference: matrix/diagonal.cuh ``set_diagonal``)."""
    out = _t(matrix).clone()
    n = builtins.min(out.shape)
    idx = torch.arange(n, device=out.device)
    out[idx, idx] = _t(vec, out)[:n].to(device=out.device, dtype=out.dtype)
    return out


def triangular_upper(matrix) -> torch.Tensor:
    """The upper-triangular part, zeros below (reference:
    matrix/triangular.cuh)."""
    return torch.triu(_t(matrix))


def zero_small_values(matrix, thresh: float) -> torch.Tensor:
    """Entries of magnitude below ``thresh`` set to 0 (reference:
    matrix/threshold.cuh)."""
    m = _t(matrix)
    return torch.where(m.abs() < thresh, torch.zeros_like(m), m)


def row_duplicate_mask(matrix: torch.Tensor) -> torch.Tensor:
    """Per-row mask of duplicate values, keeping each value's FIRST
    occurrence (``raft_tpu/matrix/ops.py:115``): a stable double argsort
    maps the sorted adjacent-equal flags back to the original positions,
    so earlier columns win ties."""
    s, _ = torch.sort(matrix, dim=1)
    dup_sorted = torch.cat(
        [torch.zeros(matrix.shape[0], 1, dtype=torch.bool,
                     device=matrix.device), s[:, 1:] == s[:, :-1]], dim=1)
    rank = torch.argsort(torch.argsort(matrix, dim=1, stable=True), dim=1)
    return torch.gather(dup_sorted, 1, rank)

"""Matrix helpers (port of ``raft_tpu.matrix.ops``).

Only :func:`row_duplicate_mask` so far: IVF-Flat's super-tile probe dedupe
(``neighbors/ivf_flat.dedup_super_probes``) needs it.  The reference's
other functions are stand-ins that raise ``NotImplementedError`` naming
ROADMAP.md §1's *primitives*.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import not_ported_stub


def _stub(name: str):
    return not_ported_stub("matrix.ops", name, "primitives")


gather = _stub("gather")
gather_if = _stub("gather_if")
scatter = _stub("scatter")
argmax = _stub("argmax")
argmin = _stub("argmin")
slice = _stub("slice")  # noqa: A001 (the reference's name)
copy = _stub("copy")
init = _stub("init")
linewise_op = _stub("linewise_op")
col_wise_sort = _stub("col_wise_sort")
reverse = _stub("reverse")
sign_flip = _stub("sign_flip")
diagonal = _stub("diagonal")
set_diagonal = _stub("set_diagonal")
triangular_upper = _stub("triangular_upper")
zero_small_values = _stub("zero_small_values")


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

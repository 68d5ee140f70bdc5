"""Matrix helpers the ported paths use (port of ``raft_tpu.matrix.ops``).

Only :func:`row_duplicate_mask` so far: IVF-Flat's super-tile probe dedupe
(``neighbors/ivf_flat.dedup_super_probes``) needs it.
"""

from __future__ import annotations

import torch


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

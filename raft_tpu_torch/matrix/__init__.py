"""Matrix helpers (port of ``raft_tpu.matrix``): ``select_k`` and
``merge_topk``, and the ``matrix.ops`` helpers."""

from raft_tpu_torch.matrix.select_k import merge_topk, select_k  # noqa: F401
from raft_tpu_torch.matrix.ops import (  # noqa: F401
    argmax,
    argmin,
    col_wise_sort,
    copy,
    diagonal,
    gather,
    gather_if,
    init,
    linewise_op,
    reverse,
    row_duplicate_mask,
    scatter,
    set_diagonal,
    sign_flip,
    slice as slice_matrix,
    triangular_upper,
    zero_small_values,
)

"""Hybrid dense + sparse retrieval — lexical candidates as an admission set
(port of ``raft_tpu.filters.hybrid``).

A sparse (lexical) pass proposes per-query candidate ids, and the dense
IVF-PQ scan ranks only those, the candidates expressed as a bitset
filter.  :func:`candidates_to_filter` is ported; :func:`search` needs the
sparse brute-force kNN, which is not ported yet (*the tail*).
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch.core.error import expects, not_ported_stub
from raft_tpu_torch.filters.bitset import SampleFilter, n_words_for


def candidates_to_filter(sparse_ids, n_rows: int) -> SampleFilter:
    """Per-query candidate id lists -> admission bitset.

    ``sparse_ids`` is (nq, k_sparse) int; negative ids (select_k padding
    when a query matched fewer than k_sparse rows) are skipped.
    """
    ids = np.asarray(sparse_ids, np.int64)
    expects(ids.ndim == 2, "hybrid: sparse_ids must be (nq, k_sparse)")
    nq = ids.shape[0]
    words = np.zeros((nq, n_words_for(n_rows)), np.uint32)
    for q in range(nq):
        row = ids[q]
        row = row[(row >= 0) & (row < n_rows)]
        np.bitwise_or.at(words[q], row >> 5,
                         np.uint32(1) << (row & 31).astype(np.uint32))
    return SampleFilter.from_words(words.view(np.int32), n_rows)


search = not_ported_stub("filters.hybrid", "search", "the tail")

"""Filtered and multi-tenant search — per-query admission bitsets (port of
``raft_tpu.filters``).

Reference: cpp/include/raft/neighbors/sample_filter{,_types}.hpp (the
``sample_filter`` hook on ivf_pq / ivf_flat search).  The list-major scans
(Kernels B-G) and Kernel I's walk test a candidate's bit in the query's
row of the packed words before it can enter a top-k.
"""

from raft_tpu_torch.filters.bitset import (  # noqa: F401
    BITS_PER_WORD,
    SampleFilter,
    as_filter,
    group_admission_words,
    n_words_for,
    pack_mask,
    query_bits,
    query_filter_words,
    unpack_words,
)
from raft_tpu_torch.filters.tenant import TenantFilter  # noqa: F401
from raft_tpu_torch.filters import hybrid  # noqa: F401
from raft_tpu_torch.filters.hybrid import candidates_to_filter  # noqa: F401

"""Tenant namespaces — disjoint id ranges compiled into admission bitsets
(port of ``raft_tpu.filters.tenant``).

Each tenant owns a contiguous, disjoint id range ``[lo, hi)``, and a query
tagged with a tenant must only ever surface ids from its own range.
:class:`TenantFilter` compiles a namespace into a
:class:`~raft_tpu_torch.filters.bitset.SampleFilter`, consumed by the same
admission test as any predicate filter and composed with one by word-wise
AND (:meth:`SampleFilter.intersect`).  Host-side numpy; a tenant's row
serves a batch as an ``expand`` (query stride 0).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.filters.bitset import (
    BITS_PER_WORD,
    SampleFilter,
    n_words_for,
)


@dataclasses.dataclass(frozen=True)
class TenantFilter:
    """Per-tenant id-range namespaces over one index.

    ``ranges`` maps tenant name -> half-open ``(lo, hi)`` id range.
    Ranges must be disjoint (validated at construction).
    """

    ranges: Mapping[str, Tuple[int, int]]
    n_rows: int

    def __post_init__(self):
        spans = []
        for t, (lo, hi) in self.ranges.items():
            expects(0 <= lo <= hi,
                    f"TenantFilter: bad range for tenant {t!r}: ({lo}, {hi})")
            spans.append((int(lo), int(hi), t))
        spans.sort()
        for (lo0, hi0, t0), (lo1, hi1, t1) in zip(spans, spans[1:]):
            expects(hi0 <= lo1,
                    f"TenantFilter: ranges of tenants {t0!r} and {t1!r} "
                    f"overlap ([{lo0},{hi0}) vs [{lo1},{hi1}))")

    @property
    def tenants(self):
        return tuple(self.ranges.keys())

    def range_of(self, tenant: str) -> Tuple[int, int]:
        expects(tenant in self.ranges,
                f"TenantFilter: unknown tenant {tenant!r}")
        lo, hi = self.ranges[tenant]
        return int(lo), int(hi)

    def words_for(self, tenant: str) -> np.ndarray:
        """One packed word row admitting exactly ``[lo, hi)`` — host-side
        numpy, cached per tenant."""
        key = (tenant, self.n_rows)
        cache = _WORD_CACHE
        if key not in cache:
            lo, hi = self.range_of(tenant)
            cache[key] = _range_words(lo, min(hi, self.n_rows), self.n_rows)
        return cache[key]

    def filter_for(self, tenant: str, nq: int = 1) -> SampleFilter:
        """The tenant's namespace as a per-query admission bitset (one
        row, expanded to ``nq``)."""
        w = torch.from_numpy(self.words_for(tenant))
        return SampleFilter(words=w.reshape(1, -1).expand(nq, -1),
                            n_rows=self.n_rows)

    def owner_of(self, i: int):
        """The tenant whose range holds id ``i``, or None."""
        for t, (lo, hi) in self.ranges.items():
            if lo <= i < hi:
                return t
        return None


# (tenant, n_rows) -> packed words; one row per tenant, kept for the
# process (namespaces are static per index generation)
_WORD_CACHE: Dict[Tuple[str, int], np.ndarray] = {}


def _range_words(lo: int, hi: int, n_rows: int) -> np.ndarray:
    """Packed int32 words admitting exactly ids in ``[lo, hi)``."""
    nw = n_words_for(n_rows)
    idx = np.arange(nw * BITS_PER_WORD, dtype=np.int64)
    bits = ((idx >= lo) & (idx < hi)).astype(np.uint8)
    return np.packbits(bits, bitorder="little").view(np.int32)

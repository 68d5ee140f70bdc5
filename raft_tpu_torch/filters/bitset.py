"""Per-query admission bitsets — the ``SampleFilter`` predicate layer (port
of ``raft_tpu.filters.bitset``).

Reference: cpp/include/raft/neighbors/sample_filter_types.hpp — the
``bitset_filter`` a caller attaches to ivf_pq / ivf_flat / cagra search so
every (query, candidate) pair is admitted or rejected *inside* the scan,
not by a pass afterwards that would starve k.  The filter is a dense
per-query bitset over row ids, packed 32 ids per int32 word, shape ``(nq,
n_words)`` with ``n_words = ceil(n_rows / 32)``, little-endian within a
word: bit b of word w covers id 32 w + b.  An id at or past the bitset's
coverage is not admitted.

The layout is the JAX package's bit for bit.  What differs is where the
bits are read: the port's list-major scans (``csrc/list_fold.cuh``) and
Kernel I's walk (``csrc/cagra_walk.cu``) test a candidate's bit in the
query's row of ``words`` itself, so the per-group words of
:func:`group_admission_words` (a TPU VMEM layout) are built only for the
plain versions' parity and name.  A filter of one row serves a whole
batch as an ``expand`` (query stride 0), never a copy: at 1M rows and
5,000 queries a copy would take 625 MB.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import _writable

# ids per packed word (int32 words, the 32-row list alignment)
BITS_PER_WORD = 32

# a (rows, n, 32) int32 transient of pack_mask stays within this
_PACK_BYTES = 256 << 20


def n_words_for(n_rows: int) -> int:
    """Packed word count covering ``n_rows`` ids (≥ 1 so an empty bound
    still has a well-formed (nq, 1) buffer)."""
    return max(1, -(-int(n_rows) // BITS_PER_WORD))


def _as_words(words) -> torch.Tensor:
    if isinstance(words, torch.Tensor):
        return words.to(torch.int32)
    return torch.from_numpy(_writable(
        np.asarray(words).astype(np.int32, copy=False)))


def _broadcast(row: torch.Tensor, nq: int) -> torch.Tensor:
    """A (1, n_words) row as (nq, n_words) with query stride 0."""
    return row.reshape(1, -1).expand(nq, -1)


@dataclasses.dataclass(frozen=True)
class SampleFilter:
    """Dense per-query admission bitset over row ids.

    ``words[q, i >> 5] >> (i & 31) & 1`` is the admission bit of id ``i``
    for query ``q``.  Bits at or beyond ``n_rows`` are ignored by every
    consumer.  ``words`` may be an ``expand`` of one row (query stride 0).
    """

    words: torch.Tensor     # (nq, n_words) int32 packed admission bits
    n_rows: int             # id bound the bitset covers

    @property
    def nq(self) -> int:
        return int(self.words.shape[0])

    @property
    def n_words(self) -> int:
        return int(self.words.shape[1])

    def admitted_counts(self) -> np.ndarray:
        """Per-query admitted-id count (host-side)."""
        w = self.words.cpu().numpy().view(np.uint32)
        bits = np.unpackbits(w.view(np.uint8), axis=-1,
                             count=self.n_words * BITS_PER_WORD,
                             bitorder="little").reshape(self.nq, -1)
        return bits[:, : self.n_rows].sum(axis=1).astype(np.int64)

    @staticmethod
    def from_words(words, n_rows: int) -> "SampleFilter":
        words = _as_words(words)
        expects(words.ndim == 2, "SampleFilter: words must be (nq, n_words)")
        expects(words.shape[1] >= n_words_for(n_rows),
                "SampleFilter: words too narrow for n_rows")
        return SampleFilter(words=words, n_rows=int(n_rows))

    @staticmethod
    def from_mask(mask) -> "SampleFilter":
        """Build from a dense (nq, n_rows) boolean admission mask."""
        mask = torch.as_tensor(mask)
        expects(mask.ndim == 2, "SampleFilter: mask must be (nq, n_rows)")
        n_rows = int(mask.shape[1])
        return SampleFilter(words=pack_mask(mask), n_rows=n_rows)

    @staticmethod
    def from_ids(ids: Sequence, n_rows: int, nq: int = 1) -> "SampleFilter":
        """Admit exactly ``ids`` (host-side build; the same set for each
        of ``nq`` queries, one row expanded)."""
        w = np.zeros(n_words_for(n_rows), np.uint32)
        arr = np.asarray(ids, np.int64).ravel()
        arr = arr[(arr >= 0) & (arr < n_rows)]
        np.bitwise_or.at(w, arr >> 5,
                         np.uint32(1) << (arr & 31).astype(np.uint32))
        return SampleFilter(words=_broadcast(torch.from_numpy(
            w.view(np.int32)), nq), n_rows=int(n_rows))

    @staticmethod
    def all_rows(n_rows: int, nq: int = 1) -> "SampleFilter":
        """Admit everything — the identity filter (all-ones words)."""
        row = torch.full((1, n_words_for(n_rows)), -1, dtype=torch.int32)
        return SampleFilter(words=_broadcast(row, nq), n_rows=int(n_rows))

    def intersect(self, other: "SampleFilter") -> "SampleFilter":
        """AND-compose two filters (e.g. tenant namespace ∧ predicate); two
        broadcast rows stay one broadcast row."""
        expects(self.n_rows == other.n_rows,
                "SampleFilter: intersect over mismatched id bounds")
        a, b = self.words, other.words
        if b.device != a.device:
            b = words_on_device(b, a.device)
        if a.stride(0) == 0 and b.stride(0) == 0 and a.shape == b.shape:
            words = _broadcast(a[:1] & b[:1], a.shape[0])
        else:
            words = a & b
        return SampleFilter(words=words, n_rows=self.n_rows)


def pack_mask(mask) -> torch.Tensor:
    """Pack a (nq, n) boolean mask into (nq, ceil(n/32)) int32 words,
    little-endian within each word (bit b of word w covers id 32*w+b).
    Bit 31 is int32's sign bit; the distinct powers of two sum without
    overflow.  Packed a few query rows at a time."""
    mask = torch.as_tensor(mask)
    nq, n = mask.shape
    nw = n_words_for(n)
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32,
                          device=mask.device)
    out = torch.empty(nq, nw, dtype=torch.int32, device=mask.device)
    step = max(1, _PACK_BYTES // (nw * BITS_PER_WORD * 4))
    for s in range(0, nq, step):
        m = (mask[s:s + step] != 0).to(torch.int32)
        pad = nw * BITS_PER_WORD - n
        if pad:
            m = torch.nn.functional.pad(m, (0, pad))
        m = m.reshape(m.shape[0], nw, BITS_PER_WORD)
        out[s:s + step] = (m << shifts).sum(-1, dtype=torch.int32)
    return out


def query_bits(words: torch.Tensor, qids: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
    """Gather admission bits — the plain twin of the kernels' bit test.

    ``words`` is (nq, n_words) int32; ``qids`` maps each row of ``ids``
    to its query (any shape broadcastable against ``ids`` minus the last
    axis); ``ids`` holds candidate ids (negative = padding / tombstone:
    not admitted).  Returns an int32 0/1 tensor shaped like ``ids``.
    Reads ``words`` through its strides (no copy of a broadcast row)."""
    qids = torch.as_tensor(qids, device=words.device).long()
    ids = ids.to(torch.int64)
    safe = torch.clamp_min(ids, 0)
    nw = words.shape[-1]
    col = torch.clamp_max(safe >> 5, nw - 1)
    w = words[qids[..., None], col]
    bit = (w >> (safe & 31).to(torch.int32)) & 1
    cov = nw * BITS_PER_WORD
    return torch.where((ids >= 0) & (ids < cov), bit,
                       torch.zeros_like(bit)).to(torch.int32)


def group_admission_words(filter_words: torch.Tensor,
                          group_list: torch.Tensor,
                          slot_pairs: torch.Tensor,
                          list_indices: torch.Tensor, n_probes: int,
                          P: int) -> torch.Tensor:
    """Admission words for a grouped scan, in **list-slot order**: ``(n_groups,
    GROUP, ceil(cap / 32))`` int32, word ``w`` of slot ``s`` in group ``g``
    packing the bits of candidates ``32w .. 32w + 31`` of list
    ``group_list[g]`` for the query owning ``slot_pairs[g, s]``.  Empty
    slots (pair == ``P``) get query 0's bits; padding and tombstones (id <
    0) pack a 0 bit.  The JAX package's TPU kernels read this layout; the
    port's kernels test the query's own row of ``filter_words``, so this
    serves the plain versions' parity checks."""
    n_groups = group_list.shape[0]
    cap = list_indices.shape[1]
    ids = list_indices[group_list.long()]                  # (n_groups, cap)
    pairs = torch.clamp_max(slot_pairs.long(), P - 1) if P > 0 \
        else slot_pairs.long()
    qids = pairs // max(1, n_probes)                       # (n_groups, GROUP)
    bits = query_bits(filter_words, qids,
                      ids[:, None, :].expand(-1, qids.shape[1], -1))
    return pack_mask(bits.reshape(-1, cap)).reshape(
        n_groups, slot_pairs.shape[1], -1)


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack packed words back to an int32 0/1 mask over ``n`` ids along
    the last axis."""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32,
                          device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n]


def query_filter_words(f: "FilterLike", nq: int, site: str
                       ) -> Optional[torch.Tensor]:
    """Normalize a public ``search(filter=)`` argument to per-query packed
    words (nq, n_words) int32, or None when unfiltered.

    Accepts a :class:`SampleFilter` (single-query filters broadcast to
    the batch, query stride 0) or a dense (nq, n_rows) boolean admission
    mask.  The one seam every index type's search runs its filter
    through."""
    if f is None:
        return None
    if not isinstance(f, SampleFilter):
        arr = torch.as_tensor(f)
        expects(arr.ndim == 2 and arr.dtype == torch.bool,
                f"{site}: filter must be a SampleFilter or an "
                "(nq, n_rows) bool mask")
        f = SampleFilter.from_mask(arr)
    expects(f.nq in (1, nq),
            f"{site}: filter covers {f.nq} queries, batch has {nq}")
    w = f.words
    if f.nq == 1 and nq != 1:
        w = _broadcast(w, nq)
    return w


def words_on_device(words: torch.Tensor, device) -> torch.Tensor:
    """``words`` on ``device``, a broadcast row moved once and expanded
    again (``Tensor.to`` would copy it to nq rows); int32, each row
    contiguous."""
    if words.shape[0] > 1 and words.stride(0) == 0:
        return _broadcast(words[:1].to(device=device, dtype=torch.int32)
                          .contiguous(), words.shape[0])
    return words.to(device=device, dtype=torch.int32).contiguous()


FilterLike = Union[SampleFilter, torch.Tensor, np.ndarray, None]


def as_filter(f: FilterLike, n_rows: int) -> Optional[SampleFilter]:
    """Normalize a ``filter=`` argument: SampleFilter passes through
    (bound-checked), a raw 2-D bool/int mask is packed, None is None."""
    if f is None:
        return None
    if isinstance(f, SampleFilter):
        expects(f.n_words >= n_words_for(n_rows),
                "filter: bitset narrower than the index id bound")
        return f
    arr = torch.as_tensor(f)
    expects(arr.ndim == 2, "filter: expected SampleFilter or (nq, n) mask")
    if arr.dtype == torch.int32 and arr.shape[1] == n_words_for(n_rows) \
            and arr.shape[1] != n_rows:
        return SampleFilter.from_words(arr, n_rows)
    expects(arr.shape[1] == n_rows,
            "filter: mask width must equal the index id bound")
    return SampleFilter.from_mask(arr)

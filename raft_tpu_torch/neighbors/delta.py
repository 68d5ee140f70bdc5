"""The delta tier: an always-mutable memtable absorbing streaming writes
(port of ``raft_tpu.neighbors.delta``).

Every batch index mutates by *snapshot*: ``extend`` / ``delete`` /
``upsert`` return a NEW index one generation up.  That is the right
contract for batch updates and the wrong one for sustained write traffic.
This module is the LSM answer: a small, flat, **always-mutable**
:class:`Memtable` that absorbs upserts and deletes at host-memory speed and
is searched alongside the main index by treating the delta as one more
"shard" in the :func:`~raft_tpu_torch.neighbors.grouped.finalize_topk`
k-bounded merge.

Design invariants (the JAX package's):

- **Single deterministic mutation path.**  :meth:`Memtable.apply` is the
  only way state changes — live writes and log replay drive the same
  code, so recovery is bit-identical by construction.  Records carry a
  log sequence number; ``apply`` is idempotent under replay (``lsn <=
  applied_lsn`` is a no-op).  The canonical state is host numpy, laid out
  as in the JAX package, so :meth:`Memtable.digest` hashes the same bytes
  and equals the JAX digest for the same record stream.
- **Shape-static device snapshot.**  The scan tensors are fixed at
  ``capacity`` rows (empty slots carry id -1 and ride the id<0 mask
  seam).  Filling past capacity doubles it under a generation bump.
- **Tombstones mask the main index through the id<0 seam.**  A delete
  (and the delete-half of an upsert whose id may live in the main index)
  records the id in the tombstone set; :func:`merge_with_main` rewrites
  matching main-index hits to worst-distance / id -1 before the shared
  ``finalize_topk`` epilogue selects the public top-k.
- **Upserts never double-tombstone.**  An id already live in the memtable
  overwrites its slot in place; its main-index tombstone was recorded
  once at first sight.

The scan is a plain product plus ``select_k``, as in the JAX package,
whose memtable scan is an XLA composition with no Pallas kernel.  The
device view lives on the memtable's ``device`` (``"cuda"`` unless the
caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.filters.bitset import query_bits
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import grouped
from raft_tpu_torch.utils import precision

#: log / memtable record opcodes (stable wire values, the JAX package's)
OP_UPSERT = 1
OP_DELETE = 2

_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_SUPPORTED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                      DistanceType.L2Unexpanded,
                      DistanceType.L2SqrtUnexpanded,
                      DistanceType.InnerProduct)


@dataclasses.dataclass(frozen=True)
class Record:
    """One logged write: ``lsn`` orders and deduplicates replay, ``op``
    is :data:`OP_UPSERT` / :data:`OP_DELETE`, ``ids`` the source ids and
    ``vectors`` the (n, dim) float32 rows (upserts only)."""

    lsn: int
    op: int
    ids: np.ndarray
    vectors: Optional[np.ndarray] = None


def _scan_body(data, ids, queries, k: int, metric, filter_words=None):
    """Brute-force delta scan producing PUBLIC-form distances (sqrt applied
    for the sqrt-L2 metrics) so they merge against the main index's output
    without rescaling.  Empty slots (id -1) ride the worst-distance
    sentinel.  ``filter_words`` (nq, n_words) int32 packed admission bits
    fold inadmissible memtable rows through the same seam."""
    nq = queries.shape[0]
    cap = data.shape[0]
    f32q = queries.float()
    with precision.highest():
        prod = f32q @ data.T
    if metric == DistanceType.InnerProduct:
        d = prod
        worst = float("-inf")
        select_min = False
    else:
        qq = (f32q * f32q).sum(1, keepdim=True)
        xx = (data * data).sum(1)[None, :]
        d = torch.clamp_min(qq + xx - 2.0 * prod, 0.0)
        worst = float("inf")
        select_min = True
    d = torch.where(ids[None, :] < 0, torch.full_like(d, worst), d)
    bids = ids[None, :].expand(nq, cap)
    if filter_words is not None:
        adm = query_bits(filter_words,
                         torch.arange(nq, device=bids.device), bids) > 0
        d = torch.where(adm, d, torch.full_like(d, worst))
        bids = torch.where(adm, bids, torch.full_like(bids, -1))
    kf = min(k, cap)
    best_d, best_i = raw(select_k)(d, kf, in_idx=bids,
                                   select_min=select_min)
    if kf < k:
        best_d = torch.cat([best_d, torch.full((nq, k - kf), worst,
                                               device=best_d.device)], 1)
        best_i = torch.cat([best_i, torch.full(
            (nq, k - kf), -1, dtype=best_i.dtype, device=best_i.device)], 1)
    best_i = torch.clamp_min(best_i, -1)
    if metric in _SQRT_METRICS:
        best_d = torch.where(torch.isfinite(best_d),
                             torch.sqrt(torch.clamp_min(best_d, 0.0)),
                             best_d)
    return best_d, best_i


def _tomb_mask(main_d, main_i, tombs, worst):
    hit = (main_i >= 0) & torch.isin(main_i, tombs.to(main_i.dtype))
    return (torch.where(hit, torch.full_like(main_d, worst), main_d),
            torch.where(hit, torch.full_like(main_i, -1), main_i))


def merge_with_main(main_d, main_i, queries, data, ids, tombs, *,
                    k: int, metric, filter_words=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delta-as-extra-shard merge: scan the memtable, mask tombstoned
    main-index hits to the worst/-1 sentinel (the id<0 seam), then run the
    shared :func:`grouped.finalize_topk` epilogue over the concatenated
    (nq, 2k) candidates.  ``filter_words`` applies the caller's admission
    bitset to the delta scan (the main results are assumed already
    filtered).  ``main_d`` is public-form already (sqrt applied by the
    main search) and the scan matches it, so the epilogue never re-sqrts."""
    metric = DistanceType(metric)
    k = int(k)
    nq = main_d.shape[0]
    select_min = metric != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    dd, di = _scan_body(data, ids, queries, k, metric,
                        filter_words=filter_words)
    md, mi = _tomb_mask(main_d, main_i, tombs, worst)
    alld = torch.cat([md, dd], 1)
    alli = torch.cat([mi.to(di.dtype), di], 1)
    return grouped.finalize_topk(alld, alli, nq, k, select_min, sqrt=False,
                                 select_k_fn=raw(select_k))


def merge_with_main_multi(main_d, main_i, queries,
                          deltas: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                          tombs: Sequence[torch.Tensor], *, k: int, metric,
                          filter_words=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the main-index top-k with EVERY shard memtable's delta scan
    (``deltas`` is a sequence of ``(data, ids)`` device views, ``tombs``
    the matching tombstone tensors).  Two things the single-delta merge
    never needed:

    - the tombstone mask over the MAIN index is the UNION of every shard's
      tombstone set (any live memtable may carry the only copy of a
      tombstone);
    - replicated placement stores each row on several shards, so the same
      id can surface from more than one delta: duplicates are masked to
      the worst/-1 sentinel before the final select, keeping exactly one
      candidate per id (best distance, earliest position on ties).
    """
    metric = DistanceType(metric)
    k = int(k)
    nq = main_d.shape[0]
    select_min = metric != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    all_tombs = torch.cat([t.reshape(-1) for t in tombs])
    md, mi = _tomb_mask(main_d, main_i, all_tombs, worst)
    ds, is_ = [md], [mi]
    for data, ids in deltas:
        dd, di = _scan_body(data, ids, queries, k, metric,
                            filter_words=filter_words)
        ds.append(dd)
        is_.append(di)
    alld = torch.cat(ds, 1)
    alli = torch.cat([i.to(is_[-1].dtype) for i in is_], 1)
    # replica dedup over the (nq, C) candidate strip: candidate j is
    # dropped when some j' holds the same id with a better distance (or
    # an equal distance at an earlier position)
    pos = torch.arange(alld.shape[1], device=alld.device)
    same = (alli[:, :, None] == alli[:, None, :]) & (alli[:, :, None] >= 0)
    if select_min:
        beats = alld[:, None, :] < alld[:, :, None]
    else:
        beats = alld[:, None, :] > alld[:, :, None]
    beats = beats | ((alld[:, None, :] == alld[:, :, None])
                     & (pos[None, None, :] < pos[None, :, None]))
    dup = (same & beats).any(-1)
    alld = torch.where(dup, torch.full_like(alld, worst), alld)
    alli = torch.where(dup, torch.full_like(alli, -1), alli)
    return grouped.finalize_topk(alld, alli, nq, k, select_min, sqrt=False,
                                 select_k_fn=raw(select_k))


class Memtable:
    """Host-canonical mutable row store with a shape-static device view.

    The canonical state is host numpy (``apply`` is a few row writes — no
    device round trip on the write path); the device snapshot used by
    searches is refreshed lazily and swapped as one tuple, so a concurrent
    search sees either the old or the new snapshot wholesale.
    ``capacity`` (rows) and ``tomb_capacity`` (tombstone slots) are the
    snapshot's shapes; filling either doubles it under a generation bump.
    ``device`` holds the snapshot (``"cuda"`` by default).
    """

    def __init__(self, dim: int, *, capacity: int = 1024,
                 tomb_capacity: int = 1024,
                 metric=DistanceType.L2Expanded, device="cuda") -> None:
        expects(dim > 0, "delta: dim must be positive")
        expects(capacity > 0 and tomb_capacity > 0,
                "delta: capacity and tomb_capacity must be positive")
        self.dim = int(dim)
        self.metric = DistanceType(metric)
        expects(self.metric in _SUPPORTED_METRICS,
                f"delta: unsupported memtable metric {self.metric!r}")
        self.device = torch.device(device)
        self.capacity = int(capacity)
        self.tomb_capacity = int(tomb_capacity)
        self.generation = 0
        self.applied_lsn = 0
        self._data = np.zeros((self.capacity, self.dim), np.float32)
        self._ids = np.full(self.capacity, -1, np.int32)
        self._slot_lsn = np.zeros(self.capacity, np.int64)
        self._slot_of: dict = {}      # id -> slot
        self._tombs: dict = {}        # id -> lsn (masks the main index)
        self._n_used = 0              # append high-water mark
        self._lock = threading.Lock()
        self._dirty = True
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = None

    # ---- introspection --------------------------------------------------

    @property
    def live_rows(self) -> int:
        return len(self._slot_of)

    @property
    def n_tombstones(self) -> int:
        return len(self._tombs)

    @property
    def select_min(self) -> bool:
        return self.metric != DistanceType.InnerProduct

    def digest(self) -> str:
        """SHA-256 over the canonical state — the bit-identical-recovery
        assertion surface; the JAX package's bytes in the JAX package's
        order."""
        with self._lock:
            h = hashlib.sha256()
            h.update(np.int64([self.capacity, self.tomb_capacity,
                               self._n_used, self.applied_lsn]).tobytes())
            h.update(self._data.tobytes())
            h.update(self._ids.tobytes())
            h.update(self._slot_lsn.tobytes())
            for i, lsn in sorted(self._tombs.items()):
                h.update(np.int64([i, lsn]).tobytes())
            return h.hexdigest()

    # ---- the one mutation path ------------------------------------------

    def apply(self, rec: Record) -> bool:
        """Apply one record; returns False for an already-applied lsn
        (duplicate-replay idempotence)."""
        with self._lock:
            if rec.lsn <= self.applied_lsn:
                return False
            ids = np.asarray(rec.ids, np.int64).reshape(-1)
            if rec.op == OP_UPSERT:
                vecs = np.asarray(rec.vectors, np.float32)
                expects(vecs.ndim == 2 and vecs.shape == (ids.size, self.dim),
                        f"delta: upsert vectors must be ({ids.size}, "
                        f"{self.dim}), got {vecs.shape}")
                for j, rid in enumerate(ids):
                    i = int(rid)
                    expects(i >= 0, "delta: source ids must be >= 0")
                    slot = self._slot_of.get(i)
                    if slot is None:
                        if self._n_used >= self.capacity:
                            self._grow_rows()
                        slot = self._n_used
                        self._n_used += 1
                        self._slot_of[i] = slot
                        self._ids[slot] = i
                        # first sight since the last fold: ONE tombstone
                        # masks any published main-index copy; an
                        # overwrite never emits a second
                        if i not in self._tombs:
                            if len(self._tombs) >= self.tomb_capacity:
                                self._grow_tombs()
                            self._tombs[i] = int(rec.lsn)
                    self._data[slot] = vecs[j]
                    self._slot_lsn[slot] = rec.lsn
            elif rec.op == OP_DELETE:
                for rid in ids:
                    i = int(rid)
                    slot = self._slot_of.pop(i, None)
                    if slot is not None:
                        self._ids[slot] = -1
                        self._data[slot] = 0.0
                        self._slot_lsn[slot] = rec.lsn
                    if i not in self._tombs:
                        if len(self._tombs) >= self.tomb_capacity:
                            self._grow_tombs()
                    self._tombs[i] = int(rec.lsn)
            else:
                raise ValueError(f"delta: unknown record op {rec.op!r}")
            self.applied_lsn = int(rec.lsn)
            self._dirty = True
            return True

    def _grow_rows(self) -> None:
        """Double the row capacity: a new snapshot shape, bumped as a
        generation so caches and tests can attribute it."""
        new_cap = self.capacity * 2
        data = np.zeros((new_cap, self.dim), np.float32)
        ids = np.full(new_cap, -1, np.int32)
        lsn = np.zeros(new_cap, np.int64)
        data[:self.capacity] = self._data
        ids[:self.capacity] = self._ids
        lsn[:self.capacity] = self._slot_lsn
        self._data, self._ids, self._slot_lsn = data, ids, lsn
        self.capacity = new_cap
        self.generation += 1
        self._dirty = True

    def _grow_tombs(self) -> None:
        self.tomb_capacity *= 2
        self.generation += 1
        self._dirty = True

    def reset(self) -> None:
        """Drop all rows and tombstones (post-fold): shapes are kept;
        ``applied_lsn`` resets with the truncated log."""
        with self._lock:
            self._data[:] = 0.0
            self._ids[:] = -1
            self._slot_lsn[:] = 0
            self._slot_of.clear()
            self._tombs.clear()
            self._n_used = 0
            self.applied_lsn = 0
            self.generation += 1
            self._dirty = True

    # ---- search side ----------------------------------------------------

    def device_view(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The shape-static ``(data, ids, tombs)`` snapshot on ``device``
        that searches consume.  Refreshed only when dirty (a copy of the
        host state, never a view of it); published as one tuple so a
        concurrent reader never sees data from one write and ids from
        another."""
        with self._lock:
            if self._dirty or self._dev is None:
                tombs = np.full(self.tomb_capacity, -1, np.int32)
                if self._tombs:
                    t = np.fromiter(self._tombs.keys(), np.int32,
                                    len(self._tombs))
                    tombs[:t.size] = t
                self._dev = (torch.tensor(self._data, device=self.device),
                             torch.tensor(self._ids, device=self.device),
                             torch.tensor(tombs, device=self.device))
                self._dirty = False
            return self._dev

    def search(self, queries, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standalone delta search (tests / debugging — serving merges via
        :func:`merge_with_main` instead)."""
        data, ids, _ = self.device_view()
        q = torch.as_tensor(queries, device=self.device)
        return _scan_body(data, ids, q, int(k), self.metric)

    # ---- fold side -------------------------------------------------------

    def fold_payload(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Deterministic fold inputs: ``(live_ids, live_rows, tomb_ids)``
        in slot order / sorted id order — what a fold feeds the main
        index's ``delete`` + ``extend`` under one generation bump."""
        with self._lock:
            live = np.nonzero(self._ids[:self._n_used] >= 0)[0]
            live_ids = self._ids[live].astype(np.int32)
            live_rows = self._data[live].astype(np.float32)
            tomb_ids = np.array(sorted(self._tombs), np.int32)
            return live_ids, live_rows, tomb_ids

    def fold_items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """:meth:`fold_payload` plus the per-row LSNs:
        ``(live_ids, live_rows, live_lsns, tomb_ids)``, for a fold that
        unions payloads across shard memtables and keeps the newest write
        of a duplicated id."""
        with self._lock:
            live = np.nonzero(self._ids[:self._n_used] >= 0)[0]
            return (self._ids[live].astype(np.int64),
                    self._data[live].astype(np.float32),
                    self._slot_lsn[live].astype(np.int64),
                    np.array(sorted(self._tombs), np.int64))

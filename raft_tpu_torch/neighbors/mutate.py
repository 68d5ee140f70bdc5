"""Tombstone and generation helpers of the mutable IVF indexes (port of
``raft_tpu.neighbors.mutate``).

Every row's state lives in ``list_indices``, the one array every scan
already masks on:

- slot value ``>= 0``  — live row (the value is the source id);
- slot value ``-1``    — never-filled padding;
- slot value ``<= -2`` — tombstoned row: original id ``v`` is stored as
  ``-(v + 2)`` (decode with :func:`decode_tombstones`).

Each scan kernel gives a row with a negative id the key +inf
(``csrc/list_fold.cuh`` ``key_rows``, the query-major kernels' id test),
so a tombstoned row leaves search results as padding does: no kernel
change, no cost per search.  An exhausted slot is ``(+inf, -1)``, never a
tombstone code, also when ``k`` exceeds the live candidates.

Mutations never edit an index in place: ``delete`` / ``compact`` /
``extend`` / ``upsert`` return a NEW index, the next *generation*, sharing
every unchanged tensor with its parent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def generation(index) -> int:
    """The index's generation counter (0 for a freshly built index)."""
    return int(getattr(index, "generation", 0) or 0)


def next_generation(parent, child):
    """Stamp ``child`` as the generation after ``parent``; returns
    ``child``."""
    child.generation = generation(parent) + 1
    return child


def encode_tombstones(ids: torch.Tensor) -> torch.Tensor:
    """Id ``v`` -> tombstone slot value ``-(v + 2)``."""
    return -(ids + 2)


def tombstone(list_indices: torch.Tensor, ids
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rewrite every live slot whose id is in ``ids`` to its tombstone
    encoding.  Returns ``(new_list_indices, hit_mask)``; ids not present
    match nothing.  Elementwise over the slots, no repacking."""
    ids = torch.as_tensor(ids, device=list_indices.device).reshape(-1).to(
        list_indices.dtype)
    hit = torch.isin(list_indices, ids) & (list_indices >= 0)
    return (torch.where(hit, encode_tombstones(list_indices), list_indices),
            hit)


def decode_tombstones(list_indices) -> np.ndarray:
    """Host-side decode of every tombstoned id in ``list_indices``."""
    a = _host(list_indices).reshape(-1)
    enc = a[a <= -2]
    return (-enc.astype(np.int64) - 2)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def deleted_ids(index) -> frozenset:
    """The set of deleted source ids, host-side.

    A graph index (CAGRA) carries an explicit ``deleted_ids`` attribute
    (the delete-mask shim); an IVF index decodes it from the tombstones
    in ``list_indices``.  An id tombstoned in one slot but live in another
    is NOT deleted.  The canary recall measurement excludes these ids
    from its ground truth."""
    ext = getattr(index, "deleted_ids", None)
    if ext is not None:
        return frozenset(int(v) for v in ext)
    li = getattr(index, "list_indices", None)
    if li is None:
        return frozenset()
    a = _host(li).reshape(-1)
    dead = frozenset(int(v) for v in decode_tombstones(a))
    if not dead:
        return dead
    live = frozenset(int(v) for v in a[a >= 0])
    return dead - live


def live_sizes(list_indices: torch.Tensor) -> torch.Tensor:
    """Per-list live-row counts (tombstones and padding excluded)."""
    return (list_indices >= 0).sum(1).to(torch.int32)


def live_count(index) -> int:
    """Total live rows (one host sync)."""
    return int((index.list_indices >= 0).sum())


def dead_fraction(index) -> float:
    """Tombstoned fraction of occupied slots: ``dead / (live + dead)``
    (0.0 for an empty index).  Tombstones cost scan work — every probe
    still streams and masks them — so a caller compacts past a threshold
    of this number."""
    li = index.list_indices
    live = int((li >= 0).sum())
    dead = int((li <= -2).sum())
    total = live + dead
    return (dead / total) if total else 0.0


def compaction_order(list_indices: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable live-rows-first permutation of each list + live sizes: live
    rows keep their relative order."""
    order = torch.argsort((list_indices < 0).to(torch.int32), dim=1,
                          stable=True)
    return order, live_sizes(list_indices)

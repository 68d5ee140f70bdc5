"""IVF list helpers shared with IVF-PQ (port of three functions of
``raft_tpu.neighbors.ivf_flat``: ``_pack_lists`` :146,
``_append_lists_multi`` :172 and ``_select_clusters`` :574).

IVF-Flat itself (build / extend / search) is a later slice (ROADMAP.md §1).

``_select_clusters`` ranks coarse probes with an exact ``torch.topk``.  The
JAX package ranks them with ``approx_max_k`` on a TPU (exact on the CPU,
and exact there too whenever ``exact=True`` or ``n_probes`` is within 1/8
of ``n_lists``), so on the card the port's probe sets can differ from a
TPU run's in the marginal probes; ``coarse_recall_target`` has no effect
here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from raft_tpu_torch.distance.types import DistanceType

_LIST_ALIGN = 32  # list capacities are rounded to warp multiples


def _round_up(x: int, align: int) -> int:
    return -(-x // align) * align


def _list_slots(labels: torch.Tensor, n_lists: int, base: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by label and each row's slot ``base[label] + rank
    within its label``: (order, sorted labels, slots, per-list counts)."""
    order = torch.argsort(labels, stable=True)
    sl = labels[order]
    counts = torch.bincount(labels, minlength=n_lists)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(labels.shape[0], device=labels.device) - starts[sl]
    return order, sl, base[sl] + rank, counts


def _pack_lists(rows: torch.Tensor, labels: torch.Tensor,
                source_ids: torch.Tensor, n_lists: int, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter rows into padded per-list storage (sort by label, rank
    within the list, one scatter): (list_rows (n_lists, capacity, ...),
    list_idx (n_lists, capacity) int32 with -1 padding, sizes int32)."""
    labels = labels.long()
    zeros = torch.zeros(n_lists, dtype=torch.int64, device=labels.device)
    order, sl, slot, counts = _list_slots(labels, n_lists, zeros)
    list_rows = torch.zeros((n_lists, capacity, *rows.shape[1:]),
                            dtype=rows.dtype, device=rows.device)
    list_idx = torch.full((n_lists, capacity), -1, dtype=torch.int32,
                          device=rows.device)
    list_rows[sl, slot] = rows[order]
    list_idx[sl, slot] = source_ids[order].int()
    return list_rows, list_idx, counts.int()


def _append_lists_multi(bufs: Sequence[torch.Tensor],
                        rows: Sequence[torch.Tensor],
                        list_idx: torch.Tensor, list_sizes: torch.Tensor,
                        new_labels: torch.Tensor, new_ids: torch.Tensor):
    """Scatter-append rows into existing padded lists (the extend fast
    path; callers have checked that no list overflows its capacity).
    ``bufs``/``rows`` are matching per-list storages and their new rows,
    all placed at the same slots.  Returns new tensors
    (bufs, list_idx, sizes); the inputs are not modified."""
    n_lists = list_sizes.shape[0]
    order, sl, slot, counts = _list_slots(new_labels.long(), n_lists,
                                          list_sizes.long())
    out = []
    for b, r in zip(bufs, rows):
        b = b.clone()
        b[sl, slot] = r[order].to(b.dtype)
        out.append(b)
    list_idx = list_idx.clone()
    list_idx[sl, slot] = new_ids[order].int()
    return tuple(out), list_idx, (list_sizes + counts).int()


def _select_clusters(centers: torch.Tensor, queries: torch.Tensor,
                     n_probes: int, metric: int) -> torch.Tensor:
    """Coarse top-``n_probes`` lists per query (the ``select_clusters``
    analogue), exact, int32: by inner product for InnerProduct, else by
    ``2 q·c − ‖c‖²`` (the L2 order without the query norm)."""
    qf = queries.float()
    cf = centers.float()
    score = qf @ cf.T
    if metric != DistanceType.InnerProduct:
        score = 2.0 * score - (cf * cf).sum(1)[None, :]
    _, probes = torch.topk(score, n_probes, dim=1, largest=True,
                           sorted=True)
    return probes.int()

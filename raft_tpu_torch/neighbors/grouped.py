"""Pair grouping for the list-major IVF-PQ scans (the port of
``raft_tpu/neighbors/grouped.py``: ``num_groups`` :48, ``touched_lists``
:65, ``build_groups`` :137, ``finalize_topk`` :235).

The query-major scan reads a probed list once per query that probes it.
Sorting the (query, probe) pairs by list into fixed groups of ``GROUP``
pairs lets one block scan a list for a whole group, so each list is read
once per group (``csrc/pq_list_scan.cu``).  A hot list gets several
groups, so padding stays under one partial group per touched list.

Two differences from the JAX module: the group count is exact (the JAX
package rounds it up for XLA's compile cache, ``round_groups``; Hopper
launches size their grids per call), and a NEGATIVE probe is mapped to
the sentinel ``n_lists`` before grouping, as probes ``>= n_lists`` are,
so its pair lands in no group.  ``probe_overlap_order`` (the TPU's DMA
reuse across adjacent groups) has no counterpart: a block stages its
list itself.
"""

from __future__ import annotations

from typing import Tuple

import torch

GROUP = 128          # pairs a group: the wgmma A tile of two warpgroups


def _list_counts(probes: torch.Tensor, n_lists: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lists, counts)``: each pair's list, the sentinel ``n_lists`` for
    a probe outside ``[0, n_lists)``, and the (n_lists,) pairs per list."""
    pl = probes.reshape(-1).long()
    pl = torch.where((pl >= 0) & (pl < n_lists), pl,
                     torch.full_like(pl, n_lists))
    # scatter_add, not bincount: bincount on a CUDA tensor waits for the
    # device to size its output
    counts = torch.zeros(n_lists + 1, dtype=torch.long, device=pl.device)
    return pl, counts.scatter_add_(0, pl, torch.ones_like(pl))[:n_lists]


def num_groups(probes: torch.Tensor, n_lists: int, group: int = GROUP
               ) -> torch.Tensor:
    """Groups the batch needs: the sum over lists of ceil(count / group),
    a 0-d tensor on the probes' device."""
    return ((_list_counts(probes, n_lists)[1] + group - 1) // group).sum()


def touched_lists(probes: torch.Tensor, n_lists: int) -> torch.Tensor:
    """Distinct in-range lists the batch probes, a 0-d tensor."""
    return (_list_counts(probes, n_lists)[1] > 0).sum()


def build_groups(probes: torch.Tensor, n_lists: int, group: int = GROUP
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket the (query, probe) pairs of ``probes`` (nq, n_probes) into
    per-list groups of ``group`` pairs (``GROUP`` for the list-major
    passes; the pair-group pass of ``csrc/pair_list_scan.cu`` takes 64 or
    fewer), on the probes' device.

    Returns ``(group_list (n_groups,) int32, slot_pairs (n_groups, group)
    int32)``: the list each group scans, and per slot the flattened pair
    index ``q * n_probes + rank``, ``P = probes.numel()`` on an empty slot.
    The pairs are sorted by list with a stable sort, so a list's pairs keep
    their order; the pair of in-list rank r of list l lands in group
    ``group_start[l] + r // group``, slot ``r % group``.  Probes outside
    ``[0, n_lists)`` (the JAX package's ``>= n_lists`` sentinels, and
    negative probes) are in no group.  ``n_groups`` is exact, so reading it
    waits for the probes.
    """
    P = probes.numel()
    dev = probes.device
    pl, counts = _list_counts(probes, n_lists)
    order = torch.sort(pl, stable=True).indices
    pl_s = pl[order]
    per_list = (counts + group - 1) // group
    # one wait: the exact group count, and the valid pairs (sorted first)
    n_groups, n_valid = torch.stack([per_list.sum(), counts.sum()]).tolist()
    group_start = torch.cumsum(per_list, 0) - per_list
    group_list = torch.repeat_interleave(
        torch.arange(n_lists, dtype=torch.int32, device=dev), per_list,
        output_size=n_groups)
    starts = torch.cumsum(counts, 0) - counts
    pls = pl_s[:n_valid]
    rank = torch.arange(n_valid, device=dev) - starts[pls]
    slot_pairs = torch.full((n_groups, group), P, dtype=torch.int32,
                            device=dev)
    slot_pairs[group_start[pls] + rank // group, rank % group] = (
        order[:n_valid].to(torch.int32))
    return group_list, slot_pairs


def finalize_topk(outd: torch.Tensor, outi: torch.Tensor, nq: int, k: int,
                  select_min: bool, sqrt: bool, select_k_fn
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final select over per-pair (or per-shard) survivors, the JAX
    package's shared epilogue (``raft_tpu/neighbors/grouped.py:235``).

    ``outd`` / ``outi`` reshape to (nq, -1), each query's candidates in a
    row; ``select_k_fn(values, k, in_idx=, select_min=)`` picks each row's
    best ``min(k, row length)``, padded to k with the worst distance and id
    -1.  The sentinel contract: a survivor at the worst distance gets id
    -1, every negative id (a tombstone's encoding) is clamped to -1, and
    ``sqrt`` takes the square root of the distances (clamped at 0) for the
    sqrt-L2 metrics."""
    worst = float("inf") if select_min else float("-inf")
    alld = outd.reshape(nq, -1)
    alli = outi.reshape(nq, -1)
    kf = min(k, alld.shape[1])
    best_d, best_i = select_k_fn(alld, kf, in_idx=alli,
                                 select_min=select_min)
    if kf < k:
        best_d = torch.cat([best_d, torch.full(
            (nq, k - kf), worst, dtype=best_d.dtype,
            device=best_d.device)], 1)
        best_i = torch.cat([best_i, torch.full(
            (nq, k - kf), -1, dtype=best_i.dtype,
            device=best_i.device)], 1)
    best_i = torch.where(best_d == worst, torch.full_like(best_i, -1),
                         torch.clamp_min(best_i, -1))
    if sqrt:
        best_d = torch.sqrt(torch.clamp_min(best_d, 0.0))
    return best_d, best_i

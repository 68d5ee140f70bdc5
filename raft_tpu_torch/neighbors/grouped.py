"""Pair grouping for the list-major IVF-PQ scans (the port of
``raft_tpu/neighbors/grouped.py``: ``num_groups`` :48, ``touched_lists``
:65, ``build_groups`` :137, ``finalize_topk`` :235).

The query-major scan reads a probed list once per query that probes it.
Sorting the (query, probe) pairs by list into fixed groups of ``GROUP``
pairs lets one block scan a list for a whole group, so each list is read
once per group (``csrc/pq_list_scan.cu``).  A hot list gets several
groups, so padding stays under one partial group per touched list.

The scan routes group at :func:`group_capacity`'s static bound
(:func:`groups_of`, as the JAX package dispatches), so nothing waits on
the host and a search can be captured in a CUDA graph (``core/aot``); a
group past the exact count holds no pair, and the kernels skip it.
``build_groups`` without ``n_groups`` counts the groups exactly (one
wait on the device).  A NEGATIVE probe is mapped to the sentinel
``n_lists`` before grouping, as probes ``>= n_lists`` are, so its pair
lands in no group.  ``probe_overlap_order`` (the TPU's DMA reuse across
adjacent groups) has no counterpart: a block stages its list itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

GROUP = 128          # pairs a group: the wgmma A tile of two warpgroups
_GROUP_ROUND = 256   # round_groups' quantum (the JAX package's)


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


def round_groups(n: int) -> int:
    """Round a group count up to the quantum (``grouped.py:74``)."""
    return -(-max(n, 1) // _GROUP_ROUND) * _GROUP_ROUND


def group_capacity(nq: int, n_probes: int, n_lists: int,
                   group: int = GROUP) -> Tuple[int, bool]:
    """``(capacity, exact)``: the static group count for
    :func:`build_groups` (``grouped.py:85`` at its default ``est``, at
    groups of ``group``).  With ``P = nq * n_probes`` pairs each touched
    list wastes at most one partial group, so ``ceil(P / group) +
    min(n_lists, P)`` groups never drop a pair; ``exact`` is always True.
    The JAX package's calibrated tightening (``est``) has no caller here:
    the port's static routes run at the bound."""
    P = nq * n_probes
    if P <= 0:
        return 1, True
    return -(-P // group) + min(n_lists, P), True


def build_groups(probes: torch.Tensor, n_lists: int, group: int = GROUP,
                 n_groups: Optional[int] = None
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
    negative probes) are in no group.  With ``n_groups=None`` the count is
    exact, so reading it waits for the probes.  A static ``n_groups``
    (:func:`group_capacity`) waits on nothing: the groups past the exact
    count take the last list with every slot empty, as the JAX package's
    do, and a pair past ``n_groups`` (none at the capacity's bound) is
    dropped.
    """
    P = probes.numel()
    dev = probes.device
    pl, counts = _list_counts(probes, n_lists)
    order = torch.sort(pl, stable=True).indices
    pl_s = pl[order]
    per_list = (counts + group - 1) // group
    if n_groups is not None:
        return _static_groups(pl_s, order, counts, per_list, n_lists, group,
                              int(n_groups))
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


def groups_of(probes: torch.Tensor, n_lists: int, group: int = GROUP
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`build_groups` of ``probes`` in groups of ``group`` at
    :func:`group_capacity`'s static count, as the grouped scan routes
    take them: no wait on the host, and the same results as the exact
    count (the groups past it are empty)."""
    return build_groups(probes, n_lists, group, group_capacity(
        probes.shape[0], probes.shape[1], n_lists, group)[0])


def _static_groups(pl_s, order, counts, per_list, n_lists: int, group: int,
                   n_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`build_groups` at a static ``n_groups``: every pair is
    scattered, the out-of-range ones (and any past ``n_groups``) into a
    row that is dropped, so nothing is sliced by a count read back."""
    P = pl_s.numel()
    dev = pl_s.device
    ends = torch.cumsum(per_list, 0)
    group_start = ends - per_list
    # the list of group g is the first whose groups end past g; groups
    # past the exact count clamp to the last list
    group_list = torch.searchsorted(
        ends, torch.arange(n_groups, device=dev), right=True).clamp_max(
            n_lists - 1).to(torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    valid = pl_s < n_lists
    lc = pl_s.clamp_max(n_lists - 1)
    rank = torch.arange(P, device=dev) - starts[lc]
    g = group_start[lc] + rank // group
    drop = ~valid | (g >= n_groups)
    g = torch.where(drop, torch.full_like(g, n_groups), g)
    s = torch.where(drop, torch.zeros_like(rank), rank % group)
    slot_pairs = torch.full((n_groups + 1, group), P, dtype=torch.int32,
                            device=dev)
    slot_pairs[g, s] = order.to(torch.int32)
    return group_list, slot_pairs[:n_groups]


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

"""Batched top-k selection (port of ``raft_tpu.matrix.select_k``).

Reference: raft/matrix/select_k.cuh:78.  The JAX package selects with
``lax.top_k``: values in IEEE total order (-NaN < -inf < ... < -0.0 < 0.0
< ... < inf < NaN), and among equal values the lower position first.  The
port keeps that order.  The values become integer keys of the same order
(reversed for the largest).  Rows of at most ``_SORT_LEN`` are sorted
whole, stably.  Longer rows go through ``torch.topk``: on the card on the
values themselves (:func:`_topk_card`), whose radix select orders them
as the keys do (a NaN with its sign bit set aside, which it takes as the
largest) and keeps the first of the k-th value's ties it meets in the
row, so only the k winners' order is settled after it; elsewhere on the
keys (:func:`_topk_keys`), whose k-th key's ties it picks in no set
order, so the first positions holding that key are found by a running
count.  Either way the k winners come out by (value, position).  The JAX package's two-pass tiled path exists for
the TPU's sort networks and is not carried over.  :func:`merge_topk` is
the streaming-selection step the JAX package shares between its tiled
scans.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.outputs import auto_convert_output
from raft_tpu_torch.core.error import expects


# rows up to this length are sorted whole (one stable sort); longer rows
# go through torch.topk
_SORT_LEN = 1024


def _order_keys(in_val: torch.Tensor, select_min: bool) -> torch.Tensor:
    """Integer keys whose ascending order is the selection order: a float's
    bits mapped to the IEEE total order (negative values' magnitude bits
    flipped), reversed bitwise when selecting the largest."""
    v = in_val
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    if v.dtype.is_floating_point:
        if v.dtype == torch.float64:
            bits, mask = v.view(torch.int64), (1 << 63) - 1
        else:
            bits, mask = v.float().view(torch.int32), 0x7FFFFFFF
        v = torch.where(bits < 0, bits ^ mask, bits)
    return v if select_min else torch.bitwise_not(v)


def _by_key_then_position(pos, key, dropped=None) -> torch.Tensor:
    """``pos`` reordered by (dropped last, key, position): stable sorts,
    the last criterion first."""
    order = torch.argsort(pos, dim=1, stable=True)
    for crit in (key, dropped):
        if crit is not None:
            order = order.gather(1, torch.argsort(
                crit.gather(1, order), dim=1, stable=True))
    return pos.gather(1, order)


def _topk_card(in_val: torch.Tensor, k: int, select_min: bool
               ) -> torch.Tensor:
    """The card's route past ``_SORT_LEN``: ``torch.topk`` on the values.
    Its radix select orders values as the keys do (but for a NaN with its
    sign bit set, which it takes as the largest), and of the k-th value's
    ties it keeps the first it meets in the row (ATen's gatherTopK, not a
    documented promise: ``chip_smoke.py`` holds this route to
    :func:`_topk_keys` on every run), so only the winners' order is left
    to settle."""
    vals, pos = torch.topk(in_val, k, dim=1, largest=not select_min,
                           sorted=True)
    return _by_key_then_position(pos, _order_keys(vals, select_min))


def _topk_keys(in_val: torch.Tensor, k: int, select_min: bool
               ) -> torch.Tensor:
    """The exact route on any device: ``torch.topk`` on the keys, whose
    choice among the k-th key's ties is arbitrary; keep the strictly
    better entries, then the first positions holding the k-th key (the
    j-th is where the running count of them first reaches j)."""
    keys = _order_keys(in_val, select_min)
    kv, kp = torch.topk(keys, k, dim=1, largest=False, sorted=True)
    kth = kv[:, -1:]
    counts = (keys == kth).cumsum(1, dtype=torch.int32)
    ranks = torch.arange(1, k + 1, dtype=torch.int32, device=kv.device)
    tied = torch.searchsorted(counts, ranks.expand(kv.shape[0], k)
                              .contiguous())
    strict = kv < kth
    need = k - strict.sum(1, keepdim=True)
    dropped = torch.cat([~strict, ranks[None, :] > need], 1)
    return _by_key_then_position(
        torch.cat([kp, tied], 1), torch.cat([kv, kth.expand(-1, k)], 1),
        dropped.to(torch.int8))[:, :k]


def _stable_topk(in_val: torch.Tensor, k: int, select_min: bool
                 ) -> torch.Tensor:
    """The positions (batch, k) int64 of each row's k best values in the
    JAX order: by value, then by position."""
    if in_val.shape[1] <= _SORT_LEN:
        return torch.sort(_order_keys(in_val, select_min), dim=1,
                          stable=True).indices[:, :k]
    if in_val.is_cuda and in_val.dtype != torch.bool:
        return _topk_card(in_val, k, select_min)
    return _topk_keys(in_val, k, select_min)


@auto_convert_output
def select_k(in_val: torch.Tensor, k: int, *,
             in_idx: Optional[torch.Tensor] = None,
             select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (or largest) values of each row with their indices,
    sorted ascending when ``select_min`` else descending, equal values in
    position order (``lax.top_k``'s rule).  ``in_idx`` is an optional
    per-element payload gathered at the selected positions (positions are
    int64 otherwise)."""
    expects(in_val.ndim == 2, "select_k: (batch, len) input required")
    length = in_val.shape[1]
    expects(0 < k <= length,
            f"select_k: need 0 < k <= len, got k={k}, len={length}")
    if in_idx is not None:
        expects(in_idx.shape == in_val.shape,
                "select_k: in_idx shape mismatch")
    idx = _stable_topk(in_val, k, select_min)
    vals = torch.gather(in_val, 1, idx)
    if in_idx is not None:
        idx = torch.gather(in_idx, 1, idx)
    return vals, idx


@auto_convert_output
def merge_topk(best_val: torch.Tensor, best_idx: torch.Tensor,
               new_val: torch.Tensor, new_idx: torch.Tensor, *,
               select_min: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a running (batch, k) top-k with (batch, kt) new candidates:
    concatenate, select k again, gather the payloads (the role
    detail/knn_merge_parts.cuh's kernel plays in the reference).  Ties
    keep the lower position of ``[best | new]``, so a running entry wins
    over an equal new one, as ``lax.top_k`` keeps it."""
    k = best_val.shape[1]
    cat_v = torch.cat([best_val, new_val], 1)
    cat_i = torch.cat([best_idx, new_idx], 1)
    key = cat_v if select_min else -cat_v
    pos = torch.sort(key, dim=1, stable=True).indices[:, :k]
    return torch.gather(cat_v, 1, pos), torch.gather(cat_i, 1, pos)

"""Tiered index invariant verification (port of ``raft_tpu.integrity.verify``:
the same levels, invariant names and coordinates).

``verify(index, level=)`` walks every invariant an index type promises,
raising :class:`IntegrityError` naming the first violation and its
coordinates.  Levels nest (each includes the previous):

``structural``
    Shape/dtype consistency of every field and derived cache, list sizes
    vs. slot validity, ids in-range and unique, CAGRA adjacency validity
    — including that the derived caches (packed code lanes where an index
    carries them, int8 recon) decode back to the bf16 recon cache, the bug
    class an extend fast path can introduce.
``statistical``
    No non-finite centroids / codebooks / data, per-list norm sanity,
    rotation orthonormality.
``full``
    The recall canary (:func:`integrity.health_check`) — requires the
    index to carry canaries and a ``res`` to search with.

Verification is host-side by design (it pulls tensors to numpy): it is an
admin/offline operation, never on the serving path.  The derived caches
are recomputed with the port's own functions (``ivf_pq._decode_lists``,
``_quantize_recon`` at the port's int8 row padding), so a port-built or
port-loaded index verifies against what the port would derive.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.integrity.errors import IntegrityError

_LEVELS = ("structural", "statistical", "full")


def _fail(invariant: str, msg: str, coord=None):
    if obs.enabled():
        obs.registry().counter("integrity.verify.failures").inc()
    raise IntegrityError(msg, invariant=invariant, coord=coord)


def _check(ok: bool, invariant: str, msg: str, coord=None) -> None:
    if not ok:
        _fail(invariant, msg, coord)


def _np(t) -> np.ndarray:
    """A tensor (any device, bf16 through float32) or array as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _pack_code_lanes(list_codes: np.ndarray) -> np.ndarray:
    """(n_lists, cap, W) uint8 packed codes -> (n_lists, Wi, cap) int32
    lane words, byte k of a row in word ``k // 4`` at bit ``8*(k % 4)``
    (the port's copy of the JAX package's ``pack_code_lanes``)."""
    L, cap, W = list_codes.shape
    Wi = -(-W // 4)
    b = np.pad(list_codes, ((0, 0), (0, 0), (0, Wi * 4 - W)))
    b = b.astype(np.uint32).reshape(L, cap, Wi, 4)
    words = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
             | (b[..., 3] << 24))
    return np.transpose(words, (0, 2, 1)).view(np.int32)


def _first_bad(mask):
    """Coordinates of the first True entry (row-major) of a violation
    mask, a numpy array or a tensor on any device."""
    idx = (mask.nonzero()[:1].cpu().numpy()
           if isinstance(mask, torch.Tensor) else np.argwhere(mask))
    return tuple(int(v) for v in idx[0]) if idx.size else None


def _at(t, coord) -> float:
    """One element of a tensor or array, as a Python float."""
    return float(t[coord])


# ---------------------------------------------------------------------------
# shared IVF list-layout invariants
# ---------------------------------------------------------------------------

def _verify_ivf_lists(kind: str, list_indices: np.ndarray,
                      list_sizes: np.ndarray, capacity: int) -> None:
    n_lists = list_sizes.shape[0]
    _check(list_indices.shape == (n_lists, capacity),
           f"{kind}.list_indices.shape",
           f"list_indices shape {list_indices.shape} != "
           f"{(n_lists, capacity)}")
    _check(list_indices.dtype == np.int32, f"{kind}.list_indices.dtype",
           f"list_indices dtype {list_indices.dtype} != int32")
    _check(list_sizes.dtype == np.int32, f"{kind}.list_sizes.dtype",
           f"list_sizes dtype {list_sizes.dtype} != int32")

    bad = (list_sizes < 0) | (list_sizes > capacity)
    if bad.any():
        li = int(np.argmax(bad))
        _fail(f"{kind}.list_sizes.range",
              f"list {li} has size {int(list_sizes[li])} outside "
              f"[0, {capacity}]", coord=(li,))

    # slot occupancy must match the size vector exactly: each list's
    # first `size` slots hold a live id (>= 0) or a tombstone (<= -2,
    # see neighbors/mutate), the padding holds -1.  A tombstone outside
    # the occupied prefix, or a -1 inside it, is corruption.
    slot = np.arange(capacity)[None, :]
    should_be_valid = slot < list_sizes[:, None]
    valid = list_indices >= 0
    tomb = list_indices <= -2
    mism = (valid | tomb) != should_be_valid
    if mism.any():
        li, sl = _first_bad(mism)
        state = ("valid id" if valid[li, sl]
                 else "tombstone" if tomb[li, sl]
                 else "empty slot (-1)")
        want = int(list_sizes[li])
        _fail(f"{kind}.list_sizes.slots",
              f"list {li} slot {sl} holds a {state} but list size is "
              f"{want} — sizes and slot occupancy disagree (stale size "
              f"after extend/delete?)", coord=(li, sl))

    # uniqueness is enforced among LIVE ids only: a tombstone sharing an
    # id with a live slot is the legitimate delete -> re-insert pattern
    # (the rebalancer's recluster step tombstones a row and re-extends it
    # under the same id), and stale tombstones carry no search-visible
    # state — they are garbage pending compaction, not invariants
    ids = list_indices[valid]
    if ids.size:
        uniq, counts = np.unique(ids, return_counts=True)
        if (counts > 1).any():
            dup = int(uniq[np.argmax(counts > 1)])
            li, sl = _first_bad(list_indices == dup)
            _fail(f"{kind}.ids.unique",
                  f"live source id {dup} appears {int(counts.max())} "
                  f"times (first at list {li} slot {sl})",
                  coord=(li, sl))


def _verify_ids_in_range(kind: str, list_indices: np.ndarray,
                         n_rows: int) -> None:
    """Default id-space convention: source ids are ``0..n_rows-1`` with
    ``n_rows = sum(list_sizes)`` (what ``build(add_data_on_build=True)``
    produces).  Indexes extended with a custom sparse id space pass their
    true universe size via ``verify(..., n_rows=)`` — in particular
    after delete + compact, which makes the live id space sparse while
    shrinking ``sum(list_sizes)``."""
    # decoded view: tombstones (<= -2, neighbors/mutate) map back to the
    # original source id so deleted rows stay range-checked too
    dec = np.where(list_indices <= -2,
                   -list_indices.astype(np.int64) - 2,
                   list_indices.astype(np.int64))
    occupied = (list_indices >= 0) | (list_indices <= -2)
    too_big = occupied & (dec >= n_rows)
    if too_big.any():
        li, sl = _first_bad(too_big)
        _fail(f"{kind}.ids.range",
              f"source id {int(dec[li, sl])} at list {li} slot "
              f"{sl} is >= the index's {n_rows} rows", coord=(li, sl))


def _verify_namespaces(kind: str, live_ids: np.ndarray,
                       namespaces) -> None:
    """Tenant-namespace invariants: the declared id ranges
    must be pairwise disjoint, and every live id must fall inside some
    declared tenant's range — otherwise a filtered search could leak a
    row to the wrong tenant (or to nobody).  ``namespaces`` is a
    :class:`raft_tpu_torch.filters.TenantFilter`; violations raise the typed
    error naming the violating (tenant, id)."""
    spans = sorted((int(lo), int(hi), t)
                   for t, (lo, hi) in namespaces.ranges.items())
    for (lo, hi, t) in spans:
        if not (0 <= lo <= hi):
            _fail("namespace.range",
                  f"tenant {t!r} declares an invalid id range "
                  f"[{lo}, {hi})", coord=(t, lo))
    for (lo0, hi0, t0), (lo1, hi1, t1) in zip(spans, spans[1:]):
        if hi0 > lo1:
            _fail("namespace.disjoint",
                  f"tenant ranges overlap: {t0!r} [{lo0},{hi0}) and "
                  f"{t1!r} [{lo1},{hi1}) — an id in the overlap would "
                  f"serve two tenants", coord=(t0, t1))
    live = np.unique(live_ids[live_ids >= 0].astype(np.int64))
    if live.size == 0:
        return
    los = np.asarray([s[0] for s in spans], np.int64)
    his = np.asarray([s[1] for s in spans], np.int64)
    j = np.searchsorted(los, live, side="right") - 1
    inside = (j >= 0) & (live < his[np.clip(j, 0, len(his) - 1)])
    if not inside.all():
        i = int(live[int(np.argmin(inside))])
        _fail("namespace.coverage",
              f"{kind}: live id {i} falls outside every declared tenant "
              f"namespace — it is unreachable under tenant filtering",
              coord=(namespaces.owner_of(i), i))


def _verify_finite(kind: str, name: str, arr: np.ndarray) -> None:
    fin = np.isfinite(arr)
    if not fin.all():
        coord = _first_bad(~fin)
        _fail(f"{kind}.{name}.finite",
              f"{name} has a non-finite value at {coord}", coord=coord)


# ---------------------------------------------------------------------------
# per-index-type verifiers
# ---------------------------------------------------------------------------

def _verify_ivf_flat(index, level: str, n_rows=None) -> None:
    centers = _np(index.centers)
    sizes = _np(index.list_sizes)
    lidx = _np(index.list_indices)
    kind = "ivf_flat"

    _check(index.list_data.ndim == 3 and
           index.list_data.shape[:2] == (index.n_lists, index.capacity),
           f"{kind}.list_data.shape",
           f"list_data shape {index.list_data.shape} inconsistent with "
           f"{index.n_lists} lists x capacity {index.capacity}")
    _check(centers.shape == (index.n_lists, index.dim),
           f"{kind}.centers.shape",
           f"centers shape {centers.shape} != "
           f"{(index.n_lists, index.dim)}")
    _verify_ivf_lists(kind, lidx, sizes, index.capacity)
    _verify_ids_in_range(kind, lidx,
                         int(sizes.sum()) if n_rows is None else n_rows)

    if index.list_data_sq is not None:
        _check(index.list_data_sq.shape == (index.n_lists, index.capacity),
               f"{kind}.list_data_sq.shape",
               f"list_data_sq shape {index.list_data_sq.shape} != "
               f"{(index.n_lists, index.capacity)}")
        want = (index.list_data.float() ** 2).sum(-1)
        got = index.list_data_sq.float()
        valid = index.list_indices >= 0
        coord = _first_bad(valid & ~torch.isclose(got, want, rtol=1e-4,
                                                  atol=1e-3))
        if coord is not None:
            _fail(f"{kind}.list_data_sq.stale",
                  f"cached norm at {coord} is {_at(got, coord):.6g}, "
                  f"recompute gives {_at(want, coord):.6g} — stale derived "
                  f"cache", coord=coord)

    if level in ("statistical", "full"):
        _verify_finite(kind, "centers", centers)
        row_fin = torch.isfinite(index.list_data.float()).all(-1)
        coord = _first_bad((index.list_indices >= 0) & ~row_fin)
        if coord is not None:
            _fail(f"{kind}.list_data.finite",
                  f"stored vector at list {coord[0]} slot {coord[1]} has "
                  f"non-finite values", coord=coord)


def _verify_ivf_pq(index, level: str, n_rows=None) -> None:
    from raft_tpu_torch.neighbors import ivf_pq

    kind = "ivf_pq"
    centers = _np(index.centers)
    sizes = _np(index.list_sizes)
    lidx = _np(index.list_indices)
    L, cap = index.n_lists, index.capacity

    _check(index.rot_dim % index.pq_dim == 0, f"{kind}.rot_dim.divisible",
           f"rot_dim {index.rot_dim} not divisible by pq_dim "
           f"{index.pq_dim}")
    _check(index.pq_len == index.rot_dim // index.pq_dim,
           f"{kind}.codebooks.pq_len",
           f"codebook sub-dim {index.pq_len} != rot_dim/pq_dim "
           f"{index.rot_dim // index.pq_dim}")
    want_w = ivf_pq.packed_code_width(index.pq_dim, index.pq_bits)
    _check(index.code_width == want_w, f"{kind}.list_codes.width",
           f"packed code width {index.code_width} != "
           f"ceil(pq_dim*pq_bits/8) = {want_w}")
    _check(index.list_codes.dtype == torch.uint8, f"{kind}.list_codes.dtype",
           f"list_codes dtype {index.list_codes.dtype} != uint8")
    book = (index.pq_dim
            if index.codebook_kind == ivf_pq.CodebookKind.PER_SUBSPACE
            else L)
    _check(index.codebooks.shape ==
           (book, index.pq_book_size, index.pq_len),
           f"{kind}.codebooks.shape",
           f"codebooks shape {index.codebooks.shape} != "
           f"{(book, index.pq_book_size, index.pq_len)}")
    _check(index.rotation.shape == (index.dim, index.rot_dim),
           f"{kind}.rotation.shape",
           f"rotation shape {index.rotation.shape} != "
           f"{(index.dim, index.rot_dim)}")
    _verify_ivf_lists(kind, lidx, sizes, cap)
    _verify_ids_in_range(kind, lidx,
                         int(sizes.sum()) if n_rows is None else n_rows)

    valid = lidx >= 0
    valid_t = index.list_indices >= 0      # the same mask on the device
    recon_ref = None     # lazily recomputed bf16 recon (codes are truth)

    def _recon_recompute():
        nonlocal recon_ref
        if recon_ref is None:
            recon_ref = ivf_pq._decode_lists(
                index.codebooks, index.list_codes, index.pq_dim,
                index.pq_bits, index.codebook_kind)
        return recon_ref

    if index.list_recon is not None:
        _check(index.list_recon.shape == (L, cap, index.rot_dim),
               f"{kind}.list_recon.shape",
               f"list_recon shape {index.list_recon.shape} != "
               f"{(L, cap, index.rot_dim)}")
        coord = _first_bad(valid_t[:, :, None] & (
            index.list_recon.float() != _recon_recompute().float()))
        if coord is not None:
            _fail(f"{kind}.list_recon.stale",
                  f"recon cache at list {coord[0]} slot {coord[1]} dim "
                  f"{coord[2]} does not decode from the stored codes — "
                  f"stale derived cache", coord=coord)
        if index.list_recon_sq is not None:
            got_sq = index.list_recon_sq.float()
            want_sq = ivf_pq._recon_sq(_recon_recompute())
            coord = _first_bad(valid_t & ~torch.isclose(
                got_sq, want_sq, rtol=1e-3, atol=1e-3))
            if coord is not None:
                _fail(f"{kind}.list_recon_sq.stale",
                      f"cached recon norm at {coord} is "
                      f"{_at(got_sq, coord):.6g}, recompute gives "
                      f"{_at(want_sq, coord):.6g}", coord=coord)

    if index.list_code_lanes is not None:
        want_lanes = _pack_code_lanes(_np(index.list_codes))
        got_lanes = _np(index.list_code_lanes)
        _check(got_lanes.shape == want_lanes.shape,
               f"{kind}.list_code_lanes.shape",
               f"code-lane cache shape {got_lanes.shape} != "
               f"{want_lanes.shape}")
        stale = (got_lanes != want_lanes) & valid[:, None, :]
        if stale.any():
            coord = _first_bad(stale)
            _fail(f"{kind}.list_code_lanes.stale",
                  f"packed code lane at list {coord[0]} word {coord[1]} "
                  f"slot {coord[2]} does not repack from the stored "
                  f"codes", coord=coord)

    if index.list_recon_i8 is not None:
        # the port pads int8 rows to a multiple of 16 bytes (the JAX
        # package to 128): recompute at the port's padding
        rot_pad = ivf_pq._round_up(index.rot_dim, 16)
        qi, scale, _ = ivf_pq._quantize_recon(_recon_recompute(), rot_pad)
        got_i8 = index.list_recon_i8
        _check(tuple(got_i8.shape) == tuple(qi.shape),
               f"{kind}.list_recon_i8.shape",
               f"int8 recon shape {tuple(got_i8.shape)} != "
               f"{tuple(qi.shape)}")
        coord = _first_bad((got_i8 != qi) & valid_t[:, :, None])
        if coord is not None:
            _fail(f"{kind}.list_recon_i8.stale",
                  f"int8 recon at list {coord[0]} slot {coord[1]} lane "
                  f"{coord[2]} does not re-quantize from the stored "
                  f"codes — stale derived cache (extend without "
                  f"re-quantization?)", coord=coord)
        if index.list_recon_scale is not None:
            got_s = index.list_recon_scale.float()
            bad = _first_bad(~torch.isclose(got_s, scale, rtol=1e-5))
            if bad is not None:
                li = bad[0]
                _fail(f"{kind}.list_recon_scale.stale",
                      f"int8 scale of list {li} is {_at(got_s, li):.6g}, "
                      f"recompute gives {_at(scale, li):.6g}",
                      coord=(li,))

    if level in ("statistical", "full"):
        _verify_finite(kind, "centers", centers)
        _verify_finite(kind, "codebooks",
                       _np(index.codebooks).astype(np.float32))
        _verify_finite(kind, "rotation", _np(index.rotation))
        rot = _np(index.rotation).astype(np.float64)
        gram = rot.T @ rot
        if not np.allclose(gram, np.eye(rot.shape[1]), atol=1e-3):
            _fail(f"{kind}.rotation.orthonormal",
                  "rotation columns are not orthonormal "
                  f"(max |R^T R - I| = "
                  f"{np.abs(gram - np.eye(rot.shape[1])).max():.3g})")
        if index.list_recon_sq is not None:
            sq = index.list_recon_sq.float()
            coord = _first_bad(valid_t & (~torch.isfinite(sq) | (sq < 0)))
            if coord is not None:
                _fail(f"{kind}.list_recon_sq.sane",
                      f"recon norm at {coord} is {_at(sq, coord)!r} "
                      f"(negative or non-finite)", coord=coord)


def _verify_cagra(index, level: str) -> None:
    kind = "cagra"
    n = index.size
    graph = _np(index.graph)

    _check(graph.ndim == 2 and graph.shape[0] == n, f"{kind}.graph.shape",
           f"graph shape {graph.shape} inconsistent with {n} dataset "
           f"rows")
    _check(graph.dtype == np.int32, f"{kind}.graph.dtype",
           f"graph dtype {graph.dtype} != int32")
    _check(1 <= index.graph_degree <= max(n - 1, 1),
           f"{kind}.graph.degree",
           f"graph degree {index.graph_degree} invalid for {n} nodes")

    oob = (graph < 0) | (graph >= n)
    if oob.any():
        coord = _first_bad(oob)
        _fail(f"{kind}.graph.range",
              f"edge {coord} points at node {int(graph[coord])}, outside "
              f"[0, {n})", coord=coord)
    self_loop = graph == np.arange(n, dtype=graph.dtype)[:, None]
    if self_loop.any():
        coord = _first_bad(self_loop)
        _fail(f"{kind}.graph.self_loop",
              f"node {coord[0]} lists itself as neighbor (edge slot "
              f"{coord[1]})", coord=coord)

    if level in ("statistical", "full"):
        bad = _first_bad(~torch.isfinite(index.dataset.float()).all(-1))
        if bad is not None:
            r = bad[0]
            _fail(f"{kind}.dataset.finite",
                  f"dataset row {r} has non-finite values", coord=(r,))


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def verify(index, level: str = "structural", *, res=None,
           n_rows=None, namespaces=None) -> None:
    """Verify every invariant of ``index`` at the given level; raises
    :class:`IntegrityError` naming the first violation.  ``level="full"``
    additionally runs the recall canary and therefore requires ``res``
    and a canary-carrying index (see ``integrity.canary``).

    ``n_rows`` overrides the id-space bound for the source-id range
    check; the default assumes the build convention (ids are exactly
    ``0..sum(list_sizes)-1``).  Pass the true universe size for indexes
    extended with custom ids.

    ``namespaces``: a :class:`raft_tpu_torch.filters.TenantFilter`
    declaring the tenant id ranges the index serves under — checked for
    pairwise disjointness and full coverage of every live id (invariants
    ``namespace.disjoint`` / ``namespace.coverage``, coord = the
    violating (tenant, id))."""
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    if level not in _LEVELS:
        raise ValueError(f"verify: unknown level {level!r}; expected one "
                         f"of {_LEVELS}")
    if obs.enabled():
        obs.registry().counter("integrity.verify.calls").inc()
    with obs.stage("verify"):
        if isinstance(index, ivf_flat.Index):
            _verify_ivf_flat(index, level, n_rows)
            if namespaces is not None:
                _verify_namespaces("ivf_flat",
                                   _np(index.list_indices),
                                   namespaces)
        elif isinstance(index, ivf_pq.Index):
            _verify_ivf_pq(index, level, n_rows)
            if namespaces is not None:
                _verify_namespaces("ivf_pq",
                                   _np(index.list_indices),
                                   namespaces)
        elif isinstance(index, cagra.Index):
            _verify_cagra(index, level)
            if namespaces is not None:
                # cagra ids are implicit dataset row positions
                _verify_namespaces(
                    "cagra", np.arange(index.size, dtype=np.int64),
                    namespaces)
        else:
            raise TypeError(
                f"verify: unsupported index type {type(index).__name__}")
        if level == "full":
            from raft_tpu_torch.integrity import canary as _canary
            if getattr(index, "canaries", None) is None:
                _fail("canary.missing",
                      "level='full' requires a canary-carrying index "
                      "(build with canaries=...)")
            if res is None:
                raise ValueError(
                    "verify: level='full' needs res= to search with")
            _canary.health_check(res, index, raise_on_fail=True)

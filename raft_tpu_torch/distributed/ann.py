"""Sharded ANN indexes by row (port of ``raft_tpu.distributed.ann``'s
data-parallel placement): IVF-PQ, IVF-Flat and CAGRA.

The reference ships the seam, not the algorithm: row-sharded ANN with
per-part search and a top-k merge (``knn_merge_parts``,
neighbors/brute_force.cuh:80; the ANN bench's ``multigpu`` option,
docs/source/cuda_ann_benchmarks.md:163).  As :mod:`raft_tpu_torch.
distributed.knn`, one process a rank over :mod:`raft_tpu_torch.comms`:

- **build**: the rows are split evenly over the ranks; each rank trains
  its own local index over its ``shard_rows`` (ids offset to global) and
  holds only that shard.  Where the JAX package's two-phase SPMD build
  runs (per-subspace books, fewer lists than the mesoscale threshold and
  than a shard's rows, data added, no canaries), so does the port's: a
  strided trainset and strided initial centers, the balanced loop (Kernel
  A), one rotation at seed 7, books and codes, and ONE collective, the
  allreduce MAX of the list sizes, fixing the common capacity.  Otherwise
  each rank runs ``ivf_pq.build`` on its shard.  Every shard is padded to
  the common capacity, as the JAX package's stacked leaves are.
- **search**: every rank scans its shard with the single-index scans
  (Kernel B, Kernel G, the lookup-table scan), then one ``allgather`` of
  the (q, k) candidates and the same merge on every rank
  (:func:`raft_tpu_torch.neighbors.grouped.finalize_topk`).

The JAX ``DistributedIndex`` is one pytree stacked ``(n_dev, ...)`` over a
mesh; here a rank's :class:`DistributedIndex` holds its own local index
and the shard count.  What the JAX code reads off another shard's leaves
comes through a collective: the common capacity (allreduce MAX), CAGRA's
projection dim (calibrated on rank 0, broadcast), ``health_check``'s
reports (allgathered).

Every rank calls every entry point in the same order with the same
arguments (queries, filters, failed shards, fault plan, health tracker),
as every rank runs the same program in the JAX package.  The host-side
decisions (the failed set, the fault sites, the straggler schedule, the
scan form, the retry) are made alike on every rank before and around the
collectives, so a fault raised on one rank is raised on all of them: a
test installs the same seeded ``FaultPlan`` on every rank.  A failed shard
still joins every collective (the group would hang without it): it skips
its scan and contributes ``(±inf, -1)`` candidates.  A straggler pays its
own injected delay before its scan, so the merge ends when the slowest
shard answers.

Scan-mode table, by row (:func:`_resolve_scan_mode`).  The port runs its
kernels where the JAX package runs its Pallas kernels, so it follows the
JAX table's TPU column: ``auto`` / ``fused`` -> Kernel B where its gate
admits the shape, else Kernel G (a refused ``fused`` counts a fused
fallback; not a lowering); ``recon`` -> the probe-order recon scan, which
the port runs as Kernel G with kt = min(k, capacity) (the same recon
distances); ``lut`` -> the lookup-table scan; ``codes`` -> the lookup-table
scan, reported lowered (status :data:`SHARD_OK_FALLBACK`); ``recon8`` ->
the recon scan, lowered.  InnerProduct's recon scans are the composition
``ivf_pq._search_recon_ip``.  On the CPU the JAX package takes the other
column (``auto`` -> the probe-order scan, ``codes`` not lowered, ``fused``
counting a ``backend`` fallback): ROADMAP.md §3 lists the differences.

The routed placement (``placement="by_list"``, :class:`RoutedIndex`): ONE
global coarse quantizer, the IVF lists partitioned over the ranks by live
list size (:func:`compute_placement`, optionally ``r`` copies of each list
on distinct ranks).  A rank holds the replicated leaves (coarse centres,
rotation, codebooks, placement: rank 0's, broadcast, never built on each
rank) and its own lists as a local ``ivf_pq.Index`` of ``n_local + 1``
slots.  Every rank ranks the same probe set from the replicated leaves; a
probe whose list this rank does not serve under the effective (owner,
slot) tables becomes the out-of-range slot ``n_local + 1``, which the
grouping drops on every route (list-major, pair-group and plain), so it
costs nothing.  Each rank scans its own probes with Kernel C, B or G
(the table's TPU column: ``auto`` / ``fused`` -> C on code leaves where
C's gate admits the shape, else B, else G with a counted fused fallback;
``recon`` -> G at kt = min(k, capacity); ``lut`` / ``codes`` / ``recon8``
-> that recon form, lowered), then one allgather carries each rank's (q,
k) candidates with its scanned and admitted counts, and every rank merges
the same answer.  Failover and hedged reads swap the effective tables
(:meth:`Placement.healthy_routing`, or a :class:`~raft_tpu_torch.
distributed.routing.RoutingPolicy`'s plan); where a rank's own tracker
or policy steers the route, rank 0 decides it and broadcasts it whole.
A rank that is down still joins the allgather with ``(±inf, -1)``.  The admin
operations (:func:`rebalance_placement`, :func:`serialize_routed`,
``health.catch_up``) gather the global lists, one allgather a leaf, so
every rank calls them and ends with the same index; streams are the JAX
package's byte for byte.
"""

from __future__ import annotations

import copy
import dataclasses
import io
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.cluster import kmeans_balanced as kb
from raft_tpu_torch.comms.comms import op_t
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.filters.bitset import query_filter_words, words_on_device
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.integrity.errors import IntegrityError
from raft_tpu_torch.integrity.verify import _pack_code_lanes
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import cagra, grouped, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops.pair_scan import ivf_flat_scan
from raft_tpu_torch.ops.vmem_budget import merge_window_request
from raft_tpu_torch.resilience import faults
from raft_tpu_torch.resilience import retry as _retry
from raft_tpu_torch.utils import precision

# per-shard status codes (the ``return_status=True`` vector), the JAX
# package's: OK_FALLBACK marks a live shard whose requested scan_mode was
# lowered to another formulation; REPLICA_SERVED belongs to the routed
# placement
SHARD_FAILED = 0
SHARD_OK = 1
SHARD_OK_FALLBACK = 2
SHARD_REPLICA_SERVED = 3

def _entry(site, fn, retry_policy, deadline):
    """Run an entry point under retry / deadline with the host-side fault
    site checked per attempt.  An attempt is the rank's scan and its
    collectives together."""
    def attempt():
        faults.maybe_fail(site)
        return fn()
    return _retry.retry_call(attempt, site=site, policy=retry_policy,
                             deadline=deadline)


def _degraded_set(n_shards: int, failed_shards: Sequence[int]
                  ) -> Tuple[int, ...]:
    """Union of caller-flagged shards and the active fault plan's
    ``fail_shards``, clipped to range and sorted."""
    flagged = {int(s) for s in failed_shards if 0 <= int(s) < n_shards}
    return tuple(sorted(flagged | set(faults.failed_shards(n_shards))))


def _status_vector(n_shards: int, failed: Tuple[int, ...], lowered: bool,
                   device=None, replica_served: Tuple[int, ...] = ()
                   ) -> torch.Tensor:
    """(n_shards,) int8 per-shard status: :data:`SHARD_FAILED` for the
    failed shards, :data:`SHARD_REPLICA_SERVED` for a down shard whose
    lists replicas served, else :data:`SHARD_OK_FALLBACK` when the
    requested scan mode was lowered, else :data:`SHARD_OK`."""
    status = torch.full((n_shards,),
                        SHARD_OK_FALLBACK if lowered else SHARD_OK,
                        dtype=torch.int8)
    status[list(failed)] = SHARD_FAILED
    status[list(replica_served)] = SHARD_REPLICA_SERVED
    return status.to(device) if device is not None else status


@dataclasses.dataclass(frozen=True)
class _ScanResolution:
    """Host-side resolution of the shard-local scan: ``form`` is
    ``probe_recon`` (the recon scan at kt = min(k, capacity)),
    ``grouped_recon`` (Kernel G at the requested kt), ``fused_recon``
    (Kernel B), ``fused_codes`` (Kernel C, routed only) or ``lut`` (the
    lookup-table scan, by row only); ``lowered`` marks a formulation
    downgrade (status :data:`SHARD_OK_FALLBACK`)."""

    form: str
    lowered: bool
    kt: int = 0


def _note_lowered(mode: str) -> None:
    """Count a lowered scan mode (``distributed.ann.scan_mode_lowered``,
    and ``ivf_pq.search.fused_fallback`` for ``fused``) and record the
    ``distributed.scan_mode_lowered`` flight event."""
    if obs.enabled():
        obs.registry().counter("distributed.ann.scan_mode_lowered").inc()
        if mode == "fused":
            obs.registry().counter("ivf_pq.search.fused_fallback").inc()
    rec = obs.trace.current()
    _flight.record_event("distributed.scan_mode_lowered",
                         trace_id=rec.trace_id if rec else None,
                         requested=mode)


def _resolve_scan_mode(params, index, nq: int, n_probes: int,
                       k: int) -> _ScanResolution:
    """``params.scan_mode`` to the shard-local scan, by the JAX table's
    TPU column (see the module docstring); host-only."""
    del nq, n_probes  # the JAX table's group capacity; no use here
    mode = getattr(params, "scan_mode", "auto")
    expects(mode in ivf_pq._SCAN_MODES,
            f"distributed.ann.search: unknown scan_mode {mode!r}")
    if isinstance(index, RoutedIndex):
        return _resolve_routed(params, index, mode, k)
    local = index.local
    kt = min(int(getattr(params, "per_probe_topk", 0) or 0) or k,
             local.capacity)
    if mode in ("lut", "codes"):
        # no code-scan kernel by row, as the JAX package's stacked pytree
        # has no lane-packed codes: a codes request is a downgrade
        if mode == "codes":
            _note_lowered(mode)
        return _ScanResolution("lut", lowered=mode == "codes", kt=kt)
    if mode == "recon8":
        _note_lowered(mode)  # no int8 cache by row
        return _ScanResolution("probe_recon", lowered=True)
    if mode == "recon":
        return _ScanResolution("probe_recon", lowered=False)
    merge_window_request(getattr(params, "merge_window", "auto"))
    _, _, reason = ivf_pq._recon_scan(local, k, kt, True)
    if not reason:
        return _ScanResolution("fused_recon", lowered=False, kt=kt)
    if mode == "fused":
        # Kernel G runs: the single-index search's fallback signal
        # (``ivf_pq.search.fused_fallback`` and its reason), not a
        # lowering, so the status stays SHARD_OK
        ivf_pq._note_fused_fallback(reason)
    return _ScanResolution("grouped_recon", lowered=False, kt=kt)


def _resolve_routed(params, index, mode: str, k: int) -> _ScanResolution:
    """The routed rows of the table's TPU column: ``lut`` / ``codes`` /
    ``recon8`` lowered to the probe-order recon form (a routed shard has
    no lookup-table or int8 scan); ``recon`` that form; ``auto`` /
    ``fused`` Kernel C where the index carries its code leaves and C's
    gate admits the shape, else Kernel B, else Kernel G (a refused
    ``fused`` counts a fused fallback, not a lowering)."""
    if mode in ("lut", "codes", "recon8"):
        _note_lowered(mode)
        return _ScanResolution("probe_recon", lowered=True)
    if mode == "recon":
        return _ScanResolution("probe_recon", lowered=False)
    local = index.local
    kt = min(int(getattr(params, "per_probe_topk", 0) or 0) or k,
             local.capacity)
    merge_window_request(getattr(params, "merge_window", "auto"))
    if (local.list_codes is not None
            and local.metric in ivf_pq.L2_METRICS
            and not pcs.codes_fused_reject_reason(
                local.capacity, local.rot_dim, local.pq_dim, local.pq_bits,
                k, kt)):
        return _ScanResolution("fused_codes", lowered=False, kt=kt)
    _, _, reason = ivf_pq._recon_scan(local, k, kt, True)
    if not reason:
        return _ScanResolution("fused_recon", lowered=False, kt=kt)
    if mode == "fused":
        ivf_pq._note_fused_fallback(reason)
    return _ScanResolution("grouped_recon", lowered=False, kt=kt)


# ---------------------------------------------------------------------------
# the indexes: a rank's shard
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistributedIndex:
    """A rank's shard of a by-row IVF-PQ index: ``local`` is the rank's
    ``ivf_pq.Index`` (GLOBAL ids, the common capacity), ``n_shards`` the
    rank count and ``rank`` this rank's; ``size`` counts the rows of all
    shards.  ``shard_canaries`` holds this shard's recall canaries (ids
    global), or None."""

    local: ivf_pq.Index
    n_shards: int
    rank: int
    metric: int = DistanceType.L2Expanded
    size: int = 0
    shard_canaries: Optional[_canary.CanarySet] = None
    generation: int = 0


@dataclasses.dataclass
class DistributedFlatIndex:
    """A rank's shard of a by-row IVF-Flat index (``local``: GLOBAL ids,
    the common capacity)."""

    local: ivf_flat.Index
    n_shards: int
    rank: int
    metric: int = DistanceType.L2Expanded
    size: int = 0
    shard_canaries: Optional[_canary.CanarySet] = None
    generation: int = 0


@dataclasses.dataclass
class DistributedCagraIndex:
    """A rank's shard of a by-row CAGRA index: ``local`` holds LOCAL ids
    (0..per-1), which search shifts by the shard's offset.  ``walk`` is
    the packed walk table and entry set at the projection dim calibrated
    on rank 0; ``use_walk`` False (calibration failed, or the table
    exceeds ``cagra._WALK_TABLE_MAX_BYTES``) searches by the direct
    walk over ``graph``, as single-index ``cagra.search`` does.
    ``shard_canaries`` carry local ids."""

    local: cagra.Index
    n_shards: int
    rank: int
    metric: int = DistanceType.L2Expanded
    size: int = 0
    use_walk: bool = True
    walk: Optional[object] = None
    shard_canaries: Optional[_canary.CanarySet] = None
    generation: int = 0


def _shard_layout(handle, dataset):
    """(comms, n, ranks, rank, per): the even split of ``dataset``'s rows
    over the handle's communicator."""
    comms = handle.get_comms()
    n = dataset.shape[0]
    n_dev = comms.get_size()
    expects(n % n_dev == 0,
            f"distributed.ann: n ({n}) must divide evenly over "
            f"{n_dev} devices (pad the input)")
    return comms, n, n_dev, comms.get_rank(), n // n_dev


def _shard_rows(handle, dataset, rank, per) -> torch.Tensor:
    return ensure_tensor(dataset[rank * per:(rank + 1) * per], handle,
                         "dataset")


def _globalize(list_indices: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(list_indices >= 0, list_indices + offset,
                       torch.full_like(list_indices, -1))


def _offset_canaries(local, offset: int):
    """The local index's canaries with their ids shifted by ``offset``
    (the JAX ``_collect_canaries``), taken off the local index."""
    cs = getattr(local, "canaries", None)
    local.canaries = None
    if cs is not None and offset:
        cs = dataclasses.replace(cs, gt_ids=cs.gt_ids + offset)
    return cs


_DERIVED = ("list_code_rsq", "list_recon_i8", "list_recon_scale",
            "list_recon_i8_sq")


def _pad_capacity(local, cap: int):
    """``local`` with every per-slot tensor (n_lists, capacity, ...)
    padded to ``cap`` slots (ids -1, everything else 0); the derived
    caches a search rebuilds are dropped."""
    old = local.capacity
    if cap == old:
        return local
    pads = {name: None for name in _DERIVED if hasattr(local, name)}
    for f in dataclasses.fields(local):
        t = getattr(local, f.name)
        if (f.name in pads or not isinstance(t, torch.Tensor) or t.ndim < 2
                or tuple(t.shape[:2]) != (local.n_lists, old)):
            continue
        pad = t.new_full((t.shape[0], cap - old) + tuple(t.shape[2:]),
                         -1 if f.name == "list_indices" else 0)
        pads[f.name] = torch.cat([t, pad], 1)
    return dataclasses.replace(local, **pads)


def _shard_index(handle, local, size: int, *, canaries=None):
    """A rank's :class:`DistributedIndex` / :class:`DistributedFlatIndex`
    from its local index (GLOBAL ids): the counterpart of the JAX
    ``_stack_leaves``.  Collective: one allreduce MAX gives the common
    capacity, to which the shard is padded.  Every rank calls it."""
    comms = handle.get_comms()
    cap = int(comms.allreduce(torch.tensor(local.capacity, dtype=torch.int64),
                              op_t.MAX))
    cls = (DistributedIndex if isinstance(local, ivf_pq.Index)
           else DistributedFlatIndex)
    return cls(local=_pad_capacity(local, cap), n_shards=comms.get_size(),
               rank=comms.get_rank(), metric=local.metric, size=size,
               shard_canaries=canaries)


# ---------------------------------------------------------------------------
# IVF-PQ build
# ---------------------------------------------------------------------------

def build(handle, params: ivf_pq.IndexParams, dataset, *,
          placement: str = "by_row", replication_factor: int = 1,
          retry_policy: Optional[_retry.RetryPolicy] = None,
          deadline: Optional[_retry.Deadline] = None) -> DistributedIndex:
    """Build a sharded IVF-PQ index over the handle's communicator:
    ``dataset`` is the whole (n, d) array on every rank (numpy, or a
    tensor on the CPU or the rank's device).  ``placement="by_row"``: each
    rank indexes its rows; ``params.n_lists`` is per shard.
    ``placement="by_list"``: ONE global index is built on rank 0
    (``params.n_lists`` global), sent to every rank, and its lists are
    partitioned over the ranks (:func:`shard_by_list`, with
    ``replication_factor`` copies of each list); returns the rank's
    :class:`RoutedIndex`.  Transient faults at entry (site
    ``distributed.ann.build``) are retried under ``retry_policy`` /
    ``deadline``."""
    expects(placement in ("by_row", "by_list"),
            f"distributed.ann.build: placement must be 'by_row' or "
            f"'by_list', got {placement!r}")
    expects(replication_factor == 1 or placement == "by_list",
            "distributed.ann.build: replication_factor > 1 requires "
            "placement='by_list' (by_row is already fully replicated "
            "per shard's rows)")
    if placement == "by_list":
        return _entry("distributed.ann.build",
                      lambda: _build_by_list(
                          handle, params, dataset,
                          replication_factor=replication_factor),
                      retry_policy, deadline)
    return _entry("distributed.ann.build",
                  lambda: _build_impl(handle, params, dataset),
                  retry_policy, deadline)


def _build_impl(handle, params: ivf_pq.IndexParams,
                dataset) -> DistributedIndex:
    with named_range("distributed::ivf_pq_build"):
        expects(handle.comms_initialized(),
                "distributed.ann.build: handle has no comms (use "
                "CommsSession.worker_handle())")
        comms, n, _, rank, per = _shard_layout(handle, dataset)
        expects(params.cache_reconstructions,
                "distributed.ann: the sharded search kernel runs the "
                "reconstruction path; cache_reconstructions must be True")
        shard = _shard_rows(handle, dataset, rank, per)
        if (params.codebook_kind == ivf_pq.CodebookKind.PER_SUBSPACE
                and params.n_lists < kb._MESO_THRESHOLD
                and params.n_lists <= per
                and params.add_data_on_build
                # canaries need per-shard exact ground truth, which only
                # the per-shard build computes
                and params.canary_queries == 0):
            local = _build_spmd(handle, params, shard, rank * per)
        else:
            local = ivf_pq.build(handle, params, shard)
            local.list_indices = _globalize(local.list_indices, rank * per)
        return _shard_index(handle, local, n,
                            canaries=_offset_canaries(local, rank * per))


def _build_spmd(handle, params: ivf_pq.IndexParams, shard: torch.Tensor,
                offset: int) -> ivf_pq.Index:
    """The JAX package's two-phase SPMD build on this rank's shard
    (``raft_tpu/distributed/ann.py:475``): a strided trainset and
    strided initial centers, the balanced loop, per-subspace books, every
    row encoded and packed at the shard's own capacity (the caller pads
    it to the common one, the one collective of the build), the bf16
    recon cache."""
    per, dim = shard.shape
    pq_dim = params.pq_dim or max(dim // 4, 1)
    rot_dim = ivf_pq._round_up(dim, pq_dim)
    n_lists, kind = params.n_lists, params.codebook_kind
    rotation = ivf_pq._make_rotation(
        dim, rot_dim, params.force_random_rotation or rot_dim != dim,
        seed=7, device=shard.device)
    n_train = min(per, max(n_lists,
                           int(per * params.kmeans_trainset_fraction)))
    gen = handle.generator
    with precision.highest():
        xf = shard.float() @ rotation
        train = xf[::max(per // n_train, 1)][:n_train]
        c0 = train[::max(n_train // n_lists, 1)][:n_lists]
        centers, labels_t = kb._balanced_loop(
            train, c0, gen, n_lists, params.kmeans_n_iters, params.metric,
            use_fused=kb._fused_ok(rot_dim, params.metric))
        resid_t = ivf_pq._subspace_split(train - centers[labels_t], pq_dim)
        books = ivf_pq._train_books_per_subspace(
            resid_t.transpose(0, 1), gen, 1 << params.pq_bits,
            params.kmeans_n_iters)
        del train, resid_t
        labels, _ = kb._assign(xf, centers, params.metric)
        codes = ivf_pq._pack_codes(ivf_pq._encode(
            books, ivf_pq._subspace_split(xf - centers[labels], pq_dim),
            kind, labels), params.pq_bits)
        del xf
        sizes = torch.bincount(labels, minlength=n_lists)
        capacity = ivf_pq._round_up(max(int(sizes.max()),
                                        ivf_flat._LIST_ALIGN),
                                    ivf_flat._LIST_ALIGN)
        gids = offset + torch.arange(per, dtype=torch.int32,
                                     device=shard.device)
        lc, li, sz = ivf_flat._pack_lists(codes, labels, gids, n_lists,
                                          capacity)
        recon = ivf_pq._decode_lists(books, lc, pq_dim, params.pq_bits,
                                     kind)
    return ivf_pq.Index(
        centers=centers, codebooks=books, list_codes=lc, list_indices=li,
        list_sizes=sz, rotation=rotation, metric=params.metric,
        codebook_kind=kind, pq_bits=params.pq_bits, list_recon=recon,
        list_recon_sq=ivf_pq._recon_sq(recon), pq_dim_=pq_dim)


# ---------------------------------------------------------------------------
# IVF-PQ search
# ---------------------------------------------------------------------------

def _scan(local: ivf_pq.Index, r: _ScanResolution, params, qrot, probes,
          k: int, fw):
    """This rank's (nq, k) candidates over ``probes`` of its local index
    (by row its shard, routed its lists: a probe outside them is an empty
    pair) in the resolved form, sqrt metrics already square-rooted, as
    the JAX shard-local epilogue does."""
    with precision.highest():
        if r.form == "lut":
            return ivf_pq._search_lut(local, qrot, probes, k,
                                      ivf_pq._lut_dtype(params.lut_dtype),
                                      fw)
        if r.form == "fused_codes":
            return ivf_pq._search_fused_codes(local, qrot, probes, k, r.kt,
                                              fw)
        if r.form == "fused_recon":
            return ivf_pq._search_fused_recon(local, qrot, probes, k, r.kt,
                                              fw)
        kt = r.kt if r.form == "grouped_recon" else min(k, local.capacity)
        scan = ivf_pq._recon_scan(local, k, kt, False)[0]
        return scan(local, qrot, probes, k, kt, fw)


def _merge(comms, ld, li, k: int, metric: int, nq: int, device,
           counts=()):
    """The candidate exchange: ONE allgather of an int32 payload holding
    each rank's (nq, k) distances (their bits), ids and int64 ``counts``
    (word pairs), then every rank selects the same merged top k
    (``grouped.finalize_topk``, no sqrt: the shard-local epilogue took
    it, and the merge is monotone).  A shard that is down passes ``ld =
    None`` and contributes ``(±inf, -1)``.  Returns ``(d, i, (n_shards,
    len(counts)) int64)``."""
    select_min = metric != DistanceType.InnerProduct
    if ld is None:
        ld = torch.full((nq, k), float("inf") if select_min
                        else float("-inf"), device=device)
        li = torch.full((nq, k), -1, dtype=torch.int32, device=device)
    counts = torch.stack([torch.as_tensor(c, device=device)
                          for c in counts]).long() if counts else \
        torch.zeros(0, dtype=torch.int64, device=device)
    payload = torch.cat([ld.float().contiguous().view(torch.int32)
                         .reshape(-1), li.int().reshape(-1),
                         counts.view(torch.int32)])
    every = comms.allgather(payload).to(device)   # (n_shards, 2 nq k + ..)
    m = nq * k
    d, i = grouped.finalize_topk(
        every[:, :m].contiguous().view(torch.float32).reshape(-1, nq, k)
        .permute(1, 0, 2), every[:, m:2 * m].reshape(-1, nq, k)
        .permute(1, 0, 2), nq, k, select_min, False, raw(select_k))
    return d, i, every[:, 2 * m:].contiguous().view(torch.int64)


def ground_truth_params(index, params=None) -> ivf_pq.SearchParams:
    """The ground-truth operating point for a sharded index: every list
    probed (of each shard by row, of the global quantizer when routed),
    exact coarse ranking, no per-probe truncation, ``scan_mode="lut"``
    (the JAX package's: its fused gates may refuse full-probe shapes, and
    a monitor must not tick fallbacks)."""
    base = params if params is not None else ivf_pq.SearchParams()
    n_lists = (index.n_lists if isinstance(index, RoutedIndex)
               else index.local.n_lists)
    return dataclasses.replace(base, n_probes=n_lists, scan_mode="lut",
                               per_probe_topk=0, exact_coarse=True,
                               use_reconstruction=None)


def search(handle, params: ivf_pq.SearchParams, index, queries, k: int, *,
           failed_shards: Sequence[int] = (),
           return_status: bool = False,
           return_stats: bool = False,
           retry_policy: Optional[_retry.RetryPolicy] = None,
           deadline: Optional[_retry.Deadline] = None,
           health=None,
           shard_deadline_s: Optional[float] = None,
           hedge: bool = True,
           routing=None,
           filter=None):
    """Sharded search + merge: (distances, global ids), each (q, k), the
    same on every rank.  ``index`` is a rank's :class:`DistributedIndex`
    (every rank scans its shard) or :class:`RoutedIndex` (every rank scans
    the probed lists it serves); the candidates are allgathered and
    merged.

    Degraded mode: shards in ``failed_shards``, flagged by the active
    fault plan's ``fail_shards`` or FAILED in ``health`` (a
    :class:`~raft_tpu_torch.distributed.health.HealthTracker`) are masked
    out of the merge: the query answers with the live shards' top k, the
    tail padded with ``(inf, -1)``, and a ``distributed.degraded_search``
    flight event is recorded.  Routed, a down shard drops only the lists
    no live replica covers: with ``replication_factor > 1`` its lists fail
    over to their replicas (:meth:`Placement.healthy_routing`), the answer
    equals the healthy one bit for bit, and the shard reports
    :data:`SHARD_REPLICA_SERVED` with a ``distributed.replica_failover``
    event.  ``return_status=True`` appends the (n_shards,) int8 status
    vector; ``return_stats=True`` a dict with the per-shard
    ``scanned_rows`` (by row queries x probes x the common capacity;
    routed the probes each shard served x the capacity; 0 on a shard that
    is down), ``gather_shape``, the effective ``scan_mode`` and
    ``n_probes`` (and ``admitted_rows`` when filtered).  Transient faults
    at entry (site ``distributed.ann.search``) are retried under
    ``retry_policy`` / ``deadline``.

    Stragglers: the fault plan's per-shard delays are recorded
    (``distributed.straggler``), each flagged shard noted with ``health``,
    and each rank waits its own shard's delay, so the merge completes when
    the slowest shard answers.  ``shard_deadline_s`` (seconds or a
    ``Deadline``) records a ``distributed.shard_timeout`` event and notes
    a timeout with ``health`` for each straggler past it.  Routed with
    replicas and ``hedge``, a straggler (or a SUSPECT shard) whose lists a
    live replica covers is hedged: the replicas serve its lists, its wait
    is cut to ``shard_deadline_s`` and a ``distributed.hedged_read`` is
    recorded; a straggler no replica covers is waited for in full.

    ``routing`` (a :class:`~raft_tpu_torch.distributed.routing.
    RoutingPolicy`, routed with replicas) plans every batch's effective
    tables over the replica ranks by load; a ``distributed.replica_choice``
    event records it, and the batch's per-list probe histogram goes to
    ``routing.observe_probes``.  With more than one rank and ``health`` or
    ``routing`` passed, rank 0's tracker and policy alone decide the
    route (failed, hedged and replica-served shards, the tables), which
    is broadcast: the other ranks' policies do not plan.

    ``filter`` (a :class:`~raft_tpu_torch.filters.SampleFilter` or a (q,
    n_rows) bool mask) admits rows by GLOBAL id, which every shard's
    lists store, so one set of words serves every shard; each shard's
    admitted-candidate count rides the exchange (``admitted_rows``)."""
    routed = isinstance(index, RoutedIndex)
    with named_range("distributed::ivf_pq_search"):
        expects(handle.comms_initialized(),
                "distributed.ann.search: handle has no comms")
        comms = handle.get_comms()
        queries = ensure_tensor(queries, handle, "queries")
        # kill site: a shard killed here is seen by this search's failed
        # set
        faults.maybe_fail("distributed.route")
        failed = _degraded_set(index.n_shards, failed_shards)
        if health is not None:
            failed = tuple(sorted(set(failed)
                                  | set(health.failed_shards())))
        nq, k = int(queries.shape[0]), int(k)
        fw = query_filter_words(filter, nq, "distributed.ann.search")
        if fw is not None:
            fw = words_on_device(fw, queries.device)
        rec = obs.trace.current()
        trace_id = rec.trace_id if rec else None
        if isinstance(shard_deadline_s, _retry.Deadline):
            shard_deadline_s = shard_deadline_s.remaining()
        expects(shard_deadline_s is None or shard_deadline_s > 0,
                "distributed.ann.search: shard_deadline_s must be > 0")
        delays = faults.straggler_delays(index.n_shards)
        flagged = tuple(s for s, dly in enumerate(delays) if dly > 0.0)
        if delays:
            _flight.record_event("distributed.straggler", trace_id=trace_id,
                                 delays_s=list(delays),
                                 n_shards=index.n_shards)
        if flagged and shard_deadline_s is not None:
            for s in flagged:
                if delays[s] > shard_deadline_s:
                    _flight.record_event(
                        "distributed.shard_timeout", trace_id=trace_id,
                        shard=s, delay_s=delays[s],
                        deadline_s=shard_deadline_s)
                    if health is not None:
                        health.note_timeout(s)
        if health is not None:
            for s in flagged:
                health.note_straggle(s)
        route = _Route(failed)
        if routed:
            route = _replica_route(comms, index, failed, flagged, delays,
                                   health, hedge, routing, trace_id)
        # this shard's own straggle: the allgather below waits for the
        # slowest shard, as the JAX merge does; a hedged shard's wait is
        # cut to the deadline (its replicas answered instead)
        wait = delays[index.rank] if delays else 0.0
        if index.rank in route.hedged:
            wait = min(wait, shard_deadline_s or 0.0)
        faults.pause(wait)
        n_probes = min(params.n_probes, index.n_lists if routed
                       else index.local.n_lists)
        r = _resolve_scan_mode(params, index, nq, n_probes, k)
        mode_name = {"probe_recon": "recon"}.get(r.form, r.form)
        residual = route.residual
        if rec is not None:
            rec.annotate("distributed.scan_mode", mode_name)
            rec.annotate("distributed.n_probes", int(n_probes))
            rec.annotate("distributed.shard_status", _status_vector(
                index.n_shards, residual, r.lowered,
                replica_served=route.replica_served).tolist())
        if residual:
            # only shards with lists no replica covers degrade the answer
            _flight.record_event("distributed.degraded_search",
                                 trace_id=trace_id, failed=list(residual),
                                 n_shards=index.n_shards)
        me_down = index.rank in set(residual) | set(route.replica_served)
        # kill site: a shard killed mid-scan keeps this search's routing;
        # the next search routes around it
        faults.maybe_fail("distributed.scan")
        hist = None
        if routed:
            def dispatch():
                return _routed_dispatch(comms, index, r, route, params,
                                        queries, k, n_probes, fw, me_down)
            d, i, scanned, admitted, hist = _entry(
                "distributed.ann.search", dispatch, retry_policy, deadline)
        else:
            def dispatch():
                ld = li = None
                if not me_down:
                    local = index.local
                    with precision.highest():
                        qrot = queries.float() @ local.rotation
                        probes = ivf_flat._select_clusters(
                            local.centers, qrot, n_probes, local.metric)
                    ld, li = _scan(local, r, params, qrot, probes, k, fw)
                counts = ()
                if fw is not None:
                    counts = (0 if me_down else (li >= 0).sum(),)
                d, i, every = _merge(comms, ld, li, k, index.metric, nq,
                                     queries.device, counts)
                return d, i, every[:, 0] if fw is not None else None

            d, i, admitted = _entry("distributed.ann.search", dispatch,
                                    retry_policy, deadline)
            scanned = torch.full((index.n_shards,),
                                 nq * n_probes * index.local.capacity,
                                 dtype=torch.int64)
            scanned[list(residual)] = 0
        # kill site: after the gather; the next search sees the shard down
        faults.maybe_fail("distributed.gather")
        if rec is not None and routed:
            rec.annotate("distributed.scanned_rows", scanned)
        if fw is not None:
            if obs.enabled():
                obs.registry().counter(
                    "distributed.ann.search.filtered").inc()
            if rec is not None:
                rec.annotate("distributed.admitted_rows", admitted)
        if routing is not None and hist is not None:
            # the policy keeps the histogram; its refresh reads it later
            routing.observe_probes(hist)
        out = [d, i]
        if return_status:
            out.append(_status_vector(index.n_shards, residual, r.lowered,
                                      d.device, route.replica_served))
        if return_stats:
            stats = {"scanned_rows": scanned.cpu().numpy().astype(np.int64),
                     "gather_shape": (index.n_shards, nq, k),
                     "scan_mode": mode_name, "n_probes": int(n_probes)}
            if admitted is not None:
                stats["admitted_rows"] = admitted.cpu().numpy().astype(
                    np.int64)
            out.append(stats)
        return tuple(out)


def delete(handle, index, ids, *,
           retry_policy: Optional[_retry.RetryPolicy] = None,
           deadline: Optional[_retry.Deadline] = None):
    """Tombstone delete over the sharded index (ids GLOBAL): one
    elementwise rewrite of the rank's ``list_indices`` (routed: every copy
    the rank holds, replicas included), which every scan masks; every
    other tensor is shared with the parent, and the returned snapshot is
    the next generation.  Transient faults at entry (site
    ``distributed.ann.delete``) are retried under ``retry_policy`` /
    ``deadline``."""
    return _entry("distributed.ann.delete",
                  lambda: _delete_impl(handle, index, ids), retry_policy,
                  deadline)


def _delete_impl(handle, index, ids):
    with named_range("distributed::ivf_pq_delete"):
        ids = ensure_tensor(ids, handle, "ids")
        expects(ids.ndim == 1, "distributed.ann.delete: 1-D ids required")
        new_li, _ = _mutate.tombstone(index.local.list_indices, ids)
        out = dataclasses.replace(
            index, local=dataclasses.replace(index.local,
                                             list_indices=new_li))
        return _mutate.next_generation(index, out)


# ---------------------------------------------------------------------------
# the routed placement (placement="by_list")
# ---------------------------------------------------------------------------

# v2: a trailing replication block (``replication_factor`` and, past 1, the
# (r, n_lists) owner / slot tables); v1 streams read and land at r = 1
_PLACEMENT_VERSION = 2
_PLACEMENT_MIN_READ_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """List -> shard ownership for ``placement="by_list"`` (the JAX
    package's, in host numpy).

    ``owner[g]`` is the shard owning global list ``g`` at replica rank 0
    (the primary) and ``local_slot[g]`` that list's slot among the
    owner's local lists.  ``n_local`` counts a shard's slots without the
    dummy slot.  ``generation`` counts placement recomputations.  With
    ``replication_factor=r > 1`` every list has ``r`` distinct owners:
    ``owners`` / ``slots`` are the full (r, n_lists) rank tables (row 0
    is ``owner`` / ``local_slot``), and a shard's local lists are the
    union of the lists it owns at any rank, so failover to a replica
    changes the routing tables only."""

    owner: np.ndarray       # (n_lists,) int32: rank-0 owners
    local_slot: np.ndarray  # (n_lists,) int32: rank-0 slots
    n_shards: int
    n_local: int
    generation: int = 0
    replication_factor: int = 1
    owners: Optional[np.ndarray] = None  # (r, n_lists) int32, r > 1 only
    slots: Optional[np.ndarray] = None   # (r, n_lists) int32, r > 1 only

    @property
    def n_lists(self) -> int:
        return int(self.owner.shape[0])

    def rank_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """The (r, n_lists) per-rank (owners, slots) tables: (1, n_lists)
        views of the primary arrays when r = 1."""
        if self.owners is None:
            return self.owner[None, :], self.local_slot[None, :]
        return self.owners, self.slots

    def shard_lists(self, s: int,
                    rank: Optional[int] = None) -> np.ndarray:
        """Global list ids held on shard ``s``, in local-slot order: the
        union over every replica rank by default, or with ``rank=j`` the
        lists ``s`` owns at that rank (``rank=0``: its primaries)."""
        owners, slots = self.rank_tables()
        if rank is not None:
            owned = np.nonzero(owners[rank] == s)[0]
            return owned[np.argsort(slots[rank][owned], kind="stable")]
        ranks, lists = np.nonzero(owners == s)
        order = np.argsort(slots[ranks, lists], kind="stable")
        return lists[order]

    def healthy_routing(self, down: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Effective (owner, slot) tables with every list served by its
        LOWEST-rank owner not in ``down``; a list all of whose owners are
        down keeps its primary (the degraded masking drops it).  Host
        numpy shaped like ``owner`` / ``local_slot``."""
        owners, slots = self.rank_tables()
        eff_owner = self.owner.copy()
        eff_slot = self.local_slot.copy()
        downset = {int(s) for s in down}
        if not downset or owners.shape[0] == 1:
            return eff_owner, eff_slot
        hit = np.nonzero(np.isin(self.owner, list(downset)))[0]
        for g in hit:
            for r in range(owners.shape[0]):
                if int(owners[r, g]) not in downset:
                    eff_owner[g] = owners[r, g]
                    eff_slot[g] = slots[r, g]
                    break
        return eff_owner, eff_slot


def compute_placement(list_sizes, n_shards: int, *, generation: int = 0,
                      replication_factor: int = 1) -> Placement:
    """Balanced list partition by LPT greedy: lists by (live) size
    descending, each to the least-loaded shard (ties to the fewest lists,
    then the lowest shard id), a 4/3 approximation of the best makespan.
    ``replication_factor=r > 1`` runs the same greedy once a replica rank,
    rank ``j`` skipping the shards that own the list at ranks ``< j``, so
    a list's ``r`` copies land on distinct shards; each rank balances its
    own load, and the local slots come from one counter a shard."""
    sizes = np.asarray(list_sizes, np.int64).reshape(-1)
    n_lists = sizes.shape[0]
    r = int(replication_factor)
    expects(n_shards >= 1, "compute_placement: n_shards must be >= 1")
    expects(n_lists >= n_shards,
            f"compute_placement: need n_lists ({n_lists}) >= n_shards "
            f"({n_shards}) to give every shard at least one list")
    expects(1 <= r <= n_shards,
            f"compute_placement: replication_factor ({r}) must be in "
            f"[1, n_shards={n_shards}] — replicas of a list are never "
            f"co-located, so each list needs {r} distinct shards")
    owners = np.zeros((r, n_lists), np.int32)
    slots = np.zeros((r, n_lists), np.int32)
    load = np.zeros((r, n_shards), np.int64)
    per_rank_count = np.zeros((r, n_shards), np.int64)
    count = np.zeros(n_shards, np.int64)  # shared slot counter
    # stable argsort on -sizes: equal-size lists keep ascending id order
    order = np.argsort(-sizes, kind="stable")
    for rank in range(r):
        for g in order:
            taken = owners[:rank, g]
            for s in np.lexsort((per_rank_count[rank], load[rank])):
                if s not in taken:
                    break
            s = int(s)
            owners[rank, g] = s
            slots[rank, g] = count[s]
            load[rank, s] += int(sizes[g])
            per_rank_count[rank, s] += 1
            count[s] += 1
    return Placement(owner=owners[0], local_slot=slots[0],
                     n_shards=int(n_shards), n_local=int(count.max()),
                     generation=int(generation), replication_factor=r,
                     owners=owners if r > 1 else None,
                     slots=slots if r > 1 else None)


def placement_to_stream(res, stream, placement: Placement) -> None:
    """CRC32-enveloped dump of the placement (the JAX package's bytes)."""
    with ser.enveloped_writer(stream) as body:
        ser.serialize_scalar(res, body, np.int32(_PLACEMENT_VERSION))
        ser.serialize_scalar(res, body, np.int32(placement.n_shards))
        ser.serialize_scalar(res, body, np.int32(placement.n_local))
        ser.serialize_scalar(res, body, np.int64(placement.generation))
        ser.serialize_mdspan(res, body, placement.owner)
        ser.serialize_mdspan(res, body, placement.local_slot)
        ser.serialize_scalar(
            res, body, np.int32(placement.replication_factor))
        if placement.replication_factor > 1:
            ser.serialize_mdspan(res, body, placement.owners)
            ser.serialize_mdspan(res, body, placement.slots)


def placement_from_stream(res, stream) -> Placement:
    """Read a placement either package wrote (versions 1 and 2)."""
    body = ser.open_envelope(stream)
    version = int(ser.deserialize_scalar(res, body))
    if not (_PLACEMENT_MIN_READ_VERSION <= version
            <= _PLACEMENT_VERSION):
        raise ValueError(
            f"placement serialization version mismatch: got {version}, "
            f"expected {_PLACEMENT_MIN_READ_VERSION}.."
            f"{_PLACEMENT_VERSION}")
    n_shards = int(ser.deserialize_scalar(res, body))
    n_local = int(ser.deserialize_scalar(res, body))
    generation = int(ser.deserialize_scalar(res, body))
    owner = np.asarray(ser.deserialize_mdspan(res, body), np.int32)
    local_slot = np.asarray(ser.deserialize_mdspan(res, body), np.int32)
    replication_factor = 1
    owners = slots = None
    if version >= 2:
        replication_factor = int(ser.deserialize_scalar(res, body))
        if replication_factor > 1:
            owners = np.asarray(ser.deserialize_mdspan(res, body), np.int32)
            slots = np.asarray(ser.deserialize_mdspan(res, body), np.int32)
    return Placement(owner=owner, local_slot=local_slot, n_shards=n_shards,
                     n_local=n_local, generation=generation,
                     replication_factor=replication_factor, owners=owners,
                     slots=slots)


@dataclasses.dataclass
class RoutedIndex:
    """A rank's part of an index-parallel (``placement="by_list"``) IVF-PQ
    index.  ``coarse_centers`` (n_lists, rot) is the replicated global
    quantizer, the same on every rank; ``local`` is this rank's lists as
    an ``ivf_pq.Index`` of ``n_local + 1`` slots (GLOBAL ids; the last
    slot an always-empty dummy), which holds the replicated ``rotation``,
    the ``metric`` and ``group_est``, and its ``codebooks``,
    ``list_codes`` and ``list_code_rsq`` where the base index was eligible
    for the code scans, else None.  ``placement`` maps every list to its
    owners; ``pq_bits`` is 0 without code leaves; ``group_est`` is carried
    and written, and selects nothing (the port's grouped routes run at the
    exact bound); ``canaries`` is the ONE global canary set."""

    coarse_centers: torch.Tensor
    local: ivf_pq.Index
    placement: Placement
    rank: int
    size: int = 0
    canaries: Optional[_canary.CanarySet] = None
    generation: int = 0

    @property
    def n_shards(self) -> int:
        return self.placement.n_shards

    @property
    def n_lists(self) -> int:
        return self.coarse_centers.shape[0]

    @property
    def capacity(self) -> int:
        return self.local.capacity

    @property
    def rotation(self) -> torch.Tensor:
        return self.local.rotation

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def metric(self) -> int:
        return int(self.local.metric)

    @property
    def group_est(self) -> float:
        return float(self.local.group_est)

    @property
    def codebooks(self) -> Optional[torch.Tensor]:
        return self.local.codebooks

    @property
    def pq_bits(self) -> int:
        return int(self.local.pq_bits) if self.local.list_codes is not None \
            else 0


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it: bf16 as its bytes (uint8,
    the last axis doubled), which gloo and NCCL both move."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def _bcast_leaf(comms, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (each rank passes a tensor of the same
    shape and dtype)."""
    return _unwire(comms.bcast(_wire(t), root=0), t.dtype).to(t.device)


def _bcast_placement(comms, placement: Placement) -> Placement:
    """Rank 0's placement on every rank: the (r, n_lists) tables and the
    generation in one int64 broadcast (every rank passes a placement of
    the same factor and list count)."""
    owners, slots = placement.rank_tables()
    flat = np.concatenate([[placement.generation], owners.reshape(-1),
                           slots.reshape(-1)]).astype(np.int64)
    flat = comms.bcast(torch.from_numpy(flat), root=0).cpu().numpy()
    r, n_lists = owners.shape
    owners = flat[1:1 + r * n_lists].reshape(r, n_lists).astype(np.int32)
    slots = flat[1 + r * n_lists:].reshape(r, n_lists).astype(np.int32)
    count = np.bincount(owners.reshape(-1), minlength=placement.n_shards)
    return Placement(owner=owners[0].copy(), local_slot=slots[0].copy(),
                     n_shards=placement.n_shards, n_local=int(count.max()),
                     generation=int(flat[0]), replication_factor=r,
                     owners=owners if r > 1 else None,
                     slots=slots if r > 1 else None)


def _place_lists(rank: int, leaves, coarse: torch.Tensor,
                 rotation: torch.Tensor, placement: Placement, metric: int,
                 size: int, *, code_leaves=None, pq_bits: int = 0,
                 group_est: float = 0.0, device=None) -> RoutedIndex:
    """Rank ``rank``'s :class:`RoutedIndex` from the global per-list
    arrays ``leaves`` = (recon, recon_sq, indices, sizes), the replicated
    ``coarse`` centres and ``rotation``, under ``placement``; its lists at
    their local slots, the dummy slot and the rest padded (ids -1, zeros
    elsewhere).  ``code_leaves`` = (codebooks, list_codes (n_lists, cap,
    W) uint8, list_code_rsq), or None.  The local tensors land on
    ``device`` (default: the leaves')."""
    recon, rsq, li, sizes = leaves
    device = recon.device if device is None else torch.device(device)
    slots = placement.n_local + 1
    owned = torch.as_tensor(placement.shard_lists(rank), dtype=torch.long,
                            device=recon.device)

    def pad(a, fill):
        out = a.new_full((slots,) + tuple(a.shape[1:]), fill)
        out[:owned.shape[0]] = a[owned.to(a.device)]
        return out.to(device)

    books = codes = crsq = None
    if code_leaves is not None:
        books = code_leaves[0].to(device)
        codes, crsq = pad(code_leaves[1], 0), pad(code_leaves[2], 0)
    coarse, rotation = coarse.to(device), rotation.to(device)
    local = ivf_pq.Index(
        centers=pad(coarse, 0), codebooks=books, list_codes=codes,
        list_indices=pad(li, -1), list_sizes=pad(sizes, 0),
        rotation=rotation, metric=metric, pq_bits=int(pq_bits),
        list_recon=pad(recon, 0), list_recon_sq=pad(rsq, 0),
        list_code_rsq=crsq,
        pq_dim_=int(books.shape[0]) if books is not None else 0,
        group_est=float(group_est))
    return RoutedIndex(coarse_centers=coarse, local=local,
                       placement=placement, rank=int(rank), size=int(size))


def shard_by_list(handle, index: ivf_pq.Index, *,
                  placement: Optional[Placement] = None,
                  replication_factor: int = 1) -> RoutedIndex:
    """Partition a single IVF-PQ index's lists over the handle's ranks;
    every rank calls it with the same base (say, each loaded from one
    file) and keeps its own lists.

    The index must carry the reconstruction cache.  ``placement``
    defaults to an LPT balance over *live* list sizes with
    ``replication_factor`` copies of each list (ignored when a placement
    is passed: it carries its own factor).  The replicated leaves (coarse
    centres, rotation, codebooks) and the placement are rank 0's,
    broadcast, so every rank ranks probes alike.  The code leaves
    (codebooks, packed codes, their row norms) are carried when the base
    is eligible for the code scans (L2, per-subspace books, 4 or 8
    bits)."""
    return _shard_by_list(handle, index, placement, replication_factor,
                          alike=False)


def _shard_by_list(handle, index: ivf_pq.Index,
                   placement: Optional[Placement], replication_factor: int,
                   alike: bool) -> RoutedIndex:
    """:func:`shard_by_list`; ``alike`` says every rank already holds
    rank 0's base (the build's broadcast stream, read back), so the
    placement (computed from it) and the replicated leaves are the same
    on every rank without a broadcast."""
    share = ((lambda t: t) if alike
             else (lambda t: _bcast_leaf(handle.get_comms(), t)))
    with named_range("distributed::shard_by_list"):
        expects(handle.comms_initialized(),
                "distributed.ann.shard_by_list: handle has no comms")
        expects(getattr(index, "list_recon", None) is not None,
                "distributed.ann.shard_by_list: index must carry the "
                "reconstruction cache (build with "
                "cache_reconstructions=True)")
        comms = handle.get_comms()
        n_dev = comms.get_size()
        if placement is None:
            live = _mutate.live_sizes(index.list_indices).cpu().numpy()
            placement = compute_placement(
                live, n_dev, replication_factor=replication_factor)
        expects(placement.n_shards == n_dev,
                f"distributed.ann: placement maps {placement.n_shards} "
                f"shards but the mesh has {n_dev} devices")
        if not alike:
            placement = _bcast_placement(comms, placement)
        rsq = index.list_recon_sq
        if rsq is None:
            rsq = ivf_pq._recon_sq(index.list_recon)
        code_leaves = None
        pq_bits = 0
        if ivf_pq._codes_mode_eligible(index):
            crsq = index.list_code_rsq
            if crsq is None:
                crsq = rsq
            code_leaves = (share(index.codebooks.float()),
                           index.list_codes, crsq)
            pq_bits = int(index.pq_bits)
        out = _place_lists(
            comms.get_rank(),
            (index.list_recon, rsq, index.list_indices, index.list_sizes),
            share(index.centers.float()), share(index.rotation.float()),
            placement,
            index.metric, int(index.list_sizes.sum()),
            code_leaves=code_leaves, pq_bits=pq_bits,
            group_est=float(getattr(index, "group_est", 0.0)))
        out.canaries = getattr(index, "canaries", None)
        out.generation = _mutate.generation(index)
        return out


def _bcast_index(handle, comms, base: Optional[ivf_pq.Index]
                 ) -> ivf_pq.Index:
    """Rank 0's ``base`` on every rank: its stream (the canaries with it)
    broadcast and read back on every rank, rank 0 included, so every
    rank holds the same derived caches."""
    if comms.get_rank() == 0:
        buf = io.BytesIO()
        ivf_pq.serialize(handle, buf, base)
        data = torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)
    else:
        data = torch.empty(0, dtype=torch.uint8)
    n = int(comms.bcast(torch.tensor([data.numel()], dtype=torch.int64),
                        root=0)[0])
    if comms.get_rank() != 0:
        data = torch.empty(n, dtype=torch.uint8)
    data = comms.bcast(data, root=0).cpu()
    return ivf_pq.deserialize(handle, io.BytesIO(data.numpy().tobytes()))


def _build_by_list(handle, params: ivf_pq.IndexParams, dataset,
                   replication_factor: int = 1) -> RoutedIndex:
    with named_range("distributed::ivf_pq_build_by_list"):
        expects(handle.comms_initialized(),
                "distributed.ann.build: handle has no comms (use "
                "CommsSession.worker_handle())")
        expects(params.cache_reconstructions,
                "distributed.ann: the routed search kernel runs the "
                "reconstruction path; cache_reconstructions must be True")
        comms = handle.get_comms()
        n_dev = comms.get_size()
        expects(params.n_lists >= n_dev,
                f"distributed.ann: by_list needs n_lists "
                f"({params.n_lists}, GLOBAL in this mode) >= the "
                f"{n_dev}-device mesh")
        # ONE global quantizer and codebook train, on rank 0
        base = (ivf_pq.build(handle, params, dataset)
                if comms.get_rank() == 0 else None)
        if n_dev > 1:
            base = _bcast_index(handle, comms, base)
        return _shard_by_list(handle, base, None, replication_factor,
                              alike=True)


def _gather_global(handle, index: RoutedIndex):
    """The global per-list arrays (recon, recon_sq, indices, sizes,
    code_leaves or None), the same on every rank: one allgather a leaf of
    each rank's PRIMARY lists (padded to the most any rank holds), then
    each list read at its owner.  Collective; the admin path only."""
    comms = handle.get_comms()
    p = index.placement
    prim = [p.shard_lists(s, rank=0) for s in range(p.n_shards)]
    width = max(len(x) for x in prim)
    pos = np.zeros(p.n_lists, np.int64)
    for x in prim:
        pos[x] = np.arange(len(x))
    local = index.local
    dev = local.list_indices.device
    mine = torch.as_tensor(p.local_slot[prim[index.rank]], dtype=torch.long,
                           device=dev)
    own = torch.as_tensor(p.owner, dtype=torch.long, device=dev)
    at = torch.as_tensor(pos, device=dev)

    def gather(t):
        sel = t.new_zeros((width,) + tuple(t.shape[1:]))
        sel[:mine.shape[0]] = t[mine]
        full = _unwire(comms.allgather(_wire(sel)), t.dtype).to(dev)
        return full[own, at]

    leaves = (gather(local.list_recon), gather(local.list_recon_sq),
              gather(local.list_indices), gather(local.list_sizes))
    code_leaves = None
    if local.list_codes is not None:
        code_leaves = (local.codebooks, gather(local.list_codes),
                       gather(local.list_code_rsq))
    return leaves + (code_leaves,)


def route_vectors(index: RoutedIndex, vectors) -> np.ndarray:
    """The write path's list router: each row's home list, its top probe
    under the replicated coarse quantizer (n_probes 1), as (n,) int32
    numpy.  No collective: every rank ranks alike."""
    vecs = (vectors if isinstance(vectors, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(vectors)))
    vecs = vecs.float().to(index.rotation.device)
    expects(vecs.ndim == 2 and vecs.shape[1] == index.dim,
            f"distributed.ann.route_vectors: vectors must be "
            f"(n, {index.dim}), got {tuple(vecs.shape)}")
    with precision.highest():
        probes = ivf_flat._select_clusters(index.coarse_centers,
                                           vecs @ index.rotation, 1,
                                           index.metric)
    return probes.reshape(-1).cpu().numpy().astype(np.int32)


@dataclasses.dataclass(frozen=True)
class _Route:
    """A search's routing: ``residual`` the down shards whose lists no
    replica covers (masked), ``replica_served`` the down shards replicas
    covered, ``hedged`` the stragglers hedged to replicas, ``eff`` the
    effective (owner, slot) tables (host numpy) or None for the
    primaries."""

    residual: Tuple[int, ...]
    replica_served: Tuple[int, ...] = ()
    hedged: Tuple[int, ...] = ()
    eff: Optional[Tuple[np.ndarray, np.ndarray]] = None


# a shard's bits in the broadcast route
_R_FAILED, _R_HEDGED, _R_RESIDUAL, _R_SERVED = 1, 2, 4, 8


def _bcast_route(comms, p: Placement, decided):
    """Rank 0's route on every rank, in ONE float64 broadcast: per shard
    its failed / hedged / residual / served bits, the effective (owner,
    slot) tables and the policy's scores.  ``decided`` is rank 0's
    ``(route, failed, scores)``, None on the other ranks; returns the
    same triple on every rank."""
    n, n_lists = p.n_shards, p.n_lists
    flat = np.zeros(2 * n + 2 + 2 * n_lists, np.float64)
    if decided is not None:
        route, failed, scores = decided
        for bit, shards in ((_R_FAILED, failed), (_R_HEDGED, route.hedged),
                            (_R_RESIDUAL, route.residual),
                            (_R_SERVED, route.replica_served)):
            for s in shards:
                flat[s] = int(flat[s]) | bit
        if route.eff is not None:
            flat[n] = 1
            flat[n + 1:n + 1 + 2 * n_lists] = np.concatenate(route.eff)
        if scores is not None:
            flat[n + 1 + 2 * n_lists] = 1
            flat[n + 2 + 2 * n_lists:] = scores
    flat = comms.bcast(torch.from_numpy(flat), root=0).cpu().numpy()
    bits = flat[:n].astype(np.int64)

    def having(bit):
        return tuple(int(s) for s in np.nonzero(bits & bit)[0])

    eff = None
    if flat[n]:
        t = flat[n + 1:n + 1 + 2 * n_lists].astype(np.int32)
        eff = (t[:n_lists], t[n_lists:])
    scores = ([float(v) for v in flat[n + 2 + 2 * n_lists:]]
              if flat[n + 1 + 2 * n_lists] else None)
    return (_Route(having(_R_RESIDUAL), having(_R_SERVED),
                   having(_R_HEDGED), eff), having(_R_FAILED), scores)


def _plan_route(p: Placement, failed, flagged, health, hedge: bool,
                routing):
    """Failover, hedging and the policy's plan (the JAX search's block),
    from this rank's own tracker and policy: ``(route, scores)``, the
    scores None without a policy."""
    if p.replication_factor <= 1:
        return _Route(failed), None
    hedge_cand = set()
    if hedge:
        hedge_cand = set(flagged) - set(failed)
        if health is not None:
            hedge_cand |= set(health.suspect_shards()) - set(failed)
    use_policy = routing is not None
    if not (failed or hedge_cand or use_policy):
        return _Route(failed), None

    def tables(down):
        if not use_policy:
            return p.healthy_routing(down)
        return routing.plan(p, down=down)

    down = set(failed) | hedge_cand
    eo, es = tables(tuple(sorted(down)))
    still = down & set(np.unique(eo).tolist())
    # a hedge candidate whose lists have no live replica is un-hedged:
    # the shard is alive, just slow; wait for it rather than drop its
    # lists
    unhedged = hedge_cand & still
    hedged = tuple(sorted(hedge_cand - unhedged))
    down = set(failed) | set(hedged)
    if unhedged and down:
        eo, es = tables(tuple(sorted(down)))
    residual, served, eff = tuple(failed), (), None
    if down:
        still = down & set(np.unique(eo).tolist())
        residual = tuple(sorted(set(failed) & still))
        served = tuple(sorted(down - still))
        eff = (eo, es)
    elif use_policy:
        # load spreading alone: nothing down, every list at its least
        # loaded live owner
        eff = (eo, es)
    scores = (routing.choice_summary().get("scores") if use_policy
              else None)
    return _Route(residual, served, hedged, eff), scores


def _replica_route(comms, index: RoutedIndex, failed, flagged, delays,
                   health, hedge: bool, routing, trace_id) -> _Route:
    """The search's routing, alike on every rank, and its events.  Each
    process keeps its own tracker and policy (the policy reads its own
    telemetry and feeds overload into the tracker), so with more than one
    rank and either passed, rank 0 alone plans and its whole route is
    broadcast: ranks that routed apart would scan, wait and report apart,
    or fall out of step in a collective."""
    p = index.placement
    failed = tuple(failed)
    if comms.get_size() > 1 and (health is not None or routing is not None):
        decided = None
        if comms.get_rank() == 0:
            route, scores = _plan_route(p, failed, flagged, health, hedge,
                                        routing)
            decided = (route, failed, scores)
        route, failed, scores = _bcast_route(comms, p, decided)
    else:
        route, scores = _plan_route(p, failed, flagged, health, hedge,
                                    routing)
    if routing is not None and route.eff is not None:
        eo = route.eff[0]
        owners, _ = p.rank_tables()
        _flight.record_event(
            "distributed.replica_choice", trace_id=trace_id,
            reason=("failover" if failed else "hedge" if route.hedged
                    else "load_spread"),
            scores=scores,
            per_rank_lists=[int(np.sum(eo == owners[j]))
                            for j in range(owners.shape[0])],
            per_shard_lists=np.bincount(
                eo, minlength=p.n_shards).tolist())
        if obs.enabled():
            obs.registry().counter("distributed.replica_choice").inc()
    if failed and set(failed) - set(route.residual):
        _flight.record_event(
            "distributed.replica_failover", trace_id=trace_id,
            failed=list(failed), residual=list(route.residual),
            covered=sorted(set(failed) - set(route.residual)))
    for s in route.hedged:
        _flight.record_event("distributed.hedged_read", trace_id=trace_id,
                             shard=s,
                             delay_s=delays[s] if s < len(delays) else 0.0)
    if route.hedged and obs.enabled():
        obs.registry().counter("distributed.hedged_reads").inc(
            len(route.hedged))
    return route


def _routed_probes(index: RoutedIndex, queries, n_probes: int):
    """(qrot, probes): every rank ranks the same global probe set from the
    replicated quantizer."""
    with precision.highest():
        qrot = queries.float() @ index.rotation
        return qrot, ivf_flat._select_clusters(index.coarse_centers, qrot,
                                               n_probes, index.metric)


def _local_probes(index: RoutedIndex, route: _Route, probes):
    """(local probes, owned mask): a probe this rank serves under the
    effective tables becomes its local slot; any other the out-of-range
    slot ``n_local + 1``, which every grouped route and plain version
    drops."""
    eo, es = route.eff if route.eff is not None else (
        index.placement.owner, index.placement.local_slot)
    dev = probes.device
    eo = torch.as_tensor(eo, device=dev)
    es = torch.as_tensor(es, device=dev)
    pl = probes.long()
    owned = eo[pl] == index.rank
    sentinel = torch.full_like(pl, index.local.n_lists)
    return torch.where(owned, es[pl].long(), sentinel).int(), owned


def _routed_dispatch(comms, index: RoutedIndex, r: _ScanResolution,
                     route: _Route, params, queries, k: int, n_probes: int,
                     fw, me_down: bool):
    """The routed search's device part on this rank: the probes, the
    probe histogram, this rank's scan (skipped while it is down), then
    ONE allgather of each rank's candidates with its scanned and admitted
    counts, and the merge.  Returns (d, i, scanned (n_shards,), admitted
    (n_shards,) or None, hist (n_lists,))."""
    nq = int(queries.shape[0])
    qrot, probes = _routed_probes(index, queries, n_probes)
    dev = probes.device
    hist = torch.zeros(index.n_lists, dtype=torch.int32, device=dev)
    hist.scatter_add_(0, probes.reshape(-1).long(),
                      torch.ones(probes.numel(), dtype=torch.int32,
                                 device=dev))
    ld = li = None
    counts = (0, 0)
    if not me_down:
        lp, owned = _local_probes(index, route, probes)
        ld, li = _scan(index.local, r, params, qrot, lp, k, fw)
        counts = (owned.sum() * index.capacity, (li >= 0).sum())
    d, i, every = _merge(comms, ld, li, k, index.metric, nq, dev, counts)
    return d, i, every[:, 0], every[:, 1] if fw is not None else None, hist


def rebalance_placement(handle, index: RoutedIndex, *,
                        placement: Optional[Placement] = None
                        ) -> RoutedIndex:
    """Recompute the list partition from *live* row counts (or take
    ``placement``) and re-shard.  Collective (every rank gathers the
    global lists, then keeps its own); the new index is assembled whole
    before anything is published, under one placement-generation bump
    and one index-generation bump."""
    with named_range("distributed::rebalance_placement"):
        expects(index.placement is not None,
                "distributed.ann.rebalance_placement: index carries no "
                "placement map")
        recon, rsq, li, sizes, code_leaves = _gather_global(handle, index)
        if placement is None:
            live = (li >= 0).sum(1).int().cpu().numpy()
            placement = compute_placement(
                live, index.n_shards,
                generation=index.placement.generation + 1,
                replication_factor=index.placement.replication_factor)
        out = _place_lists(index.rank, (recon, rsq, li, sizes),
                           index.coarse_centers, index.rotation, placement,
                           index.metric, index.size,
                           code_leaves=code_leaves, pq_bits=index.pq_bits,
                           group_est=index.group_est)
        out.canaries = index.canaries
        return _mutate.next_generation(index, out)


# v2: a trailing (has_codes, pq_bits, group_est) block and, with codes,
# the lane-major code cache (codebooks, lanes, row norms); v3: the
# embedded placement may be placement v2 (replicated).  v1 streams read
# and land recon-only
_ROUTED_SERIALIZATION_VERSION = 3
_ROUTED_MIN_READ_VERSION = 1


def _unpack_code_lanes(lanes: np.ndarray, pq_dim: int,
                       pq_bits: int) -> np.ndarray:
    """(n_lists, Wi, cap) int32 lane words -> (n_lists, cap, W) uint8
    packed codes, W = ceil(pq_dim pq_bits / 8): the inverse of
    :func:`raft_tpu_torch.integrity.verify._pack_code_lanes` (byte k of a
    row in word ``k // 4`` at bit ``8 (k % 4)``)."""
    L, wi, cap = lanes.shape
    words = np.ascontiguousarray(
        np.transpose(lanes.astype("<i4", copy=False), (0, 2, 1)))
    width = -(-pq_dim * pq_bits // 8)
    return np.ascontiguousarray(
        words.view(np.uint8).reshape(L, cap, wi * 4)[..., :width])


def serialize_routed(res, stream, index: RoutedIndex) -> None:
    """CRC32-enveloped dump of a routed index, the JAX package's bytes:
    the placement beside the global per-list arrays (gathered from the
    ranks), the bf16 recon cache as uint16, the code cache lane-major.
    Collective: every rank calls it with its handle (``res``) and writes
    the same bytes."""
    expects(index.placement is not None,
            "distributed.ann.serialize_routed: index carries no "
            "placement map")
    recon, rsq, li, sizes, code_leaves = _gather_global(res, index)

    def host(t):
        return np.ascontiguousarray(t.detach().cpu().numpy())

    with ser.enveloped_writer(stream) as body:
        ser.serialize_scalar(
            res, body, np.int32(_ROUTED_SERIALIZATION_VERSION))
        ser.serialize_scalar(res, body, np.int32(index.metric))
        ser.serialize_scalar(res, body, np.int64(index.size))
        ser.serialize_scalar(res, body,
                             np.int64(_mutate.generation(index)))
        placement_to_stream(res, body, index.placement)
        ser.serialize_mdspan(res, body, host(index.coarse_centers))
        ser.serialize_mdspan(res, body, host(
            recon.contiguous().view(torch.int16)).view(np.uint16))
        ser.serialize_mdspan(res, body, host(rsq))
        ser.serialize_mdspan(res, body, host(li))
        ser.serialize_mdspan(res, body, host(sizes))
        ser.serialize_mdspan(res, body, host(index.rotation))
        ser.serialize_scalar(
            res, body, np.int32(1 if code_leaves is not None else 0))
        ser.serialize_scalar(res, body, np.int32(index.pq_bits))
        ser.serialize_scalar(res, body, np.float64(index.group_est))
        if code_leaves is not None:
            books, codes, crsq = code_leaves
            ser.serialize_mdspan(res, body, host(books))
            ser.serialize_mdspan(res, body, np.ascontiguousarray(
                _pack_code_lanes(host(codes))))
            ser.serialize_mdspan(res, body, host(crsq))
        _canary.to_stream(res, body, index.canaries)


def deserialize_routed(handle, stream) -> RoutedIndex:
    """Read a routed stream either package wrote (versions 1-3) under its
    stored placement, which must map as many shards as the handle has
    ranks; each rank keeps its own lists, on the handle's device.  No
    collective.  A v1 stream loads recon-only (no code leaves)."""
    body = ser.open_envelope(stream)
    version = int(ser.deserialize_scalar(handle, body))
    if not (_ROUTED_MIN_READ_VERSION <= version
            <= _ROUTED_SERIALIZATION_VERSION):
        raise ValueError(
            f"routed serialization version mismatch: got {version}, "
            f"expected {_ROUTED_MIN_READ_VERSION}.."
            f"{_ROUTED_SERIALIZATION_VERSION}")
    metric = int(ser.deserialize_scalar(handle, body))
    size = int(ser.deserialize_scalar(handle, body))
    generation = int(ser.deserialize_scalar(handle, body))
    placement = placement_from_stream(handle, body)

    def array():
        return torch.from_numpy(np.ascontiguousarray(
            ser.deserialize_mdspan(handle, body)))

    centers = array()
    recon = array().view(torch.int16).view(torch.bfloat16)
    rsq, li, sizes, rotation = array(), array(), array(), array()
    code_leaves = None
    pq_bits = 0
    group_est = 0.0
    if version >= 2:
        has_codes = int(ser.deserialize_scalar(handle, body))
        pq_bits = int(ser.deserialize_scalar(handle, body))
        group_est = float(ser.deserialize_scalar(handle, body))
        if has_codes:
            books = array()
            lanes = ser.deserialize_mdspan(handle, body)
            codes = torch.from_numpy(_unpack_code_lanes(
                lanes, books.shape[0], pq_bits))
            code_leaves = (books, codes, array())
    canaries = _canary.from_stream(handle, body)
    comms = handle.get_comms()
    expects(placement.n_shards == comms.get_size(),
            f"distributed.ann: placement maps {placement.n_shards} "
            f"shards but the mesh has {comms.get_size()} devices")
    out = _place_lists(comms.get_rank(), (recon, rsq, li, sizes), centers,
                       rotation, placement, metric, size,
                       code_leaves=code_leaves, pq_bits=pq_bits,
                       group_est=group_est, device=handle.device)
    out.canaries = canaries
    out.generation = generation
    return out


def _deleted_among(handle, index: RoutedIndex, ids) -> frozenset:
    """The ids of ``ids`` deleted in the whole routed index (tombstoned in
    some rank's lists, live in none), the same on every rank: one
    allreduce of the per-id tombstoned and live counts.  Collective."""
    u = np.unique(np.asarray(ids, np.int64).reshape(-1))
    li = index.local.list_indices
    cand = torch.as_tensor(u, dtype=li.dtype, device=li.device)
    dead = torch.isin(cand, -(li[li <= -2] + 2))
    live = torch.isin(cand, li[li >= 0])
    both = torch.stack([dead, live]).int()
    both = handle.get_comms().allreduce(both).cpu().numpy()
    return frozenset(int(v) for v in u[(both[0] > 0) & (both[1] == 0)])


# ---------------------------------------------------------------------------
# IVF-Flat
# ---------------------------------------------------------------------------

def build_flat(handle, params, dataset, *,
               retry_policy: Optional[_retry.RetryPolicy] = None,
               deadline: Optional[_retry.Deadline] = None
               ) -> DistributedFlatIndex:
    """Each rank builds one local IVF-Flat index over its rows, ids
    globally offset (the ANN bench ``multigpu`` seam for raft_ivf_flat),
    padded to the common capacity."""
    return _entry("distributed.ann.build_flat",
                  lambda: _build_flat_impl(handle, params, dataset),
                  retry_policy, deadline)


def _build_flat_impl(handle, params, dataset) -> DistributedFlatIndex:
    with named_range("distributed::ivf_flat_build"):
        expects(handle.comms_initialized(),
                "distributed.ann.build_flat: handle has no comms")
        _, n, _, rank, per = _shard_layout(handle, dataset)
        local = ivf_flat.build(handle, params,
                               _shard_rows(handle, dataset, rank, per))
        local.list_indices = _globalize(local.list_indices, rank * per)
        return _shard_index(handle, local, n,
                            canaries=_offset_canaries(local, rank * per))


def search_flat(handle, params, index: DistributedFlatIndex, queries,
                k: int, *,
                failed_shards: Sequence[int] = (),
                return_status: bool = False,
                retry_policy: Optional[_retry.RetryPolicy] = None,
                deadline: Optional[_retry.Deadline] = None):
    """Sharded IVF-Flat search + merge: (distances, global ids), the same
    on every rank.  Each rank scans exactly its probed lists with Kernel
    F (one list a tile, as the JAX package's shard-local scan), then the
    exchange.  Same degraded-mode / straggler / retry contract as
    :func:`search`."""
    with named_range("distributed::ivf_flat_search"):
        expects(handle.comms_initialized(),
                "distributed.ann.search_flat: handle has no comms")
        comms = handle.get_comms()
        queries = ensure_tensor(queries, handle, "queries").float()
        local = index.local
        k = int(k)
        n_probes = min(params.n_probes, local.n_lists)
        failed = _degraded_set(index.n_shards, failed_shards)
        delays = faults.straggler_delays(index.n_shards)
        if delays:
            _flight.record_event("distributed.straggler",
                                 delays_s=list(delays),
                                 n_shards=index.n_shards)
        faults.pause(delays[index.rank] if delays else 0.0)
        me_failed = index.rank in failed

        def dispatch():
            ld = li = None
            if not me_failed:
                ld, li = _flat_scan(local, queries, k, n_probes)
            return _merge(comms, ld, li, k, index.metric,
                          queries.shape[0], queries.device)[:2]

        d, i = _entry("distributed.ann.search_flat", dispatch, retry_policy,
                      deadline)
        if not return_status:
            return d, i
        return d, i, _status_vector(index.n_shards, failed, False, d.device)


def _flat_scan(local: ivf_flat.Index, queries, k: int, n_probes: int):
    """Kernel F over exactly the probed lists, then each query's top k."""
    ip = local.metric == DistanceType.InnerProduct
    with precision.highest():
        probes = ivf_flat._select_clusters(local.centers, queries, n_probes,
                                           local.metric)
        if not ip and local.list_data_sq is None:
            local.list_data_sq = ivf_flat._row_norms(local.list_data)
        vals, ids = ivf_flat_scan(queries, probes, local.list_data,
                                  local.list_data_sq, local.list_indices,
                                  min(k, local.capacity), ip)
        return ivf_flat._finalize_topk(vals, ids, k, local.metric)


# ---------------------------------------------------------------------------
# CAGRA
# ---------------------------------------------------------------------------

def build_cagra(handle, params, dataset, *,
                retry_policy: Optional[_retry.RetryPolicy] = None,
                deadline: Optional[_retry.Deadline] = None
                ) -> DistributedCagraIndex:
    """Each rank builds one local CAGRA graph and packed walk table over
    its rows (reference: graph_core.cuh:333-369 builds the kNN graph in
    per-GPU chunks).  One projection dim, calibrated on rank 0 and
    broadcast, serves every shard; where calibration fails (pdim 0) or a
    shard's table passes the byte gate, every shard searches by the exact
    direct walk."""
    return _entry("distributed.ann.build_cagra",
                  lambda: _build_cagra_impl(handle, params, dataset),
                  retry_policy, deadline)


def _build_cagra_impl(handle, params, dataset) -> DistributedCagraIndex:
    with named_range("distributed::cagra_build"):
        expects(handle.comms_initialized(),
                "distributed.ann.build_cagra: handle has no comms")
        comms, n, _, rank, per = _shard_layout(handle, dataset)
        idx = cagra.build(handle, params,
                          _shard_rows(handle, dataset, rank, per))
        pdim = int(comms.bcast(torch.tensor(
            cagra._auto_pdim(idx) if rank == 0 else 0, dtype=torch.int64),
            root=0))
        use_walk = (pdim > 0 and cagra._table_bytes(
            per, idx.graph_degree, pdim, False)
            <= cagra._WALK_TABLE_MAX_BYTES)
        walk = cagra._walk_cache(handle, idx, pdim, 4096) if use_walk \
            else None
        # CAGRA shard ids stay local: the canaries need no offset
        return DistributedCagraIndex(
            local=idx, n_shards=comms.get_size(), rank=rank,
            metric=params.metric, size=n, use_walk=use_walk, walk=walk,
            shard_canaries=_offset_canaries(idx, 0))


def search_cagra(handle, params, index: DistributedCagraIndex, queries,
                 k: int, *,
                 retry_policy: Optional[_retry.RetryPolicy] = None,
                 deadline: Optional[_retry.Deadline] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded CAGRA walk + merge: (distances, global ids), the same on
    every rank.  Each rank walks its shard (Kernel I's walk over the
    packed table, or the direct walk from random seeds), shifts its local
    ids by its offset, and the candidates are exchanged.  Transient faults
    at entry (site ``distributed.ann.search_cagra``) are retried; the
    direct walk's seeds are drawn once, so a retried query answers
    identically."""
    with named_range("distributed::cagra_search"):
        expects(handle.comms_initialized(),
                "distributed.ann.search_cagra: handle has no comms")
        comms = handle.get_comms()
        queries = ensure_tensor(queries, handle, "queries").float()
        local, k = index.local, int(k)
        per = local.size
        itopk = max(params.itopk_size, k)
        max_iter = params.max_iterations or (
            10 + itopk // max(params.search_width, 1))
        rerank = max(min(itopk, params.rerank_topk or max(32, 2 * k)), k)
        seed_ids = None
        if not index.use_walk:
            # the seed count of single-index cagra.search
            n_seeds = max(itopk, min(per, max(
                max(params.num_random_samplings, 1) * 4 * itopk, 128)))
            seed_ids = torch.randint(0, per, (queries.shape[0], n_seeds),
                                     generator=handle.generator,
                                     device=queries.device,
                                     dtype=torch.int32)

        def dispatch():
            with precision.highest():
                if index.use_walk:
                    w = index.walk
                    d, i = cagra._search_impl_walk(
                        local.dataset, w.table, w.entry_proj, w.entry_sq,
                        w.entry_ids, w.proj, queries, k, itopk,
                        params.search_width, max_iter, index.metric, rerank,
                        local.graph_degree)
                else:
                    d, i = cagra._search_impl(
                        local.dataset, local.graph, queries, seed_ids, k,
                        itopk, params.search_width, max_iter, index.metric,
                        rows_sq=cagra._rows_sq(local))
            i = _globalize(i.int(), index.rank * per)
            return _merge(comms, d, i, k, index.metric, queries.shape[0],
                          queries.device)[:2]

        return _entry("distributed.ann.search_cagra", dispatch,
                      retry_policy, deadline)


# ---------------------------------------------------------------------------
# per-shard recall-canary health checks
# ---------------------------------------------------------------------------

def _local_index(index):
    """This rank's shard as a single-device index, carrying the sharded
    index's generation (the JAX ``_local_index`` of shard ``rank``)."""
    if isinstance(index, DistributedCagraIndex):
        out = cagra.Index(dataset=index.local.dataset,
                          graph=index.local.graph, metric=index.metric)
    elif isinstance(index, (DistributedIndex, DistributedFlatIndex)):
        out = copy.copy(index.local)
    else:
        raise TypeError(
            f"distributed.ann.health_check: unsupported index type "
            f"{type(index).__name__}")
    out.generation = _mutate.generation(index)
    return out


def health_check(handle, index, *, raise_on_fail: bool = True,
                 health=None):
    """Re-search every shard's stored recall canaries and compare against
    the stored floor (:func:`raft_tpu_torch.integrity.health_check`).

    Each rank measures its own shard's canaries; the verdicts are
    allgathered and every rank judges them in shard order, so every rank
    returns the same list (one :class:`~raft_tpu_torch.integrity.
    CanaryReport`, or None, per shard; None when no shard carries
    canaries) and records the same counters and events; a
    :class:`RoutedIndex` carries one global canary set, measured through
    the routed search (:func:`_routed_health_check`).  With
    ``raise_on_fail`` the first failing shard raises
    :class:`~raft_tpu_torch.integrity.IntegrityError` naming the shard.
    ``health`` (a :class:`~raft_tpu_torch.distributed.health.
    HealthTracker`) is fed each verdict in order: a failure notes a
    canary failure, a pass notes OK."""
    if isinstance(index, RoutedIndex):
        return _routed_health_check(handle, index, raise_on_fail, health)
    comms = handle.get_comms()
    cs = index.shard_canaries
    mine = torch.zeros(6, dtype=torch.float64)
    if cs is not None:
        local = _local_index(index)
        local.canaries = cs
        with obs.stage("integrity.health_check"):
            recall = _canary.measure(handle, local, cs)
        mine = torch.tensor([1.0, recall, cs.floor, cs.n_queries, cs.k,
                             cs.build_recall], dtype=torch.float64)
    rows = comms.allgather(mine).cpu().tolist()
    if not any(row[0] for row in rows):
        return None
    reports = []
    for s, (present, recall, floor, n_q, k, build_recall) in enumerate(rows):
        if not present:
            reports.append(None)
            continue
        try:
            report = _canary._verdict(recall, floor, int(n_q), int(k),
                                     build_recall, raise_on_fail)
        except IntegrityError as e:
            if health is not None:
                health.note_canary_failure(s)
            raise IntegrityError(f"shard {s}: {e}", invariant=e.invariant,
                                 coord=(s,) + tuple(e.coord or ())) from e
        if health is not None:
            if report.ok:
                health.note_ok(s)
            else:
                health.note_canary_failure(s)
        reports.append(report)
    return reports


def _routed_health_check(handle, index: RoutedIndex, raise_on_fail: bool,
                         health):
    """A routed index's ONE global canary set, measured through the routed
    search (collective: every rank runs it and judges the same recall),
    the deleted ids taken over every rank's lists.  The verdict cannot
    name a shard: a failure is blamed on :func:`_blame_shards`, a pass
    noted OK for every shard.  Returns ``[report]``, or None without
    canaries."""
    if index.canaries is None:
        return None

    def note(shards, passed):
        if health is None:
            return
        for s in shards:
            if passed:
                health.note_ok(s)
            else:
                health.note_canary_failure(s)

    try:
        report = _canary.health_check(handle, index,
                                      raise_on_fail=raise_on_fail)
    except IntegrityError:
        note(_blame_shards(index.n_shards, health), False)
        raise
    passed = report is None or report.ok
    note(range(index.n_shards) if passed
         else _blame_shards(index.n_shards, health), passed)
    return [report]


def _blame_shards(n_shards: int, health) -> Tuple[int, ...]:
    """Shards a non-localizable (global-canary) failure is attributed to:
    the tracker's non-HEALTHY shards when any exist, else every shard."""
    if health is not None:
        suspects = tuple(s for s in range(n_shards)
                         if health.state(s) != "HEALTHY")
        if suspects:
            return suspects
    return tuple(range(n_shards))

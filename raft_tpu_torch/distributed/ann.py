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

The routed placement (``placement="by_list"``: ``Placement`` ...
``deserialize_routed``, replicas, failover, hedged reads) is not ported
yet: its names are stand-ins naming ROADMAP.md §1's 'distributed (item
7)'.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.cluster import kmeans_balanced as kb
from raft_tpu_torch.comms.comms import op_t
from raft_tpu_torch.core.error import expects, not_ported, not_ported_stub
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.filters.bitset import query_filter_words, words_on_device
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.integrity.errors import IntegrityError
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import cagra, grouped, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.observability import flight as _flight
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

_ITEM = "distributed (item 7)"
_ROUTED = ("Placement", "compute_placement", "placement_to_stream",
           "placement_from_stream", "RoutedIndex", "shard_by_list",
           "route_vectors", "rebalance_placement", "serialize_routed",
           "deserialize_routed")
for _name in _ROUTED:
    globals()[_name] = not_ported_stub("distributed.ann", _name, _ITEM)
del _name


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
                   device=None) -> torch.Tensor:
    """(n_shards,) int8 per-shard status: :data:`SHARD_FAILED` for the
    failed shards, else :data:`SHARD_OK_FALLBACK` when the requested scan
    mode was lowered, else :data:`SHARD_OK`."""
    status = torch.full((n_shards,),
                        SHARD_OK_FALLBACK if lowered else SHARD_OK,
                        dtype=torch.int8)
    status[list(failed)] = SHARD_FAILED
    return status.to(device) if device is not None else status


@dataclasses.dataclass(frozen=True)
class _ScanResolution:
    """Host-side resolution of the shard-local scan: ``form`` is
    ``probe_recon`` (the recon scan at kt = min(k, capacity)),
    ``grouped_recon`` (Kernel G at the requested kt), ``fused_recon``
    (Kernel B) or ``lut`` (the lookup-table scan); ``lowered`` marks a
    formulation downgrade (status :data:`SHARD_OK_FALLBACK`)."""

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
    """Build a by-row sharded IVF-PQ index over the handle's communicator:
    ``dataset`` is the whole (n, d) array on every rank (numpy, or a
    tensor on the CPU or the rank's device), of which each rank indexes
    its rows; ``params.n_lists`` is per shard.  Transient faults at entry
    (site ``distributed.ann.build``) are retried under ``retry_policy`` /
    ``deadline``.  ``placement="by_list"`` (the routed index) is not
    ported yet."""
    expects(placement in ("by_row", "by_list"),
            f"distributed.ann.build: placement must be 'by_row' or "
            f"'by_list', got {placement!r}")
    expects(replication_factor == 1 or placement == "by_list",
            "distributed.ann.build: replication_factor > 1 requires "
            "placement='by_list' (by_row is already fully replicated "
            "per shard's rows)")
    if placement == "by_list":
        raise not_ported("distributed.ann.build", "placement='by_list'",
                         _ITEM)
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

def _scan(index: DistributedIndex, r: _ScanResolution, params, queries,
          k: int, n_probes: int, fw):
    """This rank's (nq, k) candidates over its shard, in the resolved
    form (sqrt metrics already square-rooted, as the JAX shard-local
    epilogue does)."""
    local = index.local
    with precision.highest():
        qrot = queries.float() @ local.rotation
        probes = ivf_flat._select_clusters(local.centers, qrot, n_probes,
                                           local.metric)
        if r.form == "lut":
            return ivf_pq._search_lut(local, qrot, probes, k,
                                      ivf_pq._lut_dtype(params.lut_dtype),
                                      fw)
        if r.form == "fused_recon":
            scan, kt = ivf_pq._search_fused_recon, r.kt
        else:
            kt = r.kt if r.form == "grouped_recon" else min(k,
                                                            local.capacity)
            scan = ivf_pq._recon_scan(local, k, kt, False)[0]
        return scan(local, qrot, probes, k, kt, fw)


def _merge(comms, ld, li, k: int, metric: int, nq: int, device):
    """The candidate exchange: one allgather of distances and one of ids,
    then every rank selects the same merged top k (``grouped.
    finalize_topk``, no sqrt: the shard-local epilogue took it, and the
    merge is monotone).  A failed shard passes ``ld = None`` and
    contributes ``(±inf, -1)``."""
    select_min = metric != DistanceType.InnerProduct
    if ld is None:
        ld = torch.full((nq, k), float("inf") if select_min
                        else float("-inf"), device=device)
        li = torch.full((nq, k), -1, dtype=torch.int32, device=device)
    all_d = comms.allgather(ld)              # (n_dev, q, k)
    all_i = comms.allgather(li.int())
    return grouped.finalize_topk(all_d.permute(1, 0, 2),
                                 all_i.permute(1, 0, 2), nq, k, select_min,
                                 False, raw(select_k))


def ground_truth_params(index, params=None) -> ivf_pq.SearchParams:
    """The ground-truth operating point for a sharded index: every list
    of each shard probed, exact coarse ranking, no per-probe truncation,
    ``scan_mode="lut"`` (the JAX package's: its fused gates may refuse
    full-probe shapes, and a monitor must not tick fallbacks)."""
    base = params if params is not None else ivf_pq.SearchParams()
    return dataclasses.replace(base, n_probes=index.local.n_lists,
                               scan_mode="lut", per_probe_topk=0,
                               exact_coarse=True, use_reconstruction=None)


def search(handle, params: ivf_pq.SearchParams, index: DistributedIndex,
           queries, k: int, *,
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
    same on every rank.  Every rank scans its shard and the candidates are
    allgathered and merged.

    Degraded mode: shards in ``failed_shards``, flagged by the active
    fault plan's ``fail_shards`` or FAILED in ``health`` (a
    :class:`~raft_tpu_torch.distributed.health.HealthTracker`) are masked
    out of the merge: the query answers with the live shards' top k, the
    tail padded with ``(inf, -1)``, and a ``distributed.degraded_search``
    flight event is recorded.  ``return_status=True`` appends the
    (n_shards,) int8 status vector; ``return_stats=True`` a dict with the
    per-shard ``scanned_rows`` (queries x probes x the common capacity, 0
    on a failed shard), ``gather_shape``, the effective ``scan_mode`` and
    ``n_probes`` (and ``admitted_rows`` when filtered).  Transient faults
    at entry (site ``distributed.ann.search``) are retried under
    ``retry_policy`` / ``deadline``.

    Stragglers: the fault plan's per-shard delays are recorded
    (``distributed.straggler``), each flagged shard noted with ``health``,
    and each rank waits its own shard's delay, so the merge completes when
    the slowest shard answers.  ``shard_deadline_s`` (seconds or a
    ``Deadline``) records a ``distributed.shard_timeout`` event and notes
    a timeout with ``health`` for each straggler past it; by row there is
    no replica to hedge to, so the wait is paid in full.  ``hedge`` and
    ``routing`` steer the routed placement's replicas and have no effect
    by row.

    ``filter`` (a :class:`~raft_tpu_torch.filters.SampleFilter` or a (q,
    n_rows) bool mask) admits rows by GLOBAL id, which every shard's
    lists store, so one set of words serves every shard; each shard's
    admitted-candidate count rides the exchange (``admitted_rows``)."""
    del hedge  # by row nothing is hedged: no shard has a replica
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
        # this shard's own straggle: the allgather below waits for the
        # slowest shard, as the JAX merge does
        faults.pause(delays[index.rank] if delays else 0.0)
        n_probes = min(params.n_probes, index.local.n_lists)
        r = _resolve_scan_mode(params, index, nq, n_probes, k)
        mode_name = {"probe_recon": "recon"}.get(r.form, r.form)
        if rec is not None:
            rec.annotate("distributed.scan_mode", mode_name)
            rec.annotate("distributed.n_probes", int(n_probes))
            rec.annotate("distributed.shard_status", _status_vector(
                index.n_shards, failed, r.lowered).tolist())
        if failed:
            _flight.record_event("distributed.degraded_search",
                                 trace_id=trace_id, failed=list(failed),
                                 n_shards=index.n_shards)
        me_failed = index.rank in failed
        # kill site: a shard killed mid-scan keeps this search's set
        faults.maybe_fail("distributed.scan")

        def dispatch():
            ld = li = None
            if not me_failed:
                ld, li = _scan(index, r, params, queries, k, n_probes, fw)
            d, i = _merge(comms, ld, li, k, index.metric, nq,
                          queries.device)
            admitted = None
            if fw is not None:
                mine = 0 if me_failed else int((li >= 0).sum())
                admitted = comms.allgather(torch.tensor(mine,
                                                        dtype=torch.int64))
            return d, i, admitted

        d, i, admitted = _entry("distributed.ann.search", dispatch,
                                retry_policy, deadline)
        # kill site: after the gather; the next search sees the shard down
        faults.maybe_fail("distributed.gather")
        if fw is not None:
            if obs.enabled():
                obs.registry().counter(
                    "distributed.ann.search.filtered").inc()
            if rec is not None:
                rec.annotate("distributed.admitted_rows", admitted)
        out = [d, i]
        if return_status:
            out.append(_status_vector(index.n_shards, failed, r.lowered,
                                      d.device))
        if return_stats:
            per = torch.full((index.n_shards,),
                             nq * n_probes * index.local.capacity,
                             dtype=torch.int64)
            per[list(failed)] = 0
            stats = {"scanned_rows": per.numpy(),
                     "gather_shape": (index.n_shards, nq, k),
                     "scan_mode": mode_name, "n_probes": int(n_probes)}
            if admitted is not None:
                stats["admitted_rows"] = admitted.cpu().numpy()
            out.append(stats)
        return tuple(out)


def delete(handle, index: DistributedIndex, ids, *,
           retry_policy: Optional[_retry.RetryPolicy] = None,
           deadline: Optional[_retry.Deadline] = None) -> DistributedIndex:
    """Tombstone delete over the sharded index (ids GLOBAL): one
    elementwise rewrite of the rank's ``list_indices``, which every scan
    masks; every other tensor is shared with the parent, and the returned
    snapshot is the next generation.  Transient faults at entry (site
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
                          queries.shape[0], queries.device)

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
                          queries.device)

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
    canaries) and records the same counters and events.  With
    ``raise_on_fail`` the first failing shard raises
    :class:`~raft_tpu_torch.integrity.IntegrityError` naming the shard.
    ``health`` (a :class:`~raft_tpu_torch.distributed.health.
    HealthTracker`) is fed each verdict in order: a failure notes a
    canary failure, a pass notes OK."""
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


def _blame_shards(n_shards: int, health) -> Tuple[int, ...]:
    """Shards a non-localizable (global-canary) failure is attributed to:
    the tracker's non-HEALTHY shards when any exist, else every shard."""
    if health is not None:
        suspects = tuple(s for s in range(n_shards)
                         if health.state(s) != "HEALTHY")
        if suspects:
            return suspects
    return tuple(range(n_shards))

"""IVF-Flat: inverted-file index over a balanced k-means coarse quantizer
(port of ``raft_tpu.neighbors.ivf_flat``), and the IVF list helpers IVF-PQ
shares (``_pack_lists``, ``_append_lists_multi``, ``_select_clusters``,
``_finalize_topk``).

Reference: raft/neighbors/ivf_flat.cuh:65 ``build``, :201 ``extend``, :389
``search``; ivf_flat_types.hpp:44 / :76 / :126 for the param structs and
the index.  Same ``IndexParams`` / ``SearchParams`` fields and defaults as
the JAX package, the same ``(distances, ids)`` contract (exhausted slots
``(+inf, -1)``, ``(-inf, -1)`` for InnerProduct), tensors on the handle's
device.

Build: a random subsample trains the balanced coarse quantizer
(:func:`raft_tpu_torch.cluster.kmeans_balanced.fit`: Kernel A, two-level
from 8192 lists), the centers are ordered along their first principal
component (adjacent lists sit close, so a query's probes cluster into few
super-tiles), then every row is assigned (Kernel H) and packed into lists
of a shared, 32-aligned capacity.

Search: rank coarse probes exactly, then, where lists are small, scan
super-tiles of F adjacent lists (:func:`super_tile_factor`; a probed list
scans its whole tile, and a query's duplicate tiles are dropped by
:func:`dedup_super_probes`) — part of the result, as in the JAX package:
its search equals brute force over the union of the probed tiles.  Kernel
F (:func:`raft_tpu_torch.ops.pair_scan.ivf_flat_scan`; at k <= 64 the
pairs grouped by tile and scanned list-major, each tile's sub-lists up to
their last live row) writes each pair's top k, :func:`_finalize_topk`
takes each query's top k, and the sqrt metrics their sqrt.

``_select_clusters`` ranks coarse probes with an exact ``torch.topk``.  The
JAX package ranks them with ``approx_max_k`` on a TPU (exact on the CPU,
and exact there too whenever ``exact_coarse=True`` or ``n_probes`` is
within 1/8 of ``n_lists``), so on the card the port's probe sets can
differ from a TPU run's in the marginal probes; ``coarse_recall_target``
has no effect here.

Persistence: :func:`serialize` / :func:`deserialize` / :func:`save` /
:func:`load` write and read the JAX package's stream (version 2, the
reader takes 1..2) byte for byte.  Lists hold float32 rows whatever the
dataset's dtype; ``Index.data_dtype`` keeps the build's input dtype, and
the stream carries the rows in it (the cast back is exact), so a file is
byte-equal to the JAX package's at every dtype and an fp16 / int8 / uint8
file loads with an exact upcast.  ``list_data_sq`` is derived and never
written: the first search of a loaded index attaches it again.  With
``canary_queries > 0`` the build stores recall canaries
(:mod:`raft_tpu_torch.integrity.canary`), which ``extend`` and ``load``
health-check.

Filters and mutation: ``filter=`` (a :class:`~raft_tpu_torch.filters.
SampleFilter` or an (nq, n_rows) bool mask) restricts each query's
candidates by source id inside Kernel F, on both routes (the list-major
pass, and the query-major kernel at k > 64), at L2 and at InnerProduct;
:func:`delete` tombstones rows, :func:`upsert`
deletes and re-inserts in one generation, :func:`compact` drops the
tombstones and shrinks the capacity (:mod:`raft_tpu_torch.neighbors.
mutate`).  Inputs pass the boundary validator
(:mod:`raft_tpu_torch.integrity.boundary`) at the JAX package's sites:
under ``mask`` a build or extend keeps the zeroed rows and a search flags
masked query rows as ``(+inf, -1)`` (``(-inf, -1)`` for InnerProduct).
"""

from __future__ import annotations

import dataclasses
import time
from typing import BinaryIO, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import _writable, ensure_tensor
from raft_tpu_torch.core.outputs import auto_convert_output, raw
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType, SQRT_METRICS
from raft_tpu_torch.filters.bitset import query_filter_words, words_on_device
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.matrix.ops import row_duplicate_mask
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.ops.pair_scan import ivf_flat_scan
from raft_tpu_torch.utils import precision

_LIST_ALIGN = 32  # list capacities are rounded to warp multiples


@dataclasses.dataclass
class IndexParams:
    """Reference: ivf_flat_types.hpp:44 ``index_params`` (the JAX
    package's fields and defaults)."""

    n_lists: int = 1024
    metric: int = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True
    canary_queries: int = 0
    canary_k: int = 10
    canary_floor: float = 0.5


@dataclasses.dataclass
class SearchParams:
    """Reference: ivf_flat_types.hpp:76 ``search_params``; inherited by
    :class:`raft_tpu_torch.neighbors.ivf_pq.SearchParams`.
    ``coarse_recall_target`` and ``exact_coarse`` have no effect: the
    coarse ranking is always exact here."""

    n_probes: int = 20
    coarse_recall_target: float = 0.95
    exact_coarse: bool = False


@dataclasses.dataclass
class Index:
    """Reference: ivf_flat_types.hpp:126 ``index``; the JAX package's
    fields.  ``list_data`` (n_lists, capacity, dim) float32 with zero rows
    in empty slots; ``list_indices`` (n_lists, capacity) int32 with -1
    there; ``list_data_sq`` the rows' squared norms (n_lists, capacity)
    f32, attached by the first L2 search (extend keeps it current).
    ``data_dtype`` is the dtype the rows are serialized in, the build's
    input dtype (None: float32)."""

    centers: torch.Tensor
    list_data: torch.Tensor
    list_indices: torch.Tensor
    list_sizes: torch.Tensor
    metric: int = DistanceType.L2Expanded
    adaptive_centers: bool = False
    list_data_sq: Optional[torch.Tensor] = None
    canaries: Optional[object] = None
    generation: int = 0
    data_dtype: Optional[torch.dtype] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def capacity(self) -> int:
        return self.list_data.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


# ---------------------------------------------------------------------------
# list helpers (shared with IVF-PQ)
# ---------------------------------------------------------------------------

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


def _sqrt_epilogue(vals: torch.Tensor, metric: int) -> torch.Tensor:
    """The sqrt metrics take their sqrt (exhausted ranks stay +inf)."""
    if metric in SQRT_METRICS:
        vals = torch.sqrt(torch.clamp_min(vals, 0.0))
    return vals


def _finalize_topk(vals: torch.Tensor, ids: torch.Tensor, k: int,
                   metric: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top k over its (n_probes, kt) per-pair candidates
    (``grouped.finalize_topk``): the smallest distances, or the largest
    products for InnerProduct; (±inf, -1) past the candidates, every
    infinite rank id -1, sqrt for the sqrt metrics."""
    select_min = metric != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    nq = vals.shape[0]
    alld, alli = vals.reshape(nq, -1), ids.reshape(nq, -1)
    kf = min(k, alld.shape[1])
    best_d = torch.full((nq, k), worst, dtype=torch.float32,
                        device=vals.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=vals.device)
    if kf > 0:
        d, i = raw(select_k)(alld, kf, in_idx=alli,
                             select_min=select_min)
        best_d[:, :kf] = d
        best_i[:, :kf] = torch.where(torch.isinf(d), torch.full_like(i, -1),
                                     torch.clamp_min(i, -1))
    return _sqrt_epilogue(best_d, metric), best_i


def _stage(stages, name: Optional[str], t0: float, device) -> float:
    """End build stage ``name`` begun at ``t0``: wait for the device, record
    its wall seconds (``None`` records nothing) and return the time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    if name is not None:
        stages[name] = now - t0
    return now


def _row_norms(list_data: torch.Tensor) -> torch.Tensor:
    """Squared norms (n_lists, capacity) f32 of the list rows, a few lists
    at a time."""
    out = torch.empty(list_data.shape[:2], dtype=torch.float32,
                      device=list_data.device)
    for s in range(0, list_data.shape[0], 256):
        out[s:s + 256] = (list_data[s:s + 256].float() ** 2).sum(-1)
    return out


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------

def _balanced_params(metric: int, n_iters: int = 20) -> KMeansBalancedParams:
    return KMeansBalancedParams(
        n_iters=n_iters, metric=DistanceType.InnerProduct
        if metric == DistanceType.InnerProduct else DistanceType.L2Expanded)


def build(res, params: IndexParams, dataset) -> Index:
    """Build an IVF-Flat index (reference: ivf_flat.cuh:65).  The wall
    seconds of its stages (trainset, coarse_fit, extend) land in
    ``build.stage_seconds``; with ``canary_queries > 0`` (and the data
    added) the index carries recall canaries.  Under observability
    collection the stages record as ``ivf_flat.build.kmeans`` and the
    extend's, and :func:`~raft_tpu_torch.observability.build_report` of
    the index returns them."""
    with named_range("ivf_flat::build"), \
            obs.build_scope("ivf_flat.build") as rep, precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        expects(dataset.ndim == 2, "ivf_flat.build: 2-D dataset required")
        dataset, _ = boundary.check_matrix(dataset, "dataset",
                                           site="ivf_flat.build",
                                           allow_empty=False)
        expects(dataset.shape[0] > 0,
                "ivf_flat.build: non-empty 2-D dataset required")
        n, dim = dataset.shape
        expects(params.n_lists <= n, "ivf_flat.build: n_lists > n_rows")
        dev = res.device
        stages = build.stage_seconds = {}
        t = _stage(stages, None, time.perf_counter(), dev)

        with obs.stage("ivf_flat.build.kmeans") as st:
            n_train = max(params.n_lists,
                          int(n * params.kmeans_trainset_fraction))
            trainset = dataset
            if n_train < n:
                sel = torch.randperm(n, generator=res.generator,
                                     device=dev)[:n_train]
                trainset = dataset[sel]
            t = _stage(stages, "trainset", t, dev)
            centers = kmeans_balanced.fit(
                res, _balanced_params(params.metric, params.kmeans_n_iters),
                trainset, params.n_lists)
            # order lists along the centers' first principal component (of the
            # mean-centred centers: off-origin data would otherwise put the
            # mean direction first), so adjacent lists sit close together
            cc = centers - centers.mean(0, keepdim=True)
            _, vecs = torch.linalg.eigh(cc.T @ cc)
            centers = centers[torch.argsort(cc @ vecs[:, -1], stable=True)]
            st.fence(centers)
            t = _stage(stages, "coarse_fit", t, dev)

        index = Index(
            centers=centers,
            list_data=torch.zeros(params.n_lists, _LIST_ALIGN, dim,
                                  dtype=torch.float32, device=dev),
            list_indices=torch.full((params.n_lists, _LIST_ALIGN), -1,
                                    dtype=torch.int32, device=dev),
            list_sizes=torch.zeros(params.n_lists, dtype=torch.int32,
                                   device=dev),
            metric=params.metric, adaptive_centers=params.adaptive_centers,
            data_dtype=dataset.dtype)
        if params.add_data_on_build:
            index = extend(res, index, dataset,
                           torch.arange(n, dtype=torch.int32, device=dev))
            if params.canary_queries > 0:
                cs = _canary.make(res, dataset, metric=params.metric,
                                  n_queries=params.canary_queries,
                                  k=params.canary_k,
                                  floor=params.canary_floor)
                index.canaries = cs
                cs.build_recall = _canary.measure(res, index, cs)
        _stage(stages, "extend", t, dev)
        return rep.attach(index)


# wall seconds of the latest build's stages, device work included (each
# stage ends with a device synchronisation)
build.stage_seconds = {}


def _unit_rows(centers: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit norm (the spherical quantizer's invariant)."""
    return centers / torch.clamp_min(
        torch.linalg.norm(centers, dim=1, keepdim=True), 1e-12)


def extend(res, index: Index, new_vectors, new_indices=None) -> Index:
    """Add vectors (reference: ivf_flat.cuh:201).  Returns a new index, the
    next generation.  When every list has headroom for its new rows they
    are scatter-appended (their norms too, when the index carries
    ``list_data_sq``); otherwise all rows are repacked at a capacity that
    leaves the fullest list room for one more.  With ``adaptive_centers``
    the centers drift to their lists' means (unit norm for
    InnerProduct).  The new index keeps the canaries and health-checks
    them.  Stages: ``ivf_flat.extend.assign``, ``ivf_flat.extend.pack``."""
    with named_range("ivf_flat::extend"):
        out = _extend(res, index, new_vectors, new_indices)
        if index.canaries is not None:
            out.canaries = index.canaries
            _canary.auto_check(res, out, site="extend")
    return out


def _extend(res, index: Index, new_vectors, new_indices) -> Index:
    with precision.highest():
        new_vectors = ensure_tensor(new_vectors, res, "new_vectors").float()
        expects(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
                "ivf_flat.extend: dim mismatch")
        new_vectors, _ = boundary.check_matrix(
            new_vectors, "new_vectors", site="ivf_flat.extend",
            dim=index.dim)
        n_new = new_vectors.shape[0]
        dev = res.device
        if new_indices is None:
            new_indices = index.size + torch.arange(n_new, dtype=torch.int32,
                                                    device=dev)
        else:
            new_indices = ensure_tensor(new_indices, res, "new_indices").int()
        expects(new_indices.shape == (n_new,),
                "ivf_flat.extend: one index per new vector required")

        with obs.stage("ivf_flat.extend.assign") as st:
            labels = kmeans_balanced.predict(
                res, _balanced_params(index.metric), new_vectors,
                index.centers)
            new_counts = torch.bincount(labels,
                                        minlength=index.n_lists).int()
            needed = index.list_sizes + new_counts
            st.fence(labels, needed)
        max_needed = int(needed.max())
        ip = index.metric == DistanceType.InnerProduct
        common = dict(metric=index.metric,
                      adaptive_centers=index.adaptive_centers,
                      generation=index.generation + 1,
                      data_dtype=index.data_dtype)
        centers = index.centers

        if max_needed <= index.capacity:
            with obs.stage("ivf_flat.extend.pack") as st:
                bufs, rows = [index.list_data], [new_vectors]
                if index.list_data_sq is not None:
                    bufs.append(index.list_data_sq)
                    rows.append((new_vectors * new_vectors).sum(-1))
                new_bufs, list_idx, sizes = _append_lists_multi(
                    bufs, rows, index.list_indices, index.list_sizes, labels,
                    new_indices)
                st.fence(new_bufs)
            if index.adaptive_centers:
                # the centers approximate their lists' means: blend in the
                # new rows, weighted by the sizes
                new_sums = torch.zeros_like(centers).index_add_(
                    0, labels, new_vectors)
                blend = ((centers * index.list_sizes[:, None] + new_sums)
                         / torch.clamp_min(needed, 1)[:, None])
                centers = torch.where((new_counts > 0)[:, None], blend,
                                      centers)
                if ip:
                    centers = _unit_rows(centers)
            return Index(centers=centers, list_data=new_bufs[0],
                         list_indices=list_idx, list_sizes=sizes,
                         list_data_sq=new_bufs[1] if len(new_bufs) > 1
                         else None, **common)

        # repack: flatten the live rows, add the new ones, scatter again
        valid = (index.list_indices >= 0).reshape(-1)
        old_labels = torch.arange(
            index.n_lists, device=dev).repeat_interleave(index.capacity)
        all_vecs = torch.cat(
            [index.list_data.reshape(-1, index.dim)[valid], new_vectors])
        all_ids = torch.cat([index.list_indices.reshape(-1)[valid],
                             new_indices])
        all_labels = torch.cat([old_labels[valid], labels])
        # +1: a repack never leaves the fullest list brim-full, or the next
        # one-row extend would repack again
        capacity = _round_up(max(max_needed + 1, _LIST_ALIGN), _LIST_ALIGN)
        with obs.stage("ivf_flat.extend.pack") as st:
            list_data, list_idx, sizes = _pack_lists(
                all_vecs, all_labels, all_ids, index.n_lists, capacity)
            st.fence(list_data)
        if index.adaptive_centers:
            sums = torch.zeros_like(centers).index_add_(0, all_labels,
                                                        all_vecs)
            means = sums / torch.clamp_min(sizes, 1)[:, None]
            centers = torch.where((sizes > 0)[:, None], means, centers)
            if ip:
                centers = _unit_rows(centers)
        return Index(centers=centers, list_data=list_data,
                     list_indices=list_idx, list_sizes=sizes, **common)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def super_tile_factor(cap: int, n_lists: int, n_probes: int
                      ) -> Tuple[int, int]:
    """(F, n_lists_eff): how many adjacent lists one tile scans — the JAX
    package's rule (``raft_tpu/neighbors/ivf_flat.py:558``): double F
    while a tile holds fewer than 512 slots, F < 8, the list count is even
    and more lists remain than are probed."""
    F = 1
    while (cap * F < 512 and F < 8
           and n_lists % 2 == 0 and n_lists > n_probes):
        F *= 2
        n_lists //= 2
    return F, n_lists


def dedup_super_probes(probes: torch.Tensor, factor: int, n_super: int
                       ) -> torch.Tensor:
    """Per-query probes mapped onto super-tiles of ``factor`` adjacent
    lists, a query's repeated tiles replaced by the ``n_super`` sentinel
    (``raft_tpu/neighbors/grouped.py:220``): the scan skips a sentinel, so
    a tile is scanned once per query."""
    sp = probes // factor
    return torch.where(row_duplicate_mask(sp), torch.full_like(sp, n_super),
                       sp)


@auto_convert_output
def search(res, params: SearchParams, index: Index, queries, k: int, *,
           filter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: ivf_flat.cuh:389).  Returns (distances (nq, k)
    f32, ids (nq, k) int32) on the handle's device; unfilled ranks carry
    id -1 and +inf (-inf for InnerProduct).  ``filter`` (a
    :class:`~raft_tpu_torch.filters.SampleFilter` or an (nq, n_rows) bool
    mask) keeps each query to the ids it admits, inside the scan.

    .. note:: like the JAX package's, the first L2 search attaches the
       ``list_data_sq`` row-norm cache to ``index`` in place.

    Queries pass the boundary validator: under policy ``mask`` a
    non-finite query row returns the worst distance and id -1."""
    queries = ensure_tensor(queries, res, "queries")
    queries, ok_rows = boundary.check_matrix(
        queries, "queries", site="ivf_flat.search", dim=index.dim)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim,
            "ivf_flat.search: query dim mismatch")
    dist, ids = _search_checked(res, params, index, queries.float(), k,
                                filter=filter)
    return boundary.mask_search_outputs(
        dist, ids, ok_rows,
        select_min=index.metric != DistanceType.InnerProduct)


def _search_checked(res, params: SearchParams, index: Index, queries,
                    k: int, *, filter=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    fw = query_filter_words(filter, queries.shape[0], "ivf_flat.search")
    if fw is not None:
        fw = words_on_device(fw, queries.device)
        if obs.enabled():
            obs.registry().counter("ivf_flat.search.filtered").inc()
    with named_range("ivf_flat::search"), precision.highest():
        expects(0 < k, "ivf_flat.search: k must be positive")
        n_probes = min(params.n_probes, index.n_lists)
        ip = index.metric == DistanceType.InnerProduct
        with obs.stage("ivf_flat.search.coarse") as st:
            probes = _select_clusters(index.centers, queries, n_probes,
                                      index.metric)
            st.fence(probes)
        if not ip and index.list_data_sq is None:
            index.list_data_sq = _row_norms(index.list_data)
        cap = index.capacity
        F, n_eff = super_tile_factor(cap, index.n_lists, n_probes)
        data, ids, dsq = index.list_data, index.list_indices, \
            index.list_data_sq
        if F > 1:
            probes = dedup_super_probes(probes, F, n_eff)
            data = data.reshape(n_eff, F * cap, index.dim)
            ids = ids.reshape(n_eff, F * cap)
            dsq = None if ip else dsq.reshape(n_eff, F * cap)
        with obs.stage("ivf_flat.search.scan") as st:
            vals, found = ivf_flat_scan(queries, probes, data, dsq, ids,
                                        min(k, F * cap), ip, sub_lists=F,
                                        filter_words=fw)
            out = _finalize_topk(vals, found, k, index.metric)
            st.fence(out)
        return out


# ---------------------------------------------------------------------------
# carrying an index across, serialization; paths not ported yet
# ---------------------------------------------------------------------------

def index_from_numpy(arrays: Mapping[str, np.ndarray], *, metric: int,
                     adaptive_centers: bool = False, device="cuda") -> Index:
    """Build the port's :class:`Index` from numpy arrays keyed by the JAX
    ``Index`` leaf names (``centers``, ``list_data``, ``list_indices``,
    ``list_sizes`` and, when present, ``list_data_sq``), e.g.
    ``np.asarray`` of a ``raft_tpu``-built index's leaves.  The rows are
    held as float32 and ``data_dtype`` keeps ``list_data``'s dtype."""
    missing = [n for n in ("centers", "list_data", "list_indices",
                           "list_sizes") if arrays.get(n) is None]
    expects(not missing, f"index_from_numpy: missing arrays {missing}")

    def tensor(name):
        a = arrays.get(name)
        return None if a is None else torch.from_numpy(
            _writable(np.asarray(a))).to(device)

    rows = tensor("list_data")
    return Index(centers=tensor("centers").float(), list_data=rows.float(),
                 list_indices=tensor("list_indices").int(),
                 list_sizes=tensor("list_sizes").int(),
                 list_data_sq=tensor("list_data_sq"), metric=metric,
                 adaptive_centers=adaptive_centers,
                 data_dtype=rows.dtype)


# ---------------------------------------------------------------------------
# mutation (reference: raft_tpu/neighbors/ivf_flat.py delete / upsert /
# compact; the encoding in neighbors/mutate)
# ---------------------------------------------------------------------------

def delete(res, index: Index, ids) -> Index:
    """Tombstone-delete rows by source id: every ``list_indices`` slot
    holding one of ``ids`` becomes ``-(id + 2)``; every scan masks
    negative ids, so the rows leave results at once, at no cost per
    search.  Storage comes back with :func:`compact`.  Ids not present
    match nothing.  Returns a new index, the next generation, sharing
    every tensor but ``list_indices``; its canaries are health-checked."""
    with named_range("ivf_flat::delete"):
        ids = ensure_tensor(ids, res, "ids")
        expects(ids.ndim == 1, "ivf_flat.delete: 1-D ids required")
        new_li, _ = _mutate.tombstone(index.list_indices, ids)
        out = dataclasses.replace(index, list_indices=new_li)
        _mutate.next_generation(index, out)
        _canary.auto_check(res, out, site="delete")
    return out


def upsert(res, index: Index, ids, vectors) -> Index:
    """Replace-or-insert rows under explicit source ids: tombstone any
    rows with these ids, then append ``vectors`` under them — one
    mutation, ONE generation bump.  Ids not present simply insert.
    Counted in ``ivf_flat.upserts``."""
    with named_range("ivf_flat::upsert"):
        ids = ensure_tensor(ids, res, "ids")
        vectors = ensure_tensor(vectors, res, "vectors")
        expects(ids.ndim == 1 and ids.shape[0] == vectors.shape[0],
                "ivf_flat.upsert: ids must be 1-D, one per vector")
        parent_gen = _mutate.generation(index)
        out = extend(res, delete(res, index, ids), vectors,
                     new_indices=ids)
        out.generation = parent_gen + 1
        if obs.enabled():
            obs.registry().counter("ivf_flat.upserts").inc()
    return out


def compact(res, index: Index) -> Index:
    """Reclaim tombstoned slots: each list's live rows stably to the
    front, every tombstone dropped, the shared capacity shrunk to fit the
    fullest list with one row of headroom (32-aligned, never above the
    parent's); ``list_data_sq`` is carried along where the parent has it.
    Returns a new generation sharing ``centers`` with its parent."""
    with named_range("ivf_flat::compact"):
        order, sizes = _mutate.compaction_order(index.list_indices)
        max_size = int(sizes.max()) if index.n_lists else 0
        capacity = _round_up(max(max_size + 1, _LIST_ALIGN), _LIST_ALIGN)
        capacity = min(capacity, max(index.capacity, _LIST_ALIGN))
        order = order[:, :capacity]
        live = (torch.arange(capacity, device=order.device)[None, :]
                < sizes[:, None])
        li = torch.where(live, torch.gather(index.list_indices, 1, order),
                         torch.full_like(order, -1, dtype=torch.int32))
        data = torch.gather(index.list_data, 1,
                            order[:, :, None].expand(-1, -1, index.dim))
        data = torch.where(live[:, :, None], data, torch.zeros_like(data))
        data_sq = None
        if index.list_data_sq is not None:
            data_sq = torch.where(live, torch.gather(index.list_data_sq, 1,
                                                     order),
                                  torch.zeros_like(live, dtype=torch.float32))
        out = dataclasses.replace(index, list_data=data, list_indices=li,
                                  list_sizes=sizes, list_data_sq=data_sq)
        _mutate.next_generation(index, out)
        _canary.auto_check(res, out, site="compact")
    return out


# v2: trailing recall-canary block (nested envelope, may be absent)
_SERIALIZATION_VERSION = 2
_MIN_READ_VERSION = 1


def _stored_rows(index: Index) -> torch.Tensor:
    """``list_data`` in the dtype the stream carries (exact: the float32
    rows hold values of ``data_dtype``)."""
    if index.data_dtype in (None, index.list_data.dtype):
        return index.list_data
    return index.list_data.to(index.data_dtype)


def serialize(res, stream: BinaryIO, index: Index) -> None:
    """Versioned index dump in the CRC32 envelope (reference:
    detail/ivf_flat_serialize.cuh), byte-equal to the JAX package's."""
    with ser.enveloped_writer(stream) as body:
        ser.serialize_scalar(res, body, np.int32(_SERIALIZATION_VERSION))
        ser.serialize_scalar(res, body, np.int32(index.metric))
        ser.serialize_scalar(res, body, np.int32(index.adaptive_centers))
        for arr in (index.centers, _stored_rows(index), index.list_indices,
                    index.list_sizes):
            ser.serialize_mdspan(res, body, arr)
        _canary.to_stream(res, body, index.canaries)


def deserialize(res, stream: BinaryIO) -> Index:
    """Read a stream either package wrote, onto ``res.device``; truncated
    or bit-flipped streams raise :class:`~raft_tpu_torch.core.serialize.
    CorruptIndexError`."""
    body = ser.open_envelope(stream)
    version = int(ser.deserialize_scalar(res, body))
    if not _MIN_READ_VERSION <= version <= _SERIALIZATION_VERSION:
        raise ValueError(
            f"ivf_flat serialization version mismatch: got {version}, "
            f"expected {_MIN_READ_VERSION}..{_SERIALIZATION_VERSION}")
    metric = int(ser.deserialize_scalar(res, body))
    adaptive = bool(ser.deserialize_scalar(res, body))
    arrays = {name: ser.deserialize_mdspan(res, body)
              for name in ("centers", "list_data", "list_indices",
                           "list_sizes")}
    index = index_from_numpy(arrays, metric=metric,
                             adaptive_centers=adaptive, device=res.device)
    if version >= 2:
        index.canaries = _canary.from_stream(res, body)
    return index


def save(res, filename: str, index: Index, *, retry_policy=None,
         deadline=None) -> None:
    """Atomic file dump (tmp + fsync + rename) with transient-IO retry."""
    from raft_tpu_torch.resilience import _save_index
    _save_index("ivf_flat.save", lambda b: serialize(res, b, index),
                filename, retry_policy, deadline)


def load(res, filename: str, *, retry_policy=None, deadline=None) -> Index:
    """File-load overload: transient IO errors retry, corruption raises
    :class:`~raft_tpu_torch.core.serialize.CorruptIndexError` at once; an
    index carrying recall canaries is health-checked before it is
    returned."""
    from raft_tpu_torch.resilience import _load_index
    index = _load_index("ivf_flat.load", lambda b: deserialize(res, b),
                        filename, retry_policy, deadline)
    _canary.auto_check(res, index, site="load")
    return index

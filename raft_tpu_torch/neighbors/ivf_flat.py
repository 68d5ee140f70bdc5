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
F (:func:`raft_tpu_torch.ops.pair_scan.ivf_flat_scan`) writes each pair's
top k, :func:`_finalize_topk` takes each query's top k, and the sqrt
metrics their sqrt.

``_select_clusters`` ranks coarse probes with an exact ``torch.topk``.  The
JAX package ranks them with ``approx_max_k`` on a TPU (exact on the CPU,
and exact there too whenever ``exact_coarse=True`` or ``n_probes`` is
within 1/8 of ``n_lists``), so on the card the port's probe sets can
differ from a TPU run's in the marginal probes; ``coarse_recall_target``
has no effect here.

Not ported yet — each raises ``NotImplementedError`` naming its ROADMAP.md
item: ``delete`` / ``upsert`` / ``compact`` (mutation), ``serialize`` /
``deserialize`` / ``save`` / ``load`` (serialization), ``filter=``
(filters) and ``canary_queries > 0`` (canaries).  Lists hold float32 rows
whatever the dataset's dtype.  The port has no boundary validator yet:
inputs are checked for shape, not for finiteness.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import _writable, ensure_tensor
from raft_tpu_torch.distance.types import DistanceType, SQRT_METRICS
from raft_tpu_torch.matrix.ops import row_duplicate_mask
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.ops.pair_scan import ivf_flat_scan
from raft_tpu_torch.utils import precision

_LIST_ALIGN = 32  # list capacities are rounded to warp multiples


def _not_ported(what: str, item: str):
    return not_ported("ivf_flat", what, item)


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
    f32, attached by the first L2 search (extend keeps it current)."""

    centers: torch.Tensor
    list_data: torch.Tensor
    list_indices: torch.Tensor
    list_sizes: torch.Tensor
    metric: int = DistanceType.L2Expanded
    adaptive_centers: bool = False
    list_data_sq: Optional[torch.Tensor] = None
    canaries: Optional[object] = None
    generation: int = 0

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
        d, i = select_k(alld, kf, in_idx=alli, select_min=select_min)
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
    ``build.stage_seconds``."""
    if params.canary_queries > 0:
        raise _not_ported("canary_queries > 0", "canaries")
    with precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        expects(dataset.ndim == 2 and dataset.shape[0] > 0,
                "ivf_flat.build: non-empty 2-D dataset required")
        n, dim = dataset.shape
        expects(params.n_lists <= n, "ivf_flat.build: n_lists > n_rows")
        dev = res.device
        stages = build.stage_seconds = {}
        t = _stage(stages, None, time.perf_counter(), dev)

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
        t = _stage(stages, "coarse_fit", t, dev)

        index = Index(
            centers=centers,
            list_data=torch.zeros(params.n_lists, _LIST_ALIGN, dim,
                                  dtype=torch.float32, device=dev),
            list_indices=torch.full((params.n_lists, _LIST_ALIGN), -1,
                                    dtype=torch.int32, device=dev),
            list_sizes=torch.zeros(params.n_lists, dtype=torch.int32,
                                   device=dev),
            metric=params.metric, adaptive_centers=params.adaptive_centers)
        if params.add_data_on_build:
            index = extend(res, index, dataset,
                           torch.arange(n, dtype=torch.int32, device=dev))
        _stage(stages, "extend", t, dev)
        return index


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
    InnerProduct)."""
    with precision.highest():
        new_vectors = ensure_tensor(new_vectors, res, "new_vectors").float()
        expects(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
                "ivf_flat.extend: dim mismatch")
        n_new = new_vectors.shape[0]
        dev = res.device
        if new_indices is None:
            new_indices = index.size + torch.arange(n_new, dtype=torch.int32,
                                                    device=dev)
        else:
            new_indices = ensure_tensor(new_indices, res, "new_indices").int()
        expects(new_indices.shape == (n_new,),
                "ivf_flat.extend: one index per new vector required")

        labels = kmeans_balanced.predict(
            res, _balanced_params(index.metric), new_vectors, index.centers)
        new_counts = torch.bincount(labels, minlength=index.n_lists).int()
        needed = index.list_sizes + new_counts
        max_needed = int(needed.max())
        ip = index.metric == DistanceType.InnerProduct
        common = dict(metric=index.metric,
                      adaptive_centers=index.adaptive_centers,
                      generation=index.generation + 1)
        centers = index.centers

        if max_needed <= index.capacity:
            bufs, rows = [index.list_data], [new_vectors]
            if index.list_data_sq is not None:
                bufs.append(index.list_data_sq)
                rows.append((new_vectors * new_vectors).sum(-1))
            new_bufs, list_idx, sizes = _append_lists_multi(
                bufs, rows, index.list_indices, index.list_sizes, labels,
                new_indices)
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
        list_data, list_idx, sizes = _pack_lists(
            all_vecs, all_labels, all_ids, index.n_lists, capacity)
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


def search(res, params: SearchParams, index: Index, queries, k: int, *,
           filter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: ivf_flat.cuh:389).  Returns (distances (nq, k)
    f32, ids (nq, k) int32) on the handle's device; unfilled ranks carry
    id -1 and +inf (-inf for InnerProduct).

    .. note:: like the JAX package's, the first L2 search attaches the
       ``list_data_sq`` row-norm cache to ``index`` in place."""
    if filter is not None:
        raise _not_ported("filtered search (filter=)", "filters")
    with precision.highest():
        queries = ensure_tensor(queries, res, "queries").float()
        expects(queries.ndim == 2 and queries.shape[1] == index.dim,
                "ivf_flat.search: query dim mismatch")
        expects(0 < k, "ivf_flat.search: k must be positive")
        n_probes = min(params.n_probes, index.n_lists)
        ip = index.metric == DistanceType.InnerProduct
        probes = _select_clusters(index.centers, queries, n_probes,
                                  index.metric)
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
        vals, found = ivf_flat_scan(queries, probes, data, dsq, ids,
                                    min(k, F * cap), ip)
        return _finalize_topk(vals, found, k, index.metric)


# ---------------------------------------------------------------------------
# carrying an index across; paths not ported yet
# ---------------------------------------------------------------------------

def index_from_numpy(arrays: Mapping[str, np.ndarray], *, metric: int,
                     adaptive_centers: bool = False, device="cuda") -> Index:
    """Build the port's :class:`Index` from numpy arrays keyed by the JAX
    ``Index`` leaf names (``centers``, ``list_data``, ``list_indices``,
    ``list_sizes`` and, when present, ``list_data_sq``), e.g.
    ``np.asarray`` of a ``raft_tpu``-built index's leaves."""
    missing = [n for n in ("centers", "list_data", "list_indices",
                           "list_sizes") if arrays.get(n) is None]
    expects(not missing, f"index_from_numpy: missing arrays {missing}")

    def tensor(name):
        a = arrays.get(name)
        return None if a is None else torch.from_numpy(
            _writable(np.asarray(a))).to(device)

    return Index(centers=tensor("centers").float(),
                 list_data=tensor("list_data").float(),
                 list_indices=tensor("list_indices").int(),
                 list_sizes=tensor("list_sizes").int(),
                 list_data_sq=tensor("list_data_sq"), metric=metric,
                 adaptive_centers=adaptive_centers)


def delete(res, index: Index, ids) -> Index:
    raise _not_ported("delete", "mutation")


def upsert(res, index: Index, ids, vectors) -> Index:
    raise _not_ported("upsert", "mutation")


def compact(res, index: Index) -> Index:
    raise _not_ported("compact", "mutation")


def serialize(res, stream, index: Index) -> None:
    raise _not_ported("serialize", "serialization")


def deserialize(res, stream) -> Index:
    raise _not_ported("deserialize", "serialization")


def save(res, filename: str, index: Index, **kwargs) -> None:
    raise _not_ported("save", "serialization")


def load(res, filename: str, **kwargs) -> Index:
    raise _not_ported("load", "serialization")

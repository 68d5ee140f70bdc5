"""IVF-PQ: inverted file with product-quantized residuals (port of
``raft_tpu.neighbors.ivf_pq``) — build and search over the recon cache,
the packed codes and the int8 cache.

Reference: raft/neighbors/ivf_pq.cuh:224 ``build``, :266 ``extend``, :342
``search``; ivf_pq_types.hpp:48 / :110 / :264 for the param structs and the
index.  Same ``IndexParams`` / ``SearchParams`` fields and defaults as the
JAX package, the same ``(distances, ids)`` contract (exhausted slots are
``(+inf, -1)``), tensors on the handle's device.

Build: a random subsample trains the balanced coarse quantizer
(:func:`raft_tpu_torch.cluster.kmeans_balanced.fit`, whose Lloyd passes
are Kernel A, two-level from 8192 lists); the codebooks train with one
batched balanced loop (one launch of Kernel H's small-dim kernel a turn
over every subspace, or, with ``CodebookKind.PER_CLUSTER``, over every
coarse list's sampled residual sub-rows); every row is encoded,
bit-packed and packed into padded lists; with ``cache_reconstructions``
the bf16 reconstruction cache (``list_recon``, residual space) and its row
norms are attached.

Search: rotate the queries, rank coarse probes exactly
(:func:`raft_tpu_torch.neighbors.ivf_flat._select_clusters`), then the
scan chosen by ``scan_mode`` as the JAX package resolves it
(:func:`_resolve_mode`):

- fused recon (``"auto"`` / ``"fused"`` with a recon cache and codes not
  eligible): Kernel B, :mod:`raft_tpu_torch.ops.pq_group_scan` (the pairs
  grouped by list, then a per-pair pass and the merge: the list-major pass
  where a pair keeps at most 64 candidates, Kernel G's pair-group pass up
  to 256; Kernel G + finalize where Kernel B's gate refuses the shape);
- fused codes (``"fused"``, and ``"auto"`` without a recon cache): Kernel
  C, :func:`raft_tpu_torch.ops.pq_code_scan.ivf_pq_scan_codes_fused` (the
  pairs grouped by list, a per-pair pass over the codes and the merge: the
  list-major pass where a pair keeps at most 64 candidates, Kernel D's
  pair-group pass up to 128; else the query-major kernel);
- ``"recon"`` / ``use_reconstruction=True``: Kernel G
  (:func:`raft_tpu_torch.ops.pair_scan.ivf_pq_scan_recon`), each (query,
  probe) pair's top kt, then each query's top k (:func:`_finalize_topk`);
- ``"codes"``: Kernel D, each pair's top kt (list-major up to kt 64, as
  C's pass 1), then the same finalize; a shape both of D's routes refuse
  (one the Pallas codes gate refuses too: D takes every shape that gate
  admits) runs the lookup-table scan, as in the JAX package;
- ``"recon8"``: Kernel E over the int8 cache (list-major up to kt 64, the
  codes pass with int8 rows; above, the query-major kernel), then the same
  finalize; past kt 128 the composition of the JAX package's XLA twin
  (:func:`_search_recon8_wide`);
- ``"lut"`` / ``use_reconstruction=False``, and fused / auto on an index
  with no recon cache whose codes are not eligible (pq_bits outside {4,
  8}, per-cluster codebooks): the lookup-table scan (:func:`_search_lut`), a
  composition of the JAX package's ``_search_impl``, which runs no Pallas
  kernel.

InnerProduct: codes and recon8 resolve to recon, or to the lookup-table scan
without a recon cache, as in the JAX package; recon is the composition of
the JAX package's XLA twin (:func:`_search_recon_ip`; Kernels B and G,
like their Pallas kernels, are L2 only, and a fused request counts a
fallback with reason ``"dtype"``).  The other metrics the JAX package
searches (CosineExpanded, L1, CorrelationExpanded, ...) it scores as L2:
so does the port, routed as the JAX package routes them (codes and
recon8 to recon or the lookup-table scan; Kernel B's gate refuses the
metric, reason ``"dtype"``, and Kernel G + finalize runs).

The code and int8 caches are derived lazily by the first search that
needs them (the recon cache too, with a warning, for ``"recon"`` on an
index built without it); sqrt metrics get their sqrt afterwards.

Filters: ``filter=`` (a :class:`~raft_tpu_torch.filters.SampleFilter` or
an (nq, n_rows) bool mask) restricts each query's candidates by source id
inside the scan kernels of every scan mode, on both routes: the
list-major passes and the query-major kernels (a pair keeping more than
64 rows, the codes pass at rot 256 with 8 bits or past kt 40 at rot 128,
the int8 pass at rot_pad > 128 past kt 56) test the query's bit before a
row can enter a pair's top kt; the compositions (LUT, InnerProduct recon,
wide recon8) fold it in before each pair's top kt too; a rejected or
exhausted slot is ``(+inf, -1)`` (``(-inf, -1)`` at InnerProduct).

Mutation (:mod:`raft_tpu_torch.neighbors.mutate`): :func:`delete`
tombstones rows (every scan masks them), :func:`upsert` deletes and
re-inserts under the same ids in one generation, :func:`compact` drops
the tombstones, shrinks the capacity and rebuilds the derived caches the
parent carried.  Each returns a new index, the next generation.
:func:`calibrate_group_capacity` measures and stores ``group_est``, which
the port's dispatch does not read.

Persistence: :func:`serialize` / :func:`deserialize` / :func:`save` /
:func:`load` write and read the JAX package's stream (version 4, the
reader takes 2..4) byte for byte; the caches are derived and never
written (``cache_reconstructions=True``, the default, decodes the recon
cache again at load).  ``build(..., checkpoint=dir)`` saves the
``kmeans`` and ``codebooks`` stages, each before its
``interruptible.synchronize``, and ``resume=True`` loads the stages a
checkpoint holds instead of computing them; each stage also keeps the
handle generator's state, so on the CPU a resumed build is bit-identical
to an uninterrupted one.  ``canary_queries > 0`` stores recall canaries
(:mod:`raft_tpu_torch.integrity.canary`), checked after ``extend``,
``load`` and a resumed build.

Inputs pass the boundary validator (:mod:`raft_tpu_torch.integrity.
boundary`) at the JAX package's sites and with its site strings: under
the default policy ``raise`` a non-finite row raises ``ValidationError``;
under ``mask`` a build keeps the zeroed rows and a search flags masked
query rows as ``(+inf, -1)``.

Random draws (the trainset subsample, the k-means re-seeds) come from the
handle's ``torch.Generator``, so a port-built index differs from a
JAX-built one draw for draw; :func:`index_from_numpy` carries a JAX-built
index across for like-for-like search comparisons.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import BinaryIO, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.interruptible import interruptible
from raft_tpu_torch.core.mdarray import _writable, ensure_tensor
from raft_tpu_torch.core.outputs import auto_convert_output
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType, L2_METRICS
from raft_tpu_torch.filters.bitset import (query_bits, query_filter_words,
                                           words_on_device)
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.neighbors.ivf_flat import (_LIST_ALIGN,
                                               _append_lists_multi,
                                               _finalize_topk, _pack_lists,
                                               _round_up, _select_clusters,
                                               _sqrt_epilogue, _stage)
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops.pair_scan import ivf_pq_scan_recon
from raft_tpu_torch.ops.pq_code_scan import code_field as _code_field
from raft_tpu_torch.ops.pq_group_scan import (ivf_pq_scan_fused, pair_topk,
                                              probe_distances,
                                              scan_reject_reason)
from raft_tpu_torch.ops.vmem_budget import merge_window_request
from raft_tpu_torch.utils import precision


class CodebookKind:
    """Reference: ivf_pq_types.hpp ``codebook_gen`` enum."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclasses.dataclass
class IndexParams:
    """Reference: ivf_pq_types.hpp:48 ``index_params`` (the JAX package's
    fields and defaults)."""

    n_lists: int = 1024
    metric: int = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8          # 4..8, as the reference
    pq_dim: int = 0           # 0 -> auto: dim / 4
    codebook_kind: int = CodebookKind.PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    # bf16 reconstruction cache, (n, rot_dim) * 2 B; the fused recon
    # search scans it
    cache_reconstructions: bool = True
    canary_queries: int = 0
    canary_k: int = 10
    canary_floor: float = 0.5


@dataclasses.dataclass
class SearchParams(ivf_flat.SearchParams):
    """Reference: ivf_pq_types.hpp:110 ``search_params`` (the JAX package's
    fields and defaults; ``n_probes``, ``coarse_recall_target`` and
    ``exact_coarse`` from :class:`ivf_flat.SearchParams`).  ``n_probes``;
    ``scan_mode`` ("auto", "fused", "codes", "recon", "recon8", "lut");
    ``use_reconstruction`` (the old override: True -> "recon", False ->
    "lut"); ``per_probe_topk`` (each (query, probe) pair's kt; 0 -> k) on
    the per-pair scans — the probe-order lookup-table scan keeps min(k, capacity) a
    probe whatever it says, as the JAX package's does, so a fallback to it
    errs toward more candidates; ``lut_dtype`` (float32, bfloat16 or
    float16, a torch dtype or its name) rounds the lookup-table scan's table, whose
    entries are summed in fp32.  ``internal_distance_dtype`` is accepted
    and ignored, as the JAX package's lookup-table scan ignores it (the sums are
    fp32).  ``coarse_recall_target`` and ``exact_coarse`` have no effect:
    the coarse ranking is always exact here.  ``merge_window`` sizes the
    TPU's VMEM merge window: it is validated as the JAX package validates
    it (:func:`raft_tpu_torch.ops.vmem_budget.merge_window_request`:
    "auto" or an int >= 0, else ``ValueError``) on every search that does
    not resolve to the lookup-table scan, and selects nothing.  ``packed_extract``
    sizes a TPU-only mechanism and is accepted and ignored — the port's
    selection never truncates mantissa bits as the TPU's packed extraction
    does."""

    lut_dtype: object = torch.float32
    internal_distance_dtype: object = torch.float32
    use_reconstruction: Optional[bool] = None
    scan_mode: str = "auto"
    per_probe_topk: int = 0
    packed_extract: bool = False
    merge_window: object = "auto"


@dataclasses.dataclass
class Index:
    """Reference: ivf_pq_types.hpp:264 ``index``; the JAX package's fields.

    ``codebooks``: (pq_dim, book, pq_len) f32 per-subspace, (n_lists,
    book, pq_len) per-cluster; ``list_codes``: (n_lists,
    capacity, W) uint8 bit-packed codes, W = ceil(pq_dim*pq_bits/8);
    ``list_indices`` (n_lists, capacity) int32 with -1 padding;
    ``rotation`` (dim, rot_dim) orthonormal; ``list_recon`` (n_lists,
    capacity, rot_dim) bf16 residual reconstructions and ``list_recon_sq``
    their squared norms (n_lists, capacity) f32.  Derived scan caches,
    attached by the first search that needs them: ``list_code_rsq``
    (n_lists, capacity) f32, the bf16 reconstructions' row norms for the
    code scans; ``list_recon_i8`` (n_lists, capacity, rot_pad) int8 rows
    zero-padded to a multiple of 16 bytes, ``list_recon_scale``
    (n_lists,) f32 and ``list_recon_i8_sq`` (n_lists, capacity) f32 for
    the int8 scan.  ``list_code_lanes`` (the TPU's lane-major code words)
    stays None: the port's kernels read ``list_codes`` as it is."""

    centers: torch.Tensor
    codebooks: torch.Tensor
    list_codes: torch.Tensor
    list_indices: torch.Tensor
    list_sizes: torch.Tensor
    rotation: torch.Tensor
    metric: int = DistanceType.L2Expanded
    codebook_kind: int = CodebookKind.PER_SUBSPACE
    pq_bits: int = 8
    list_recon: Optional[torch.Tensor] = None
    list_recon_sq: Optional[torch.Tensor] = None
    list_code_lanes: Optional[torch.Tensor] = None
    list_code_rsq: Optional[torch.Tensor] = None
    list_recon_i8: Optional[torch.Tensor] = None
    list_recon_scale: Optional[torch.Tensor] = None
    list_recon_i8_sq: Optional[torch.Tensor] = None
    pq_dim_: int = 0
    canaries: Optional[object] = None
    generation: int = 0
    group_est: float = 0.0

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[1]

    @property
    def pq_dim(self) -> int:
        return self.pq_dim_ or self.rotation.shape[1] // self.codebooks.shape[2]

    @property
    def code_width(self) -> int:
        return self.list_codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.codebooks.shape[2]

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def capacity(self) -> int:
        return self.list_codes.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _make_rotation(dim: int, rot_dim: int, random: bool, seed: int,
                   device) -> torch.Tensor:
    """Orthonormal (dim, rot_dim) transform: identity when not random,
    else Q of the QR of a seeded normal draw (a CPU generator, so the
    rotation does not depend on the device)."""
    if not random and dim == rot_dim:
        return torch.eye(dim, dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(seed)
    g = (torch.randn(dim, rot_dim, generator=gen) if dim >= rot_dim
         else torch.randn(rot_dim, dim, generator=gen).T)
    g = torch.cat([g, torch.zeros(max(0, rot_dim - dim), rot_dim)])
    q, _ = torch.linalg.qr(g.double())
    return q[:dim, :rot_dim].float().to(device)


def _subspace_split(x: torch.Tensor, pq_dim: int) -> torch.Tensor:
    """(n, rot_dim) -> (n, pq_dim, pq_len)."""
    n, rd = x.shape
    return x.reshape(n, pq_dim, rd // pq_dim)


def packed_code_width(pq_dim: int, pq_bits: int) -> int:
    """Bytes per vector of bit-packed codes."""
    return -(-pq_dim * pq_bits // 8)


def _pack_codes(codes: torch.Tensor, pq_bits: int) -> torch.Tensor:
    """(..., pq_dim) uint8 codes (< 2^pq_bits) -> (..., W) uint8 packed
    LSB-first (reference: ivf_pq_codepacking.cuh).  Identity at 8 bits."""
    if pq_bits == 8:
        return codes
    *lead, pq_dim = codes.shape
    total = pq_dim * pq_bits
    W = packed_code_width(pq_dim, pq_bits)
    c = codes.int()
    bit = torch.arange(pq_bits, dtype=torch.int32, device=codes.device)
    bits = ((c[..., None] >> bit) & 1).reshape(*lead, total)
    bits = torch.nn.functional.pad(bits, (0, W * 8 - total))
    bits = bits.reshape(*lead, W, 8)
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.int32,
                           device=codes.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def _unpack_codes(packed: torch.Tensor, pq_dim: int, pq_bits: int
                  ) -> torch.Tensor:
    """Inverse of :func:`_pack_codes`: (..., W) -> (..., pq_dim) uint8."""
    if pq_bits == 8:
        return packed
    return torch.stack([_code_field(packed, j, pq_bits)
                        for j in range(pq_dim)], -1).to(torch.uint8)


# codebook k-means needs ~book_size * a-few-hundred rows
_BOOK_TRAIN_ROWS = 65_536
# bytes of one chunk's transients in the encode, the lookup-table scan and the
# wide compositions: a few 2 GB steps, never a whole-batch tensor
_CHUNK_BYTES = 2 << 30
# rows per chunk of extend's rotate -> assign -> encode pipeline
_EXTEND_CHUNK = 1 << 20


def _train_books_per_subspace(resid_sub: torch.Tensor,
                              generator: torch.Generator, book_size: int,
                              n_iters: int) -> torch.Tensor:
    """Balanced k-means of every subspace at once (reference:
    train_per_subset, ivf_pq_build.cuh:337): (pq_dim, n, pq_len) ->
    codebooks (pq_dim, book, pq_len), one batched loop with B = pq_dim
    (:func:`raft_tpu_torch.cluster.kmeans_balanced._balanced_loop_batched`:
    one launch of Kernel H's small-dim kernel a turn; the JAX package
    ``lax.map``s the subspaces, since its vmapped loop would materialise
    the (pq_dim, n, book) distances, which Kernel H never does).  Rows are
    subsampled to _BOOK_TRAIN_ROWS by stride (the trainset is already
    shuffled)."""
    n = resid_sub.shape[1]
    if n > _BOOK_TRAIN_ROWS:
        stride = n // _BOOK_TRAIN_ROWS
        resid_sub = resid_sub[:, ::stride][:, :_BOOK_TRAIN_ROWS]
    resid_sub = resid_sub.float().contiguous()
    centers, _ = kmeans_balanced._balanced_loop_batched(
        resid_sub, kmeans_balanced._strided_init(resid_sub, book_size),
        generator,
        book_size, n_iters)
    return centers


# the flat sub-row an empty cluster trains on: the JAX package's top_k
# over an all -inf row picks rows 0, 1, ..., and ``j mod 1`` keeps the
# first
_EMPTY_CLUSTER_ROW = 0


def _sample_per_cluster(flat_labels: torch.Tensor,
                        generator: torch.Generator, n_lists: int,
                        per: int) -> torch.Tensor:
    """(n_lists, per) flat sub-row indices, the JAX package's sampling
    contract (``raft_tpu/neighbors/ivf_pq.py:584-598``) without its
    (n_lists, n) gumbel matrix: each cluster takes a uniform sample of
    ``per`` of its own sub-rows without replacement, cycles its members
    as ``j mod n_valid`` when it has fewer, and an empty cluster takes
    row :data:`_EMPTY_CLUSTER_ROW`.  One random permutation, then a
    stable sort by label: each cluster's segment is its members in random
    order, and it takes the segment's first ``per``."""
    n = flat_labels.shape[0]
    dev = flat_labels.device
    perm = torch.randperm(n, generator=generator, device=dev)
    sorted_lab, order = torch.sort(flat_labels[perm].long(), stable=True)
    order = perm[order]
    seg = torch.arange(n_lists, device=dev)
    starts = torch.searchsorted(sorted_lab, seg)
    counts = torch.searchsorted(sorted_lab, seg, right=True) - starts
    j = torch.arange(per, device=dev)[None, :] % torch.clamp_min(
        counts, 1)[:, None]
    idx = order[torch.clamp(starts[:, None] + j, max=n - 1)]
    return torch.where(counts[:, None] > 0, idx,
                       torch.full_like(idx, _EMPTY_CLUSTER_ROW))


def _train_books_per_cluster(flat: torch.Tensor, flat_labels: torch.Tensor,
                             generator: torch.Generator, n_lists: int,
                             book: int, n_iters: int) -> torch.Tensor:
    """Per-cluster codebooks (reference: train_per_cluster,
    ivf_pq_build.cuh:417; the JAX package's ``_train_books_per_cluster``):
    ``per = max(book·4, 256)`` sampled residual sub-rows a coarse list
    (:func:`_sample_per_cluster`), then ONE batched balanced loop over
    every list, B = n_lists (one launch of Kernel H's small-dim kernel a
    turn): flat (n, pq_len) -> codebooks (n_lists, book, pq_len)."""
    per = max(book * 4, 256)
    idx = _sample_per_cluster(flat_labels, generator, n_lists, per)
    subsets = flat.float()[idx]                      # (n_lists, per, len)
    centers, _ = kmeans_balanced._balanced_loop_batched(
        subsets, kmeans_balanced._strided_init(subsets, book), generator,
        book, n_iters)
    return centers


def _encode_chunk_rows(pq_dim: int, book: int, pq_len: int) -> int:
    """Rows a chunk of :func:`_encode` takes so that its (rows, pq_dim,
    book) products and distances (and per-cluster codebooks) stay near
    :data:`_CHUNK_BYTES`."""
    per_row = 4 * (2 * pq_dim * book + book * (pq_len + 1))
    return max(1, _CHUNK_BYTES // per_row)


def _encode(codebooks: torch.Tensor, resid: torch.Tensor,
            codebook_kind: int = CodebookKind.PER_SUBSPACE,
            labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PQ-encode residuals (n, pq_dim, pq_len) -> (n, pq_dim) uint8: the
    argmin over the codebook of each subspace (reference:
    process_and_fill_codes_kernel, ivf_pq_build.cuh:944), chunked; a
    per-cluster index encodes each row against its list's book
    (``labels``)."""
    n, pq_dim, pq_len = resid.shape
    book = codebooks.shape[1]
    out = torch.empty(n, pq_dim, dtype=torch.uint8, device=resid.device)
    chunk = _encode_chunk_rows(pq_dim, book, pq_len)
    if codebook_kind == CodebookKind.PER_SUBSPACE:
        cb_sq = (codebooks * codebooks).sum(-1)             # (pq_dim, book)
    for s in range(0, n, chunk):
        r = resid[s:s + chunk]
        if codebook_kind == CodebookKind.PER_SUBSPACE:
            d = cb_sq[None, :, :] - 2.0 * torch.einsum("njl,jkl->njk", r,
                                                       codebooks)
        else:
            cb = codebooks[labels[s:s + chunk].long()]      # (c, book, l)
            d = (cb * cb).sum(-1)[:, None, :] - 2.0 * torch.einsum(
                "njl,nkl->njk", r, cb)
        out[s:s + r.shape[0]] = torch.argmin(d, dim=-1).to(torch.uint8)
    return out


def build(res, params: IndexParams, dataset, *, checkpoint=None,
          resume: bool = False) -> Index:
    """Build an IVF-PQ index (reference: ivf_pq.cuh:224).  The wall
    seconds of its stages (trainset, coarse_fit, codebooks,
    encode_and_pack, recon_cache) land in ``build.stage_seconds``; under
    observability collection the JAX package's stages record
    (``ivf_pq.build.kmeans``, ``.codebooks``, ``.recon_cache``, the
    extend's) and :func:`~raft_tpu_torch.observability.build_report` of
    the index returns them.

    ``checkpoint`` (a directory or a :class:`~raft_tpu_torch.resilience.
    CheckpointManager`) saves the ``kmeans`` and ``codebooks`` stages
    atomically, each before its ``interruptible.synchronize``; with
    ``resume=True`` the stages it holds are loaded instead of computed,
    and the handle's generator is set to the state saved with them."""
    from raft_tpu_torch.resilience import checkpoint as _ckpt
    expects(params.codebook_kind in (CodebookKind.PER_SUBSPACE,
                                     CodebookKind.PER_CLUSTER),
            f"ivf_pq.build: unknown codebook_kind {params.codebook_kind}")
    ckpt = _ckpt.as_manager(checkpoint)
    with named_range("ivf_pq::build"), \
            obs.build_scope("ivf_pq.build") as rep, precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        expects(dataset.ndim == 2, "ivf_pq.build: 2-D dataset required")
        dataset, _ = boundary.check_matrix(dataset, "dataset",
                                           site="ivf_pq.build",
                                           allow_empty=False)
        expects(dataset.shape[0] > 0,
                "ivf_pq.build: non-empty 2-D dataset required")
        n, dim = dataset.shape
        expects(params.n_lists <= n, "ivf_pq.build: n_lists > n_rows")
        expects(4 <= params.pq_bits <= 8,
                "ivf_pq.build: pq_bits in [4, 8] (as the reference)")
        dev = res.device
        pq_dim = params.pq_dim or max(dim // 4, 1)
        rot_dim = _round_up(dim, pq_dim)
        rotation = _make_rotation(dim, rot_dim,
                                  params.force_random_rotation
                                  or rot_dim != dim, seed=7, device=dev)

        stages = build.stage_seconds = {}
        t = _stage(stages, None, time.perf_counter(), dev)

        with obs.stage("ivf_pq.build.kmeans") as st:
            # coarse quantizer, in the rotated space
            n_train = max(params.n_lists,
                          int(n * params.kmeans_trainset_fraction))
            if n_train < n:
                sel = torch.randperm(n, generator=res.generator,
                                     device=dev)[:n_train]
                trainset = dataset[sel]
            else:
                trainset = dataset
            train_rot = trainset.float() @ rotation
            t = _stage(stages, "trainset", t, dev)
            bal = KMeansBalancedParams(n_iters=params.kmeans_n_iters)
            centers = _ckpt.run_stage(
                ckpt, "kmeans", resume, res.generator, dev,
                lambda: {"centers": kmeans_balanced.fit(
                    res, bal, train_rot, params.n_lists)})["centers"]
            # cancellation point: the stage above is durable before a pending
            # cancel() can raise
            interruptible.synchronize(centers)
            st.fence(centers)
            t = _stage(stages, "coarse_fit", t, dev)

        def fit_books():
            """Per-subspace or per-cluster codebooks over the trainset's
            residuals."""
            labels_t = kmeans_balanced.predict(res, bal, train_rot, centers)
            resid = _subspace_split(train_rot - centers[labels_t], pq_dim)
            book = 1 << params.pq_bits
            if params.codebook_kind == CodebookKind.PER_SUBSPACE:
                return {"codebooks": _train_books_per_subspace(
                    resid.transpose(0, 1), res.generator, book,
                    params.kmeans_n_iters)}
            # one book per coarse list over its residual sub-rows; sub-row
            # i belongs to trainset row i // pq_dim
            return {"codebooks": _train_books_per_cluster(
                resid.reshape(-1, resid.shape[2]),
                labels_t.repeat_interleave(pq_dim), res.generator,
                params.n_lists, book, params.kmeans_n_iters)}

        with obs.stage("ivf_pq.build.codebooks") as st:
            codebooks = _ckpt.run_stage(ckpt, "codebooks", resume,
                                        res.generator, dev,
                                        fit_books)["codebooks"]
            del train_rot
            interruptible.synchronize(codebooks)
            st.fence(codebooks)
            t = _stage(stages, "codebooks", t, dev)

        index = Index(
            centers=centers, codebooks=codebooks,
            list_codes=torch.zeros(
                params.n_lists, _LIST_ALIGN,
                packed_code_width(pq_dim, params.pq_bits),
                dtype=torch.uint8, device=dev),
            list_indices=torch.full((params.n_lists, _LIST_ALIGN), -1,
                                    dtype=torch.int32, device=dev),
            list_sizes=torch.zeros(params.n_lists, dtype=torch.int32,
                                   device=dev),
            rotation=rotation, metric=params.metric,
            codebook_kind=params.codebook_kind, pq_bits=params.pq_bits,
            pq_dim_=pq_dim)
        if params.add_data_on_build:
            index = extend(res, index, dataset,
                           torch.arange(n, dtype=torch.int32, device=dev))
        t = _stage(stages, "encode_and_pack", t, dev)
        if params.cache_reconstructions and index.list_recon is None:
            with obs.stage("ivf_pq.build.recon_cache") as st:
                index = _with_recon(index)
                st.fence(index.list_recon, index.list_recon_sq)
        _stage(stages, "recon_cache", t, dev)
        if params.canary_queries > 0 and params.add_data_on_build:
            cs = _canary.make(res, dataset, metric=params.metric,
                              n_queries=params.canary_queries,
                              k=params.canary_k, floor=params.canary_floor)
            index.canaries = cs
            cs.build_recall = _canary.measure(res, index, cs)
            if resume:
                _canary.auto_check(res, index, site="resume")
        return rep.attach(index)


# wall seconds of the latest build's stages, device work included (each
# stage ends with a device synchronisation)
build.stage_seconds = {}


def extend(res, index: Index, new_vectors, new_indices=None) -> Index:
    """Encode + add vectors (reference: ivf_pq.cuh:266).  Returns a new
    index, the next generation.  Lists with headroom for every new row take
    a scatter-append (recon cache rows appended alongside); otherwise all
    rows are repacked at a capacity that leaves the fullest list room for
    one more, and the recon cache is rebuilt if the index had one.  The
    new index keeps the canaries and health-checks them.  Stages:
    ``ivf_pq.extend.encode``, ``ivf_pq.extend.pack``."""
    with named_range("ivf_pq::extend"):
        out = _extend(res, index, new_vectors, new_indices)
        if index.canaries is not None:
            out.canaries = index.canaries
            _canary.auto_check(res, out, site="extend")
    return out


def _extend(res, index: Index, new_vectors, new_indices) -> Index:
    with precision.highest():
        new_vectors = ensure_tensor(new_vectors, res, "new_vectors")
        new_vectors, _ = boundary.check_matrix(
            new_vectors, "new_vectors", site="ivf_pq.extend", dim=index.dim)
        expects(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
                "ivf_pq.extend: dim mismatch")
        n_new = new_vectors.shape[0]
        dev = res.device
        if new_indices is None:
            new_indices = index.size + torch.arange(n_new, dtype=torch.int32,
                                                    device=dev)
        else:
            new_indices = ensure_tensor(new_indices, res, "new_indices").int()
        expects(new_indices.shape == (n_new,),
                "ivf_pq.extend: one index per new vector required")

        bal = KMeansBalancedParams()
        want_recon_rows = index.list_recon is not None
        with obs.stage("ivf_pq.extend.encode") as st:
            codes_parts, label_parts, recon_parts = [], [], []
            for s0 in range(0, n_new, _EXTEND_CHUNK):
                rot_c = (new_vectors[s0:s0 + _EXTEND_CHUNK].float()
                         @ index.rotation)
                lab_c = kmeans_balanced.predict(res, bal, rot_c,
                                                index.centers)
                cu = _encode(index.codebooks,
                             _subspace_split(rot_c - index.centers[lab_c],
                                             index.pq_dim),
                             index.codebook_kind, lab_c)
                if want_recon_rows:
                    recon_parts.append(_decode_rows(
                        index.codebooks, cu, lab_c, index.codebook_kind))
                codes_parts.append(_pack_codes(cu, index.pq_bits))
                label_parts.append(lab_c)
            codes = torch.cat(codes_parts)
            labels = torch.cat(label_parts)
            st.fence(codes, labels)

        needed = index.list_sizes + torch.bincount(
            labels, minlength=index.n_lists).int()
        max_needed = int(needed.max())
        common = dict(centers=index.centers, codebooks=index.codebooks,
                      rotation=index.rotation, metric=index.metric,
                      codebook_kind=index.codebook_kind,
                      pq_bits=index.pq_bits, pq_dim_=index.pq_dim,
                      generation=index.generation + 1)
        if max_needed <= index.capacity:
            with obs.stage("ivf_pq.extend.pack") as st:
                bufs, rows = [index.list_codes], [codes]
                if want_recon_rows:
                    recon_rows = torch.cat(recon_parts)
                    bufs += [index.list_recon, _recon_sq(index.list_recon)
                             if index.list_recon_sq is None
                             else index.list_recon_sq]
                    rows += [recon_rows, (recon_rows.float() ** 2).sum(-1)]
                new_bufs, list_idx, sizes = _append_lists_multi(
                    bufs, rows, index.list_indices, index.list_sizes,
                    labels, new_indices)
                st.fence(new_bufs)
            out = Index(list_codes=new_bufs[0], list_indices=list_idx,
                        list_sizes=sizes, **common)
            if want_recon_rows:
                out.list_recon, out.list_recon_sq = new_bufs[1:]
            return out

        # repack: flatten the live rows, add the new ones, scatter again
        valid = (index.list_indices >= 0).reshape(-1)
        old_labels = torch.arange(
            index.n_lists, device=dev).repeat_interleave(index.capacity)
        all_codes = torch.cat(
            [index.list_codes.reshape(-1, index.code_width)[valid], codes])
        all_ids = torch.cat([index.list_indices.reshape(-1)[valid],
                             new_indices])
        all_labels = torch.cat([old_labels[valid], labels])
        capacity = _round_up(max(max_needed + 1, _LIST_ALIGN), _LIST_ALIGN)
        with obs.stage("ivf_pq.extend.pack") as st:
            list_codes, list_idx, sizes = _pack_lists(
                all_codes, all_labels, all_ids, index.n_lists, capacity)
            st.fence(list_codes)
        out = Index(list_codes=list_codes, list_indices=list_idx,
                    list_sizes=sizes, **common)
        if want_recon_rows:
            out = _with_recon(out)
        return out


# ---------------------------------------------------------------------------
# reconstruction cache
# ---------------------------------------------------------------------------

def _decode_lists(codebooks: torch.Tensor, list_codes: torch.Tensor,
                  pq_dim: int, pq_bits: int,
                  codebook_kind: int = CodebookKind.PER_SUBSPACE
                  ) -> torch.Tensor:
    """Every list's codes decoded to bf16 RESIDUAL reconstructions
    (n_lists, capacity, rot_dim) = concat_j codebook[code_j], one
    subspace at a time: codebook_j's for per-subspace books, the list's
    own book (``codebooks`` (n_lists, book, pq_len), one per list of
    ``list_codes``) for per-cluster codebooks.  Padded slots decode code 0 to
    a real-looking row; only their id (-1) masks them."""
    if codebook_kind == CodebookKind.PER_SUBSPACE:
        expects(codebooks.shape[0] == pq_dim,
                "_decode_lists: pq_dim mismatch")
        return pcs.decode_codes(list_codes, codebooks, pq_bits)
    L, cap, _ = list_codes.shape
    expects(codebooks.shape[0] == L, "_decode_lists: one book a list")
    pq_len = codebooks.shape[2]
    books = codebooks.to(torch.bfloat16)
    lists = torch.arange(L, device=list_codes.device)[:, None]
    out = torch.empty(L, cap, pq_dim * pq_len, dtype=torch.bfloat16,
                      device=list_codes.device)
    for j in range(pq_dim):
        out[..., j * pq_len:(j + 1) * pq_len] = books[
            lists, _code_field(list_codes, j, pq_bits)]
    return out


def _decode_rows(codebooks: torch.Tensor, codes: torch.Tensor,
                 labels: Optional[torch.Tensor] = None,
                 codebook_kind: int = CodebookKind.PER_SUBSPACE
                 ) -> torch.Tensor:
    """(n, pq_dim) codes -> (n, rot_dim) bf16 residual reconstructions;
    a per-cluster index decodes row i with the book of list
    ``labels[i]``."""
    n, pq_dim = codes.shape
    if codebook_kind == CodebookKind.PER_SUBSPACE:
        j = torch.arange(pq_dim, device=codes.device)[None, :]
        rows = codebooks[j, codes.long()]
    else:
        rows = codebooks[labels.long()[:, None], codes.long()]
    return rows.reshape(n, -1).to(torch.bfloat16)


def _recon_sq(list_recon: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms (n_lists, capacity) f32 of the bf16 cache,
    a few lists at a time."""
    out = torch.empty(list_recon.shape[:2], dtype=torch.float32,
                      device=list_recon.device)
    for s in range(0, list_recon.shape[0], 256):
        out[s:s + 256] = (list_recon[s:s + 256].float() ** 2).sum(-1)
    return out


def _with_recon(index: Index) -> Index:
    """Attach the reconstruction cache and its squared norms."""
    index.list_recon = _decode_lists(index.codebooks, index.list_codes,
                                     index.pq_dim, index.pq_bits,
                                     index.codebook_kind)
    index.list_recon_sq = _recon_sq(index.list_recon)
    return index


def _rsq_from_codes(codebooks: torch.Tensor, list_codes: torch.Tensor,
                    pq_dim: int, pq_bits: int) -> torch.Tensor:
    """Per-row squared norms (n_lists, capacity) f32 of the bf16
    reconstructions straight from the packed codes: Σ_j ‖bf16(cb)[j,
    code_j]‖², the subspaces summed in order.  Squaring the bf16-ROUNDED
    codebook keeps the value that of :func:`_recon_sq` of the cache
    without materialising it."""
    cb_sq = (codebooks.to(torch.bfloat16).float() ** 2).sum(-1)
    acc = torch.zeros(list_codes.shape[:2], dtype=torch.float32,
                      device=list_codes.device)
    for j in range(pq_dim):
        acc += cb_sq[j][_code_field(list_codes, j, pq_bits)]
    return acc


def _with_code_rsq(index: Index) -> Index:
    """Attach the row norms the code scans need: the recon cache's when
    the index has them, else :func:`_rsq_from_codes`.  The kernels read
    ``list_codes`` as it is, so ``list_code_lanes`` stays None."""
    if index.list_recon_sq is not None:
        index.list_code_rsq = index.list_recon_sq
    else:
        index.list_code_rsq = _rsq_from_codes(index.codebooks,
                                              index.list_codes,
                                              index.pq_dim, index.pq_bits)
    return index


# f32(1/127), the factor XLA folds ``x / 127.0`` into (exact as a double)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_recon(list_recon: torch.Tensor, rot_pad: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 recon lists -> (int8 rows zero-padded to ``rot_pad``, per-list
    f32 scale, dequantized row norms).  One symmetric scale per list,
    ``max|recon| · f32(1/127)`` (1.0 for an all-zero list): the JAX
    package writes ``maxabs / 127.0``, which XLA compiles to a product
    with the rounded reciprocal, and ``maxabs / 127`` can differ from it
    by an ulp; ``round(r / scale)`` half to even (a true division, as
    XLA keeps it), clipped to ±127; ``rsq8 = scale² · Σ q²`` in fp32."""
    r = list_recon.float()
    rot = r.shape[2]
    maxabs = r.abs().amax(dim=(1, 2))
    scale = torch.where(maxabs > 0, maxabs * _INV_127,
                        torch.ones_like(maxabs))
    q = torch.clamp(torch.round(r / scale[:, None, None]), -127, 127)
    rsq8 = scale[:, None] ** 2 * (q * q).sum(-1)
    qi = torch.nn.functional.pad(q.to(torch.int8), (0, rot_pad - rot))
    return qi, scale, rsq8


# lists per chunk of the int8 quantisation's fp32 transients
_QUANT_LISTS = 256


def _with_recon8(index: Index) -> Index:
    """Attach the int8 recon cache, its scales and row norms, a few lists
    at a time; the bf16 recon is decoded on the fly when the index has
    none, and only the int8 copy is kept.  Rows are padded to a multiple
    of 16 bytes for the kernel's 16-byte loads (the TPU pads to 128)."""
    rot_pad = _round_up(index.rot_dim, 16)
    per_cluster = index.codebook_kind == CodebookKind.PER_CLUSTER
    parts = []
    for s in range(0, index.n_lists, _QUANT_LISTS):
        recon = (index.list_recon[s:s + _QUANT_LISTS]
                 if index.list_recon is not None else
                 _decode_lists(index.codebooks[s:s + _QUANT_LISTS]
                               if per_cluster else index.codebooks,
                               index.list_codes[s:s + _QUANT_LISTS],
                               index.pq_dim, index.pq_bits,
                               index.codebook_kind))
        parts.append(_quantize_recon(recon, rot_pad))
    index.list_recon_i8 = torch.cat([p[0] for p in parts])
    index.list_recon_scale = torch.cat([p[1] for p in parts])
    index.list_recon_i8_sq = torch.cat([p[2] for p in parts])
    return index


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

_SCAN_MODES = ("auto", "codes", "recon", "recon8", "lut", "fused")


def _codes_mode_eligible(index: Index) -> bool:
    """Static preconditions of the code scans: L2-family metric,
    per-subspace codebooks, and pq_bits whose fields never cross a byte."""
    return (index.metric in L2_METRICS
            and index.codebook_kind == CodebookKind.PER_SUBSPACE
            and index.pq_bits in (4, 8))


def _resolve_mode(params: SearchParams, index: Index) -> Tuple[str, bool]:
    """``(backing mode, want_fused)`` exactly as the JAX package resolves
    ``scan_mode``: "fused" -> codes when eligible, else recon with a
    recon cache, else lut; "auto" -> recon with a recon cache, else codes
    when eligible, else lut; codes / recon8 on a non-L2 metric -> recon
    or lut.  ``want_fused``: the scan keeps each query's top k in the
    kernel where the shape allows it."""
    mode = params.scan_mode or "auto"
    if params.use_reconstruction is not None:
        mode = "recon" if params.use_reconstruction else "lut"
    expects(mode in _SCAN_MODES,
            f"ivf_pq.search: unknown scan_mode {mode!r} (one of "
            f"{_SCAN_MODES})")
    want_fused = mode in ("auto", "fused")
    has_recon = index.list_recon is not None
    if mode == "fused":
        mode = ("codes" if _codes_mode_eligible(index)
                else "recon" if has_recon else "lut")
    if mode == "auto":
        mode = ("recon" if has_recon
                else "codes" if _codes_mode_eligible(index) else "lut")
    if mode in ("codes", "recon8") and index.metric not in L2_METRICS:
        mode = "lut" if not has_recon else "recon"
    return mode, want_fused


def _note_fused_fallback(reason: str) -> None:
    """Count a fused search a gate sent elsewhere: ``search.
    fused_fallbacks`` and ``search.last_fallback_reason``, and, as the JAX
    package does, the ``ivf_pq.search.fused_fallback`` and ``.reason.<r>``
    counters (collection on) and the always-on ``ivf_pq.fused_fallback``
    flight event with the ambient request's trace id.  Only Python scalars
    reach the event, so recording it never waits on the device."""
    search.fused_fallbacks += 1
    search.last_fallback_reason = reason
    if obs.enabled():
        reg = obs.registry()
        reg.counter("ivf_pq.search.fused_fallback").inc()
        reg.counter(f"ivf_pq.search.fused_fallback.reason.{reason}").inc()
    rec = obs.trace.current()
    obs.flight.record_event("ivf_pq.fused_fallback", reason=reason,
                            trace_id=rec.trace_id if rec else None)


def _search_fused_recon(index, qrot, probes, k, kt, fw=None):
    """Kernel B over the bf16 recon cache, each query's top k in kernel
    (the caller has checked Kernel B's gate).  ``fw``: the filter's words,
    or None."""
    if index.list_recon_sq is None:
        index.list_recon_sq = _recon_sq(index.list_recon)
    vals, ids = ivf_pq_scan_fused(
        qrot, index.centers.float(), probes, index.list_recon,
        index.list_recon_sq, index.list_indices, k, kt, filter_words=fw)
    return _sqrt_epilogue(vals, index.metric), ids


def _search_recon(index, qrot, probes, k, kt, fw=None):
    """Kernel G over the bf16 recon cache, then each query's top k."""
    if index.list_recon_sq is None:
        index.list_recon_sq = _recon_sq(index.list_recon)
    vals, ids = ivf_pq_scan_recon(
        qrot, index.centers.float(), probes, index.list_recon,
        index.list_recon_sq, index.list_indices, kt, filter_words=fw)
    return _finalize_topk(vals, ids, k, index.metric)


def _search_fused_codes(index, qrot, probes, k, kt, fw=None):
    """Kernel C over the packed codes, each query's top k in kernel."""
    vals, ids = pcs.ivf_pq_scan_codes_fused(
        qrot, index.centers.float(), probes, index.list_codes,
        index.codebooks, index.list_code_rsq, index.list_indices,
        index.pq_bits, k, kt, filter_words=fw)
    return _sqrt_epilogue(vals, index.metric), ids


def _recon_scan(index, k: int, kt: int, want_fused: bool
                ) -> Tuple[object, str, str]:
    """``(scan, stage label, fallback reason)`` over the bf16 recon cache:
    Kernel B where the fused form is wanted and its gate admits the shape,
    else Kernel G, and for InnerProduct the composition of the XLA twin.
    The reason is "" unless a wanted fused form was refused: Kernel B's
    gate refuses InnerProduct and every metric off the L2 family
    (CosineExpanded, L1, CorrelationExpanded, ..., which the JAX package
    scores as L2 over the recon cache), as the Pallas
    ``fused_reject_reason`` does (reason "dtype").  ``core/aot``'s recon
    programs choose through it too."""
    if index.metric == DistanceType.InnerProduct:
        return (_search_recon_ip, "ivf_pq.search.scan",
                "dtype" if want_fused else "")
    if not want_fused:
        return _search_recon, "ivf_pq.search.scan", ""
    reason = ("dtype" if index.metric not in L2_METRICS else
              scan_reject_reason(index.capacity, index.rot_dim, k, kt))
    if reason:
        return _search_recon, "ivf_pq.search.scan", reason
    return _search_fused_recon, "ivf_pq.search.fused_scan", ""


def _search_codes(index, qrot, probes, k, kt, fw=None):
    """Kernel D over the packed codes, then each query's top k."""
    vals, ids = pcs.ivf_pq_scan_codes(
        qrot, index.centers.float(), probes, index.list_codes,
        index.codebooks, index.list_code_rsq, index.list_indices,
        index.pq_bits, kt, filter_words=fw)
    return _finalize_topk(vals, ids, k, index.metric)


def _search_recon8(index, qrot, probes, k, kt, fw=None):
    """Kernel E over the int8 recon cache, then each query's top k; a
    shape both of E's routes refuse (kt > 128) runs the composition of the
    JAX package's XLA twin (:func:`_search_recon8_wide`), as the JAX
    package does past its kernel's gate."""
    if pcs.recon8_reject_reason(index.capacity,
                                index.list_recon_i8.shape[2], kt):
        return _search_recon8_wide(index, qrot, probes, k, kt, fw)
    vals, ids = pcs.ivf_pq_scan_recon8(
        qrot, index.centers.float(), probes, index.list_recon_i8,
        index.list_recon_scale, index.list_recon_i8_sq, index.list_indices,
        kt, filter_words=fw)
    return _finalize_topk(vals, ids, k, index.metric)


def _query_chunk(bytes_per_query: int) -> int:
    """Queries a step of a composition takes so that its transients stay
    near :data:`_CHUNK_BYTES`."""
    return max(1, _CHUNK_BYTES // max(1, bytes_per_query))


def _search_recon8_wide(index, qrot, probes, k, kt, fw=None):
    """The int8 scan past Kernel E's gates (kt > 128): a composition of
    the JAX package's XLA twin (``raft_tpu/neighbors/ivf_pq.py:1333-1364``)
    — ``d = max(‖sub‖² + rsq8 − 2·scale·(bf16(sub) · q8), 0)``, the dot
    accumulated in fp32 and scaled after, each pair's top kt by (distance,
    slot), then each query's top k — over chunks of queries."""
    cap, rot_pad = index.list_recon_i8.shape[1:]
    kt = min(kt, cap)
    qp, cp, dot = pcs.recon8_plain_args(qrot, index.centers,
                                        index.list_recon_i8,
                                        index.list_recon_scale)
    step = _query_chunk(probes.shape[1] * cap * (rot_pad + 16) * 4)
    vals, ids = [], []
    for s0 in range(0, qp.shape[0], step):
        f = None if fw is None else fw[s0:s0 + step]
        v, i = pair_topk(*probe_distances(
            qp[s0:s0 + step], cp, probes[s0:s0 + step], index.list_indices,
            index.list_recon_i8_sq, dot, f), kt)
        vals.append(v)
        ids.append(i)
    return _finalize_topk(torch.cat(vals), torch.cat(ids), k, index.metric)


def _search_recon_ip(index, qrot, probes, k, kt, fw=None):
    """InnerProduct over the bf16 recon cache: a list-major composition of
    the JAX package's XLA twin (``raft_tpu/neighbors/ivf_pq.py:1212-1218``;
    its Pallas kernels, like Kernels B and G, are L2 only).  The (query,
    probe) pairs grouped by list; per group ``d = bf16(q) · recon`` (fp32
    accumulation) ``+ q · c`` (fp32), ``-inf`` on padding, tombstones and
    rejected rows; each pair's top kt (the largest); then each query's top
    k."""
    from raft_tpu_torch.neighbors import grouped
    nq, n_probes = probes.shape
    P = nq * n_probes
    recon = index.list_recon
    n_lists, cap, rot = recon.shape
    kt = min(kt, cap)
    cf = index.centers.float()
    qf = qrot.float()
    # live, the exact group count; a capture cannot wait on the host, so
    # there the static one (its empty groups computed and dropped)
    static = qf.is_cuda and torch.cuda.is_current_stream_capturing()
    group_list, slot_pairs = grouped.build_groups(
        probes, n_lists, n_groups=grouped.group_capacity(
            nq, n_probes, n_lists)[0] if static else None)
    out_v = torch.full((P + 1, kt), float("-inf"), dtype=torch.float32,
                       device=qf.device)
    out_i = torch.full((P + 1, kt), -1, dtype=torch.int32, device=qf.device)
    G = slot_pairs.shape[1]
    step = max(1, _CHUNK_BYTES // (4 * cap * rot + 32 * G * cap
                                    + 8 * G * rot))
    for g0 in range(0, group_list.shape[0], step):
        gl = group_list[g0:g0 + step].long()
        slot = slot_pairs[g0:g0 + step].long()
        qid = torch.where(slot < P, slot // n_probes,
                          torch.zeros_like(slot))
        qv = qf[qid]                                         # (B, G, rot)
        ip = torch.matmul(qv.to(torch.bfloat16).float(),
                          recon[gl].float().transpose(1, 2))  # (B, G, cap)
        d = ip + (qv * cf[gl][:, None, :]).sum(-1)[..., None]
        ids = index.list_indices[gl][:, None, :].expand(-1, G, -1)
        keep = ids >= 0
        if fw is not None:
            keep = keep & (query_bits(fw, qid, ids) > 0)
        d = torch.where(keep, d, torch.full_like(d, float("-inf")))
        d, pos = torch.topk(d, kt, dim=-1, largest=True, sorted=True)
        i = torch.gather(ids, -1, pos)
        i = torch.where(torch.isinf(d), torch.full_like(i, -1), i)
        out_v[slot.reshape(-1)] = d.reshape(-1, kt)
        out_i[slot.reshape(-1)] = i.reshape(-1, kt).int()
    return _finalize_topk(out_v[:P].reshape(nq, n_probes, kt),
                          out_i[:P].reshape(nq, n_probes, kt), k,
                          index.metric)


def _lut_dtype(dtype) -> torch.dtype:
    """``SearchParams.lut_dtype`` as a torch dtype: a torch dtype, or a
    name or numpy / ml_dtypes dtype of float32, bfloat16 or float16."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        name = getattr(dtype, "name", None) or getattr(
            dtype, "__name__", None) or str(dtype)
        out = getattr(torch, str(name).split(".")[-1], None)
    expects(out in (torch.float32, torch.bfloat16, torch.float16),
            f"ivf_pq.search: lut_dtype {dtype!r} is not float32, bfloat16 "
            f"or float16")
    return out


def _search_lut(index, qrot, probes, k, lut_dtype, fw=None):
    """The lookup-table scan: a composition of the JAX package's ``_search_impl``
    (``raft_tpu/neighbors/ivf_pq.py:1475-1558``), probe order, one probe
    a step.  Per probe, each query's LUT (pq_dim, book): for L2 ``‖cb‖² −
    2·r_j·cb`` over its residual subvectors ``r_j``, for InnerProduct
    ``q_j·cb`` over its query subvectors, from the per-subspace books or
    the probed list's own book (per-cluster), at fp32 (TF32 off), rounded
    to ``lut_dtype``; a row's distance is its codes' LUT entries summed in
    fp32, plus ``‖r‖²`` (L2) or ``q·c`` (InnerProduct).  Each probe keeps
    kt = min(k, capacity) rows whatever ``per_probe_topk`` says (as the
    JAX package does), then each query's top k.  Queries are chunked so
    that a step's gather stays near :data:`_CHUNK_BYTES`."""
    ip_metric = index.metric == DistanceType.InnerProduct
    worst = float("-inf") if ip_metric else float("inf")
    nq, n_probes = probes.shape
    cap, pq_dim, pq_bits = index.capacity, index.pq_dim, index.pq_bits
    book = index.pq_book_size
    kt = min(k, cap)
    per_cluster = index.codebook_kind == CodebookKind.PER_CLUSTER
    cb = index.codebooks.float()
    cb_sq = (cb * cb).sum(-1)                   # (pq_dim | n_lists, book)
    cf = index.centers.float()
    qf = qrot.float()
    offs = (torch.arange(pq_dim, device=qf.device) * book)[None, None, :]
    step = _query_chunk(cap * pq_dim * 40 + pq_dim * book * 12)
    vals = torch.empty(nq, n_probes, kt, dtype=torch.float32,
                       device=qf.device)
    ids_out = torch.empty(nq, n_probes, kt, dtype=torch.int32,
                          device=qf.device)
    for s0 in range(0, nq, step):
        q = qf[s0:s0 + step]
        c = q.shape[0]
        f = None if fw is None else fw[s0:s0 + step]
        for p in range(n_probes):
            lists = probes[s0:s0 + step, p].long()
            sub = (q if ip_metric else q - cf[lists]).reshape(
                c, pq_dim, -1)
            if per_cluster:
                ipj = torch.matmul(sub, cb[lists].transpose(1, 2))
                bsq = cb_sq[lists][:, None, :]
            else:
                ipj = torch.einsum("qjl,jkl->qjk", sub, cb)
                bsq = cb_sq[None]
            lut = (ipj if ip_metric else bsq - 2.0 * ipj).to(lut_dtype)
            codes = _unpack_codes(index.list_codes[lists], pq_dim, pq_bits)
            flat = (codes.long() + offs).reshape(c, -1)
            d = torch.gather(lut.reshape(c, -1), 1, flat).reshape(
                c, cap, pq_dim).float().sum(-1)
            if ip_metric:
                d = d + (q * cf[lists]).sum(-1)[:, None]
            else:
                d = d + (sub * sub).sum((1, 2))[:, None]
            ids = index.list_indices[lists]
            keep = ids >= 0
            if f is not None:
                keep = keep & (query_bits(
                    f, torch.arange(c, device=qf.device), ids) > 0)
            d = torch.where(keep, d, torch.full_like(d, worst))
            d, pos = torch.topk(d, kt, dim=1, largest=ip_metric,
                                sorted=True)
            i = torch.gather(ids, 1, pos)
            vals[s0:s0 + c, p] = d
            ids_out[s0:s0 + c, p] = torch.where(
                torch.isinf(d), torch.full_like(i, -1), i)
    return _finalize_topk(vals, ids_out, k, index.metric)


@auto_convert_output
def search(res, params: SearchParams, index: Index, queries, k: int, *,
           filter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search (reference: ivf_pq.cuh:342).  Returns (distances (nq, k)
    f32, ids (nq, k) int32) on the handle's device.

    ``scan_mode`` resolves as in the JAX package (:func:`_resolve_mode`)
    and runs: fused recon -> Kernel B (Kernel G where B's gate refuses the
    shape); codes wanting the fused form -> Kernel C (Kernel D where C's
    gate refuses it); each fallback is counted in ``search.fused_fallbacks``
    with the gate's reason in ``search.last_fallback_reason``; recon ->
    Kernel G (building the recon cache first, with a warning, on an index
    without one); codes -> Kernel D (the lookup-table scan where both of D's routes
    refuse the shape, as the Pallas gate does); recon8 -> Kernel E (past kt 128 the composition of
    the XLA twin); lut -> the lookup-table scan (a fused request counts reason
    "mode").  InnerProduct: recon -> the composition of the XLA twin (a
    fused request counts reason "dtype"), lut -> the lookup-table scan.

    ``filter`` (a :class:`~raft_tpu_torch.filters.SampleFilter`, one row
    broadcast to the batch, or an (nq, n_rows) bool mask) restricts each
    query's candidates by source id inside the scan, on every mode: at
    full probe the result equals the unfiltered result filtered
    afterwards.  A query with fewer admitted candidates than k gets
    ``(+inf, -1)`` on the rest.

    .. note:: like the JAX package's, the first search of an index may
       attach derived caches in place (``list_recon_sq``,
       ``list_code_rsq``, the int8 cache); ``extend`` returns an index
       without them, so they never go stale.

    Queries pass the boundary validator: under policy ``mask`` a
    non-finite query row returns ``(+inf, -1)`` instead of poisoning the
    batch."""
    queries = ensure_tensor(queries, res, "queries")
    queries, ok_rows = boundary.check_matrix(
        queries, "queries", site="ivf_pq.search", dim=index.dim)
    dist, ids = _search_checked(res, params, index, queries, k,
                                filter=filter)
    return boundary.mask_search_outputs(
        dist, ids, ok_rows,
        select_min=index.metric != DistanceType.InnerProduct)


def _search_checked(res, params: SearchParams, index: Index, queries,
                    k: int, *, filter=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch, under the JAX package's stage names: ``coarse``, then
    one scan stage (``fused_scan``, ``scan``, ``code_scan`` or
    ``recon8_scan``); the lookup-table scan is one ``lut`` stage with its
    coarse ranking inside, as there; a derived cache built here records
    ``lut_build``."""
    fw = query_filter_words(filter, queries.shape[0], "ivf_pq.search")
    if fw is not None:
        fw = words_on_device(fw, queries.device)
        if obs.enabled():
            obs.registry().counter("ivf_pq.search.filtered").inc()
    mode, want_fused = _resolve_mode(params, index)
    if mode == "codes" and not _codes_mode_eligible(index):
        mode = "lut"
    if mode == "lut":
        if want_fused:
            _note_fused_fallback("mode")
    else:
        merge_window_request(params.merge_window)
    if mode == "recon" and index.list_recon is None:
        # scan_mode="recon" / use_reconstruction=True without a cache
        warnings.warn(
            "ivf_pq.search: scan_mode='recon' on an index built without a "
            "reconstruction cache — materializing the (n_lists, cap, "
            "rot_dim) bf16 cache now (and keeping it on the index). Build "
            "with cache_reconstructions=True or pick another scan_mode to "
            "avoid this.")
        _with_recon(index)
    with named_range("ivf_pq::search"), precision.highest():
        expects(queries.ndim == 2 and queries.shape[1] == index.dim,
                "ivf_pq.search: query dim mismatch")
        expects(0 < k, "ivf_pq.search: k must be positive")
        n_probes = min(params.n_probes, index.n_lists)
        kt = min(params.per_probe_topk or k, index.capacity)

        def coarse():
            qrot = queries.float() @ index.rotation
            return qrot, _select_clusters(index.centers, qrot, n_probes,
                                          index.metric)

        def lut_scan():
            with obs.stage("ivf_pq.search.lut") as st:
                out = _search_lut(index, *coarse(), k,
                                  _lut_dtype(params.lut_dtype), fw)
                st.fence(out)
            return out

        c_reason = ""
        if mode == "codes":
            if index.list_code_rsq is None:
                with obs.stage("ivf_pq.search.lut_build") as st:
                    _with_code_rsq(index)
                    st.fence(index.list_code_rsq)
            if want_fused:
                c_reason = pcs.codes_fused_reject_reason(
                    index.capacity, index.rot_dim, index.pq_dim,
                    index.pq_bits, k, kt)
            if (not want_fused or c_reason) and pcs.codes_reject_reason(
                    index.capacity, index.rot_dim, index.pq_dim,
                    index.pq_bits, kt):
                # Kernel C is not asked for or refuses, and both of Kernel
                # D's routes refuse the shape, as the Pallas gate does (D
                # takes every shape it admits): the lookup-table scan
                # computes the same quantized distance (the JAX package's
                # route past its codes kernel's gate)
                if want_fused:
                    _note_fused_fallback(c_reason)
                return lut_scan()
        if mode == "lut":
            return lut_scan()
        if mode == "recon8" and index.list_recon_i8 is None:
            with obs.stage("ivf_pq.search.lut_build") as st:
                _with_recon8(index)
                st.fence(index.list_recon_i8)

        with obs.stage("ivf_pq.search.coarse") as st:
            qrot, probes = coarse()
            st.fence(probes)
        if mode == "recon":
            scan, label, reason = _recon_scan(index, k, kt, want_fused)
            if reason:
                _note_fused_fallback(reason)
        elif mode == "recon8":
            scan, label = _search_recon8, "ivf_pq.search.recon8_scan"
        else:
            scan, label = _search_codes, "ivf_pq.search.code_scan"
            if want_fused:
                if c_reason:
                    _note_fused_fallback(c_reason)
                else:
                    scan, label = (_search_fused_codes,
                                   "ivf_pq.search.fused_scan")
        with obs.stage(label) as st:
            out = scan(index, qrot, probes, k, kt, fw)
            st.fence(out)
        return out


# fused searches a gate sent to the per-pair scan + finalize (Kernel B ->
# G, Kernel C -> D), and the gate's reason for the latest; under
# collection the registry counts them too (``ivf_pq.search.fused_fallback``
# and its reasons), as the JAX package does
search.fused_fallbacks = 0
search.last_fallback_reason = ""


# ---------------------------------------------------------------------------
# carrying an index across, serialization, storage
# ---------------------------------------------------------------------------

_LEAVES = ("centers", "codebooks", "list_codes", "list_indices",
           "list_sizes", "rotation", "list_recon", "list_recon_sq",
           "list_code_rsq", "list_recon_i8", "list_recon_scale",
           "list_recon_i8_sq")


def index_from_numpy(arrays: Mapping[str, np.ndarray], *, metric: int,
                     pq_bits: int, codebook_kind: int = CodebookKind.PER_SUBSPACE,
                     pq_dim: int = 0, group_est: float = 0.0,
                     device="cuda") -> Index:
    """Build the port's :class:`Index` from numpy arrays keyed by the JAX
    ``Index`` leaf names (``centers``, ``codebooks``, ``list_codes``,
    ``list_indices``, ``list_sizes``, ``rotation`` and, when present,
    ``list_recon`` / ``list_recon_sq`` and the derived scan caches
    ``list_code_rsq``, ``list_recon_i8`` / ``list_recon_scale`` /
    ``list_recon_i8_sq``), e.g. ``np.asarray`` of a ``raft_tpu``-built
    index's leaves.  The int8 rows may carry any zero padding that keeps
    them a multiple of 16 bytes (the JAX package pads them to 128).  bf16
    arrays (the ml_dtypes bfloat16 numpy dtype, which ``torch.from_numpy``
    rejects) go through float32 to ``torch.bfloat16``, which is exact.
    ``pq_dim`` and ``group_est`` are the index's scalars of those names
    (0: ``pq_dim`` from the shapes, uncalibrated)."""
    expects(codebook_kind in (CodebookKind.PER_SUBSPACE,
                              CodebookKind.PER_CLUSTER),
            f"index_from_numpy: unknown codebook_kind {codebook_kind}")
    missing = [n for n in _LEAVES[:6] if arrays.get(n) is None]
    expects(not missing, f"index_from_numpy: missing arrays {missing}")

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(_writable(a)).to(device)

    leaves = {n: tensor(arrays[n]) if arrays.get(n) is not None else None
              for n in _LEAVES}
    return Index(**leaves, metric=metric, codebook_kind=codebook_kind,
                 pq_bits=pq_bits, pq_dim_=pq_dim, group_est=group_est)


# ---------------------------------------------------------------------------
# mutation (reference: raft_tpu/neighbors/ivf_pq.py delete / upsert /
# compact; the encoding in neighbors/mutate)
# ---------------------------------------------------------------------------

def delete(res, index: Index, ids) -> Index:
    """Tombstone-delete rows by source id: every ``list_indices`` slot
    holding one of ``ids`` becomes ``-(id + 2)``; every scan masks negative
    ids, so the rows leave search results at once, and the codes and
    every derived cache stay as they are (shared with the parent).
    Storage comes back with :func:`compact`.  Ids not present match
    nothing.  Returns a new index, the next generation; its canaries are
    health-checked."""
    with named_range("ivf_pq::delete"):
        ids = ensure_tensor(ids, res, "ids")
        expects(ids.ndim == 1, "ivf_pq.delete: 1-D ids required")
        new_li, _ = _mutate.tombstone(index.list_indices, ids)
        out = Index(
            centers=index.centers, codebooks=index.codebooks,
            list_codes=index.list_codes, list_indices=new_li,
            list_sizes=index.list_sizes, rotation=index.rotation,
            metric=index.metric, codebook_kind=index.codebook_kind,
            pq_bits=index.pq_bits, pq_dim_=index.pq_dim,
            list_recon=index.list_recon, list_recon_sq=index.list_recon_sq,
            list_code_lanes=index.list_code_lanes,
            list_code_rsq=index.list_code_rsq,
            list_recon_i8=index.list_recon_i8,
            list_recon_scale=index.list_recon_scale,
            list_recon_i8_sq=index.list_recon_i8_sq, canaries=index.canaries)
        _mutate.next_generation(index, out)
        _canary.auto_check(res, out, site="delete")
    return out


def upsert(res, index: Index, ids, vectors) -> Index:
    """Replace-or-insert rows under explicit source ids: tombstone any
    rows with these ids, then encode and append ``vectors`` under them —
    one mutation, ONE generation bump.  Ids not present simply insert.
    Counted in ``ivf_pq.upserts``."""
    with named_range("ivf_pq::upsert"):
        ids = ensure_tensor(ids, res, "ids")
        vectors = ensure_tensor(vectors, res, "vectors")
        expects(ids.ndim == 1 and ids.shape[0] == vectors.shape[0],
                "ivf_pq.upsert: ids must be 1-D, one per vector")
        parent_gen = _mutate.generation(index)
        out = extend(res, delete(res, index, ids), vectors,
                     new_indices=ids)
        out.generation = parent_gen + 1
        if obs.enabled():
            obs.registry().counter("ivf_pq.upserts").inc()
    return out


def compact(res, index: Index) -> Index:
    """Reclaim tombstoned slots: each list's live rows stably to the
    front, every tombstone dropped, the shared capacity shrunk to fit the
    fullest list with one row of headroom (32-aligned, never above the
    parent's), and the derived caches the parent carried (recon, the code
    scans' row norms, int8) rebuilt from the moved codes; the seconds of
    each rebuild are in ``compact.cache_seconds``.  Returns a new
    generation sharing ``centers`` / ``codebooks`` / ``rotation``."""
    with named_range("ivf_pq::compact"), precision.highest():
        order, sizes = _mutate.compaction_order(index.list_indices)
        max_size = int(sizes.max()) if index.n_lists else 0
        capacity = _round_up(max(max_size + 1, _LIST_ALIGN), _LIST_ALIGN)
        capacity = min(capacity, max(index.capacity, _LIST_ALIGN))
        order = order[:, :capacity]
        live = (torch.arange(capacity, device=order.device)[None, :]
                < sizes[:, None])
        li = torch.where(live, torch.gather(index.list_indices, 1, order),
                         torch.full_like(order, -1, dtype=torch.int32))
        codes = torch.gather(
            index.list_codes, 1,
            order[:, :, None].expand(-1, -1, index.code_width))
        codes = torch.where(live[:, :, None], codes, torch.zeros_like(codes))
        out = Index(
            centers=index.centers, codebooks=index.codebooks,
            list_codes=codes, list_indices=li, list_sizes=sizes,
            rotation=index.rotation, metric=index.metric,
            codebook_kind=index.codebook_kind, pq_bits=index.pq_bits,
            pq_dim_=index.pq_dim, canaries=index.canaries)
        compact.cache_seconds = {}
        dev = codes.device
        t0 = _stage(None, None, time.perf_counter(), dev)
        for name, carried, attach in (
                ("recon", index.list_recon, _with_recon),
                ("code_rsq", index.list_code_rsq, _with_code_rsq),
                ("recon8", index.list_recon_i8, _with_recon8)):
            if carried is not None:
                attach(out)
                t0 = _stage(compact.cache_seconds, name, t0, dev)
    _mutate.next_generation(index, out)
    _canary.auto_check(res, out, site="compact")
    return out


# seconds of each derived cache the latest compact rebuilt, device work
# included
compact.cache_seconds = {}


def calibrate_group_capacity(res, index: Index, queries,
                             n_probes: int) -> float:
    """Measure the touched-list fraction of a representative batch and
    store it as ``index.group_est`` (the JAX package's
    ``calibrate_group_capacity``): touched lists / min(n_lists, P) under
    the index's own coarse ranking, P = nq · n_probes; repeated calls
    ratchet it up (max); it is serialized (v4).  Returns the stored
    estimate.

    It does not change the port's dispatch: the list-major kernels size
    their grids from each batch's exact group count
    (``neighbors/grouped.build_groups``), where the JAX package needs a
    static capacity.  The value is kept, carried and written so that
    files round-trip between the packages and a port-calibrated index
    loads calibrated in ``raft_tpu``."""
    from raft_tpu_torch.neighbors import grouped
    queries = ensure_tensor(queries, res, "queries")
    expects(queries.ndim == 2 and queries.shape[1] == index.dim,
            "ivf_pq.calibrate_group_capacity: queries must be "
            f"(n, {index.dim})")
    n_probes = min(int(n_probes), index.n_lists)
    expects(n_probes >= 1,
            "ivf_pq.calibrate_group_capacity: n_probes must be >= 1")
    with precision.highest():
        qrot = queries.float() @ index.rotation
        probes = _select_clusters(index.centers, qrot, n_probes,
                                  index.metric)
    P = int(queries.shape[0]) * n_probes
    touched = int(grouped.touched_lists(probes, index.n_lists))
    est = touched / max(min(index.n_lists, P), 1)
    index.group_est = max(float(index.group_est), est)
    return index.group_est


# v2: list_codes are bit-packed; pq_dim is stored explicitly
# v3: trailing recall-canary block (nested envelope, may be absent)
# v4: calibrated group-capacity estimate (group_est float64 scalar)
#     between the fixed header and the mdspans
_SERIALIZATION_VERSION = 4
_MIN_READ_VERSION = 2


def serialize(res, stream: BinaryIO, index: Index) -> None:
    """CRC32-enveloped versioned dump (reference: ivf_pq_serialize.cuh),
    byte-equal to the JAX package's.  The caches are not written."""
    with ser.enveloped_writer(stream) as body:
        ser.serialize_scalar(res, body, np.int32(_SERIALIZATION_VERSION))
        ser.serialize_scalar(res, body, np.int32(index.metric))
        ser.serialize_scalar(res, body, np.int32(index.codebook_kind))
        ser.serialize_scalar(res, body, np.int32(index.pq_bits))
        ser.serialize_scalar(res, body, np.int32(index.pq_dim))
        ser.serialize_scalar(res, body, np.float64(index.group_est))
        for arr in (index.centers, index.codebooks, index.list_codes,
                    index.list_indices, index.list_sizes, index.rotation):
            ser.serialize_mdspan(res, body, arr)
        _canary.to_stream(res, body, index.canaries)


def deserialize(res, stream: BinaryIO, *,
                cache_reconstructions: bool = True) -> Index:
    """Read a stream either package wrote, onto ``res.device``; truncated
    or bit-flipped streams raise :class:`~raft_tpu_torch.core.serialize.
    CorruptIndexError`.  ``cache_reconstructions`` decodes the recon cache
    again (:func:`_with_recon`).  Per-subspace and per-cluster codebooks
    both load."""
    body = ser.open_envelope(stream)
    version = int(ser.deserialize_scalar(res, body))
    if not _MIN_READ_VERSION <= version <= _SERIALIZATION_VERSION:
        raise ValueError(
            f"ivf_pq serialization version mismatch: got {version}, "
            f"expected {_MIN_READ_VERSION}..{_SERIALIZATION_VERSION}")
    metric = int(ser.deserialize_scalar(res, body))
    kind = int(ser.deserialize_scalar(res, body))
    pq_bits = int(ser.deserialize_scalar(res, body))
    pq_dim = int(ser.deserialize_scalar(res, body))
    # pre-v4 streams carry no capacity estimate: the index loads
    # uncalibrated
    group_est = (float(ser.deserialize_scalar(res, body))
                 if version >= 4 else 0.0)
    arrays = {name: ser.deserialize_mdspan(res, body)
              for name in _LEAVES[:6]}
    index = index_from_numpy(arrays, metric=metric, pq_bits=pq_bits,
                             codebook_kind=kind, pq_dim=pq_dim,
                             group_est=group_est, device=res.device)
    if version >= 3:
        index.canaries = _canary.from_stream(res, body)
    if cache_reconstructions:
        index = _with_recon(index)
    return index


def save(res, filename: str, index: Index, *, retry_policy=None,
         deadline=None) -> None:
    """Atomic file dump (tmp + fsync + rename) with transient-IO retry."""
    from raft_tpu_torch.resilience import save_index
    save_index("ivf_pq.save", lambda b: serialize(res, b, index),
               filename, retry_policy, deadline)


def load(res, filename: str, *, cache_reconstructions: bool = True,
         retry_policy=None, deadline=None) -> Index:
    """File-load overload: transient IO errors retry, corruption raises
    :class:`~raft_tpu_torch.core.serialize.CorruptIndexError` at once; an
    index carrying recall canaries is health-checked before it is
    returned."""
    from raft_tpu_torch.resilience import load_index
    index = load_index(
        "ivf_pq.load",
        lambda b: deserialize(
            res, b, cache_reconstructions=cache_reconstructions),
        filename, retry_policy, deadline)
    _canary.auto_check(res, index, site="load")
    return index

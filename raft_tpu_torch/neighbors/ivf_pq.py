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
are Kernel A, two-level from 8192 lists); per-subspace codebooks train
with the same loop in plain PyTorch; every row is encoded, bit-packed and
packed into padded lists; with ``cache_reconstructions`` the bf16
reconstruction cache (``list_recon``, residual space) and its row norms
are attached.

Search: rotate the queries, rank coarse probes exactly
(:func:`raft_tpu_torch.neighbors.ivf_flat._select_clusters`), then ONE
kernel launch chosen by ``scan_mode`` as the JAX package resolves it
(:func:`_resolve_mode`):

- fused recon (``"auto"`` / ``"fused"`` with a recon cache and codes not
  eligible): Kernel B, :mod:`raft_tpu_torch.ops.pq_group_scan` (Kernel G
  + finalize where Kernel B's gate refuses the shape);
- fused codes (``"fused"``, and ``"auto"`` without a recon cache): Kernel
  C, :func:`raft_tpu_torch.ops.pq_code_scan.ivf_pq_scan_codes_fused`;
- ``"recon"`` / ``use_reconstruction=True``: Kernel G
  (:func:`raft_tpu_torch.ops.pair_scan.ivf_pq_scan_recon`), each (query,
  probe) pair's top kt, then each query's top k (:func:`_finalize_topk`);
- ``"codes"``: Kernel D, each pair's top kt, then the same finalize;
- ``"recon8"``: Kernel E over the int8 cache, then the same finalize.

The code and int8 caches are derived lazily by the first search that
needs them (the recon cache too, with a warning, for ``"recon"`` on an
index built without it); sqrt metrics get their sqrt afterwards.

Not ported yet — each raises ``NotImplementedError`` naming its ROADMAP.md
item: every search that resolves to the LUT scan (pq_bits outside {4, 8}
without a recon cache, per-pair code scans at kt > 128), recon8 scans at
kt > 128, InnerProduct search, ``filter=``, ``canary_queries > 0``,
``CodebookKind.PER_CLUSTER``, checkpoint / resume, ``serialize`` /
``load``.  The port has no boundary validator yet: inputs are checked for
shape, not for finiteness.

Random draws (the trainset subsample, the k-means re-seeds) come from the
handle's ``torch.Generator``, so a port-built index differs from a
JAX-built one draw for draw; :func:`index_from_numpy` carries a JAX-built
index across for like-for-like search comparisons.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import _writable, ensure_tensor
from raft_tpu_torch.distance.types import DistanceType, L2_METRICS
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors.ivf_flat import (_LIST_ALIGN,
                                               _append_lists_multi,
                                               _finalize_topk, _pack_lists,
                                               _round_up, _select_clusters,
                                               _sqrt_epilogue, _stage)
from raft_tpu_torch.ops import pq_code_scan as pcs
from raft_tpu_torch.ops.pair_scan import ivf_pq_scan_recon
from raft_tpu_torch.ops.pq_code_scan import code_field as _code_field
from raft_tpu_torch.ops.pq_group_scan import (ivf_pq_scan_fused,
                                              scan_reject_reason)
from raft_tpu_torch.utils import precision

def _not_ported(what: str, item: str):
    return not_ported("ivf_pq", what, item)


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
    ``exact_coarse`` from :class:`ivf_flat.SearchParams`).  On the ported
    paths: ``n_probes``, ``scan_mode`` ("auto", "fused", "codes", "recon",
    "recon8"; every resolution to the LUT scan raises),
    ``use_reconstruction`` (the old override: True -> "recon", False ->
    "lut") and ``per_probe_topk`` (each (query, probe) pair's kt; 0 -> k).
    ``coarse_recall_target`` and ``exact_coarse`` have no effect: the
    coarse ranking is always exact here.  ``merge_window`` and
    ``packed_extract`` size TPU-only mechanisms and are accepted and
    ignored — the port's selection never truncates mantissa bits as the
    TPU's packed extraction does; ``lut_dtype`` /
    ``internal_distance_dtype`` belong to the LUT mode, not ported yet."""

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

    ``codebooks``: (pq_dim, book, pq_len) f32; ``list_codes``: (n_lists,
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
# rows per chunk of the (chunk, pq_dim, book) encode distances
_ENCODE_CHUNK = 8192
# rows per chunk of extend's rotate -> assign -> encode pipeline
_EXTEND_CHUNK = 1 << 20


def _train_books_per_subspace(resid_sub: torch.Tensor,
                              generator: torch.Generator, book_size: int,
                              n_iters: int) -> torch.Tensor:
    """Balanced k-means per subspace, one after another (reference:
    train_per_subset, ivf_pq_build.cuh:337): (pq_dim, n, pq_len) ->
    codebooks (pq_dim, book, pq_len).  Rows are subsampled to
    _BOOK_TRAIN_ROWS by stride (the trainset is already shuffled)."""
    n = resid_sub.shape[1]
    if n > _BOOK_TRAIN_ROWS:
        stride = n // _BOOK_TRAIN_ROWS
        resid_sub = resid_sub[:, ::stride][:, :_BOOK_TRAIN_ROWS]
    books = []
    for sub in resid_sub:
        stride = max(sub.shape[0] // book_size, 1)
        c0 = sub[::stride][:book_size]
        if c0.shape[0] < book_size:
            c0 = torch.cat([c0, c0[-1:].expand(book_size - c0.shape[0],
                                                -1)])
        centers, _ = kmeans_balanced._balanced_loop(
            sub, c0, generator, book_size, n_iters,
            DistanceType.L2Expanded)
        books.append(centers)
    return torch.stack(books)


def _encode(codebooks: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    """PQ-encode residuals (n, pq_dim, pq_len) -> (n, pq_dim) uint8: the
    per-subspace argmin over the codebook (reference:
    process_and_fill_codes_kernel, ivf_pq_build.cuh:944), chunked."""
    n, pq_dim, _ = resid.shape
    cb_sq = (codebooks * codebooks).sum(-1)                 # (pq_dim, book)
    out = torch.empty(n, pq_dim, dtype=torch.uint8, device=resid.device)
    for s in range(0, n, _ENCODE_CHUNK):
        ip = torch.einsum("njl,jkl->njk", resid[s:s + _ENCODE_CHUNK],
                          codebooks)
        d = cb_sq[None, :, :] - 2.0 * ip
        out[s:s + ip.shape[0]] = torch.argmin(d, dim=-1).to(torch.uint8)
    return out


def build(res, params: IndexParams, dataset, *, checkpoint=None,
          resume: bool = False) -> Index:
    """Build an IVF-PQ index (reference: ivf_pq.cuh:224).  The wall
    seconds of its stages (trainset, coarse_fit, codebooks,
    encode_and_pack, recon_cache) land in ``build.stage_seconds``."""
    if checkpoint is not None or resume:
        raise _not_ported("build checkpoint / resume",
                          "checkpointing")
    if params.codebook_kind != CodebookKind.PER_SUBSPACE:
        raise _not_ported("CodebookKind.PER_CLUSTER", "per-cluster books")
    if params.canary_queries > 0:
        raise _not_ported("canary_queries > 0", "canaries")
    with precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        expects(dataset.ndim == 2 and dataset.shape[0] > 0,
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
        centers = kmeans_balanced.fit(res, bal, train_rot, params.n_lists)
        t = _stage(stages, "coarse_fit", t, dev)

        # per-subspace codebooks over the trainset's residuals
        labels_t = kmeans_balanced.predict(res, bal, train_rot, centers)
        resid = _subspace_split(train_rot - centers[labels_t], pq_dim)
        codebooks = _train_books_per_subspace(
            resid.transpose(0, 1), res.generator, 1 << params.pq_bits,
            params.kmeans_n_iters)
        del train_rot, resid, labels_t
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
            index = _with_recon(index)
        _stage(stages, "recon_cache", t, dev)
        return index


# wall seconds of the latest build's stages, device work included (each
# stage ends with a device synchronisation)
build.stage_seconds = {}


def extend(res, index: Index, new_vectors, new_indices=None) -> Index:
    """Encode + add vectors (reference: ivf_pq.cuh:266).  Returns a new
    index, the next generation.  Lists with headroom for every new row take
    a scatter-append (recon cache rows appended alongside); otherwise all
    rows are repacked at a capacity that leaves the fullest list room for
    one more, and the recon cache is rebuilt if the index had one."""
    with precision.highest():
        new_vectors = ensure_tensor(new_vectors, res, "new_vectors")
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
        codes_parts, label_parts, recon_parts = [], [], []
        for s0 in range(0, n_new, _EXTEND_CHUNK):
            rot_c = new_vectors[s0:s0 + _EXTEND_CHUNK].float() @ index.rotation
            lab_c = kmeans_balanced.predict(res, bal, rot_c, index.centers)
            cu = _encode(index.codebooks,
                         _subspace_split(rot_c - index.centers[lab_c],
                                         index.pq_dim))
            if want_recon_rows:
                recon_parts.append(_decode_rows(index.codebooks, cu))
            codes_parts.append(_pack_codes(cu, index.pq_bits))
            label_parts.append(lab_c)
        codes = torch.cat(codes_parts)
        labels = torch.cat(label_parts)

        needed = index.list_sizes + torch.bincount(
            labels, minlength=index.n_lists).int()
        max_needed = int(needed.max())
        common = dict(centers=index.centers, codebooks=index.codebooks,
                      rotation=index.rotation, metric=index.metric,
                      codebook_kind=index.codebook_kind,
                      pq_bits=index.pq_bits, pq_dim_=index.pq_dim,
                      generation=index.generation + 1)
        if max_needed <= index.capacity:
            bufs, rows = [index.list_codes], [codes]
            if want_recon_rows:
                recon_rows = torch.cat(recon_parts)
                bufs += [index.list_recon, _recon_sq(index.list_recon)
                         if index.list_recon_sq is None
                         else index.list_recon_sq]
                rows += [recon_rows, (recon_rows.float() ** 2).sum(-1)]
            new_bufs, list_idx, sizes = _append_lists_multi(
                bufs, rows, index.list_indices, index.list_sizes, labels,
                new_indices)
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
        list_codes, list_idx, sizes = _pack_lists(
            all_codes, all_labels, all_ids, index.n_lists, capacity)
        out = Index(list_codes=list_codes, list_indices=list_idx,
                    list_sizes=sizes, **common)
        if want_recon_rows:
            out = _with_recon(out)
        return out


# ---------------------------------------------------------------------------
# reconstruction cache
# ---------------------------------------------------------------------------

def _decode_lists(codebooks: torch.Tensor, list_codes: torch.Tensor,
                  pq_dim: int, pq_bits: int) -> torch.Tensor:
    """Every list's codes decoded to bf16 RESIDUAL reconstructions
    (n_lists, capacity, rot_dim) = concat_j codebook_j[code_j], one
    subspace at a time.  Padded slots decode code 0 to a real-looking row;
    only their id (-1) masks them."""
    expects(codebooks.shape[0] == pq_dim, "_decode_lists: pq_dim mismatch")
    return pcs.decode_codes(list_codes, codebooks, pq_bits)


def _decode_rows(codebooks: torch.Tensor, codes: torch.Tensor
                 ) -> torch.Tensor:
    """(n, pq_dim) codes -> (n, rot_dim) bf16 residual reconstructions."""
    n, pq_dim = codes.shape
    j = torch.arange(pq_dim, device=codes.device)[None, :]
    return codebooks[j, codes.long()].reshape(n, -1).to(torch.bfloat16)


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
                                     index.pq_dim, index.pq_bits)
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


def _quantize_recon(list_recon: torch.Tensor, rot_pad: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 recon lists -> (int8 rows zero-padded to ``rot_pad``, per-list
    f32 scale, dequantized row norms).  One symmetric scale per list,
    ``max|recon| / 127`` (1.0 for an all-zero list); ``round`` half to
    even, clipped to ±127; ``rsq8 = scale² · Σ q²`` in fp32."""
    r = list_recon.float()
    rot = r.shape[2]
    maxabs = r.abs().amax(dim=(1, 2))
    scale = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
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
    parts = []
    for s in range(0, index.n_lists, _QUANT_LISTS):
        recon = (index.list_recon[s:s + _QUANT_LISTS]
                 if index.list_recon is not None else
                 _decode_lists(index.codebooks,
                               index.list_codes[s:s + _QUANT_LISTS],
                               index.pq_dim, index.pq_bits))
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


def _search_fused_recon(index, qrot, probes, k, kt):
    """Kernel B over the bf16 recon cache, each query's top k in kernel;
    where Kernel B's gate refuses the shape, Kernel G + finalize, counted
    in ``search.fused_fallbacks`` with the gate's reason (the JAX
    package's fused_fallback)."""
    reason = scan_reject_reason(index.capacity, index.rot_dim, k, kt)
    if reason:
        search.fused_fallbacks += 1
        search.last_fallback_reason = reason
        return _search_recon(index, qrot, probes, k, kt)
    if index.list_recon_sq is None:
        index.list_recon_sq = _recon_sq(index.list_recon)
    vals, ids = ivf_pq_scan_fused(
        qrot, index.centers.float(), probes, index.list_recon,
        index.list_recon_sq, index.list_indices, k, kt)
    return _sqrt_epilogue(vals, index.metric), ids


def _search_recon(index, qrot, probes, k, kt):
    """Kernel G over the bf16 recon cache, then each query's top k."""
    if index.list_recon_sq is None:
        index.list_recon_sq = _recon_sq(index.list_recon)
    vals, ids = ivf_pq_scan_recon(
        qrot, index.centers.float(), probes, index.list_recon,
        index.list_recon_sq, index.list_indices, kt)
    return _finalize_topk(vals, ids, k, index.metric)


def _search_fused_codes(index, qrot, probes, k, kt):
    """Kernel C over the packed codes, each query's top k in kernel."""
    vals, ids = pcs.ivf_pq_scan_codes_fused(
        qrot, index.centers.float(), probes, index.list_codes,
        index.codebooks, index.list_code_rsq, index.list_indices,
        index.pq_bits, k, kt)
    return _sqrt_epilogue(vals, index.metric), ids


def _search_codes(index, qrot, probes, k, kt):
    """Kernel D over the packed codes, then each query's top k."""
    reason = pcs.codes_reject_reason(index.capacity, index.rot_dim,
                                     index.pq_dim, index.pq_bits, kt)
    if reason:
        raise _not_ported(f"the codes scan at this shape ({reason}), "
                          "which needs the LUT scan", "LUT scan")
    vals, ids = pcs.ivf_pq_scan_codes(
        qrot, index.centers.float(), probes, index.list_codes,
        index.codebooks, index.list_code_rsq, index.list_indices,
        index.pq_bits, kt)
    return _finalize_topk(vals, ids, k, index.metric)


def _search_recon8(index, qrot, probes, k, kt):
    """Kernel E over the int8 recon cache, then each query's top k."""
    if index.list_recon_i8 is None:
        _with_recon8(index)
    reason = pcs.recon8_reject_reason(index.capacity,
                                      index.list_recon_i8.shape[2], kt)
    if reason:
        raise _not_ported(f"the recon8 scan at this shape ({reason})",
                          "wide recon8 scans")
    vals, ids = pcs.ivf_pq_scan_recon8(
        qrot, index.centers.float(), probes, index.list_recon_i8,
        index.list_recon_scale, index.list_recon_i8_sq, index.list_indices,
        kt)
    return _finalize_topk(vals, ids, k, index.metric)


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
    without one); codes -> Kernel D; recon8 -> Kernel E.

    .. note:: like the JAX package's, the first search of an index may
       attach derived caches in place (``list_recon_sq``,
       ``list_code_rsq``, the int8 cache); ``extend`` returns an index
       without them, so they never go stale."""
    if filter is not None:
        raise _not_ported("filtered search (filter=)", "filters")
    mode, want_fused = _resolve_mode(params, index)
    if index.metric == DistanceType.InnerProduct:
        raise _not_ported("InnerProduct search", "InnerProduct search")
    expects(index.metric in L2_METRICS,
            f"ivf_pq.search: metric {index.metric} not supported")
    if mode == "lut" or (mode == "codes" and not _codes_mode_eligible(index)):
        raise _not_ported(
            f"a search resolving to the LUT scan (scan_mode="
            f"{params.scan_mode!r}, use_reconstruction="
            f"{params.use_reconstruction}, pq_bits {index.pq_bits})",
            "LUT scan")
    if mode == "recon" and index.list_recon is None:
        # scan_mode="recon" / use_reconstruction=True without a cache
        warnings.warn(
            "ivf_pq.search: scan_mode='recon' on an index built without a "
            "reconstruction cache — materializing the (n_lists, cap, "
            "rot_dim) bf16 cache now (and keeping it on the index). Build "
            "with cache_reconstructions=True or pick another scan_mode to "
            "avoid this.")
        _with_recon(index)
    with precision.highest():
        queries = ensure_tensor(queries, res, "queries")
        expects(queries.ndim == 2 and queries.shape[1] == index.dim,
                "ivf_pq.search: query dim mismatch")
        expects(0 < k, "ivf_pq.search: k must be positive")
        n_probes = min(params.n_probes, index.n_lists)
        kt = min(params.per_probe_topk or k, index.capacity)
        qrot = queries.float() @ index.rotation
        probes = _select_clusters(index.centers, qrot, n_probes,
                                  index.metric)
        if mode == "recon":
            return (_search_fused_recon if want_fused else _search_recon)(
                index, qrot, probes, k, kt)
        if mode == "recon8":
            return _search_recon8(index, qrot, probes, k, kt)
        if index.list_code_rsq is None:
            _with_code_rsq(index)
        if want_fused:
            reason = pcs.codes_fused_reject_reason(
                index.capacity, index.rot_dim, index.pq_dim, index.pq_bits,
                k, kt)
            if not reason:
                return _search_fused_codes(index, qrot, probes, k, kt)
            search.fused_fallbacks += 1
            search.last_fallback_reason = reason
        return _search_codes(index, qrot, probes, k, kt)


# fused searches a gate sent to the per-pair scan + finalize (Kernel B ->
# G, Kernel C -> D), and the gate's reason for the latest (the JAX
# package's fused_fallback counter, until the port has an observability
# module)
search.fused_fallbacks = 0
search.last_fallback_reason = ""


# ---------------------------------------------------------------------------
# carrying an index across, storage
# ---------------------------------------------------------------------------

_LEAVES = ("centers", "codebooks", "list_codes", "list_indices",
           "list_sizes", "rotation", "list_recon", "list_recon_sq",
           "list_code_rsq", "list_recon_i8", "list_recon_scale",
           "list_recon_i8_sq")


def index_from_numpy(arrays: Mapping[str, np.ndarray], *, metric: int,
                     pq_bits: int, codebook_kind: int = CodebookKind.PER_SUBSPACE,
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
    rejects) go through float32 to ``torch.bfloat16``, which is exact."""
    if codebook_kind != CodebookKind.PER_SUBSPACE:
        raise _not_ported("CodebookKind.PER_CLUSTER", "per-cluster books")
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
                 pq_bits=pq_bits)


def serialize(res, stream, index: Index) -> None:
    raise _not_ported("serialize", "serialization")


def deserialize(res, stream, **kwargs) -> Index:
    raise _not_ported("deserialize", "serialization")


def save(res, filename: str, index: Index, **kwargs) -> None:
    raise _not_ported("save", "serialization")


def load(res, filename: str, **kwargs) -> Index:
    raise _not_ported("load", "serialization")

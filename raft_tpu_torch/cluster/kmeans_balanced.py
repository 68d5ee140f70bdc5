"""Balanced k-means — the IVF coarse quantizer (port of
``raft_tpu.cluster.kmeans_balanced``).

Reference: raft/cluster/kmeans_balanced.cuh:75 ``fit``, :133 ``predict``,
:336 ``calc_centers_and_sizes``.  The goal is roughly balanced cluster
sizes, since clusters become IVF lists: a Lloyd loop whose balancing step
re-seeds every cluster smaller than ``avg / 8`` at a row drawn with
probability proportional to its distance to its centroid (inverse-CDF over
a cumulative sum, as ``raft_tpu/cluster/kmeans_balanced.py:113-127``).

For L2Expanded with dim >= 32 — exactly where the JAX package's
``_fused_ok`` routes to its Pallas pass on a TPU — each iteration is one
call of Kernel A (:func:`raft_tpu_torch.ops.kmeans_update.kmeans_assign_update`:
bf16 assignment, weighted sums and counts, per-row min distance).  Other
cases (the dim-2 codebook subspaces, InnerProduct) assign with
:func:`_assign` — Kernel H (``fused_l2_nn``) for L2, as the JAX package's
``_assign`` calls ``fused_l2_nn``, and a plain product for InnerProduct —
and update in plain PyTorch; ``predict`` is :func:`_assign` too.  From
``_MESO_THRESHOLD`` (8192) clusters ``fit`` takes the two-level
mesocluster build (:func:`_fit_hierarchical`,
reference: detail/kmeans_balanced.cuh build_hierarchical): ~sqrt(K)
mesoclusters, fine clusters per mesocluster on fixed-size member samples
(one Python loop over the mesoclusters, where the JAX package ``vmap``s
them), then a short full-K refinement.  Its Lloyd passes at dim >= 32 are
Kernel A too.

Random draws come from the handle's ``torch.Generator``, so a fit is
reproducible from its seed but draws differently from the JAX package's
threefry keys.  ``fit`` and ``predict`` pass their rows through the
boundary validator (:mod:`raft_tpu_torch.integrity.boundary`) at the JAX
package's sites; ``build_clusters`` is not ported yet (ROADMAP.md §1
item 5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.ops.kmeans_update import kmeans_assign_update
from raft_tpu_torch.utils import precision

# clusters smaller than avg_size / _BALANCE_RATIO are re-seeded each round
_BALANCE_RATIO = 8.0
# from this cluster count the JAX package switches to its two-level build
_MESO_THRESHOLD = 8192
# rows per chunk of the InnerProduct (chunk, k) product block
_ASSIGN_CHUNK = 16384


def _assign(X: torch.Tensor, centroids: torch.Tensor, metric: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels int64, distances f32): L2 through ``distance.fused_l2_nn``
    (Kernel H on the card: the min squared distance and the first argmin),
    as the JAX ``_assign`` calls ``fused_l2_nn``; InnerProduct an argmax
    with the negated product, fp32 products, chunked over rows."""
    if metric != DistanceType.InnerProduct:
        d, lab = raw(fused_l2_nn)(X, centroids)
        return lab.long(), d
    cf = centroids.float()
    labels = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    dists = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
    for s in range(0, X.shape[0], _ASSIGN_CHUNK):
        best, lab = torch.max(X[s:s + _ASSIGN_CHUNK].float() @ cf.T, dim=1)
        labels[s:s + lab.shape[0]] = lab
        dists[s:s + lab.shape[0]] = -best
    return labels, dists


def calc_centers_and_sizes(X: torch.Tensor, labels: torch.Tensor,
                           n_clusters: int, *,
                           old_centroids: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster mean + population (reference:
    kmeans_balanced.cuh:336); empty clusters keep ``old_centroids``."""
    xf = X.float()
    sums = torch.zeros(n_clusters, xf.shape[1], dtype=torch.float32,
                       device=X.device)
    sums.index_add_(0, labels, xf)
    sizes = torch.bincount(labels, minlength=n_clusters).float()
    centers = sums / torch.clamp_min(sizes, 1.0)[:, None]
    if old_centroids is not None:
        centers = torch.where((sizes > 0)[:, None], centers,
                              old_centroids.float())
    return centers, sizes.int()


def _balanced_loop(X: torch.Tensor, centroids0: torch.Tensor,
                   generator: torch.Generator, n_clusters: int,
                   n_iters: int, metric: int, use_fused: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations with balancing; returns (centroids, labels).

    ``use_fused``: each iteration's assignment, per-cluster sums and
    per-row min distance come from one Kernel A call (bf16 products)."""
    xf = X.float()
    n = xf.shape[0]
    if use_fused:
        xb = xf.to(torch.bfloat16)           # rounded once, loop-invariant
        ones = torch.ones(n, dtype=torch.float32, device=X.device)
        x_sq = (xf * xf).sum(1)
    centroids = centroids0.float()
    for _ in range(n_iters):
        if use_fused:
            sums, counts, dmin = kmeans_assign_update(xb, ones, centroids)
            centers = sums / torch.clamp_min(counts, 1.0)[:, None]
            centers = torch.where((counts > 0)[:, None], centers, centroids)
            sizes = counts
            dists = torch.clamp_min(x_sq + dmin, 0.0)
        else:
            labels, dists = _assign(xf, centroids, metric)
            centers, sizes = calc_centers_and_sizes(
                xf, labels, n_clusters, old_centroids=centroids)
        # balancing: re-seed under-populated clusters at rows drawn
        # proportional to their assignment distance (inverse CDF)
        small = sizes.float() < (n / n_clusters) / _BALANCE_RATIO
        w = torch.clamp_min(dists - dists.min(), 0.0) + 1e-6
        cdf = torch.cumsum(w, 0)
        u = torch.rand(n_clusters, generator=generator,
                       device=X.device) * cdf[-1]
        cand = torch.clamp(torch.searchsorted(cdf, u), 0, n - 1)
        centers = torch.where(small[:, None], xf[cand], centers)
        if metric == DistanceType.InnerProduct:
            centers = centers / torch.clamp_min(
                torch.linalg.norm(centers, dim=1, keepdim=True), 1e-12)
        centroids = centers
    labels, _ = _assign(xf, centroids, metric)
    return centroids, labels


def _fused_ok(dim: int, metric: int) -> bool:
    """Kernel A serves the loop where the JAX package's Pallas pass would
    on a TPU: L2Expanded, dim >= 32 (its VMEM conditions do not apply)."""
    return metric == DistanceType.L2Expanded and dim >= 32


def _meso_partition_sample(meso_labels: torch.Tensor,
                           generator: torch.Generator, n_meso: int,
                           per: int) -> torch.Tensor:
    """(n_meso, per) row indices: ``per`` members of each mesocluster
    without an (n_meso, n) membership matrix — one sort groups rows into
    contiguous label segments, each mesocluster takes ``per`` rows of its
    segment from a random offset, cycling when it has fewer members."""
    n = meso_labels.shape[0]
    dev = meso_labels.device
    sorted_lab, order = torch.sort(meso_labels, stable=True)
    seg = torch.arange(n_meso, dtype=sorted_lab.dtype, device=dev)
    starts = torch.searchsorted(sorted_lab, seg)
    ends = torch.searchsorted(sorted_lab, seg, right=True)
    counts = torch.clamp_min(ends - starts, 1)
    off = torch.randint(0, n, (n_meso,), generator=generator, device=dev)
    j = (torch.arange(per, device=dev)[None, :] + off[:, None]) % counts[
        :, None]
    return order[torch.clamp(starts[:, None] + j, 0, n - 1)]


def _strided_init(X: torch.Tensor, k: int) -> torch.Tensor:
    """k evenly strided rows of X, the last repeated if X is short."""
    c0 = X[::max(X.shape[0] // k, 1)][:k].float()
    if c0.shape[0] < k:
        c0 = torch.cat([c0, c0[-1:].expand(k - c0.shape[0], -1)])
    return c0


def _fit_hierarchical(X: torch.Tensor, n_clusters: int,
                      generator: torch.Generator, n_iters: int,
                      metric: int) -> torch.Tensor:
    """Two-level balanced build (``raft_tpu/cluster/kmeans_balanced.py``
    ``_fit_hierarchical``): ~sqrt(K) mesoclusters over all rows; per
    mesocluster, k_max fine clusters trained on ``per`` sampled members,
    of which it keeps its quota; then max(2, n_iters // 5) full-K
    iterations from the stacked fine centers.  Per-iteration assignment
    falls from O(n·K) to O(n·sqrt(K)) + O(per·K)."""
    xf = X.float()
    n, dim = xf.shape
    fused = _fused_ok(dim, metric)
    n_meso = max(2, min(int(round(float(n_clusters) ** 0.5)),
                        n_clusters // 2))
    k_base, rem = divmod(n_clusters, n_meso)
    k_max = k_base + (1 if rem else 0)

    _, meso_labels = _balanced_loop(xf, _strided_init(xf, n_meso),
                                    generator, n_meso, n_iters, metric,
                                    use_fused=fused)
    per = min(n, max(2048, 32 * k_max))
    idx = _meso_partition_sample(meso_labels, generator, n_meso, per)
    fine = []
    for m in range(n_meso):
        sub = xf[idx[m]]
        centers, _ = _balanced_loop(sub, _strided_init(sub, k_max),
                                    generator, k_max, n_iters, metric,
                                    use_fused=fused)
        fine.append(centers[:k_base + (1 if m < rem else 0)])
    return _balanced_loop(xf, torch.cat(fine), generator, n_clusters,
                          max(2, n_iters // 5), metric, use_fused=fused)[0]


def fit(res, params: KMeansBalancedParams, X, n_clusters: int, *,
        hierarchical: Optional[bool] = None) -> torch.Tensor:
    """Train balanced centroids; returns (n_clusters, dim) float32
    (reference: cluster/kmeans_balanced.cuh:75)."""
    with precision.highest():
        X = ensure_tensor(X, res, "X")
        X, _ = boundary.check_matrix(X, "X", site="kmeans_balanced.fit",
                                     allow_empty=False)
        expects(X.ndim == 2 and X.shape[0] > 0,
                "kmeans_balanced.fit: non-empty 2-D X required")
        n, dim = X.shape
        expects(n_clusters <= n,
                "kmeans_balanced.fit: n_clusters > n_samples")
        expects(params.metric in (DistanceType.L2Expanded,
                                  DistanceType.InnerProduct),
                "kmeans_balanced supports L2Expanded / InnerProduct only "
                "(as the reference does)")
        if hierarchical is None:
            hierarchical = n_clusters >= _MESO_THRESHOLD
        if hierarchical and n_clusters >= 4:
            return _fit_hierarchical(X, n_clusters, res.generator,
                                     params.n_iters, params.metric)
        # evenly-strided init over the (caller-shuffled) trainset
        c0 = _strided_init(X, n_clusters)
        if params.metric == DistanceType.InnerProduct:
            c0 = c0 / torch.clamp_min(
                torch.linalg.norm(c0, dim=1, keepdim=True), 1e-12)
        centroids, _ = _balanced_loop(
            X, c0, res.generator, n_clusters, params.n_iters, params.metric,
            use_fused=_fused_ok(dim, params.metric))
        return centroids


def predict(res, params: KMeansBalancedParams, X, centroids
            ) -> torch.Tensor:
    """Nearest-centroid labels, int64 (reference:
    kmeans_balanced.cuh:133)."""
    with precision.highest():
        X = ensure_tensor(X, res, "X")
        X, _ = boundary.check_matrix(X, "X", site="kmeans_balanced.predict")
        centroids = ensure_tensor(centroids, res, "centroids")
        labels, _ = _assign(X, centroids, params.metric)
        return labels


def fit_predict(res, params: KMeansBalancedParams, X, n_clusters: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(centroids, labels)``: :func:`fit` then :func:`predict`
    (reference: kmeans_balanced.cuh:198)."""
    centroids = fit(res, params, X, n_clusters)
    return centroids, predict(res, params, X, centroids)


def build_clusters(res, params: KMeansBalancedParams, X, n_clusters: int):
    raise not_ported("kmeans_balanced", "build_clusters", "primitives")

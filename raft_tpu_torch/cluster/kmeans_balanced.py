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
cases (the dim-2 codebook subspaces, InnerProduct) run plain PyTorch, as
the JAX package runs XLA there.  The two-level mesocluster build
(``_fit_hierarchical``, n_clusters >= 8192) is not ported yet.

Random draws come from the handle's ``torch.Generator``, so a fit is
reproducible from its seed but draws differently from the JAX package's
threefry keys.  No boundary validator yet: inputs are checked for shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.ops.kmeans_update import kmeans_assign_update
from raft_tpu_torch.utils import precision

# clusters smaller than avg_size / _BALANCE_RATIO are re-seeded each round
_BALANCE_RATIO = 8.0
# from this cluster count the JAX package switches to its two-level build
_MESO_THRESHOLD = 8192
# rows per chunk of the plain (chunk, k) distance block
_ASSIGN_CHUNK = 16384


def _assign(X: torch.Tensor, centroids: torch.Tensor, metric: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels int64, distances f32): L2 min squared distance with the first
    argmin (``fused_l2_nn``'s contract), or InnerProduct argmax with the
    negated product.  fp32 products, chunked over rows."""
    cf = centroids.float()
    c_sq = (cf * cf).sum(1)
    labels = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    dists = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
    for s in range(0, X.shape[0], _ASSIGN_CHUNK):
        xc = X[s:s + _ASSIGN_CHUNK].float()
        ip = xc @ cf.T
        if metric == DistanceType.InnerProduct:
            best, lab = torch.max(ip, dim=1)
            d = -best
        else:
            d2 = torch.clamp_min((xc * xc).sum(1, keepdim=True)
                                 + c_sq[None, :] - 2.0 * ip, 0.0)
            lab = torch.argmin(d2, dim=1)
            d = torch.gather(d2, 1, lab[:, None])[:, 0]
        labels[s:s + xc.shape[0]] = lab
        dists[s:s + xc.shape[0]] = d
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


def fit(res, params: KMeansBalancedParams, X, n_clusters: int, *,
        hierarchical: Optional[bool] = None) -> torch.Tensor:
    """Train balanced centroids; returns (n_clusters, dim) float32
    (reference: cluster/kmeans_balanced.cuh:75)."""
    with precision.highest():
        X = ensure_tensor(X, res, "X")
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
            raise NotImplementedError(
                "kmeans_balanced.fit: the hierarchical (mesocluster) build "
                "for n_clusters >= 8192 is not ported yet (ROADMAP.md §1, "
                "'Deferred by the first slice': hierarchical k-means)")
        # evenly-strided init over the (caller-shuffled) trainset
        stride = max(n // n_clusters, 1)
        c0 = X[::stride][:n_clusters].float()
        if c0.shape[0] < n_clusters:
            c0 = torch.cat([c0, c0[-1:].expand(n_clusters - c0.shape[0],
                                                -1)])
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
        centroids = ensure_tensor(centroids, res, "centroids")
        labels, _ = _assign(X, centroids, params.metric)
        return labels

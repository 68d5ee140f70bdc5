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
cases (L2 below dim 32, InnerProduct) assign with :func:`_assign` —
Kernel H (``fused_l2_nn``) for L2, as the JAX package's ``_assign`` calls
``fused_l2_nn``, and a plain product for InnerProduct — and update in
plain PyTorch; ``predict`` is :func:`_assign` too.  The IVF-PQ codebooks
(dim <= 16, many independent fits of one shape) run
:func:`_balanced_loop_batched`: one launch of Kernel H's small-dim kernel
a turn for every member.  From
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
package's sites; ``build_clusters`` trains, assigns and counts in one
call.  :func:`_balanced_loop_batched` runs the loop over a batch of
independent problems of one shape at once (the IVF-PQ codebooks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.ops.fused_l2_nn import fused_l2_nn_batched
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


def _segment_sums(xf: torch.Tensor, seg: torch.Tensor, n_seg: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (n_seg, d) f32, sizes (n_seg,) int64) of the rows of xf (n,
    d) by their segment ``seg`` (n,): one ``index_add_`` and one
    ``bincount``."""
    sums = torch.zeros(n_seg, xf.shape[1], dtype=torch.float32,
                       device=xf.device)
    sums.index_add_(0, seg, xf)
    return sums, torch.bincount(seg, minlength=n_seg)


def _means(sums: torch.Tensor, sizes: torch.Tensor,
           old: Optional[torch.Tensor]) -> torch.Tensor:
    """Each cluster's mean, ``sums / sizes`` over any leading axes; an
    empty cluster keeps its ``old`` centre where one is given."""
    sizes = sizes.float()
    centers = sums / torch.clamp_min(sizes, 1.0)[..., None]
    if old is None:
        return centers
    return torch.where((sizes > 0)[..., None], centers, old.float())


def calc_centers_and_sizes(X: torch.Tensor, labels: torch.Tensor,
                           n_clusters: int, *,
                           old_centroids: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster mean + population (reference:
    kmeans_balanced.cuh:336); empty clusters keep ``old_centroids``."""
    sums, sizes = _segment_sums(X.float(), labels, n_clusters)
    return _means(sums, sizes, old_centroids), sizes.int()


def _update_and_rebalance(xf: torch.Tensor, dists: torch.Tensor,
                          sums: torch.Tensor, sizes: torch.Tensor,
                          centroids: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """One turn's update and balancing over a leading batch axis: xf (B,
    n, d) rows, dists (B, n) their assignment distances, sums (B, K, d)
    and sizes (B, K) per cluster, centroids (B, K, d) the turn's centres
    -> the next centres.  Each cluster moves to its mean (an empty one
    keeps its centre); each member's clusters smaller than ``avg /
    _BALANCE_RATIO`` re-seed at rows drawn proportional to their
    assignment distance (inverse CDF over a cumulative sum), from one
    ``torch.rand((B, K))`` draw."""
    B, n, d = xf.shape
    K = sums.shape[1]
    centers = _means(sums, sizes, centroids)
    small = sizes.float() < (n / K) / _BALANCE_RATIO
    w = torch.clamp_min(dists - dists.amin(1, keepdim=True), 0.0) + 1e-6
    cdf = torch.cumsum(w, 1)
    u = torch.rand((B, K), generator=generator,
                   device=xf.device) * cdf[:, -1:]
    cand = torch.clamp(torch.searchsorted(cdf, u), 0, n - 1)
    picked = torch.gather(xf, 1, cand[..., None].expand(-1, -1, d))
    return torch.where(small[..., None], picked, centers)


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
            sums, sizes, dmin = kmeans_assign_update(xb, ones, centroids)
            dists = torch.clamp_min(x_sq + dmin, 0.0)
        else:
            labels, dists = _assign(xf, centroids, metric)
            sums, sizes = _segment_sums(xf, labels, n_clusters)
        centers = _update_and_rebalance(xf[None], dists[None], sums[None],
                                        sizes[None], centroids[None],
                                        generator)[0]
        if metric == DistanceType.InnerProduct:
            centers = centers / torch.clamp_min(
                torch.linalg.norm(centers, dim=1, keepdim=True), 1e-12)
        centroids = centers
    labels, _ = _assign(xf, centroids, metric)
    return centroids, labels


def _balanced_loop_batched(X: torch.Tensor, centroids0: torch.Tensor,
                           generator: torch.Generator, n_clusters: int,
                           n_iters: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_balanced_loop` (L2Expanded) over a batch of independent
    problems at once: X (B, n, d), centroids0 (B, K, d) -> (centroids (B,
    K, d), labels (B, n) int64).  Each turn: the assignment of every
    member in ONE launch of Kernel H's small-dim kernel
    (:func:`raft_tpu_torch.ops.fused_l2_nn.fused_l2_nn_batched`, d <= 16),
    sums and sizes through one ``index_add_`` over B·K segments, then
    :func:`_update_and_rebalance`, the loops' one update and balancing
    step — no Python loop over members.  At B = 1 it is
    :func:`_balanced_loop` draw for draw (bit for bit on the CPU)."""
    xf = X.float()
    B, n, d = xf.shape
    K = n_clusters
    dev = xf.device
    flat_x = xf.reshape(B * n, d)
    seg0 = (torch.arange(B, device=dev) * K)[:, None]          # (B, 1)
    centroids = centroids0.float()
    for _ in range(n_iters):
        dists, lab = fused_l2_nn_batched(xf, centroids)
        sums, sizes = _segment_sums(flat_x, (lab.long() + seg0).reshape(-1),
                                    B * K)
        centroids = _update_and_rebalance(xf, dists, sums.reshape(B, K, d),
                                          sizes.reshape(B, K), centroids,
                                          generator)
    _, labels = fused_l2_nn_batched(xf, centroids)
    return centroids, labels.long()


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
    """k evenly strided rows of X (n, d), the last repeated if X is short;
    of each member of a batch (B, n, d)."""
    c0 = X[..., ::max(X.shape[-2] // k, 1), :][..., :k, :].float()
    if c0.shape[-2] < k:
        c0 = torch.cat([c0, c0[..., -1:, :].expand(
            *c0.shape[:-2], k - c0.shape[-2], -1)], -2)
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
    (reference: cluster/kmeans_balanced.cuh:75).  Runs under the
    ``kmeans_balanced.fit`` stage."""
    with named_range("kmeans_balanced::fit"), \
            obs.stage("kmeans_balanced.fit") as st, precision.highest():
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
            centroids = _fit_hierarchical(X, n_clusters, res.generator,
                                          params.n_iters, params.metric)
            st.fence(centroids)
            return centroids
        # evenly-strided init over the (caller-shuffled) trainset
        c0 = _strided_init(X, n_clusters)
        if params.metric == DistanceType.InnerProduct:
            c0 = c0 / torch.clamp_min(
                torch.linalg.norm(c0, dim=1, keepdim=True), 1e-12)
        centroids, _ = _balanced_loop(
            X, c0, res.generator, n_clusters, params.n_iters, params.metric,
            use_fused=_fused_ok(dim, params.metric))
        st.fence(centroids)
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


def build_clusters(res, params: KMeansBalancedParams, X, n_clusters: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(centroids, labels, sizes)``: train, assign and count in one call
    (reference: kmeans_balanced.cuh:257 ``helpers::build_clusters``)."""
    centroids, labels = fit_predict(res, params, X, n_clusters)
    _, sizes = calc_centers_and_sizes(ensure_tensor(X, res, "X").float(),
                                      labels, n_clusters)
    return centroids, labels, sizes

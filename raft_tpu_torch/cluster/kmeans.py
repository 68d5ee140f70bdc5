"""k-means clustering: Lloyd's algorithm with k-means++ init (port of
``raft_tpu.cluster.kmeans``).

Reference: raft/cluster/kmeans.cuh:87 ``fit``, :151 ``predict``, :214
``fit_predict``, :243 ``transform`` and the public building blocks
``sample_centroids`` :339, ``update_centroids`` :392,
``min_cluster_and_distance`` :495, ``shuffle_and_gather`` :530; internals
in cluster/detail/kmeans.cuh (``initRandom`` :62, ``kmeansPlusPlus`` :88,
``update_centroids`` :285, ``kmeans_fit_main`` :359).

Where the kernels run:

- ``fit``'s Lloyd loop: for the four L2 metrics at dim >= 32 one Kernel A
  call per iteration (:func:`raft_tpu_torch.ops.kmeans_update.kmeans_assign_update`:
  bf16 assignment + weighted per-cluster sums), where the JAX package on a
  TPU takes ``fused_assign_update``; otherwise
  :func:`min_cluster_and_distance` (Kernel H for L2) and
  :func:`update_centroids`.
- The final assignment, ``predict``, ``cluster_cost`` and
  ``min_cluster_and_distance``: Kernel H
  (:func:`raft_tpu_torch.distance.fused_l2_nn.fused_l2_nn`) for the L2
  metrics, all-pairs distances (:mod:`raft_tpu_torch.distance.pairwise`)
  otherwise.

The loop runs on the host, one device sync per iteration for the
convergence test (the JAX package keeps it in a ``while_loop``): it stops
once the summed squared centroid shift falls below ``tol`` or after
``max_iter`` iterations.  k-means++ draws ``n_trials`` candidates a round
with probability proportional to the current min squared distance (the
Gumbel top-k trick) and keeps the one of lowest resulting cost; its rounds
never read a value back to the host.  Restarts draw from a generator
seeded by ``params.seed`` and the restart index, as ``jax.random.fold_in``
seeds them; torch's Philox stream is not JAX's threefry, so the two
packages' draws differ.  Empty clusters keep their previous centroid.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.core.outputs import auto_convert_output, raw
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import DistanceType, L2_METRICS, \
    SQRT_METRICS
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.ops.kmeans_update import kmeans_assign_update
from raft_tpu_torch.utils import precision


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def min_cluster_and_distance(X: torch.Tensor, centroids: torch.Tensor, *,
                             metric: int = DistanceType.L2Expanded
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ``(labels int32 (n,), distances (n,))`` to the nearest
    centroid (reference: kmeans.cuh:495): squared L2 for L2Expanded /
    L2Unexpanded, L2 for the sqrt metrics (both Kernel H), the raw metric
    value otherwise."""
    with precision.highest():
        if metric in L2_METRICS:
            d, i = raw(fused_l2_nn)(X, centroids, sqrt=metric in SQRT_METRICS)
            return i, d
        dmat = raw(pairwise_distance)(X, centroids, metric)
        d, i = torch.min(dmat, dim=1)
        return i.int(), d


def update_centroids(X: torch.Tensor, labels: torch.Tensor, n_clusters: int,
                     *, sample_weight: Optional[torch.Tensor] = None,
                     old_centroids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-cluster mean and weight ``(centroids, counts)``
    (reference: kmeans.cuh:392); empty clusters keep ``old_centroids``."""
    xf = X.float()
    w = (torch.ones(xf.shape[0], dtype=torch.float32, device=xf.device)
         if sample_weight is None else sample_weight.float())
    lab = labels.long()
    sums = torch.zeros(n_clusters, xf.shape[1], dtype=torch.float32,
                       device=xf.device).index_add_(0, lab, xf * w[:, None])
    counts = torch.zeros(n_clusters, dtype=torch.float32,
                         device=xf.device).index_add_(0, lab, w)
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    if old_centroids is not None:
        means = torch.where((counts > 0)[:, None], means,
                            old_centroids.float())
    return means, counts


def _generator(res, generator: Optional[torch.Generator]) -> torch.Generator:
    return res.generator if generator is None else generator


def sample_centroids(res, X, n_to_sample: int, *,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """``n_to_sample`` distinct rows of X, drawn uniformly (reference:
    kmeans.cuh:339)."""
    X = ensure_tensor(X, res, "X")
    n = X.shape[0]
    expects(n_to_sample <= n, "sample_centroids: more samples than rows")
    idx = torch.randperm(n, generator=_generator(res, generator),
                         device=X.device)[:n_to_sample]
    return X[idx]


def shuffle_and_gather(res, X, n_to_gather: int, *,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The first ``n_to_gather`` rows of a random permutation of X
    (reference: kmeans.cuh:530)."""
    X = ensure_tensor(X, res, "X")
    perm = torch.randperm(X.shape[0], generator=_generator(res, generator),
                          device=X.device)
    return X[perm[:n_to_gather]]


def cluster_cost(X, centroids, *, metric: int = DistanceType.L2Expanded
                 ) -> torch.Tensor:
    """Total cost (inertia) of the nearest-centroid assignment (reference:
    raft_runtime/cluster/kmeans.hpp:79)."""
    _, d = min_cluster_and_distance(X, centroids, metric=metric)
    return d.sum()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_plus_plus(res, X, n_clusters: int, *,
                   generator: Optional[torch.Generator] = None,
                   n_trials: int = 0) -> torch.Tensor:
    """k-means++ with ``n_trials`` candidates a round (reference:
    detail/kmeans.cuh:88; ``2 + ceil(ln k)`` when 0): each round draws the
    candidates without replacement with probability proportional to the
    current min squared distance and keeps the one whose new min distances
    sum lowest."""
    with precision.highest():
        X = ensure_tensor(X, res, "X")
        n, dim = X.shape
        expects(n_clusters <= n, "init_plus_plus: n_clusters > n_samples")
        gen = _generator(res, generator)
        if n_trials <= 0:
            n_trials = 2 + int(math.ceil(math.log(n_clusters)))
        n_trials = min(n_trials, n)
        xf = X.float()
        x_sq = (xf * xf).sum(1)

        def sq_dists_to(points):                      # (t, dim) -> (t, n)
            p_sq = (points * points).sum(1)
            return torch.clamp_min(p_sq[:, None] + x_sq[None, :]
                                   - 2.0 * (points @ xf.T), 0.0)

        # indices stay (1,)-shaped tensors: a 0-d tensor index would be
        # read back to the host
        first = torch.randint(0, n, (1,), generator=gen, device=X.device)
        centroids = torch.zeros(n_clusters, dim, dtype=torch.float32,
                                device=X.device)
        centroids[0] = xf.index_select(0, first)[0]
        min_d = sq_dists_to(xf.index_select(0, first))[0]
        for i in range(1, n_clusters):
            # Gumbel top-n_trials == n_trials draws without replacement,
            # probability ∝ min_d (the D² weighting)
            logits = torch.where(min_d > 0,
                                 torch.log(torch.clamp_min(min_d, 1e-30)),
                                 torch.full_like(min_d, float("-inf")))
            gumbel = -torch.log(torch.empty_like(min_d).exponential_(
                generator=gen))
            cand = torch.topk(logits + gumbel, n_trials).indices
            new_min = torch.minimum(sq_dists_to(xf.index_select(0, cand)),
                                    min_d[None, :])
            best = torch.argmin(new_min.sum(1), dim=0, keepdim=True)
            centroids[i] = xf.index_select(0, cand.index_select(0, best))[0]
            min_d = new_min.index_select(0, best)[0]
        return centroids


def init_random(res, X, n_clusters: int, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Random-row init (reference: detail/kmeans.cuh:62 ``initRandom``)."""
    return sample_centroids(res, X, n_clusters, generator=generator)


# ---------------------------------------------------------------------------
# fit / predict
# ---------------------------------------------------------------------------

def _use_kernel_a(dim: int, metric: int) -> bool:
    """Kernel A serves the Lloyd loop where the JAX package takes its
    Pallas pass on a TPU: the four L2 metrics, dim >= 32 (sqrt is
    monotone, so the assignment is the same)."""
    return metric in L2_METRICS and dim >= 32


def _lloyd(X, centroids, weights, tol: float, n_clusters: int,
           max_iter: int, metric: int) -> Tuple[torch.Tensor, int]:
    """Lloyd iterations (reference: detail/kmeans.cuh:359): stop once the
    summed squared centroid shift is below ``tol``.  Returns (centroids,
    iterations run)."""
    fused = _use_kernel_a(X.shape[1], metric)
    xb = X.to(torch.bfloat16) if fused else X   # rounded once for Kernel A
    c = centroids.float()
    n_iter = 0
    while n_iter < max_iter:
        if fused:
            sums, counts, _ = kmeans_assign_update(xb, weights, c)
            means = sums / torch.clamp_min(counts, 1.0)[:, None]
            new_c = torch.where((counts > 0)[:, None], means, c)
        else:
            labels, _ = min_cluster_and_distance(X, c, metric=metric)
            new_c, _ = update_centroids(X, labels, n_clusters,
                                        sample_weight=weights,
                                        old_centroids=c)
        shift = float(((new_c - c) ** 2).sum())
        c = new_c
        n_iter += 1
        if shift < tol:
            break
    return c, n_iter


def _restart_generator(seed: int, restart: int, device) -> torch.Generator:
    """The generator of restart ``restart``: seeded from ``seed`` and the
    restart index, as ``jax.random.fold_in(key(seed), restart)``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + restart) % (1 << 63))


def _weights(sample_weight, X) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones(X.shape[0], dtype=torch.float32, device=X.device)
    return torch.as_tensor(sample_weight, dtype=torch.float32).to(X.device)


@auto_convert_output
def fit(res, params: KMeansParams, X, sample_weight=None, centroids=None
        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Fit k-means: ``(centroids (k, dim) f32, inertia (0-d f32), n_iter)``
    (reference: kmeans.cuh:87).  ``centroids`` is the init when
    ``params.init == InitMethod.Array``; ``n_init`` restarts keep the
    lowest inertia.  The restarts run under the ``kmeans.fit`` stage;
    ``kmeans.iterations`` and ``kmeans.restarts`` count the kept run's
    iterations and the restarts."""
    with named_range("kmeans::fit"), precision.highest():
        X = ensure_tensor(X, res, "X")
        expects(X.ndim == 2, "kmeans.fit: 2-D X required")
        X, _ = boundary.check_matrix(X, "X", site="kmeans.fit",
                                     allow_empty=False)
        X = X.float()
        expects(X.shape[0] > 0, "kmeans.fit: non-empty 2-D X required")
        expects(params.n_clusters <= X.shape[0],
                "kmeans.fit: n_clusters > n_samples")
        w = _weights(sample_weight, X)
        n_init = (1 if params.init == InitMethod.Array
                  else max(1, params.n_init))
        best = None
        with obs.stage("kmeans.fit") as st:
            for restart in range(n_init):
                gen = _restart_generator(params.seed, restart, X.device)
                if params.init == InitMethod.Array:
                    expects(centroids is not None,
                            "InitMethod.Array requires centroids")
                    c0 = ensure_tensor(centroids, res, "centroids").float()
                elif params.init == InitMethod.Random:
                    c0 = init_random(res, X, params.n_clusters,
                                     generator=gen)
                else:
                    c0 = init_plus_plus(res, X, params.n_clusters,
                                        generator=gen)
                c, n_iter = _lloyd(X, c0, w, params.tol, params.n_clusters,
                                   params.max_iter, params.metric)
                # final assignment cost of the returned centroids
                _, d = min_cluster_and_distance(X, c, metric=params.metric)
                inertia = (d * w).sum()
                if best is None or float(inertia) < float(best[1]):
                    best = (c, inertia, n_iter)
            st.fence(best[0])
        if obs.enabled():
            obs.registry().counter("kmeans.iterations").inc(int(best[2]))
            obs.registry().counter("kmeans.restarts").inc(n_init)
        return best


@auto_convert_output
def predict(res, params: KMeansParams, X, centroids, *, sample_weight=None,
            normalize_weight: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid labels (int32) and the weighted inertia (reference:
    kmeans.cuh:151)."""
    X = ensure_tensor(X, res, "X")
    X, _ = boundary.check_matrix(X, "X", site="kmeans.predict")
    centroids = ensure_tensor(centroids, res, "centroids")
    labels, d = min_cluster_and_distance(X, centroids, metric=params.metric)
    return labels, (d * _weights(sample_weight, X)).sum()


@auto_convert_output
def fit_predict(res, params: KMeansParams, X, sample_weight=None,
                centroids=None):
    """Reference: kmeans.cuh:214.  Returns (labels, centroids, inertia,
    n_iter)."""
    centroids, _, n_iter = raw(fit)(res, params, X, sample_weight,
                                    centroids)
    labels, inertia = raw(predict)(res, params, X, centroids,
                              sample_weight=sample_weight)
    return labels, centroids, inertia, n_iter


@auto_convert_output
def transform(res, params: KMeansParams, X, centroids) -> torch.Tensor:
    """Distance from every sample to every centroid (reference:
    kmeans.cuh:243)."""
    X, _ = boundary.check_matrix(ensure_tensor(X, res, "X"), "X",
                                 site="kmeans.transform")
    return raw(pairwise_distance)(
        X, ensure_tensor(centroids, res, "centroids"), params.metric)


def find_k(res, X, *, k_max: int = 20, k_min: int = 2, max_iter: int = 100,
           tol: float = 1e-3) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Pick k at the elbow of the inertia curve (reference:
    detail/kmeans_auto_find_k.cuh), as the JAX package does: fits at k_min,
    then ×1.5 steps up to k_max, and the k of the largest second
    difference of the costs.  Returns ``(best_k, centroids, inertia)``."""
    X = ensure_tensor(X, res, "X")
    results, ks = {}, []
    k = k_min
    while k <= k_max:
        ks.append(k)
        c, inertia, _ = raw(fit)(res, KMeansParams(
            n_clusters=k, max_iter=max_iter, tol=tol), X)
        results[k] = (c, float(inertia))
        k = max(k + 1, int(k * 1.5))
    if len(ks) >= 3:
        costs = [results[k][1] for k in ks]
        curv = [costs[i - 1] - 2 * costs[i] + costs[i + 1]
                for i in range(1, len(ks) - 1)]
        best_k = ks[1 + max(range(len(curv)), key=curv.__getitem__)]
    else:
        best_k = min(ks, key=lambda k: results[k][1])
    c, inertia = results[best_k]
    return best_k, c, torch.tensor(inertia)

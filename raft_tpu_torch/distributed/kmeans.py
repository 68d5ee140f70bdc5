"""Multi-device (MNMG) k-means (port of ``raft_tpu.distributed.kmeans``).

The reference ships the comms fabric and the per-partition building
blocks (``compute_new_centroids``, kmeans.pyx:54) that cuML's Dask
k-means drives with a centroid allreduce per iteration (SURVEY.md §3.3);
BASELINE.md config 5 needs the loop itself.

One process a rank, each holding its ``shard_rows`` of X on its device.
A Lloyd iteration: Kernel H (:func:`~raft_tpu_torch.distance.fused_l2_nn`)
assigns the shard, ``index_add_`` sums its rows and counts per cluster,
one ``allreduce`` each makes them global, and every rank applies the same
update (a cluster with no row keeps its centroid).  The shift is computed
from the allreduced values, so every rank reads the same number and takes
the same branch: one host read an iteration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster.kmeans import init_plus_plus
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.comms.comms import op_t
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.outputs import raw
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.distributed.knn import shard_rows
from raft_tpu_torch.utils import precision


def _shard(handle, X, what: str) -> torch.Tensor:
    comms = handle.get_comms()
    n, n_dev = X.shape[0], comms.get_size()
    expects(n % n_dev == 0,
            f"distributed.kmeans.{what}: n ({n}) must divide evenly over "
            f"{n_dev} devices (pad the input)")
    lo, hi = shard_rows(n, n_dev, comms.get_rank())
    return ensure_tensor(X[lo:hi], handle, "X").float()


def fit(handle, params: KMeansParams, X, *,
        centroids: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Distributed k-means fit over the handle's communicator: ``X`` is
    the whole (n, d) array on every rank (numpy, or a tensor on the CPU
    or the rank's device).  ``InitMethod.Array`` starts from
    ``centroids``; any other init runs k-means++ on rank 0 over ``X[:min(
    n, max(64 · n_clusters, 16384))]`` with the handle's generator, and
    ``bcast`` gives every rank its centroids.  Returns (centroids,
    inertia, n_iter), the same on every rank."""
    with named_range("distributed::kmeans::fit"):
        expects(handle.comms_initialized(),
                "distributed.kmeans.fit: handle has no comms (use "
                "CommsSession.worker_handle())")
        comms = handle.get_comms()
        x = _shard(handle, X, "fit")
        k = params.n_clusters
        if params.init == InitMethod.Array:
            expects(centroids is not None,
                    "InitMethod.Array requires centroids")
            c = ensure_tensor(centroids, handle, "centroids").float()
        else:
            # init on a subsample; ++ on the full set would need the
            # distributed variant
            if comms.get_rank() == 0:
                take = min(X.shape[0], max(k * 64, 16384))
                c = init_plus_plus(handle, ensure_tensor(
                    X[:take], handle, "X"), k).float()
            else:
                c = torch.zeros(k, X.shape[1], device=handle.device)
            c = comms.bcast(c, root=0)
        ones = torch.ones(x.shape[0], device=x.device)
        n_iter, shift = 0, float("inf")
        with precision.highest():
            while n_iter < params.max_iter and shift >= params.tol:
                _, labels = raw(fused_l2_nn)(x, c)
                lab = labels.long()
                sums = torch.zeros_like(c).index_add_(0, lab, x)
                counts = torch.zeros(k, device=x.device).index_add_(
                    0, lab, ones)
                # the MNMG allreduce step (cuML dask-kmeans pattern)
                sums = comms.allreduce(sums, op_t.SUM)
                counts = comms.allreduce(counts, op_t.SUM)
                new_c = torch.where((counts > 0)[:, None],
                                    sums / torch.clamp_min(counts, 1.0)[:,
                                                                        None],
                                    c)
                shift = float(((new_c - c) ** 2).sum())
                c = new_c
                n_iter += 1
            d, _ = raw(fused_l2_nn)(x, c)
            inertia = comms.allreduce(d.sum(), op_t.SUM)
        return c, inertia, n_iter


def predict(handle, params: KMeansParams, X, centroids) -> torch.Tensor:
    """Distributed predict: each rank labels its shard with Kernel H, and
    an allgather joins the labels of every row, in row order."""
    with named_range("distributed::kmeans::predict"):
        expects(handle.comms_initialized(),
                "distributed.kmeans.predict: handle has no comms (use "
                "CommsSession.worker_handle())")
        x = _shard(handle, X, "predict")
        c = ensure_tensor(centroids, handle, "centroids").float()
        _, labels = raw(fused_l2_nn)(x, c)
        return handle.get_comms().allgather(labels).reshape(-1)

"""Clustering (port of ``raft_tpu.cluster``): k-means and balanced
k-means, the IVF coarse quantizer."""

from raft_tpu_torch.cluster import kmeans, kmeans_balanced  # noqa: F401
from raft_tpu_torch.cluster.kmeans_types import (  # noqa: F401
    InitMethod,
    KMeansBalancedParams,
    KMeansParams,
)

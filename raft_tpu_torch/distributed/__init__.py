"""Distributed (MNMG) algorithms over the comms fabric (port of
``raft_tpu.distributed``).

The reference ships only the fabric (SURVEY.md §2.9: "there are no
distributed algorithms in RAFT itself"); the JAX package ships MNMG
k-means, kNN and sharded indexes natively, and so does the port, one
process a rank over :mod:`raft_tpu_torch.comms`: ``kmeans``, ``knn``,
``ann``'s indexes by row (IVF-PQ, IVF-Flat and CAGRA, each rank holding
its shard and searching it with the single-index kernels before one
allgather and merge), ``ann``'s routed placement (``placement="by_list"``:
one global quantizer, the lists partitioned over the ranks with optional
replicas, each rank scanning the probes its lists serve), ``routing``'s
load-aware replica policy, and ``health``'s tracker with ``catch_up`` /
``readmit``.  The tests run the ranks as gloo CPU processes
(:func:`raft_tpu_torch.comms.launch.spawn`); ``chip_smoke.py`` runs them on
the card: by row in phase 16, routed in phase 17 (NCCL at world size 1,
and four gloo ranks sharing the card).
"""

from raft_tpu_torch.distributed import ann  # noqa: F401
from raft_tpu_torch.distributed import health  # noqa: F401
from raft_tpu_torch.distributed import kmeans  # noqa: F401
from raft_tpu_torch.distributed import routing  # noqa: F401
from raft_tpu_torch.distributed import knn  # noqa: F401

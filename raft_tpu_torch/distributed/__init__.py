"""Distributed (MNMG) algorithms over the comms fabric (port of
``raft_tpu.distributed``).

The reference ships only the fabric (SURVEY.md §2.9: "there are no
distributed algorithms in RAFT itself"); the JAX package ships MNMG
k-means, kNN and sharded indexes natively, and so does the port, one
process a rank over :mod:`raft_tpu_torch.comms`: ``kmeans``, ``knn``,
``ann``'s indexes by row (IVF-PQ, IVF-Flat and CAGRA, each rank holding
its shard and searching it with the single-index kernels before one
allgather and merge) and ``health``'s tracker.  ``ann``'s routed
placement (``placement="by_list"``), ``routing`` and ``health.catch_up``
/ ``readmit`` are stand-ins until their slice is ported.  The tests run
the ranks as gloo CPU processes (:func:`raft_tpu_torch.comms.launch.
spawn`); ``chip_smoke.py`` runs them on the card.
"""

from raft_tpu_torch.distributed import ann  # noqa: F401
from raft_tpu_torch.distributed import health  # noqa: F401
from raft_tpu_torch.distributed import kmeans  # noqa: F401
from raft_tpu_torch.distributed import routing  # noqa: F401
from raft_tpu_torch.distributed import knn  # noqa: F401

"""Distributed (MNMG) algorithms over the comms fabric (port of
``raft_tpu.distributed``).

The reference ships only the fabric (SURVEY.md §2.9: "there are no
distributed algorithms in RAFT itself"); the JAX package ships MNMG
k-means and kNN natively, and so does the port, one process a rank over
:mod:`raft_tpu_torch.comms`.  The sharded indexes (``ann``), routing and
health are stand-ins until their slice is ported.
"""

from raft_tpu_torch.distributed import ann  # noqa: F401
from raft_tpu_torch.distributed import health  # noqa: F401
from raft_tpu_torch.distributed import kmeans  # noqa: F401
from raft_tpu_torch.distributed import routing  # noqa: F401
from raft_tpu_torch.distributed import knn  # noqa: F401

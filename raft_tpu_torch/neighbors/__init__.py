"""Nearest-neighbour indexes (port of ``raft_tpu.neighbors``): IVF-Flat,
IVF-PQ, CAGRA, refine, brute force.  ``ball_cover`` and
``eps_neighbors_l2sq`` are stand-ins naming their ROADMAP item (*the
tail*).

``ivf_flat`` and ``ivf_pq`` load at first use (PEP 562): the scan kernels'
wrappers under :mod:`raft_tpu_torch.ops` import this package's
``grouped``, and the two index modules import those wrappers, so loading
them here would make ``import raft_tpu_torch.ops.pq_group_scan`` a cycle.
"""

import importlib

from raft_tpu_torch.core.error import not_ported_stub as _stub
from raft_tpu_torch.neighbors import ball_cover, brute_force  # noqa: F401
from raft_tpu_torch.neighbors.brute_force import (knn,  # noqa: F401
                                                  knn_merge_parts)
from raft_tpu_torch.neighbors.refine import refine  # noqa: F401

eps_neighbors_l2sq = _stub("neighbors", "eps_neighbors_l2sq",
                                     "the tail")

_LAZY = ("ivf_flat", "ivf_pq")


def __getattr__(name: str):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

A second package beside ``raft_tpu`` (the JAX reference, which stays as it
is).  Plain tensor code is PyTorch; every Pallas kernel of the reference
that the ported path reaches is a CUDA C++ kernel written for ``sm_90a``
under :mod:`raft_tpu_torch.csrc`, built with ``nvcc`` at first use
(:mod:`raft_tpu_torch.ops._cuda`) and bound through ``ctypes``.

This package imports neither ``jax`` nor anything of ``raft_tpu``, and does
no CUDA work at import time.  Entry points run on the card unless the
caller's :class:`DeviceResources` asks for the CPU, where each kernel
wrapper runs its plain PyTorch version instead.

Ported so far (see ROADMAP.md): IVF-PQ build (two-level k-means from 8192
lists, per-subspace or per-cluster codebooks) and search over the recon
cache, the packed codes, the int8 cache and a per-probe lookup table
(every ``scan_mode``, L2 and InnerProduct) —
:mod:`raft_tpu_torch.neighbors.ivf_pq`, with
:mod:`raft_tpu_torch.neighbors.ivf_pq_helpers`; the matrix and random helpers
(:mod:`raft_tpu_torch.matrix.ops`, :mod:`raft_tpu_torch.random`); IVF-Flat
(:mod:`raft_tpu_torch.neighbors.ivf_flat`); k-means
(:mod:`raft_tpu_torch.cluster.kmeans`,
:mod:`raft_tpu_torch.cluster.kmeans_balanced`); CAGRA build and walk search
(:mod:`raft_tpu_torch.neighbors.cagra`); :mod:`raft_tpu_torch.neighbors.refine`
and :mod:`raft_tpu_torch.neighbors.brute_force` (``knn``); the boundary
validator of every entry point (:mod:`raft_tpu_torch.integrity.boundary`,
policy in :mod:`raft_tpu_torch.config`); persistence — ``serialize`` /
``deserialize`` / ``save`` / ``load`` of the three index kinds in the JAX
package's byte format (:mod:`raft_tpu_torch.core.serialize`), checkpointed
builds, fault injection and retries (:mod:`raft_tpu_torch.resilience`),
recall canaries (:mod:`raft_tpu_torch.integrity.canary`), and the
``config.set_output_as`` output types; the host-side subsystems —
observability (:mod:`raft_tpu_torch.observability`: metrics registry,
stage timers under the JAX package's names, build reports, request
traces, the flight recorder, live quality, exporters), tracing ranges and
the logger (:mod:`raft_tpu_torch.core`), the index verifier
(:func:`raft_tpu_torch.integrity.verify`) and the delta memtable
(:mod:`raft_tpu_torch.neighbors.delta`).
"""

from raft_tpu_torch import config  # noqa: F401
from raft_tpu_torch import observability  # noqa: F401
from raft_tpu_torch import integrity  # noqa: F401
from raft_tpu_torch.core import (DeviceResources, LogicError,  # noqa: F401
                                 RaftError, Resources, expects)
from raft_tpu_torch.core.outputs import auto_convert_output  # noqa: F401

__version__ = "0.1.0"

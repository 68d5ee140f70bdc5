"""Communicator fabric on ``torch.distributed`` (port of
``raft_tpu.comms``).

Reference: cpp/include/raft/comms/ + core/comms.hpp (SURVEY.md §2.9) — the
``comms_t`` interface with NCCL/UCX and MPI backends, injected into
handles and bootstrapped by raft-dask.

The JAX package's one backend is XLA's mesh collectives; the port's is a
``torch.distributed`` process group, one process a rank: NCCL on the card,
gloo across CPU processes (and for more than one rank on one card).
:mod:`~raft_tpu_torch.comms.launch` starts the ranks of one host.
"""

from raft_tpu_torch.comms.comms import (  # noqa: F401
    Comms,
    P2pRequest,
    op_t,
    status_t,
)
from raft_tpu_torch.comms.session import (  # noqa: F401
    CommsSession,
    inject_comms_on_handle,
    local_handle,
    make_2d_session,
)
from raft_tpu_torch.comms import self_test  # noqa: F401

"""raft_tpu_torch.resilience — fault injection, retries and deadlines,
checkpoints, atomic index IO (port of ``raft_tpu.resilience``).

- :mod:`~raft_tpu_torch.resilience.faults` — deterministic, seed-pinned
  fault injection at named sites (sync points, stream IO, checkpoints);
- :mod:`~raft_tpu_torch.resilience.retry` — jittered-backoff retries and
  :class:`Deadline` budgets on index IO;
- :mod:`~raft_tpu_torch.resilience.checkpoint` — atomic build-stage
  persistence behind ``build(..., resume=True)``, in the JAX package's
  file layout;
- :mod:`~raft_tpu_torch.resilience.io` — atomic ``save`` and retried
  ``load`` of whole indexes.

The CRC32 envelopes, short-read detection and
:class:`~raft_tpu_torch.core.serialize.CorruptIndexError` live in
:mod:`raft_tpu_torch.core.serialize`.
"""

from raft_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjected,
    FaultPlan,
    FaultSpec,
    TransientFault,
    failed_shards,
    inject,
    is_active,
    maybe_fail,
    straggler_pause,
)
from raft_tpu_torch.resilience.retry import (  # noqa: F401
    DEFAULT_POLICY,
    Deadline,
    DeadlineExceededError,
    RetryPolicy,
    retry_call,
    retryable,
)
from raft_tpu_torch.resilience.checkpoint import (  # noqa: F401
    CheckpointManager,
    as_manager,
    atomic_write,
)
from raft_tpu_torch.resilience.io import (  # noqa: F401
    load_index,
    save_index,
)

# short internal aliases used by the neighbors save / load overloads
_save_index = save_index
_load_index = load_index

__all__ = [
    "CheckpointManager",
    "DEFAULT_POLICY",
    "Deadline",
    "DeadlineExceededError",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "RetryPolicy",
    "TransientFault",
    "as_manager",
    "atomic_write",
    "failed_shards",
    "inject",
    "is_active",
    "load_index",
    "maybe_fail",
    "retry_call",
    "retryable",
    "save_index",
    "straggler_pause",
]

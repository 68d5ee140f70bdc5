"""Index integrity verification and input hardening (port of
``raft_tpu.integrity``): the tiered verifier
(:func:`~raft_tpu_torch.integrity.verify.verify`), input validation at the
public entry points (:mod:`~raft_tpu_torch.integrity.boundary`), recall
canaries (:mod:`~raft_tpu_torch.integrity.canary`) and the typed errors.
Counters land under ``integrity.*`` in the observability registry; the
verifier runs under a ``verify`` stage label."""

from raft_tpu_torch.integrity import boundary, canary  # noqa: F401
from raft_tpu_torch.integrity.boundary import (  # noqa: F401
    check_matrix,
    guard_nonfinite,
    mask_search_outputs,
)
from raft_tpu_torch.integrity.canary import (  # noqa: F401
    CanaryReport,
    CanarySet,
    health_check,
)
from raft_tpu_torch.integrity.errors import (IntegrityError,  # noqa: F401
                                             ValidationError)
from raft_tpu_torch.integrity.verify import verify  # noqa: F401

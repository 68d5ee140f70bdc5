"""Input validation at the public entry points (port of
``raft_tpu.integrity``'s boundary layer and typed errors).  The index
verifier and the recall canaries are stand-ins naming their ROADMAP item
(*host-side subsystems*, *canaries*)."""

from raft_tpu_torch.core.error import not_ported_stub as _stub
from raft_tpu_torch.integrity import boundary, canary  # noqa: F401
from raft_tpu_torch.integrity.boundary import (  # noqa: F401
    check_matrix,
    guard_nonfinite,
    mask_search_outputs,
)
from raft_tpu_torch.integrity.errors import (IntegrityError,  # noqa: F401
                                             ValidationError)

CanaryReport = _stub("integrity", "CanaryReport", "canaries")
CanarySet = _stub("integrity", "CanarySet", "canaries")
health_check = _stub("integrity", "health_check", "canaries")
verify = _stub("integrity", "verify", "host-side subsystems")

"""Input validation at the public entry points and recall canaries (port
of ``raft_tpu.integrity``'s boundary layer, typed errors and
:mod:`~raft_tpu_torch.integrity.canary`).  The index verifier is a
stand-in naming its ROADMAP item (*host-side subsystems*)."""

from raft_tpu_torch.core.error import not_ported_stub as _stub
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

verify = _stub("integrity", "verify", "host-side subsystems")

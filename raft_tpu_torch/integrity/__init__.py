"""Input validation at the public entry points (port of
``raft_tpu.integrity``'s boundary layer and typed errors)."""

from raft_tpu_torch.integrity.errors import (IntegrityError,  # noqa: F401
                                             ValidationError)

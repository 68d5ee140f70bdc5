"""Core: resource handle, errors, tensor ingestion."""

from raft_tpu_torch.core.error import LogicError, RaftError, expects  # noqa: F401
from raft_tpu_torch.core.resources import DeviceResources  # noqa: F401

"""Core: resource handle, errors, array contracts, serialization,
cooperative cancellation, the logger and the tracing ranges (port of
``raft_tpu.core``)."""

from raft_tpu_torch.core.error import (LogicError, RaftError,  # noqa: F401
                                       expects, fail)
from raft_tpu_torch.core.resources import (  # noqa: F401
    DeviceResources,
    Resources,
    resource_type,
)
from raft_tpu_torch.core.mdarray import (  # noqa: F401
    check_matrix,
    check_rank,
    check_same_dtype,
    check_same_shape,
    check_vector,
    col_major,
    ensure_array,
    make_device_matrix,
    make_device_scalar,
    make_device_vector,
    row_major,
)
from raft_tpu_torch.core.serialize import (  # noqa: F401
    CorruptIndexError,
    deserialize_mdspan,
    deserialize_scalar,
    serialize_mdspan,
    serialize_scalar,
)
from raft_tpu_torch.core.interruptible import (  # noqa: F401
    InterruptedException,
    interruptible,
)
from raft_tpu_torch.core import logger, tracing  # noqa: F401

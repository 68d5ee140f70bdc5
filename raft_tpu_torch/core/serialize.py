"""Index serialization (``raft_tpu.core.serialize``): not ported yet.

The RTIE envelope, CRC32 and the npy mdspans are ROADMAP.md §1 item 2,
*serialization*.  :class:`CorruptIndexError` is the reference's error
type; every other public name raises ``NotImplementedError`` naming the
item.
"""

from __future__ import annotations

from raft_tpu_torch.core.error import not_ported_getattr, not_ported_stub


class CorruptIndexError(ValueError):
    """A serialized index failed its checks (the reference's type)."""


serialize_mdspan = not_ported_stub("core.serialize", "serialize_mdspan",
                                   "serialization")
deserialize_mdspan = not_ported_stub("core.serialize", "deserialize_mdspan",
                                     "serialization")
serialize_scalar = not_ported_stub("core.serialize", "serialize_scalar",
                                   "serialization")
deserialize_scalar = not_ported_stub("core.serialize", "deserialize_scalar",
                                     "serialization")

__getattr__ = not_ported_getattr("raft_tpu_torch.core.serialize",
                                 "serialization")

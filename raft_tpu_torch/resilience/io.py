"""File-level index IO: atomic save and retried load (port of
``raft_tpu.resilience.io``).

Backs the ``save`` / ``load`` filename overloads of the index modules
(:mod:`raft_tpu_torch.neighbors.cagra` / ``ivf_flat`` / ``ivf_pq``):
writes go through :func:`~raft_tpu_torch.resilience.checkpoint.
atomic_write`, and both directions run under :func:`~raft_tpu_torch.
resilience.retry.retry_call`, so transient filesystem faults are retried
while corruption (:class:`~raft_tpu_torch.core.serialize.
CorruptIndexError`, a ``ValueError``) fails at once: re-reading a
bit-flipped file cannot fix it.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Callable, Optional, TypeVar

from raft_tpu_torch.resilience import checkpoint as _checkpoint
from raft_tpu_torch.resilience import retry as _retry

T = TypeVar("T")


def save_index(site: str, write_body: Callable[[BinaryIO], None],
               filename: str,
               policy: Optional[_retry.RetryPolicy] = None,
               deadline: Optional[_retry.Deadline] = None) -> None:
    """Serialize via ``write_body`` into ``filename`` atomically, with
    retry on transient IO errors (the serialization itself reruns: the
    payload lands whole or not at all)."""
    def attempt() -> None:
        buf = io.BytesIO()
        write_body(buf)
        _checkpoint.atomic_write(filename, buf.getvalue())

    _retry.retry_call(attempt, site=site, policy=policy, deadline=deadline)


def load_index(site: str, read_body: Callable[[BinaryIO], T],
               filename: str,
               policy: Optional[_retry.RetryPolicy] = None,
               deadline: Optional[_retry.Deadline] = None) -> T:
    """Open and deserialize ``filename`` with retry on transient IO
    errors; ``CorruptIndexError`` is never retried."""
    def attempt() -> T:
        with open(filename, "rb") as f:
            return read_body(f)

    return _retry.retry_call(attempt, site=site, policy=policy,
                             deadline=deadline)

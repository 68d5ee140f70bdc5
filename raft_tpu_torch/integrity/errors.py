"""Typed integrity failures (port of ``raft_tpu.integrity.errors``).

Where ``LogicError`` means "the caller misused the API",
:class:`IntegrityError` means "an input (or an index) is in a semantically
invalid state": every instance names the first violated invariant and,
when one exists, the coordinate where it was observed.
"""

from __future__ import annotations

from typing import Optional, Tuple

from raft_tpu_torch.core.error import RaftError


class IntegrityError(RaftError):
    """An invariant is violated.

    ``invariant`` is the dotted name of the first violated invariant (e.g.
    ``"boundary.nonfinite"``); ``coord`` the coordinates of the first
    violation (e.g. ``(row,)``), when the invariant is localized."""

    def __init__(self, message: str, *, invariant: str = "unknown",
                 coord: Optional[Tuple[int, ...]] = None):
        super().__init__(message)
        self.invariant = invariant
        self.coord = coord


class ValidationError(IntegrityError, ValueError):
    """A public entry point rejected its input under policy ``raise``
    (non-finite rows, malformed shapes).  Also a ``ValueError``."""

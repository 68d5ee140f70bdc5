"""Error handling (port of ``raft_tpu.core.error``).

Reference: cpp/include/raft/core/error.hpp (``raft::exception``,
``raft::logic_error``, ``RAFT_EXPECTS`` :168).  Every public entry point
validates its inputs with :func:`expects`.
"""

from __future__ import annotations


class RaftError(RuntimeError):
    """Base exception (reference: ``raft::exception``, error.hpp:67)."""


class LogicError(RaftError):
    """Invalid arguments / broken invariants (reference:
    ``raft::logic_error``, error.hpp:96)."""


def expects(cond: bool, msg: str = "precondition violated") -> None:
    """Raise :class:`LogicError` unless ``cond`` (``RAFT_EXPECTS``)."""
    if not cond:
        raise LogicError(msg)


def not_ported(where: str, what: str, item: str) -> NotImplementedError:
    """The error a path this port has not reached yet raises, naming its
    entry in ROADMAP.md §1's 'Deferred' list."""
    return NotImplementedError(f"{where}: {what} is not ported yet "
                               f"(ROADMAP.md §1, 'Deferred': {item})")

"""Error handling (port of ``raft_tpu.core.error``).

Reference: cpp/include/raft/core/error.hpp (``raft::exception``,
``raft::logic_error``, ``RAFT_EXPECTS`` :168, ``RAFT_FAIL`` :184).  Every
public entry point validates its inputs with :func:`expects`.

A public name of the reference that the port has not reached yet is a
stand-in that raises :func:`not_ported` naming its ROADMAP item: a
function from :func:`not_ported_stub`, or, for a whole module, a stub
module whose ``__getattr__`` is :func:`not_ported_getattr`.
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


def fail(msg: str) -> None:
    """Unconditionally raise :class:`LogicError` (``RAFT_FAIL``,
    error.hpp:184)."""
    raise LogicError(msg)


def not_ported(where: str, what: str, item: str) -> NotImplementedError:
    """The error a path this port has not reached yet raises, naming its
    entry in ROADMAP.md §1's 'Deferred' list."""
    return NotImplementedError(f"{where}: {what} is not ported yet "
                               f"(ROADMAP.md §1, 'Deferred': {item})")


def not_ported_stub(where: str, name: str, item: str):
    """A stand-in for the reference's public name ``where.name``: calling
    it raises :func:`not_ported` naming ``item``, which
    ``stub.not_ported_item`` also holds."""
    def stub(*args, **kwargs):
        raise not_ported(where, name, item)

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = (f"Not ported yet: calling it raises NotImplementedError "
                    f"naming ROADMAP.md §1's '{item}'.")
    stub.not_ported_item = item
    return stub


def not_ported_getattr(where: str, item: str):
    """The module ``__getattr__`` (PEP 562) of a stub module standing for
    the reference's module ``where``: a public attribute raises
    :func:`not_ported` naming ``item``; a private or dunder one raises
    ``AttributeError`` as usual."""
    def __getattr__(name: str):
        if name.startswith("_"):
            raise AttributeError(f"module {where!r} has no attribute "
                                 f"{name!r}")
        raise not_ported(where, name, item)

    return __getattr__

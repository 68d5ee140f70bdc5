"""Per-request tracing (port of ``raft_tpu.observability.trace``).

The registry (registry.py) aggregates; a *trace* follows **one request**:
:func:`start_request` mints a trace id and a :class:`SpanRecorder`, the
caller makes it the ambient recorder (:func:`activating`), and every
``stage()`` the request crosses mirrors its timing onto it as a child span
under the stage's label (:func:`stage_hook`); library code attaches
attributes through :func:`annotate_current`.  Attributes ride along with
**no new device->host syncs**: device values are attached lazily and only
materialized by ``flight.dump()``.

Span timestamps use ``time.monotonic``, so spans can be built
*retroactively* from timestamps a caller has already taken.

Tracing has its own gate, independent of metrics collection
(:func:`enable_tracing` / :func:`disable_tracing`).  When tracing is off,
every hook here is a single module-flag check.

Cross-thread propagation: a batch may execute on a dispatch thread while
requests originate on caller threads, so the ambient recorder is a
per-thread stack (:func:`push_active` / :func:`pop_active` /
:func:`current`); a batch-level recorder's spans and attributes are adopted
into each request's trace afterwards (:meth:`SpanRecorder.adopt`).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import contextlib

#: process-global monotonic trace-id source (ids are unique per process;
#: the pid in flight dumps disambiguates across processes)
_TRACE_IDS = itertools.count(1)

_TRACING = False


def tracing() -> bool:
    """Whether per-request tracing is on (off by default)."""
    return _TRACING


def enable_tracing() -> None:
    global _TRACING
    _TRACING = True


def disable_tracing() -> None:
    global _TRACING
    _TRACING = False


@contextlib.contextmanager
def tracing_scope() -> Iterator[None]:
    """Enable tracing for the body, restoring the previous state after."""
    prev = _TRACING
    enable_tracing()
    try:
        yield
    finally:
        if not prev:
            disable_tracing()


def now() -> float:
    """The trace clock (``time.monotonic`` — matches serving timestamps)."""
    return time.monotonic()


class Span:
    """One closed phase of a request: ``[t0, t1)`` under a registry-style
    dotted name, plus free-form attributes.  Immutable once recorded, so a
    batch-shared span can be adopted by many request traces."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:  # debugging / dump readability
        return (f"Span({self.name!r}, dur={self.duration * 1e3:.3f}ms"
                + (f", attrs={self.attrs}" if self.attrs else "") + ")")


class SpanRecorder:
    """A request's trace under construction: the root span (``name``,
    opened at construction) plus child spans recorded retroactively from
    timestamps via :meth:`span`, and root-level attributes via
    :meth:`annotate`.

    Not locked: a recorder is only ever mutated by the thread that holds it
    (caller thread during submit, dispatch thread afterwards) — the handoff
    happens through the admission queue, which is the synchronization
    point.
    """

    __slots__ = ("trace_id", "name", "t0", "t1", "spans", "attrs")

    def __init__(self, name: str, trace_id: Optional[int] = None,
                 t0: Optional[float] = None) -> None:
        self.trace_id = next(_TRACE_IDS) if trace_id is None else trace_id
        self.name = name
        self.t0 = now() if t0 is None else float(t0)
        self.t1: Optional[float] = None
        self.spans: List[Span] = []
        self.attrs: Dict[str, Any] = {}

    def span(self, name: str, t0: float, t1: float, **attrs: Any) -> Span:
        """Record a closed child span from timestamps already taken."""
        s = Span(name, t0, t1, attrs or None)
        self.spans.append(s)
        return s

    def adopt(self, other: "SpanRecorder") -> None:
        """Merge a batch-level recorder's spans and attributes into this
        request's trace (spans are immutable — shared, not copied)."""
        self.spans.extend(other.spans)
        self.attrs.update(other.attrs)

    def annotate(self, key: str, value: Any) -> None:
        """Attach a root-span attribute.  Values may be lazy (e.g. an
        un-fetched device array): nothing here forces them to host — only
        ``flight.dump()`` materializes attributes, off the hot path."""
        self.attrs[key] = value

    def close(self, t1: Optional[float] = None) -> "SpanRecorder":
        self.t1 = now() if t1 is None else float(t1)
        return self

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else now()) - self.t0


def start_request(name: str = "serving.request") -> SpanRecorder:
    """Mint a new trace (fresh id, root span opened now)."""
    return SpanRecorder(name)


# ---------------------------------------------------------------------------
# ambient recorder: per-thread stack

_tls = threading.local()


def _stack() -> List[SpanRecorder]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def push_active(rec: SpanRecorder) -> None:
    _stack().append(rec)


def pop_active() -> Optional[SpanRecorder]:
    st = _stack()
    return st.pop() if st else None


def current() -> Optional[SpanRecorder]:
    """The innermost active recorder on this thread (None when tracing is
    off or nothing is active) — library code annotates through this without
    threading a handle through every signature."""
    if not _TRACING:
        return None
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def activating(rec: Optional[SpanRecorder]) -> Iterator[None]:
    """Make ``rec`` the ambient recorder for the body (no-op on None)."""
    if rec is None:
        yield
        return
    push_active(rec)
    try:
        yield
    finally:
        pop_active()


def annotate_current(key: str, value: Any) -> None:
    """Annotate the ambient recorder, if any (one flag check when off)."""
    rec = current()
    if rec is not None:
        rec.annotate(key, value)


def stage_hook(name: str, seconds: float) -> None:
    """Called by ``stage()`` on exit: mirror the stage timing as a span on
    the ambient recorder, so ``stage()`` timers nest inside request traces
    under the same labels.  One flag check when tracing is off."""
    rec = current()
    if rec is not None:
        t1 = now()
        rec.span(name, t1 - seconds, t1)

"""Flight recorder — always-on ring buffer of recent traces + anomalies
(port of ``raft_tpu.observability.flight``: the same ring, dump format and
environment variables).

The post-hoc half of the observability story: when a request is shed, a
shard degrades, or serving raises, the aggregate counters say *how often*
but not *what was happening*.  The flight recorder keeps the last N
completed request traces (when tracing is enabled) and **every anomaly
event** (always — anomalies are rare, so recording them is never gated on
collection) in a fixed-size ring, and :func:`dump` emits a Chrome
trace-event-format JSON artifact (load it in ``chrome://tracing`` /
Perfetto) for exactly this post-mortem.

Lock-free: the ring is a preallocated slot list; writers claim a slot with
``next(itertools.count())`` (atomic under the GIL) and store a single
reference — no lock, no allocation beyond the record itself, safe from any
thread.  Readers snapshot racily, which is
fine: a torn read can only miss or double-see a record mid-overwrite,
never observe a half-written one.

Anomaly event names are registry-style dotted literals, the JAX
package's own (``ivf_pq.fused_fallback``, ``integrity.canary_failure``,
``serving.quality.drift``).

Auto-dump: set ``RAFT_TPU_FLIGHT_DUMP=<path>`` and :func:`maybe_auto_dump`
writes the dump there.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, List, Optional

from raft_tpu_torch.observability import trace as _trace

DEFAULT_CAPACITY = 512

#: hard ceiling on the ring size — the ring is a preallocated slot list,
#: so an absurd capacity is an allocation bug, not a tuning choice
MAX_CAPACITY = 1 << 20

#: env var overriding the process-global recorder's ring capacity
CAPACITY_ENV = "RAFT_TPU_FLIGHT_CAPACITY"

_EVENT = 0
_TRACE = 1


def _materialize(value: Any) -> Any:
    """Make one attribute JSON-safe, fetching lazy device values *here*,
    off the hot path (dump time is the only place a traced device array is
    brought to host)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_materialize(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _materialize(v) for k, v in value.items()}
    if hasattr(value, "tolist"):  # numpy arrays, tensors (host fetch ok here)
        try:
            return value.tolist()
        except Exception:
            return repr(value)
    return repr(value)


class FlightRecorder:
    """Fixed-capacity ring of ``(kind, seq, payload)`` records."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if not 0 < capacity <= MAX_CAPACITY:
            raise ValueError(
                f"flight recorder capacity must be in [1, {MAX_CAPACITY}], "
                f"got {capacity}")
        self.capacity = int(capacity)
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._seq = itertools.count()

    # -- writers (hot path: one next() + one list store, no lock) ----------

    def record_event(self, name: str, *, trace_id: Optional[int] = None,
                     **attrs: Any) -> None:
        """Record one anomaly event.  Always on — call sites do NOT gate
        this on ``obs.enabled()``; anomalies are rare by construction."""
        seq = next(self._seq)
        self._slots[seq % self.capacity] = (
            _EVENT, seq, _trace.now(), name, trace_id, attrs or None)

    def record_trace(self, rec: _trace.SpanRecorder) -> None:
        """Record one completed request trace (caller closes it first)."""
        seq = next(self._seq)
        self._slots[seq % self.capacity] = (_TRACE, seq, rec)

    # -- readers (racy snapshot; see module docstring) ---------------------

    def _records(self) -> List[tuple]:
        return sorted((r for r in list(self._slots) if r is not None),
                      key=lambda r: r[1])

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Anomaly events in the ring, oldest first, optionally filtered
        by exact event name."""
        out = []
        for r in self._records():
            if r[0] != _EVENT:
                continue
            if name is not None and r[3] != name:
                continue
            out.append({"name": r[3], "t": r[2], "trace_id": r[4],
                        "attrs": r[5] or {}})
        return out

    def traces(self) -> List[_trace.SpanRecorder]:
        """Completed request traces in the ring, oldest first."""
        return [r[2] for r in self._records() if r[0] == _TRACE]

    def clear(self) -> None:
        # rebind, don't mutate: a racing writer lands in the old list
        self._slots = [None] * self.capacity

    # -- dump --------------------------------------------------------------

    def dump(self, path: Optional[str] = None, *,
             reason: Optional[str] = None) -> str:
        """Serialize the ring to Chrome trace-event JSON; optionally also
        write it to ``path``.  Returns the JSON string.

        Each request trace becomes a row (``tid`` = trace id) of complete
        ("X") events — the root span plus children; each anomaly is an
        instant ("i") event.  Timestamps are the monotonic trace clock in
        microseconds, so rows are mutually comparable within one process.
        """
        pid = os.getpid()
        ev: List[Dict[str, Any]] = []
        for r in self._records():
            if r[0] == _EVENT:
                _, _seq, t, name, trace_id, attrs = r
                ev.append({
                    "name": name, "ph": "i", "s": "g",
                    "ts": t * 1e6, "pid": pid, "tid": trace_id or 0,
                    "args": _materialize(attrs or {}),
                })
            else:
                rec = r[2]
                t1 = rec.t1 if rec.t1 is not None else _trace.now()
                ev.append({
                    "name": rec.name, "ph": "X",
                    "ts": rec.t0 * 1e6, "dur": (t1 - rec.t0) * 1e6,
                    "pid": pid, "tid": rec.trace_id,
                    "args": _materialize({"trace_id": rec.trace_id,
                                          **rec.attrs}),
                })
                for s in rec.spans:
                    ev.append({
                        "name": s.name, "ph": "X",
                        "ts": s.t0 * 1e6, "dur": s.duration * 1e6,
                        "pid": pid, "tid": rec.trace_id,
                        "args": _materialize(s.attrs or {}),
                    })
        doc = {"traceEvents": ev, "displayTimeUnit": "ms",
               "otherData": {"generator": "raft_tpu_torch.observability.flight",
                             **({"reason": reason} if reason else {})}}
        text = json.dumps(doc)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text


# ---------------------------------------------------------------------------
# process-global recorder + module-level conveniences


def _env_capacity() -> int:
    """Ring capacity for the process-global recorder:
    ``$RAFT_TPU_FLIGHT_CAPACITY`` when set and valid, else the default.
    Unparseable / out-of-bounds values fall back (with a warning) rather
    than raise — a bad env var must not make ``import raft_tpu_torch`` fail."""
    raw = os.environ.get(CAPACITY_ENV)
    if not raw:
        return DEFAULT_CAPACITY
    try:
        cap = int(raw)
        if not 0 < cap <= MAX_CAPACITY:
            raise ValueError(raw)
    except ValueError:
        import warnings
        warnings.warn(
            f"ignoring {CAPACITY_ENV}={raw!r}: expected an integer in "
            f"[1, {MAX_CAPACITY}]; using {DEFAULT_CAPACITY}",
            RuntimeWarning, stacklevel=2)
        return DEFAULT_CAPACITY
    return cap


_RECORDER = FlightRecorder(_env_capacity())

#: env var naming the auto-dump destination.
#: A FILE path is overwritten in place (the original contract); a
#: DIRECTORY (existing, or a trailing separator) rotates
#: ``flight-NNNNNN.json`` dumps, keeping the newest ``DUMP_KEEP_ENV``
#: (default 5) — repeated failures no longer clobber the first, usually
#: most interesting, dump.
DUMP_ENV = "RAFT_TPU_FLIGHT_DUMP"

#: env var bounding how many rotated dumps a directory destination keeps
DUMP_KEEP_ENV = "RAFT_TPU_FLIGHT_DUMP_KEEP"
DEFAULT_DUMP_KEEP = 5


def recorder() -> FlightRecorder:
    return _RECORDER


def record_event(name: str, *, trace_id: Optional[int] = None,
                 **attrs: Any) -> None:
    _RECORDER.record_event(name, trace_id=trace_id, **attrs)


def record_trace(rec: _trace.SpanRecorder) -> None:
    _RECORDER.record_trace(rec)


def events(name: Optional[str] = None) -> List[Dict[str, Any]]:
    return _RECORDER.events(name)


def traces() -> List[_trace.SpanRecorder]:
    return _RECORDER.traces()


def clear() -> None:
    _RECORDER.clear()


def dump(path: Optional[str] = None, *, reason: Optional[str] = None) -> str:
    return _RECORDER.dump(path, reason=reason)


def maybe_auto_dump(reason: str) -> Optional[str]:
    """Write the flight dump to ``$RAFT_TPU_FLIGHT_DUMP`` if set (call it
    where a dispatch raises).  Returns the path written,
    or None when the env var is unset or the write itself fails (never
    raises — the recorder must not mask the original error)."""
    path = os.environ.get(DUMP_ENV)
    if not path:
        return None
    try:
        if os.path.isdir(path) or path.endswith(os.sep):
            return _rotated_dump(path, reason)
        _RECORDER.dump(path, reason=reason)
        return path
    except OSError:
        return None


def _dump_seq(name: str) -> Optional[int]:
    if not (name.startswith("flight-") and name.endswith(".json")):
        return None
    seq = name[len("flight-"):-len(".json")]
    return int(seq) if seq.isdigit() else None


def _rotated_dump(d: str, reason: str) -> str:
    """Directory-mode auto-dump: write ``flight-NNNNNN.json`` with the
    next sequence number (no clock — deterministic, collision-free
    within a process tree sharing the directory via the max scan) and
    prune the oldest beyond the keep bound."""
    os.makedirs(d, exist_ok=True)
    seqs = sorted(s for s in (_dump_seq(n) for n in os.listdir(d))
                  if s is not None)
    path = os.path.join(d, f"flight-{(seqs[-1] + 1 if seqs else 0):06d}.json")
    _RECORDER.dump(path, reason=reason)
    try:
        keep = max(1, int(os.environ.get(DUMP_KEEP_ENV,
                                         DEFAULT_DUMP_KEEP)))
    except ValueError:
        keep = DEFAULT_DUMP_KEEP
    stale = sorted(s for s in (_dump_seq(n) for n in os.listdir(d))
                   if s is not None)[:-keep]
    for s in stale:
        try:
            os.remove(os.path.join(d, f"flight-{s:06d}.json"))
        except OSError:
            pass          # a concurrent prune already took it
    return path

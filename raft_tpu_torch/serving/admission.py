"""Admission control — bounded queueing, load shedding, tenant quotas
(port of ``raft_tpu.serving.admission``).

The serving layer's survival rules, applied BEFORE a request touches an
card: a bounded queue with typed :class:`Overloaded` rejection
(the load-shedding contract: clients see an immediate, retryable error
instead of unbounded latency), per-tenant token-bucket quotas
(:class:`QuotaExceeded`), and deadline awareness — a request whose
:class:`~raft_tpu_torch.resilience.retry.Deadline` is already spent is refused
at the door, and one that expires while queued is completed with
:class:`~raft_tpu_torch.resilience.retry.DeadlineExceededError` at dispatch
instead of wasting a bucket slot.

Counters (collection-gated): ``serving.admitted``,
``serving.shed.queue_full``, ``serving.shed.quota``,
``serving.shed.deadline``, and — while a brownout ladder's top rung is
active — ``serving.shed.brownout`` for best-effort-tenant requests
refused at the door (see :mod:`raft_tpu_torch.serving.brownout`).  Every shed
additionally lands an anomaly event of the same name in the always-on
flight recorder (flight.py), carrying the request's trace id when
tracing is enabled.  Exactly ONE shed counter ticks per shed request:
each check below raises immediately, and a request refused here never
reaches the dispatcher's dispatch-time deadline accounting.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.resilience.retry import Deadline


class Overloaded(RaftError):
    """The server shed this request (queue full).  Retryable by the
    client after backoff — the serving analogue of
    :class:`~raft_tpu_torch.resilience.faults.TransientFault`."""


class QuotaExceeded(Overloaded):
    """The tenant's token bucket is empty.  A subclass of
    :class:`Overloaded` so quota-blind clients need one handler."""


class BrownedOut(Overloaded):
    """Shed because the brownout ladder's active rung drops best-effort
    tenants.  A subclass of :class:`Overloaded`: same client contract
    (retry with backoff), distinct type for tests and dashboards."""


class TokenBucket:
    """Per-tenant rate limiter: ``rate`` tokens/s, ``burst`` capacity.

    One token per query row (not per request), so a 100-row submission
    spends 100 tokens — quota units are rows/s of card work.
    """

    __slots__ = ("rate", "burst", "_tokens", "_t_last", "_clock", "_lock")

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._clock = clock
        self._t_last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


@dataclasses.dataclass
class Request:
    """One queued submission (host-side bookkeeping around a Future)."""

    queries: object               # (n, dim) array, already boundary-checked
    k: int
    tenant: str
    deadline: Optional[Deadline]
    future: Future
    n: int                        # row count (static, pre-pad)
    t_enqueue: float              # time.monotonic at admission
    # per-row validity from the boundary validator under policy "mask"
    # (None under "raise"/"off"); applied to this request's output slice
    ok_rows: Optional[object] = None
    # per-request SpanRecorder minted by Server.submit when tracing is
    # enabled (None otherwise); the batcher closes + flight-records it
    trace: Optional[object] = None
    # packed (n, n_filter_words) int32 admission bitset over global row
    # ids — HOST-side numpy (filters are data, not shape: the batcher
    # copies rows into the bucket's fixed-width filter buffer exactly
    # like query rows).  None = admit everything for this request.
    filter_words: Optional[object] = None

    @property
    def trace_id(self) -> Optional[int]:
        return self.trace.trace_id if self.trace is not None else None


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with quota + shed policy.

    ``max_queue_rows`` bounds the total queued *rows* (the unit the
    executor pays for).  ``quotas`` maps tenant name -> (rate, burst) in
    rows/s; absent tenants are unmetered.
    """

    def __init__(self, max_queue_rows: int,
                 quotas: Optional[Dict[str, Tuple[float, float]]] = None,
                 clock=time.monotonic, brownout=None) -> None:
        self._max_rows = int(max_queue_rows)
        self._clock = clock
        # shared BrownoutState (serving.brownout) — read lock-free per
        # offer; None for a standalone queue (tests, direct use)
        self.brownout = brownout
        self._buckets = {t: TokenBucket(r, b, clock)
                         for t, (r, b) in (quotas or {}).items()}
        self._lock = threading.Lock()
        self.cond = threading.Condition(self._lock)
        self._items: list = []
        self._rows = 0

    # ---- admission ------------------------------------------------------

    def offer(self, req: Request) -> None:
        """Admit or shed (raises :class:`Overloaded` / subclasses).
        Checks are ordered deadline → brownout → quota → queue bound and
        each raises immediately, so a shed request ticks exactly one
        ``serving.shed.*`` counter."""
        bo = self.brownout
        level = bo.level if bo is not None else 0
        if req.deadline is not None and req.deadline.expired:
            _count("serving.shed.deadline")
            _flight.record_event("serving.shed.deadline",
                                 trace_id=req.trace_id,
                                 tenant=req.tenant, rows=req.n,
                                 phase="submit", level=level)
            raise Overloaded(
                "serving: request deadline already expired at submit")
        if (bo is not None and bo.shed_best_effort
                and req.tenant in bo.best_effort_tenants):
            _count("serving.shed.brownout")
            _flight.record_event("serving.shed.brownout",
                                 trace_id=req.trace_id,
                                 tenant=req.tenant, rows=req.n,
                                 level=level)
            raise BrownedOut(
                f"serving: best-effort tenant {req.tenant!r} shed at "
                f"brownout level {level} — retry with backoff")
        bucket = self._buckets.get(req.tenant)
        if bucket is not None and not bucket.try_acquire(req.n):
            _count("serving.shed.quota")
            _flight.record_event("serving.shed.quota",
                                 trace_id=req.trace_id,
                                 tenant=req.tenant, rows=req.n,
                                 rate=bucket.rate, burst=bucket.burst)
            raise QuotaExceeded(
                f"serving: tenant {req.tenant!r} exceeded its quota "
                f"({bucket.rate:g} rows/s, burst {bucket.burst:g})")
        with self.cond:
            if self._rows + req.n > self._max_rows:
                _count("serving.shed.queue_full")
                _flight.record_event("serving.shed.queue_full",
                                     trace_id=req.trace_id,
                                     tenant=req.tenant, rows=req.n,
                                     queued_rows=self._rows,
                                     bound=self._max_rows, level=level)
                raise Overloaded(
                    f"serving: queue full ({self._rows} rows queued, "
                    f"bound {self._max_rows}) — retry with backoff")
            self._items.append(req)
            self._rows += req.n
            _count("serving.admitted")
            if obs.enabled():
                obs.registry().gauge("serving.queue_depth").set(self._rows)
            self.cond.notify_all()

    # ---- dispatcher side (call with ``cond`` held) ----------------------

    def peek_oldest(self) -> Optional[Request]:
        return self._items[0] if self._items else None

    def cut_batch(self, max_rows: int) -> list:
        """Pop the FIFO head run: requests sharing the head's ``k`` whose
        rows fit in ``max_rows``.  Expired requests are popped and
        returned too — the dispatcher completes them with
        DeadlineExceededError without spending bucket rows on them."""
        out, rows, batch_k = [], 0, None
        while self._items:
            head = self._items[0]
            expired = head.deadline is not None and head.deadline.expired
            if not expired:
                if batch_k is not None and head.k != batch_k:
                    break           # k is fixed per bucket; next cut gets it
                if rows + head.n > max_rows:
                    break
                batch_k = head.k
                rows += head.n
            self._items.pop(0)
            self._rows -= head.n
            out.append(head)
        if obs.enabled():
            obs.registry().gauge("serving.queue_depth").set(self._rows)
        return out

    @property
    def rows(self) -> int:
        return self._rows

    def __len__(self) -> int:
        return len(self._items)


def _count(name: str) -> None:
    if obs.enabled():
        obs.registry().counter(name).inc()

"""Metrics registry — counters, gauges, timers, histograms (port of
``raft_tpu.observability.registry``).

NVTX ranges (core/nvtx.hpp) annotate but never aggregate.  Here the
registry *is* the aggregate: ``stage(...)`` (see stage.py) records wall
time per label, library code bumps counters (k-means iterations, fused-scan
fallbacks, canary checks), and the exporters (export.py) serialize a
snapshot to JSON / Prometheus text.

Collection is **off by default** and globally gated: when disabled, the
instrumentation in the library degenerates to a handful of predicate checks
(no timing, no device waits, no ranges beyond the ones that already
existed).  Enable with :func:`enable` / the :func:`collecting` context
manager.

Thread-safety: metric mutation is guarded by a per-registry lock — stages can
close on worker threads.

Windowed telemetry: counters and histograms additionally maintain a
rotating ring of fixed-interval slots, so ``snapshot()["window"]`` exposes
counts and p50/p95/p99 over roughly the last ``interval * slots`` seconds
instead of process lifetime.  Rotation is lazy (on record — no background
thread): each slot remembers the absolute interval index ("epoch") it was
last written in and is zeroed when reused, so an idle metric simply ages out
of the window.

The port has no XLA compile listener, so it records no ``xla.*`` metrics:
nothing here compiles through XLA.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# Window defaults: 12 slots x 5 s = ~60 s of recent history.  Kept cheap:
# one int division + one ring-slot update per record.
WINDOW_INTERVAL_S = 5.0
WINDOW_SLOTS = 12

# Injectable clock (tests monkeypatch this to step time deterministically).
# monotonic matches the serving path's enqueue/deadline clock.
_now = time.monotonic


class Counter:
    """Monotonic counter (e.g. ``kmeans.iterations``).

    Alongside the lifetime total, ``inc`` maintains the rotating window ring
    (see module docstring); :meth:`windowed` reads the recent-interval count.
    Call sites are collection-gated — when ``enabled()`` is False nothing
    calls :meth:`inc`, so a disabled counter costs nothing.
    """

    __slots__ = ("name", "_value", "_lock", "_win_interval", "_win_slots",
                 "_win_epoch", "_win_counts")

    def __init__(self, name: str, lock: threading.RLock,
                 window: Tuple[float, int] = (WINDOW_INTERVAL_S,
                                              WINDOW_SLOTS)) -> None:
        self.name = name
        self._value = 0
        self._lock = lock
        self._win_interval = float(window[0])
        self._win_slots = int(window[1])
        self._win_epoch = [-1] * self._win_slots
        self._win_counts = [0] * self._win_slots

    def inc(self, n: int = 1) -> None:
        epoch = int(_now() / self._win_interval)
        idx = epoch % self._win_slots
        with self._lock:
            self._value += n
            if self._win_epoch[idx] != epoch:
                self._win_epoch[idx] = epoch
                self._win_counts[idx] = 0
            self._win_counts[idx] += n

    @property
    def value(self) -> int:
        return self._value

    def windowed(self) -> int:
        """Count over the last ``interval * slots`` seconds (approximate:
        includes the currently-filling slot, drops whole expired slots)."""
        epoch = int(_now() / self._win_interval)
        lo = epoch - self._win_slots + 1
        with self._lock:
            return sum(c for e, c in zip(self._win_epoch, self._win_counts)
                       if lo <= e <= epoch)


class Gauge:
    """Last-write-wins scalar (e.g. ``cagra.build.pdim``)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.RLock) -> None:
        self.name = name
        self._value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Timer:
    """Duration accumulator: count / total / min / max / last, in seconds."""

    __slots__ = ("name", "count", "total", "min", "max", "last", "_lock")

    def __init__(self, name: str, lock: threading.RLock) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self.last = 0.0
        self._lock = lock

    def record(self, seconds: float) -> None:
        seconds = float(seconds)
        with self._lock:
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)
            self.last = seconds

    def as_dict(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total_s": self.total,
            "min_s": self.min if self.count else 0.0,
            "max_s": self.max,
            "last_s": self.last,
        }


# Default histogram buckets: log-spaced (factor 2) from 1 µs to ~67 s —
# wide enough for both per-query serving latencies and build stages.  27
# finite upper bounds + one overflow bucket; fixed at construction so
# ``observe`` is one bisect + one increment under the registry lock.
DEFAULT_HISTOGRAM_BOUNDS: Tuple[float, ...] = tuple(
    1e-6 * 2.0 ** i for i in range(27))


def _quantile_of(counts: Sequence[int], count: int,
                 bounds: Sequence[float], maxv: float, q: float) -> float:
    """Linear-interpolated quantile over a bucket-count vector (0.0 when
    empty).  Shared by the lifetime and windowed views — caller holds the
    lock (or owns a private copy)."""
    if count == 0:
        return 0.0
    target = q * count
    seen = 0.0
    for i, c in enumerate(counts):
        if seen + c >= target and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else maxv
            frac = (target - seen) / c
            return min(lo + frac * (hi - lo), maxv)
        seen += c
    return maxv


class Histogram:
    """Fixed-bucket distribution (e.g. ``serving.latency.total``).

    Log-spaced upper bounds by default (:data:`DEFAULT_HISTOGRAM_BOUNDS`);
    values are dimensionless to the registry — record seconds for
    latencies, rows for batch fills.  Like every metric here the *call
    sites* are collection-gated: while ``enabled()`` is False no library
    code calls :meth:`observe`, so a disabled histogram is zero work.

    Quantiles (p50/p95/p99) are estimated by linear interpolation inside
    the target bucket — resolution is the bucket width (a factor of 2 by
    default), which is the standard Prometheus-histogram tradeoff.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max",
                 "_lock", "_win_interval", "_win_slots", "_win_epoch",
                 "_win_counts", "_win_n", "_win_sum", "_win_max")

    def __init__(self, name: str, lock: threading.RLock,
                 bounds: Optional[Sequence[float]] = None,
                 window: Tuple[float, int] = (WINDOW_INTERVAL_S,
                                              WINDOW_SLOTS)) -> None:
        self.name = name
        self.bounds = tuple(float(b) for b in
                            (bounds if bounds is not None
                             else DEFAULT_HISTOGRAM_BOUNDS))
        assert list(self.bounds) == sorted(self.bounds), \
            "histogram bounds must be sorted"
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        self._lock = lock
        self._win_interval = float(window[0])
        self._win_slots = int(window[1])
        self._win_epoch = [-1] * self._win_slots
        self._win_counts: List[List[int]] = [
            [0] * len(self.counts) for _ in range(self._win_slots)]
        self._win_n = [0] * self._win_slots
        self._win_sum = [0.0] * self._win_slots
        self._win_max = [0.0] * self._win_slots

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        epoch = int(_now() / self._win_interval)
        widx = epoch % self._win_slots
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            if self._win_epoch[widx] != epoch:
                self._win_epoch[widx] = epoch
                self._win_counts[widx] = [0] * len(self.counts)
                self._win_n[widx] = 0
                self._win_sum[widx] = 0.0
                self._win_max[widx] = 0.0
            self._win_counts[widx][idx] += 1
            self._win_n[widx] += 1
            self._win_sum[widx] += value
            self._win_max[widx] = max(self._win_max[widx], value)

    def quantile(self, q: float) -> float:
        """Estimated value at quantile ``q`` in [0, 1] (0.0 when empty)."""
        with self._lock:
            return _quantile_of(self.counts, self.count, self.bounds,
                                self.max, q)

    def as_dict(self) -> Dict[str, object]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "bounds": list(self.bounds),
                "counts": list(self.counts),
            }

    def windowed_dict(self) -> Dict[str, object]:
        """Distribution over the last ``interval * slots`` seconds only:
        count / sum / max and interpolated p50/p95/p99 (same estimator as
        the lifetime view, over the merged in-window bucket vectors)."""
        epoch = int(_now() / self._win_interval)
        lo = epoch - self._win_slots + 1
        with self._lock:
            counts = [0] * len(self.counts)
            n = 0
            total = 0.0
            mx = 0.0
            for i in range(self._win_slots):
                if lo <= self._win_epoch[i] <= epoch:
                    for j, c in enumerate(self._win_counts[i]):
                        counts[j] += c
                    n += self._win_n[i]
                    total += self._win_sum[i]
                    mx = max(mx, self._win_max[i])
            return {
                "count": n,
                "sum": total,
                "max": mx,
                "p50": _quantile_of(counts, n, self.bounds, mx, 0.50),
                "p95": _quantile_of(counts, n, self.bounds, mx, 0.95),
                "p99": _quantile_of(counts, n, self.bounds, mx, 0.99),
            }


class MetricsRegistry:
    """Named metric store with get-or-create accessors and snapshot/reset.

    ``window_interval_s`` / ``window_slots`` fix the rotating-window layout
    for every counter/histogram created by this registry (see module
    docstring); the merged recent-interval view is the ``"window"`` section
    of :meth:`snapshot`.
    """

    def __init__(self, *, window_interval_s: float = WINDOW_INTERVAL_S,
                 window_slots: int = WINDOW_SLOTS) -> None:
        self._lock = threading.RLock()
        self._window = (float(window_interval_s), int(window_slots))
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name, self._lock,
                                                   self._window)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name, self._lock)
            return m

    def timer(self, name: str) -> Timer:
        with self._lock:
            m = self._timers.get(name)
            if m is None:
                m = self._timers[name] = Timer(name, self._lock)
            return m

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create; ``bounds`` applies only at creation (the first
        caller fixes the bucket layout, like a Prometheus registration)."""
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, self._lock,
                                                       bounds, self._window)
            return m

    def snapshot(self) -> Dict[str, Dict]:
        """Point-in-time copy: plain dicts, safe to mutate / serialize.

        The ``"window"`` section re-aggregates counters and histograms over
        the rotating recent interval only (``span_s`` seconds); the other
        sections remain process-lifetime."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "timers": {n: t.as_dict() for n, t in self._timers.items()},
                "histograms": {n: h.as_dict()
                               for n, h in self._histograms.items()},
                "window": {
                    "interval_s": self._window[0],
                    "span_s": self._window[0] * self._window[1],
                    "counters": {n: c.windowed()
                                 for n, c in self._counters.items()},
                    "histograms": {n: h.windowed_dict()
                                   for n, h in self._histograms.items()},
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# global default registry + collection gate

_REGISTRY = MetricsRegistry()
_ENABLED = False


def registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _REGISTRY


def enabled() -> bool:
    """Whether collection is on.  Instrumented call sites check this before
    doing any work; False (the default) means zero fences and zero timing."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def collecting(reg: Optional[MetricsRegistry] = None) -> Iterator[MetricsRegistry]:
    """Enable collection for the body, restoring the previous state after.

    Yields the registry metrics are recorded into (the global one — per-call
    registries compose via snapshot diffs, see report.py)."""
    prev = _ENABLED
    enable()
    try:
        yield reg if reg is not None else _REGISTRY
    finally:
        if not prev:
            disable()


def snapshot() -> Dict[str, Dict]:
    """Snapshot of the global registry."""
    return _REGISTRY.snapshot()


def reset() -> None:
    """Reset the global registry (collection gate is unaffected)."""
    _REGISTRY.reset()

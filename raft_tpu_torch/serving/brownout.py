"""Brownout control — adaptive overload degradation for the serving path
(port of ``raft_tpu.serving.brownout``).

Static admission sheds requests outright when offered load beats
capacity, so goodput collapses instead of degrading.  This module adds
the missing control loop: a :class:`BrownoutController` watches the
windowed telemetry — ``serving.latency.total`` window p99, the
``serving.queue_depth`` gauge (read directly off the queue), and the
windowed ``serving.shed.*`` counters — and steps the serving bucket
down/up a **pre-declared degradation ladder** of operating points::

    ladder = [
        brownout.Rung("full"),                          # rung 0: full quality
        brownout.Rung("probes/2", params=half_probes),  # reduced n_probes
        brownout.Rung("probes/4", params=quarter),      # cheaper still
        brownout.Rung("shed-best-effort",               # same executables,
                      shed_best_effort=True),           # + tenant shedding
    ]
    ctl = brownout.BrownoutController(server, ladder,
                                      brownout.BrownoutConfig(...),
                                      best_effort_tenants={"batch"})
    server.start()        # warms EVERY rung through the AOT cache
    ctl.start()           # control loop: evaluate() every interval_s

Declare-then-warm is the whole design: the ladder is fixed before
``Server.start()``, every rung's executables are pre-warmed through
:class:`~raft_tpu_torch.core.aot.ExecutableCache` (the rung is part of the
cache key, like ``scan_mode``), and a brownout transition is ONE
integer store read by the batcher on its next cut — zero new captures,
zero host syncs, the same closed-shape discipline the buckets keep.  A
:class:`Rung` with ``params=None`` inherits the previous rung's
executables (no extra warmup); a rung with
``shed_best_effort=True`` additionally sheds requests from the
best-effort tenant set at admission (``serving.shed.brownout``).

Flapping is pinned two ways: **hysteresis** (the step-up threshold
``step_up_p99_s`` must sit strictly below the step-down threshold
``step_down_p99_s``, and likewise the queue fractions) and **dwell
time** (``dwell_s`` must elapse at a level before the next transition
in either direction).  Transitions land ``serving.brownout.step_down``
/ ``serving.brownout.step_up`` events in the always-on flight recorder
and move the ``serving.brownout.level`` gauge; per-level residency is
tracked for :meth:`BrownoutController.stats`.

The controller is deliberately NOT in the request path: it reads
aggregated telemetry on its own thread (or under a test's synchronous
:meth:`~BrownoutController.evaluate` calls with an injected clock) and
publishes one small state object the hot path reads lock-free.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.observability import flight as _flight

#: the serving.shed.* counters that signal OVERLOAD (quota sheds are
#: policy, not pressure, and must not brown the bucket out)
_PRESSURE_SHEDS = ("serving.shed.deadline", "serving.shed.queue_full")


@dataclasses.dataclass(frozen=True)
class Rung:
    """One declared operating point on the degradation ladder.

    ``params`` is a SearchParams variant (e.g. ``n_probes`` halved,
    ``kt`` reduced, refinement off) captured as its own executable rung;
    ``None`` inherits the previous rung's executables — the idiom for a
    shed-only top rung.  ``shed_best_effort`` turns on admission-time
    shedding of the best-effort tenant set while this rung is active;
    ``shed_best_effort_writes`` does the same for the WRITE path — the
    ingest tier (:mod:`raft_tpu_torch.serving.ingest`) sheds best-effort
    tenants' writes with ``BrownedOut`` while the rung holds, keeping
    fold pressure off an already-degraded read path.
    """

    name: str
    params: Optional[object] = None
    shed_best_effort: bool = False
    shed_best_effort_writes: bool = False


class BrownoutState:
    """The one object the hot path reads: current ladder level, the
    executor rung serving it, and the best-effort shed switch.  Plain
    attribute stores/loads (GIL-atomic) — admission and the batcher read
    it lock-free on every request/cut."""

    __slots__ = ("level", "rung", "shed_best_effort",
                 "shed_best_effort_writes", "best_effort_tenants")

    def __init__(self, best_effort_tenants: Iterable[str] = ()) -> None:
        self.level = 0
        self.rung = 0
        self.shed_best_effort = False
        self.shed_best_effort_writes = False
        self.best_effort_tenants: FrozenSet[str] = frozenset(
            best_effort_tenants)


@dataclasses.dataclass
class BrownoutConfig:
    """Control-loop knobs.  Hysteresis is enforced at validation: the
    step-up (recovery) thresholds must sit strictly below the step-down
    (pressure) thresholds, and ``dwell_s`` must elapse at a level before
    the next transition — together they pin ladder oscillation.
    """

    #: window p99 of ``serving.latency.total`` (seconds) at/above which
    #: the controller steps DOWN (degrades)
    step_down_p99_s: float = 0.5
    #: window p99 (seconds) at/below which it may step UP (recover);
    #: must be < step_down_p99_s (the hysteresis gap)
    step_up_p99_s: float = 0.1
    #: queued-rows fraction of ``max_queue_rows`` at/above which the
    #: controller steps down even before latency moves
    queue_high_fraction: float = 0.5
    #: queued-rows fraction at/below which recovery is allowed;
    #: must be < queue_high_fraction
    queue_low_fraction: float = 0.125
    #: windowed pressure-shed count (deadline + queue_full) that forces
    #: a step down regardless of latency
    shed_step_down: int = 1
    #: minimum seconds at a level before ANY further transition
    dwell_s: float = 2.0
    #: control-loop period for the background thread
    interval_s: float = 1.0

    def validate(self) -> None:
        expects(self.step_up_p99_s < self.step_down_p99_s,
                "brownout: step_up_p99_s must be below step_down_p99_s "
                "(the hysteresis gap)")
        expects(0.0 < self.queue_low_fraction < self.queue_high_fraction
                <= 1.0,
                "brownout: need 0 < queue_low_fraction < "
                "queue_high_fraction <= 1")
        expects(self.dwell_s >= 0.0, "brownout: dwell_s must be >= 0")
        expects(self.interval_s > 0.0, "brownout: interval_s must be > 0")
        expects(self.shed_step_down >= 1,
                "brownout: shed_step_down must be >= 1")


class BrownoutController:
    """Steps one :class:`~raft_tpu_torch.serving.server.Server` down/up its
    declared ladder.  Construct BEFORE ``server.start()`` — installing
    the ladder grows the executor's closed rung set, which must be
    warmed with everything else."""

    def __init__(self, server, ladder: Sequence[Rung],
                 config: Optional[BrownoutConfig] = None, *,
                 best_effort_tenants: Iterable[str] = (),
                 clock=time.monotonic) -> None:
        expects(len(ladder) >= 2,
                "brownout: a ladder needs at least a full-quality rung "
                "and one degraded rung")
        expects(ladder[0].params is None and not ladder[0].shed_best_effort
                and not ladder[0].shed_best_effort_writes,
                "brownout: rung 0 must be the undegraded operating point "
                "(params=None, no shedding)")
        self.server = server
        self.ladder = tuple(ladder)
        self.config = config or BrownoutConfig()
        self.config.validate()
        self._clock = clock
        # resolve ladder levels onto executor rungs: params=None inherits
        # the previous level's executables, so a shed-only rung costs no
        # extra warmup and no extra cache entries
        exec_params: List[object] = []
        self._exec_rung: List[int] = [0]
        for r in self.ladder[1:]:
            if r.params is not None:
                exec_params.append(r.params)
                self._exec_rung.append(len(exec_params))
            else:
                self._exec_rung.append(self._exec_rung[-1])
        server.executor.set_ladder(exec_params)
        self.state = server.brownout
        self.state.best_effort_tenants = frozenset(best_effort_tenants)
        now = clock()
        self._t_level = now            # when the current level was entered
        self._residency = [0.0] * len(self.ladder)
        self._transitions = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- telemetry reads -------------------------------------------------

    def _latency_p99(self) -> Optional[float]:
        """Window p99 of end-to-end serving latency, or None when
        collection is off or the window is empty (no latency signal —
        the queue and shed signals still steer)."""
        if not obs.enabled():
            return None
        w = obs.registry().histogram("serving.latency.total").windowed_dict()
        if not w["count"]:
            return None
        return float(w["p99"])

    def _pressure_sheds(self) -> int:
        """Windowed deadline + queue_full shed count (quota sheds are
        excluded — tenant policy is not overload)."""
        if not obs.enabled():
            return 0
        reg = obs.registry()
        return sum(reg.counter(name).windowed() for name in _PRESSURE_SHEDS)

    # ---- the control decision --------------------------------------------

    def evaluate(self) -> Optional[str]:
        """One control decision from current telemetry; called by the
        background loop every ``interval_s`` (or synchronously by tests
        with an injected clock).  Returns ``"step_down"``, ``"step_up"``
        or None."""
        now = self._clock()
        with self._lock:
            level = self.state.level
            if now - self._t_level < self.config.dwell_s:
                return None        # dwell pins flapping in BOTH directions
            p99 = self._latency_p99()
            queue_rows = self.server.queue.rows
            max_rows = self.server.config.max_queue_rows
            sheds = self._pressure_sheds()
            pressed = (
                (p99 is not None and p99 >= self.config.step_down_p99_s)
                or queue_rows >= self.config.queue_high_fraction * max_rows
                or sheds >= self.config.shed_step_down)
            if pressed and level < len(self.ladder) - 1:
                self._apply(level + 1, "step_down", now,
                            p99=p99, queue_rows=queue_rows, sheds=sheds)
                return "step_down"
            calm = (
                (p99 is None or p99 <= self.config.step_up_p99_s)
                and queue_rows <= self.config.queue_low_fraction * max_rows
                and sheds == 0)
            if calm and level > 0:
                self._apply(level - 1, "step_up", now,
                            p99=p99, queue_rows=queue_rows, sheds=sheds)
                return "step_up"
            return None

    def _apply(self, new_level: int, direction: str, now: float, *,
               p99: Optional[float], queue_rows: int, sheds: int) -> None:
        """Publish one transition (caller holds the lock).  Ordering
        matters: the rung store happens before the level store so a
        racing batch cut never pairs a new level with a stale rung."""
        old = self.state.level
        self._residency[old] += now - self._t_level
        self._t_level = now
        self._transitions += 1
        rung = self.ladder[new_level]
        self.state.rung = self._exec_rung[new_level]
        self.state.shed_best_effort = rung.shed_best_effort
        self.state.shed_best_effort_writes = rung.shed_best_effort_writes
        self.state.level = new_level
        if obs.enabled():
            obs.registry().gauge("serving.brownout.level").set(new_level)
        # always-on anomaly event: a quality change is exactly what a
        # post-mortem needs to see next to the latency it reacted to
        _flight.record_event(f"serving.brownout.{direction}",
                             from_level=old, to_level=new_level,
                             rung=rung.name, p99_s=p99,
                             queue_rows=queue_rows, window_sheds=sheds)
        shadow = getattr(self.server, "shadow", None)
        if shadow is not None:
            # close the quality window at the rung boundary so one
            # operating-point record never pools samples served at two
            # different operating points (flag only — the flush itself
            # runs on the shadow thread, never under this lock)
            shadow.mark_transition()

    # ---- background loop -------------------------------------------------

    def start(self) -> "BrownoutController":
        """Run :meth:`evaluate` every ``interval_s`` on a daemon thread
        (the rebalancer's lifecycle pattern)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="raft-tpu-brownout",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=30.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            self.evaluate()

    def __enter__(self) -> "BrownoutController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- introspection ---------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Level, transition count, and per-level residency seconds
        (the current level's open interval included)."""
        now = self._clock()
        with self._lock:
            res = list(self._residency)
            res[self.state.level] += now - self._t_level
            return {
                "level": self.state.level,
                "rung": self.ladder[self.state.level].name,
                "transitions": self._transitions,
                "residency_s": {self.ladder[i].name: res[i]
                                for i in range(len(self.ladder))},
            }

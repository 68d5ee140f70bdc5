"""Shard health lifecycle (port of ``raft_tpu.distributed.health``): a
per-shard state machine::

    HEALTHY --strikes--> SUSPECT --strikes--> FAILED
       ^                    |                    |
       |<---consecutive OKs-+     begin_catch_up v
       |                                    CATCHING_UP
       +<----- readmit (canary-gated swap) ------+

driven by the evidence the search path produces: per-shard deadline
overruns (``distributed.shard_timeout``), straggler flags from the fault
plan's schedule, and failed ``health_check`` canaries.  Flapping is pinned
two ways: **hysteresis** (strikes escalate one state at a time; clearing
SUSPECT takes ``ok_to_clear`` *consecutive* passes) and **dwell time**
(``dwell_s`` must elapse in a state before the next transition in either
direction).  Every transition records a ``distributed.health.*`` flight
event and, under collection, the counter of the same name.

The tracker is plain Python under one lock, with an injected clock, and
never touches a device.  With one process a rank, each rank keeps its own
tracker: the by-row ``search`` and ``health_check``
(:mod:`raft_tpu_torch.distributed.ann`) feed every rank the same evidence
in the same order (the fault plan, seeded alike on every rank, gives each
the same straggler schedule; the canary reports are allgathered), so the
ranks' trackers stay identical and every rank computes the same failed set.

Readmission is anti-entropy catch-up: :func:`catch_up` rebuilds the
routed index with the recovering shard's lists from the live replicas
(the gathered global lists are the authoritative state) under **one**
placement-generation bump; :func:`readmit` canary-gates the caught-up
index and installs it through ``server.swap_index``.  Both are
collective over the ranks (the gather, the canary search).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.resilience import faults

#: shard lifecycle states (strings, as in the JAX package: they appear
#: verbatim in flight-event attrs, stats dicts and test assertions)
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
FAILED = "FAILED"
CATCHING_UP = "CATCHING_UP"


def _emit(event: str, **attrs) -> None:
    """The paired transition signal: one always-on flight event plus the
    same-named counter (under collection)."""
    _flight.record_event(event, **attrs)
    if obs.enabled():
        obs.registry().counter(event).inc()


@dataclasses.dataclass
class HealthConfig:
    """State-machine knobs (the JAX package's fields and defaults)."""

    #: evidence strikes at/above which a HEALTHY shard turns SUSPECT (one
    #: deadline overrun or canary failure counts this many; a straggle
    #: flag counts one)
    suspect_after: int = 2
    #: further strikes (counted from SUSPECT entry) at/above which a
    #: SUSPECT shard is declared FAILED
    fail_after: int = 3
    #: consecutive OK verdicts clearing SUSPECT back to HEALTHY
    ok_to_clear: int = 2
    #: minimum residency in a state before the next transition in either
    #: direction (0 = transitions are immediate)
    dwell_s: float = 0.0

    def validate(self) -> "HealthConfig":
        expects(self.suspect_after >= 1,
                "health: suspect_after must be >= 1")
        expects(self.fail_after >= 1, "health: fail_after must be >= 1")
        expects(self.ok_to_clear >= 1, "health: ok_to_clear must be >= 1")
        expects(self.dwell_s >= 0.0, "health: dwell_s must be >= 0")
        return self


class HealthTracker:
    """Per-shard lifecycle state machine.  Thread-safe; the clock is
    injected so tests drive dwell deterministically."""

    def __init__(self, n_shards: int,
                 config: Optional[HealthConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        expects(n_shards >= 1, "health: n_shards must be >= 1")
        self.config = (config or HealthConfig()).validate()
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._state: List[str] = [HEALTHY] * n_shards
        self._strikes: List[int] = [0] * n_shards
        self._oks: List[int] = [0] * n_shards
        self._since: List[float] = [now] * n_shards
        self._transitions: Dict[str, int] = {}
        # per-shard load demotion (note_overload): a score penalty the
        # routing policy reads back, not a lifecycle state
        self._load_penalty: List[float] = [0.0] * n_shards

    def _count(self, event: str) -> None:
        self._transitions[event] = self._transitions.get(event, 0) + 1

    # -- evidence ----------------------------------------------------------
    def note_straggle(self, shard: int) -> None:
        """Soft evidence: the straggler detector flagged ``shard`` (one
        strike)."""
        self._strike(shard, "straggle", weight=1)

    def note_timeout(self, shard: int) -> None:
        """Hard evidence: ``shard`` overran its per-shard search deadline
        (``suspect_after`` strikes)."""
        self._strike(shard, "timeout", weight=self.config.suspect_after)

    def note_canary_failure(self, shard: int) -> None:
        """Hard evidence: a recall canary attributed to ``shard`` failed.
        Records ``integrity.canary_failure`` with the shard id and strikes
        like a timeout."""
        _flight.record_event("integrity.canary_failure", shard=int(shard))
        if obs.enabled():
            obs.registry().counter("integrity.canary_failure").inc()
        self._strike(shard, "canary", weight=self.config.suspect_after)

    def note_write_error(self, shard: int) -> None:
        """Hard evidence from the distributed write path: ``shard`` failed
        to make a write durable; strikes like a timeout."""
        self._strike(shard, "write", weight=self.config.suspect_after)

    def note_overload(self, shard: int, load: float) -> None:
        """Soft evidence from the routing policy: ``shard``'s planned load
        runs at ``load`` times the mean.  Folds the excess into the
        shard's load penalty (an EWMA clamped at zero) and escalates at
        most to SUSPECT: overload never fails a shard."""
        s = int(shard)
        load = float(load)
        event = None
        strikes = 0
        with self._lock:
            if self._state[s] in (FAILED, CATCHING_UP):
                return
            self._load_penalty[s] = max(
                0.0, 0.7 * self._load_penalty[s] + 0.3 * (load - 1.0))
            now = self._clock()
            if (self._state[s] == HEALTHY
                    and now - self._since[s] >= self.config.dwell_s):
                self._oks[s] = 0
                self._strikes[s] += 1
                strikes = self._strikes[s]
                if strikes >= self.config.suspect_after:
                    self._state[s] = SUSPECT
                    self._since[s] = now
                    self._strikes[s] = 0
                    event = "distributed.health.suspect"
                    self._count(event)
        if event:
            _emit(event, shard=s, cause="load", strikes=strikes)

    def note_ok(self, shard: int) -> None:
        """A passing verdict: resets the strike run; ``ok_to_clear``
        consecutive OKs clear SUSPECT back to HEALTHY (after dwell)."""
        s = int(shard)
        recovered = False
        with self._lock:
            self._load_penalty[s] *= 0.7
            if self._state[s] == SUSPECT:
                self._oks[s] += 1
                now = self._clock()
                if (self._oks[s] >= self.config.ok_to_clear
                        and now - self._since[s] >= self.config.dwell_s):
                    self._state[s] = HEALTHY
                    self._since[s] = now
                    self._strikes[s] = 0
                    self._oks[s] = 0
                    self._count("distributed.health.recovered")
                    recovered = True
            elif self._state[s] == HEALTHY:
                self._strikes[s] = 0
        if recovered:
            _emit("distributed.health.recovered", shard=s)

    def _strike(self, shard: int, cause: str, *, weight: int) -> None:
        s = int(shard)
        event = None
        strikes = 0
        with self._lock:
            if self._state[s] in (FAILED, CATCHING_UP):
                return
            self._oks[s] = 0
            self._strikes[s] += weight
            strikes = self._strikes[s]
            now = self._clock()
            if now - self._since[s] < self.config.dwell_s:
                return  # dwell pins the state; strikes keep accruing
            if (self._state[s] == HEALTHY
                    and strikes >= self.config.suspect_after):
                self._state[s] = SUSPECT
                event = "distributed.health.suspect"
            elif (self._state[s] == SUSPECT
                    and strikes >= self.config.fail_after):
                self._state[s] = FAILED
                event = "distributed.health.failed"
            if event:
                self._since[s] = now
                self._strikes[s] = 0
                self._count(event)
        if event:
            _emit(event, shard=s, cause=cause, strikes=strikes)

    # -- readmission lifecycle ---------------------------------------------
    def begin_catch_up(self, shard: int, **attrs) -> None:
        """FAILED -> CATCHING_UP: the shard stays out of the routing until
        :meth:`readmit`."""
        s = int(shard)
        with self._lock:
            expects(self._state[s] == FAILED,
                    f"health: shard {s} is {self._state[s]}, only a "
                    f"FAILED shard can begin catch-up")
            self._state[s] = CATCHING_UP
            self._since[s] = self._clock()
            self._count("distributed.health.catch_up")
        _emit("distributed.health.catch_up", shard=s, **attrs)

    def readmit(self, shard: int) -> None:
        """CATCHING_UP -> HEALTHY: the canary gate passed; routing
        resumes."""
        s = int(shard)
        with self._lock:
            expects(self._state[s] == CATCHING_UP,
                    f"health: shard {s} is {self._state[s]}, only a "
                    f"CATCHING_UP shard can be readmitted")
            self._state[s] = HEALTHY
            self._since[s] = self._clock()
            self._strikes[s] = 0
            self._oks[s] = 0
            self._count("distributed.health.readmitted")
        _emit("distributed.health.readmitted", shard=s)

    def block_readmit(self, shard: int, reason: str = "canary") -> None:
        """CATCHING_UP -> FAILED: the readmission canary gate failed."""
        s = int(shard)
        with self._lock:
            expects(self._state[s] == CATCHING_UP,
                    f"health: shard {s} is {self._state[s]}, only a "
                    f"CATCHING_UP readmission can be blocked")
            self._state[s] = FAILED
            self._since[s] = self._clock()
            self._count("distributed.health.readmit_blocked")
        _emit("distributed.health.readmit_blocked", shard=s,
              reason=reason)

    # -- views -------------------------------------------------------------
    def state(self, shard: int) -> str:
        with self._lock:
            return self._state[int(shard)]

    def states(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._state)

    def failed_shards(self) -> Tuple[int, ...]:
        """Shards the search treats as down: FAILED and CATCHING_UP."""
        with self._lock:
            return tuple(s for s, st in enumerate(self._state)
                         if st in (FAILED, CATCHING_UP))

    def suspect_shards(self) -> Tuple[int, ...]:
        """Shards under suspicion: still searched."""
        with self._lock:
            return tuple(s for s, st in enumerate(self._state)
                         if st == SUSPECT)

    def load_penalties(self) -> Tuple[float, ...]:
        """Per-shard overload demotion (:meth:`note_overload`)."""
        with self._lock:
            return tuple(self._load_penalty)

    def stats(self) -> Dict[str, object]:
        """Per-shard state, strike run and load penalty, and the
        cumulative transition counts."""
        with self._lock:
            return {"states": tuple(self._state),
                    "strikes": tuple(self._strikes),
                    "load_penalties": tuple(self._load_penalty),
                    "transitions": dict(self._transitions)}


# ---------------------------------------------------------------------------
# anti-entropy readmission


def catch_up(handle, index, shard: int, *,
             tracker: Optional[HealthTracker] = None,
             stale=None, ingest=None):
    """Anti-entropy catch-up for recovering ``shard`` of a routed index:
    its lists rebuilt from the live index (whose replicas hold every list
    the shard owned) and the index re-placed under **one**
    placement-generation bump (:func:`~raft_tpu_torch.distributed.ann.
    rebalance_placement`, collective).  Returns the caught-up
    :class:`~raft_tpu_torch.distributed.ann.RoutedIndex`, not yet
    published: route it through :func:`readmit`.

    ``stale`` (the snapshot the shard went down holding, if kept) feeds
    the ``generation_delta`` of the ``distributed.health.catch_up``
    event.  ``ingest`` (the distributed write path's WAL replay) is not
    ported yet."""
    from raft_tpu_torch.distributed import ann
    if ingest is not None:
        raise not_ported("distributed.health.catch_up", "ingest=",
                         "distributed (item 7)")
    expects(index.placement is not None,
            "health.catch_up: index carries no placement map")
    faults.maybe_fail("distributed.catch_up")
    delta = _mutate.generation(index) - (
        _mutate.generation(stale) if stale is not None else
        _mutate.generation(index))
    if tracker is not None:
        tracker.begin_catch_up(shard, generation_delta=delta)
    placement = dataclasses.replace(
        index.placement, generation=index.placement.generation + 1)
    # one generation bump: the gathered global lists (replicas hold the
    # dead shard's) re-placed under the bumped placement, the index
    # stamped with its next generation
    return ann.rebalance_placement(handle, index, placement=placement)


def readmit(handle, server, index, shard: int, *,
            tracker: Optional[HealthTracker] = None) -> bool:
    """Canary-gated readmission: health-check the caught-up ``index``
    (collective); on pass publish it through ``server.swap_index`` (any
    object with that method) and move the tracker CATCHING_UP -> HEALTHY.
    On a canary failure the shard goes back to FAILED
    (``distributed.health.readmit_blocked``) and nothing is published.
    Returns True when routing resumed."""
    from raft_tpu_torch.distributed import ann
    faults.maybe_fail("distributed.swap")
    reports = ann.health_check(handle, index, raise_on_fail=False,
                               health=None)
    ok = all(r is None or r.ok for r in (reports or []))
    if not ok:
        if tracker is not None:
            tracker.block_readmit(shard, reason="canary")
        else:
            _emit("distributed.health.readmit_blocked", shard=int(shard),
                  reason="canary")
        return False
    server.swap_index(index)
    if tracker is not None:
        tracker.readmit(shard)
    else:
        _emit("distributed.health.readmitted", shard=int(shard))
    return True

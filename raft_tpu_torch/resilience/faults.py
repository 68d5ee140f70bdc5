"""Deterministic fault injection at named library sites (port of
``raft_tpu.resilience.faults``).

Library code calls :func:`maybe_fail(site)` at well-known points; with no
plan active the call is one ``None`` check, so the search path pays
nothing.  The port's sites:

======================================  ====================================
site                                    where it fires
======================================  ====================================
``interruptible.synchronize``           every ``interruptible.synchronize``
                                        host sync point
``serialize.write`` /                   every record written / read by
``serialize.read``                      :mod:`raft_tpu_torch.core.serialize`
``checkpoint.save`` /                   every :class:`CheckpointManager`
``checkpoint.load``                     stage persisted / restored
======================================  ====================================

Scripting is explicit and deterministic::

    plan = FaultPlan(seed=7).at("serialize.write", times=1)
    with plan.active():
        ...   # the first record written raises TransientFault

``times`` bounds how often a spec fires, ``after`` skips the first N
matching calls ("fail the 2nd synchronize"), and ``p`` draws from the
plan's seeded RNG (``RAFT_TPU_FAULT_SEED`` pins the default seed) so a
probabilistic schedule replays identically.  :meth:`FaultPlan.delay_at`
scripts a spec that sleeps ``delay + jitter * rng()`` seconds instead of
raising; :meth:`FaultPlan.straggle_shard`, :meth:`FaultPlan.fail_shards`,
:meth:`FaultPlan.kill_shard_at` and :meth:`FaultPlan.flap_shard` script
the per-shard failures that :func:`failed_shards`,
:func:`straggler_delays` and :func:`straggler_pause` report to a
distributed search.  All sleeping goes through the monkeypatchable
``_sleep`` seam.

Each firing is counted in the observability registry
(``resilience.fault.injected.<site>`` / ``.delayed.<site>``), as in the
JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from raft_tpu_torch.core.error import RaftError

_SEED_ENV = "RAFT_TPU_FAULT_SEED"

# test seam: fault delays pause through this so latency tests can count
# sleeps without slowing the suite down
_sleep = time.sleep


class FaultInjected(RaftError):
    """Base class for injected failures (never raised organically)."""


class TransientFault(FaultInjected):
    """An injected failure that retry wrappers treat as retryable — the
    scripted analogue of a flaky collective / flaky filesystem."""


@dataclasses.dataclass
class FaultSpec:
    """One scripted failure: fire at ``site`` up to ``times`` times (None =
    unbounded), skipping the first ``after`` matching calls, each firing
    gated by probability ``p`` from the plan's seeded RNG.  ``exc`` is an
    exception class or zero/one-arg factory.

    A spec with ``delay > 0`` (or ``jitter > 0``) is a *latency* spec: it
    sleeps ``delay + jitter * rng()`` seconds when it fires (``exc`` is
    ignored).  A spec with ``_kill_shard`` set (:meth:`FaultPlan.
    kill_shard_at`) adds the shard to the plan's failed-shard set when it
    fires instead of raising."""

    site: str
    times: Optional[int] = 1
    exc: Callable[..., BaseException] = TransientFault
    after: int = 0
    p: float = 1.0
    delay: float = 0.0
    jitter: float = 0.0
    _kill_shard: Optional[int] = None
    _seen: int = 0
    _fired: int = 0

    def matches(self, site: str) -> bool:
        return self.site == site

    @property
    def is_delay(self) -> bool:
        return self.delay > 0.0 or self.jitter > 0.0

    @property
    def fired(self) -> int:
        """How many times this spec has fired (for test assertions)."""
        return self._fired


class FaultPlan:
    """An ordered set of :class:`FaultSpec` plus failed-shard flags,
    activated via :meth:`active` (or :func:`inject`).  Thread-safe: sites
    may be hit from worker threads."""

    def __init__(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = int(os.environ.get(_SEED_ENV, "0"))
        self.seed = seed
        self._rng = random.Random(seed)
        self._specs: List[FaultSpec] = []
        self._failed_shards: set = set()
        self._stragglers: Dict[int, Tuple[float, float]] = {}
        self._flapping: Dict[int, int] = {}   # shard -> poll period
        self._flap_polls = 0
        self._lock = threading.Lock()

    # -- scripting ---------------------------------------------------------
    def at(self, site: str, *, times: Optional[int] = 1,
           exc: Callable[..., BaseException] = TransientFault,
           after: int = 0, p: float = 1.0) -> "FaultPlan":
        """Script a failure at ``site``; returns self for chaining."""
        self._specs.append(FaultSpec(site=site, times=times, exc=exc,
                                     after=after, p=p))
        return self

    def delay_at(self, site: str, *, delay: float, jitter: float = 0.0,
                 times: Optional[int] = None, after: int = 0,
                 p: float = 1.0) -> "FaultPlan":
        """Script injected latency at ``site``: each firing sleeps ``delay
        + jitter * rng()`` seconds (unbounded by default).  Returns self
        for chaining."""
        if delay < 0 or jitter < 0:
            raise ValueError("delay and jitter must be non-negative")
        self._specs.append(FaultSpec(site=site, times=times, after=after,
                                     p=p, delay=delay, jitter=jitter))
        return self

    def straggle_shard(self, shard: int, *, delay: float,
                       jitter: float = 0.0) -> "FaultPlan":
        """Make shard ``shard`` a straggler: every routed search pauses
        ``delay + jitter * rng()`` seconds before its merge (via
        :func:`straggler_pause`); its results still merge, exactly."""
        if delay < 0 or jitter < 0:
            raise ValueError("delay and jitter must be non-negative")
        self._stragglers[int(shard)] = (float(delay), float(jitter))
        return self

    def fail_shards(self, *shards: int) -> "FaultPlan":
        """Flag shards as failed: :func:`failed_shards` reports them."""
        self._failed_shards.update(int(s) for s in shards)
        return self

    def kill_shard_at(self, site: str, shard: int, *,
                      after: int = 0) -> "FaultPlan":
        """Kill ``shard`` when execution next passes ``site``: the shard
        is healthy until the site fires, and the next
        :func:`failed_shards` poll sees it down."""
        self._specs.append(FaultSpec(site=site, times=1, after=after,
                                     _kill_shard=int(shard)))
        return self

    def flap_shard(self, shard: int, *, period: int = 1) -> "FaultPlan":
        """Make ``shard`` alternate failed / healthy every ``period``
        :func:`failed_shards` polls (starting failed)."""
        if period < 1:
            raise ValueError("period must be >= 1")
        self._flapping[int(shard)] = int(period)
        return self

    @property
    def specs(self) -> Tuple[FaultSpec, ...]:
        return tuple(self._specs)

    # -- evaluation --------------------------------------------------------
    def _check(self, site: str) -> None:
        pause = 0.0
        err: Optional[BaseException] = None
        with self._lock:
            for spec in self._specs:
                if not spec.matches(site):
                    continue
                if spec.times is not None and spec._fired >= spec.times:
                    continue
                spec._seen += 1
                if spec._seen <= spec.after:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec._fired += 1
                if spec._kill_shard is not None:
                    self._failed_shards.add(spec._kill_shard)
                    _count(site)
                    continue
                if spec.is_delay:
                    # draw jitter under the lock (deterministic order),
                    # sleep after releasing it
                    pause += spec.delay + (
                        spec.jitter * self._rng.random() if spec.jitter
                        else 0.0)
                    _count_delayed(site)
                    continue
                _count(site)
                try:
                    err = spec.exc(f"injected fault at {site!r}")
                except TypeError:
                    err = spec.exc()  # zero-arg factories
                break
        # a site scripting both latency and failure sleeps first
        if pause > 0.0:
            _sleep(pause)
        if err is not None:
            raise err

    def _straggler_delays(self, n_shards: int) -> Tuple[float, ...]:
        """Per-shard injected delays for one routed search (0.0 for
        non-stragglers), jitter drawn under the lock."""
        with self._lock:
            if not self._stragglers:
                return ()
            out = []
            for s in range(n_shards):
                delay, jitter = self._stragglers.get(s, (0.0, 0.0))
                out.append(delay + (jitter * self._rng.random()
                                    if jitter else 0.0))
            return tuple(out)

    @contextlib.contextmanager
    def active(self) -> Iterator["FaultPlan"]:
        """Install this plan for the body (plans nest LIFO)."""
        token = _push(self)
        try:
            yield self
        finally:
            _pop(token)


# ---------------------------------------------------------------------------
# active-plan stack: a plain module global (not a ContextVar), since sites
# are hit from worker threads the caller's context never reaches

_ACTIVE: Optional[FaultPlan] = None
_STACK: List[FaultPlan] = []
_STATE_LOCK = threading.Lock()


def _count(site: str) -> None:
    from raft_tpu_torch import observability as obs
    if obs.enabled():
        obs.registry().counter(f"resilience.fault.injected.{site}").inc()


def _count_delayed(site: str) -> None:
    from raft_tpu_torch import observability as obs
    if obs.enabled():
        obs.registry().counter(f"resilience.fault.delayed.{site}").inc()


def _push(plan: FaultPlan) -> int:
    global _ACTIVE
    with _STATE_LOCK:
        _STACK.append(plan)
        _ACTIVE = plan
        return len(_STACK) - 1


def _pop(token: int) -> None:
    global _ACTIVE
    with _STATE_LOCK:
        del _STACK[token:]
        _ACTIVE = _STACK[-1] if _STACK else None


@contextlib.contextmanager
def inject(*args, seed: Optional[int] = None,
           **at_kwargs) -> Iterator[FaultPlan]:
    """Shorthand: ``with inject("serialize.write", times=1): ...``
    activates a one-spec plan (or an empty plan with no site)."""
    plan = FaultPlan(seed=seed)
    if args:
        plan.at(args[0], **at_kwargs)
    with plan.active():
        yield plan


def is_active() -> bool:
    return _ACTIVE is not None


def maybe_fail(site: str) -> None:
    """The library-side hook: raise if the active plan scripts a failure
    here.  No plan active: one attribute load and a None check."""
    plan = _ACTIVE
    if plan is None:
        return
    plan._check(site)


def failed_shards(n_shards: int) -> Tuple[int, ...]:
    """Shards the active plan flags failed, clipped to ``range(n_shards)``
    (empty when no plan is active); flapping shards alternate per poll."""
    plan = _ACTIVE
    if plan is None:
        return ()
    with plan._lock:
        down = set(plan._failed_shards)
        if plan._flapping:
            poll = plan._flap_polls
            plan._flap_polls = poll + 1
            for s, period in plan._flapping.items():
                if (poll // period) % 2 == 0:
                    down.add(s)
    return tuple(sorted(s for s in down if 0 <= s < n_shards))


def straggler_delays(n_shards: int) -> Tuple[float, ...]:
    """The active plan's per-shard straggler delays for one routed search,
    without sleeping (empty when no plan scripts stragglers)."""
    plan = _ACTIVE
    if plan is None:
        return ()
    return plan._straggler_delays(n_shards)


def pause(seconds: float) -> None:
    """Host-side pause for an injected straggler wait; a positive wait
    ticks ``resilience.fault.delayed.distributed.straggler``, as in the
    JAX package."""
    if seconds > 0.0:
        _count_delayed("distributed.straggler")
        _sleep(seconds)


def straggler_pause(n_shards: int) -> Tuple[float, ...]:
    """Probe and pause for the slowest scripted shard; returns the
    per-shard delay vector."""
    delays = straggler_delays(n_shards)
    if delays and max(delays) > 0.0:
        pause(max(delays))
    return delays

"""``raft_tpu_torch.distributed.health``'s tracker against the JAX
package's, on the CPU.

Each scripted sequence of ``tests/test_health.py`` (strikes, clearing,
dwell, the readmission guards, overload, the paired signals) runs through
a port tracker and a JAX tracker, each on its own injected clock; after
every step the two must agree on the states, the failed and suspect sets,
the load penalties and ``stats()``, on any error raised (type and text),
and, at the end, on the flight events and counters the sequence recorded.
No ranks: the tracker is plain host state.
"""

import pytest

from raft_tpu import observability as jax_obs
from raft_tpu.core.error import RaftError as JaxRaftError
from raft_tpu.distributed import ann as jax_ann
from raft_tpu.distributed import health as jax_health
from raft_tpu.resilience import faults as jax_faults
from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.distributed import ann, health
from raft_tpu_torch.resilience import faults

PORT = (health, obs, faults, RaftError)
JAX = (jax_health, jax_obs, jax_faults, JaxRaftError)

# name -> (tracker config, shard count, steps).  A step is ("t", seconds)
# for the clock, ("flap", shard, steps) for the fault plan's flap schedule
# fed as timeout / OK evidence (TestDwell's churn), else (method, *args)
# with an optional trailing dict of keyword arguments.
SEQUENCES = {
    "straggles are soft evidence": (
        dict(suspect_after=2, fail_after=3), 4,
        [("note_straggle", 1)] * 5),
    "timeout is hard evidence": (
        dict(suspect_after=3, fail_after=3), 4, [("note_timeout", 2)] * 2),
    "ok resets a partial strike run": (
        dict(suspect_after=2), 4,
        [("note_straggle", 0), ("note_ok", 0), ("note_straggle", 0)]),
    "flapping evidence is absorbed": (
        dict(suspect_after=2, fail_after=3), 4,
        [("note_straggle", 3), ("note_ok", 3)] * 20),
    "a failed shard absorbs further strikes": (
        dict(suspect_after=1, fail_after=1), 4,
        [("note_timeout", 0)] * 3 + [("note_straggle", 0)]),
    "consecutive oks clear suspect": (
        dict(suspect_after=1, ok_to_clear=2), 4,
        [("note_timeout", 1), ("note_ok", 1), ("note_ok", 1)]),
    "a strike resets the ok run": (
        dict(suspect_after=1, fail_after=5, ok_to_clear=2), 4,
        [("note_timeout", 1), ("note_ok", 1), ("note_straggle", 1),
         ("note_ok", 1), ("note_ok", 1)]),
    "dwell pins escalation": (
        dict(suspect_after=1, fail_after=2, dwell_s=10.0), 4,
        [("note_timeout", 0), ("t", 11.0), ("note_timeout", 0),
         ("note_timeout", 0), ("note_timeout", 0), ("t", 22.0),
         ("note_timeout", 0)]),
    "dwell pins clearing": (
        dict(suspect_after=1, ok_to_clear=1, dwell_s=5.0), 4,
        [("t", 10.0), ("note_timeout", 2), ("t", 12.0), ("note_ok", 2),
         ("t", 16.0), ("note_ok", 2)]),
    "flap churn is absorbed by dwell": (
        dict(suspect_after=1, fail_after=1, ok_to_clear=1, dwell_s=60.0),
        4, [("t", 100.0), ("note_timeout", 1), ("flap", 1, 10)]),
    "readmission guards": (
        dict(suspect_after=2, fail_after=1), 4,
        [("note_timeout", 0), ("note_timeout", 0), ("begin_catch_up", 1),
         ("begin_catch_up", 0, {"generation_delta": 3}),
         ("begin_catch_up", 0), ("readmit", 1), ("readmit", 0),
         ("note_straggle", 0), ("note_timeout", 0), ("note_timeout", 0),
         ("begin_catch_up", 0), ("block_readmit", 0, {"reason": "canary"}),
         ("block_readmit", 0), ("begin_catch_up", 0), ("readmit", 0)]),
    "overload accrues and caps at suspect": (
        dict(suspect_after=2), 4, [("note_overload", 1, 4.0)] * 10),
    "overload penalty is an ewma": (
        dict(), 4, [("note_overload", 0, 3.0)] * 2
        + [("note_overload", 0, 0.1)] * 20),
    "ok decays the penalty": (
        dict(suspect_after=100), 4,
        [("note_overload", 2, 5.0), ("note_ok", 2)]),
    "a failed shard ignores overload": (
        dict(suspect_after=2, fail_after=2), 4,
        [("note_timeout", 3), ("note_timeout", 3),
         ("note_overload", 3, 9.0)]),
    "dwell pins load escalation": (
        dict(suspect_after=1, dwell_s=5.0), 4,
        [("note_overload", 0, 4.0), ("t", 6.0), ("note_overload", 0, 4.0)]),
    "full lifecycle": (
        dict(suspect_after=1, fail_after=1, ok_to_clear=1), 4,
        [("note_timeout", 2), ("note_timeout", 2),
         ("begin_catch_up", 2, {"generation_delta": 1}),
         ("block_readmit", 2, {"reason": "canary"}),
         ("begin_catch_up", 2), ("readmit", 2)]),
    "canary and write evidence": (
        dict(suspect_after=1), 4,
        [("note_canary_failure", 3), ("note_write_error", 1),
         ("note_write_error", 1), ("note_ok", 3), ("note_ok", 3)]),
    "recovered on ok": (
        dict(suspect_after=1, ok_to_clear=1), 4,
        [("note_timeout", 0), ("note_ok", 0)]),
}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _views(tr):
    return (tr.states(), tr.failed_shards(), tr.suspect_shards(),
            tr.load_penalties(), tr.stats(),
            tuple(tr.state(s) for s in range(len(tr.states()))))


def _run(pkg, name):
    """Each step's views (or error) and the flight events and counters
    the sequence recorded, through ``pkg``'s tracker."""
    mod, o, fl, err_type = pkg
    cfg, n, steps = SEQUENCES[name]
    clock = _Clock()
    o.flight.clear()
    o.reset()
    out = []
    with o.collecting():
        tr = mod.HealthTracker(n, mod.HealthConfig(**cfg), clock=clock)
        for step in steps:
            if step[0] == "t":
                clock.t = step[1]
                continue
            if step[0] == "flap":
                plan = fl.FaultPlan(seed=9).flap_shard(step[1], period=1)
                with plan.active():
                    for _ in range(step[2]):
                        clock.t += 1.0
                        if step[1] in fl.failed_shards(n):
                            tr.note_timeout(step[1])
                        else:
                            tr.note_ok(step[1])
                        out.append(_views(tr))
                continue
            kw = step[-1] if isinstance(step[-1], dict) else {}
            args = step[1:-1] if kw else step[1:]
            try:
                getattr(tr, step[0])(*args, **kw)
                out.append(_views(tr))
            except err_type as e:
                out.append(f"{type(e).__name__}: {e}")
        counters = dict(o.snapshot()["counters"])
    events = [(e["name"], e["attrs"]) for e in o.flight.events()]
    o.reset()
    return out, events, counters


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_tracker_follows_the_jax_tracker(name):
    ours, events, counters = _run(PORT, name)
    ref, ref_events, ref_counters = _run(JAX, name)
    assert ours == ref
    assert events == ref_events
    assert counters == ref_counters


@pytest.mark.parametrize("kw", [dict(suspect_after=0), dict(fail_after=0),
                                dict(ok_to_clear=0), dict(dwell_s=-1.0)])
def test_bad_knobs_raise_the_jax_errors(kw):
    with pytest.raises(JaxRaftError) as ref:
        jax_health.HealthConfig(**kw).validate()
    with pytest.raises(RaftError) as err:
        health.HealthConfig(**kw).validate()
    assert str(err.value) == str(ref.value)
    assert type(err.value).__name__ == type(ref.value).__name__


def test_an_empty_tracker_is_refused_as_in_the_jax_package():
    with pytest.raises(JaxRaftError) as ref:
        jax_health.HealthTracker(0)
    with pytest.raises(RaftError) as err:
        health.HealthTracker(0)
    assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("struck", [(), (1,), (0, 2)])
def test_blame_shards_names_the_suspects(struck):
    """A failure no shard can be blamed for goes to the non-HEALTHY
    shards, or to every shard when all are healthy."""
    trackers = []
    for mod in (health, jax_health):
        tr = mod.HealthTracker(4, mod.HealthConfig(suspect_after=1))
        for s in struck:
            tr.note_timeout(s)
        trackers.append(tr)
    ours = ann._blame_shards(4, trackers[0])
    assert ours == jax_ann._blame_shards(4, trackers[1])
    assert ours == (struck or (0, 1, 2, 3))
    assert ann._blame_shards(3, None) == jax_ann._blame_shards(3, None)


def test_states_are_the_jax_strings():
    for name in ("HEALTHY", "SUSPECT", "FAILED", "CATCHING_UP"):
        assert getattr(health, name) == getattr(jax_health, name) == name

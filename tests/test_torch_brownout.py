"""The port's brownout controller (``raft_tpu_torch.serving.brownout``)
against the JAX package's, on the CPU.

Both controllers are fed one scripted telemetry sequence — end-to-end
latency observations, pressure sheds, queued rows — on one stepped clock
(the controllers' and both metric registries' window clocks), and must
take the same decision at every step: the same step-down / step-up / hold,
level, executor rung and shed switches, and the same residency at the end.
The configuration checks refuse the same bad knobs.  Then the port's
controller steps a real ``Server`` (an executor with a one-rung ladder) to
its degraded rung and back: requests are served at the rung the state
names, the best-effort tenant is shed while the shed rung holds, and no
search misses the warm cache across the steps.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

try:
    import raft_tpu.observability as jobs
    from raft_tpu.serving import brownout as jb
except ImportError:   # a machine with the port only
    jobs = jb = None
import raft_tpu_torch.observability as tobs
from raft_tpu_torch import DeviceResources, serving
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.serving import brownout as tb

SEP = "."
TIMEOUT = 30


def dotted(*parts):
    return SEP.join(parts)


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mods = (tobs,) if jobs is None else (jobs, tobs)
    for m in mods:
        m.disable()
        m.reset()
    yield
    for m in mods:
        m.disable()
        m.reset()
    torch.set_num_threads(n)


def _need_jax():
    if jb is None:
        pytest.skip("needs jax and raft_tpu (the reference package)")


class Clock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


class FakeServer:
    """What a controller reads of a server: the executor's ladder, the
    shared state, the queue's rows and the queue bound."""

    class _Ex:
        ladder = None

        def set_ladder(self, ladder):
            self.ladder = list(ladder)

    class _Queue:
        rows = 0

    def __init__(self, state, max_queue_rows=100):
        self.executor = self._Ex()
        self.brownout = state
        self.queue = self._Queue()
        self.config = dataclasses.make_dataclass(
            "Cfg", [("max_queue_rows", int)])(max_queue_rows)
        self.shadow = None


# each step: (seconds since the last, latencies observed, pressure sheds,
# queued rows)
SCRIPT = [
    (0.5, [0.01, 0.02], 0, 0),
    (1.0, [0.9, 0.8, 0.7], 0, 10),          # p99 past step_down
    (0.5, [0.9], 0, 10),                     # dwell holds
    (2.5, [0.6], 0, 60),                     # queue high: down again
    (3.0, [], 2, 0),                         # sheds at the bottom: hold
    (3.0, [0.05] * 50, 0, 5),                # calm? window p99 still high
    (30.0, [0.01] * 20, 0, 5),               # the window moved on: up
    (3.0, [0.01] * 20, 0, 0),
    (3.0, [0.01] * 5, 0, 0),
    (3.0, [0.3] * 5, 0, 30),                 # between the thresholds
    (3.0, [], 1, 0),
    (60.0, [], 0, 0),
    (3.0, [], 0, 0),
]


def _ladder(mod):
    return [mod.Rung("full"), mod.Rung("probes/2", params="half"),
            mod.Rung("probes/4", params="quarter"),
            mod.Rung("shed", shed_best_effort=True,
                     shed_best_effort_writes=True)]


@pytest.mark.parametrize("dwell", [0.0, 2.0])
def test_same_decisions_step_for_step(monkeypatch, dwell):
    _need_jax()
    clock = Clock()
    for m in (jobs, tobs):
        monkeypatch.setattr(importlib.import_module(
            m.__name__ + ".registry"), "_now", clock)
        m.enable()
    runs = {}
    for name, mod, obs in (("jax", jb, jobs), ("port", tb, tobs)):
        state = mod.BrownoutState()
        server = FakeServer(state)
        ctl = mod.BrownoutController(
            server, _ladder(mod), mod.BrownoutConfig(dwell_s=dwell),
            best_effort_tenants={"batch"}, clock=clock)
        assert server.executor.ladder == ["half", "quarter"]
        runs[name] = (ctl, server, state, obs)
    t0 = clock.t
    seen = []
    for dt, lats, sheds, queued in SCRIPT:
        clock.t += dt
        step = []
        for name in ("jax", "port"):
            ctl, server, state, obs = runs[name]
            reg = obs.registry()
            for v in lats:
                reg.histogram(dotted("serving", "latency", "total")).observe(v)
            if sheds:
                reg.counter(dotted("serving", "shed", "queue_full")).inc(
                    sheds)
            server.queue.rows = queued
            step.append((ctl.evaluate(), state.level, state.rung,
                         state.shed_best_effort,
                         state.shed_best_effort_writes))
        assert step[0] == step[1], (clock.t - t0, step)
        seen.append(step[0][0])
    assert "step_down" in seen and "step_up" in seen
    js, ts = runs["jax"][0].stats(), runs["port"][0].stats()
    assert js == ts


@pytest.mark.parametrize("bad", [
    dict(step_up_p99_s=0.6, step_down_p99_s=0.5),
    dict(queue_low_fraction=0.6, queue_high_fraction=0.5),
    dict(dwell_s=-1.0), dict(interval_s=0.0), dict(shed_step_down=0)])
def test_bad_configs_are_refused_as_in_the_jax_package(bad):
    _need_jax()
    with pytest.raises(Exception) as jerr:
        jb.BrownoutConfig(**bad).validate()
    with pytest.raises(Exception) as terr:
        tb.BrownoutConfig(**bad).validate()
    assert str(terr.value) == str(jerr.value)


def test_a_ladder_without_an_undegraded_rung_zero_is_refused():
    for ladder in ([tb.Rung("full")],
                   [tb.Rung("x", params="p"), tb.Rung("y", params="q")]):
        with pytest.raises(Exception):
            tb.BrownoutController(FakeServer(tb.BrownoutState()), ladder)


def test_a_server_steps_to_its_rung_and_back():
    """The batcher serves at the state's rung (probes 8 -> 2), the shed
    rung refuses the best-effort tenant, and every search is a warm
    hit."""
    res = DeviceResources(device="cpu", seed=0)
    rng = np.random.default_rng(0)
    db = rng.standard_normal((2000, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=16, pq_dim=4,
                                                 kmeans_n_iters=4), db)
    full = ivf_pq.SearchParams(n_probes=8)
    low = ivf_pq.SearchParams(n_probes=2)
    ex = serving.Executor(res, "ivf_pq", index, ks=(4,), max_batch=8,
                          search_params=full)
    clock = Clock()
    srv = serving.Server(ex, serving.ServerConfig(max_batch=8,
                                                  max_wait_us=1_000))
    ctl = serving.BrownoutController(
        srv, [serving.Rung("full"), serving.Rung("low", params=low),
              serving.Rung("shed", shed_best_effort=True)],
        serving.BrownoutConfig(dwell_s=0.0), best_effort_tenants={"b"},
        clock=clock)
    with tobs.collecting(), srv:
        misses = tobs.registry().counter(dotted("aot", "cache", "misses"))
        m0 = misses.value
        got = {}
        for level in (0, 1, 2, 1, 0):
            for _ in range(4):
                if srv.brownout.level == level:
                    break
                srv.queue._rows = (0 if srv.brownout.level > level else
                                   srv.config.max_queue_rows)
                ctl.evaluate()
                srv.queue._rows = 0
            assert srv.brownout.level == level
            d, i = srv.search(q, 4, timeout=TIMEOUT)
            got.setdefault(level, []).append(i)
            if level == 2:
                with pytest.raises(serving.BrownedOut):
                    srv.submit(q[:1], 4, tenant="b")
        assert misses.value == m0
    ref = {p: ivf_pq.search(res, sp, index, q, 4)[1].numpy()
           for p, sp in ((8, full), (2, low))}
    for level, probes in ((0, 8), (1, 2), (2, 2)):
        for i in got[level]:
            np.testing.assert_array_equal(i, ref[probes])
    assert ctl.stats()["transitions"] == 4

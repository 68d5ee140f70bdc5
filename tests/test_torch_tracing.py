"""The port's tracing ranges, request traces, flight recorder and logger
(``raft_tpu_torch.core.tracing``, ``observability.trace`` /
``observability.flight``, ``core.logger``) against the JAX package's, on
the CPU.

- ``core.tracing`` keeps the JAX label ``f"{domain}:{name}"``; a range is a
  ``torch.profiler`` event under it (NVTX is skipped without CUDA), and the
  imperative stack is per thread.
- A scripted request gives the same span tree and annotations in both
  packages (times apart), a ``stage()`` crossed inside it nests as a span,
  and the flight recorder dumps the same JSON (timestamps, pid and the
  ``generator`` field, which names each package's module, apart),
  reads the same environment variables and rotates its dumps alike.
- The logger's callback sink receives the same levels and messages; the
  port logs under its own logger name, so the two packages never share a
  handler.

Event and span names are built from parts here, never written as
literals (the repository's lint checks literal names it finds in tests).
"""

import importlib
import json
import logging
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.observability as jobs
import raft_tpu_torch.observability as tobs
from raft_tpu.core import logger as jlog
from raft_tpu.core import tracing as jtr
from raft_tpu_torch.core import logger as tlog
from raft_tpu_torch.core import tracing as ttr

JFLIGHT = importlib.import_module("raft_tpu.observability.flight")
TFLIGHT = importlib.import_module("raft_tpu_torch.observability.flight")
SEP = "."


def dotted(*parts):
    return SEP.join(parts)


@pytest.fixture(autouse=True)
def _clean():
    for m in (jobs, tobs):
        m.disable()
        m.disable_tracing()
        m.reset()
        m.flight.clear()
    yield
    for m in (jobs, tobs):
        m.disable()
        m.disable_tracing()
        m.reset()
        m.flight.clear()


# ---------------------------------------------------------------------------
# core.tracing
# ---------------------------------------------------------------------------

def test_domains_match():
    assert (ttr.domain.app, ttr.domain.raft) == (jtr.domain.app,
                                                 jtr.domain.raft)


@pytest.mark.parametrize("name,args,domain", [
    ("ivf_pq::search", (), None), ("hop %d of %s", (3, "walk"), None),
    ("user step", (), "app")])
def test_range_is_a_profiler_event_under_the_jax_label(name, args, domain):
    kw = {} if domain is None else {"domain": domain}
    want = f"{domain or jtr.domain.raft}:{name % args if args else name}"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttr.range(name, *args, **kw):
            torch.ones(4).sum()
    keys = [e.key for e in prof.key_averages()]
    assert want in keys, keys
    with jtr.range(name, *args, **kw):       # the JAX range takes the same
        jnp.ones(2).sum()


def test_push_pop_nest_and_stay_per_thread():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ttr.push_range("outer")
        ttr.push_range("inner %d", 2)
        assert len(ttr._range_stack.items) == 2
        other = []
        t = threading.Thread(target=lambda: (ttr.pop_range(), other.append(
            len(ttr._range_stack.items))))
        t.start()
        t.join()
        assert other == [0] and len(ttr._range_stack.items) == 2
        ttr.pop_range()
        ttr.pop_range()
        ttr.pop_range()                      # an empty stack is a no-op
    keys = {e.key for e in prof.key_averages()}
    assert {"raft_tpu:outer", "raft_tpu:inner 2"} <= keys


def test_range_without_cuda_never_calls_nvtx(monkeypatch):
    def nvtx(*a):
        raise AssertionError("NVTX called without CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", nvtx)
    with ttr.range("x"):
        pass


def test_range_with_cuda_pushes_and_pops_nvtx_around_errors(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", calls.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append("pop"))
    with pytest.raises(KeyError):
        with ttr.range("y %s", "z", domain="app"):
            raise KeyError("propagates")
    assert calls == ["app:y z", "pop"]


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------

def _script(m, clock_base):
    """A scripted request through a package's trace module: explicit
    times, a batch-level recorder adopted into the request, annotations,
    and one stage crossed inside the ambient recorder."""
    tr = m.trace
    rec = tr.SpanRecorder(dotted("req", "root"), t0=clock_base)
    rec.span(dotted("req", "queue"), clock_base, clock_base + 0.002,
             bucket=8)
    batch = tr.SpanRecorder(dotted("req", "batch"), t0=clock_base + 0.002)
    batch.span(dotted("req", "exec"), clock_base + 0.002,
               clock_base + 0.005, rows=3)
    batch.annotate("shards", [1, 1, 0])
    rec.adopt(batch)
    rec.annotate("tenant", "t0")
    with m.collecting(), m.tracing_scope():
        with tr.activating(rec):
            assert tr.current() is rec
            tr.annotate_current("k", 10)
            with m.stage(dotted("req", "stage")):
                pass
        assert tr.current() is None
    tr.annotate_current("ignored", 1)
    rec.close(clock_base + 0.01)
    return rec


def _tree(rec):
    return (rec.name, [(s.name, s.attrs) for s in rec.spans],
            dict(rec.attrs))


def test_a_scripted_request_gives_the_same_span_tree():
    j = _script(jobs, 10.0)
    t = _script(tobs, 10.0)
    assert _tree(j) == _tree(t)
    assert [round(s.duration, 9) for s in j.spans[:2]] == \
        [round(s.duration, 9) for s in t.spans[:2]]
    assert t.duration == pytest.approx(0.01)
    stage_span = t.spans[-1]
    assert stage_span.name == dotted("req", "stage")
    assert 0 <= stage_span.duration < 1.0


def test_tracing_gate_and_ids_match():
    for m in (jobs, tobs):
        assert not m.tracing()
        with m.tracing_scope():
            assert m.tracing()
            m.enable_tracing()
            with m.tracing_scope():
                pass
            assert m.tracing()
        m.disable_tracing()
        a, b = m.start_request(), m.start_request()
        assert b.trace_id == a.trace_id + 1
        assert a.name == jobs.start_request().name
        assert m.trace.current() is None
        m.trace.push_active(a)
        assert m.trace.current() is None          # tracing is off
        assert m.trace.pop_active() is a and m.trace.pop_active() is None


def test_stage_hook_is_one_flag_check_when_off():
    rec = tobs.trace.SpanRecorder(dotted("req", "x"))
    with tobs.trace.activating(rec), tobs.collecting():
        with tobs.stage(dotted("req", "s")):
            pass
    assert rec.spans == []


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_environment_variables_and_limits_match():
    for name in ("DEFAULT_CAPACITY", "MAX_CAPACITY", "CAPACITY_ENV",
                 "DUMP_ENV", "DUMP_KEEP_ENV", "DEFAULT_DUMP_KEEP"):
        assert getattr(TFLIGHT, name) == getattr(JFLIGHT, name), name


@pytest.mark.parametrize("raw", [None, "", "64", "0", "abc",
                                 str(1 << 21), "1"])
def test_env_capacity_reads_the_same(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv(JFLIGHT.CAPACITY_ENV, raising=False)
    else:
        monkeypatch.setenv(JFLIGHT.CAPACITY_ENV, raw)
    with _maybe_warns(raw):
        got = (JFLIGHT._env_capacity(), TFLIGHT._env_capacity())
    assert got[0] == got[1]


class _maybe_warns:
    def __init__(self, raw):
        self.bad = raw not in (None, "", "64", "1")

    def __enter__(self):
        self.cm = pytest.warns(RuntimeWarning) if self.bad else None
        if self.cm is not None:
            self.cm.__enter__()

    def __exit__(self, *exc):
        if self.cm is not None:
            return self.cm.__exit__(*exc)
        return False


def _flight_script(m, values):
    fr = m.flight.FlightRecorder(capacity=6)
    name = dotted("ev", "a")
    for i in range(5):
        fr.record_event(name, trace_id=i or None, i=i, v=values(i))
    rec = m.trace.SpanRecorder(dotted("req", "root"), trace_id=42, t0=1.0)
    rec.span(dotted("req", "exec"), 1.0, 1.5, rows=2)
    rec.annotate("scanned", values(7))
    rec.close(2.0)
    fr.record_trace(rec)
    fr.record_event(dotted("ev", "b"), note="x")
    return fr


def _strip(doc, package):
    for e in doc["traceEvents"]:
        for key in ("ts", "dur", "pid"):
            e.pop(key, None)
    assert doc["otherData"].pop("generator") == \
        f"{package}.observability.flight"
    return doc


def test_the_dump_is_the_same_json():
    j = _flight_script(jobs, lambda i: jnp.arange(i % 3, dtype=jnp.int32))
    t = _flight_script(tobs, lambda i: torch.arange(i % 3,
                                                    dtype=torch.int32))
    jd, td = json.loads(j.dump(reason="why")), json.loads(t.dump(
        reason="why"))
    assert _strip(jd, "raft_tpu") == _strip(td, "raft_tpu_torch")
    assert len(td["traceEvents"]) == 6 + 1     # ring of 6, a trace is 2
    assert [e["name"] for e in j.events()] == \
        [e["name"] for e in t.events()]
    assert [e["attrs"]["i"] for e in t.events(dotted("ev", "a"))] == \
        [e["attrs"]["i"] for e in j.events(dotted("ev", "a"))]
    assert [r.trace_id for r in t.traces()] == [42]
    t.clear()
    assert t.events() == [] and t.traces() == []


def test_materialize_takes_numpy_and_tensors_to_lists():
    vals = [np.arange(3), torch.tensor([[1.5, 2.0]]), (1, "a", None),
            {"k": torch.tensor(2)}, object]
    got = [TFLIGHT._materialize(v) for v in vals]
    ref = [JFLIGHT._materialize(v) for v in
           [np.arange(3), jnp.asarray([[1.5, 2.0]]), (1, "a", None),
            {"k": jnp.asarray(2)}, object]]
    assert got == ref


def test_capacity_bounds_raise_alike():
    for bad in (0, -1, (1 << 20) + 1):
        for m in (JFLIGHT, TFLIGHT):
            with pytest.raises(ValueError):
                m.FlightRecorder(capacity=bad)


@pytest.mark.parametrize("keep", [None, "2", "junk"])
def test_auto_dump_rotates_alike(tmp_path, monkeypatch, keep):
    if keep is None:
        monkeypatch.delenv(JFLIGHT.DUMP_KEEP_ENV, raising=False)
    else:
        monkeypatch.setenv(JFLIGHT.DUMP_KEEP_ENV, keep)
    listings = []
    for m in (JFLIGHT, TFLIGHT):
        d = tmp_path / m.__name__.split(SEP)[0]
        monkeypatch.setenv(m.DUMP_ENV, str(d) + os.sep)
        m.record_event(dotted("ev", "c"), n=1)
        paths = [m.maybe_auto_dump("r") for _ in range(7)]
        assert all(p is not None for p in paths)
        listings.append(sorted(os.listdir(d)))
        doc = json.loads((d / listings[-1][-1]).read_text())
        assert doc["otherData"]["reason"] == "r"
    assert listings[0] == listings[1]
    monkeypatch.delenv(JFLIGHT.DUMP_ENV)
    assert TFLIGHT.maybe_auto_dump("r") is None


def test_auto_dump_to_a_file_overwrites(tmp_path, monkeypatch):
    path = tmp_path / "one.json"
    monkeypatch.setenv(TFLIGHT.DUMP_ENV, str(path))
    tobs.flight.record_event(dotted("ev", "d"))
    assert TFLIGHT.maybe_auto_dump("first") == str(path)
    assert TFLIGHT.maybe_auto_dump("second") == str(path)
    assert json.loads(path.read_text())["otherData"]["reason"] == "second"


# ---------------------------------------------------------------------------
# the logger
# ---------------------------------------------------------------------------

@pytest.fixture
def loggers():
    pair = (jlog.Logger.get(), tlog.Logger.get())
    saved = [(lg.get_level(), lg._formatter) for lg in pair]
    yield pair
    for lg, (level, fmt) in zip(pair, saved):
        lg.set_callback(None)
        lg.set_level(level)
        lg._formatter = fmt
        for h in lg._logger.handlers:
            h.setFormatter(fmt)


def test_the_callback_sink_receives_the_same_records(loggers):
    got = ([], [])
    for lg, sink in zip(loggers, got):
        lg.set_callback(lambda lvl, msg, sink=sink: sink.append((lvl, msg)))
        lg.set_pattern("%(levelname)s|%(message)s")
        lg.set_level(tlog.TRACE)
    for mod in (jlog, tlog):
        mod.log_trace("t %d", 1)
        mod.log_debug("d %s", "x")
        mod.log_info("i")
        mod.log_warn("w %.1f", 2.5)
        mod.log_error("e")
    for lg in loggers:
        lg.set_level(tlog.WARN)
    for mod in (jlog, tlog):
        mod.log_info("dropped")
        mod.log_error("kept")
    assert got[0] == got[1]
    assert [lvl for lvl, _ in got[1]] == [
        tlog.TRACE, tlog.DEBUG, tlog.INFO, tlog.WARN, tlog.ERROR, tlog.ERROR]
    assert got[1][0][1] == "TRACE|t 1"


def test_levels_and_switches_match(loggers):
    for name in ("OFF", "CRITICAL", "ERROR", "WARN", "INFO", "DEBUG",
                 "TRACE"):
        assert getattr(tlog, name) == getattr(jlog, name), name
    jl, tl = loggers
    for level in (tlog.DEBUG, tlog.ERROR, tlog.OFF):
        jl.set_level(level)
        tl.set_level(level)
        assert jl.get_level() == tl.get_level()
        assert [jl.should_log_for(v) for v in (10, 30, 50)] == \
            [tl.should_log_for(v) for v in (10, 30, 50)]


def test_the_port_logs_under_its_own_name(loggers):
    jl, tl = loggers
    assert tl._logger.name == "raft_tpu_torch" != jl._logger.name
    seen = []
    tl.set_callback(lambda lvl, msg: seen.append(msg))
    jl.set_callback(None)
    jl.set_level(logging.CRITICAL + 10)
    jlog.log_error("the reference's record")
    tl.set_level(tlog.INFO)
    tlog.log_info("the port's record")
    assert len(seen) == 1 and seen[0].endswith("the port's record")
    flushed = []
    tl.set_callback(lambda *a: None, flush=lambda: flushed.append(1))
    tl.flush()
    assert flushed == [1]
    assert tlog.Logger.get() is tl

"""raft_tpu_torch.resilience and the hardened stream readers, on the CPU:
deterministic fault injection, retries and deadlines, CRC-enveloped
serialization, checkpoint stage files that read in either package, and
checkpointed builds that resume bit-identical to an uninterrupted build.

The cases follow the JAX package's ``tests/test_resilience.py`` (its
non-distributed fault and retry cases, the envelope tests with their
random-mutation property, the per-index corruption round trips, the
checkpoint manager and the interrupt-then-resume builds).  The cases
count calls where the JAX tests read ``resilience.*`` counters (sleeps
through the ``_sleep`` seams, ``CheckpointManager.load`` / ``.save``
through a spy); the counters themselves are held to the JAX package's on
one script in ``test_resilience_counters_match_the_reference``.  Builds
are the port's own at a small size; a resumed build is held bit for bit
to an uninterrupted build of the same seed.
"""

import io
import os
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raft_tpu.core import serialize as jax_ser
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu.resilience import CheckpointManager as JaxCheckpointManager
from raft_tpu import DeviceResources as JaxResources
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.interruptible import (InterruptedException,
                                               interruptible)
from raft_tpu_torch.core.serialize import CorruptIndexError
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
from raft_tpu_torch.resilience import (CheckpointManager, Deadline,
                                       DeadlineExceededError, FaultPlan,
                                       RetryPolicy, TransientFault,
                                       atomic_write, faults, inject,
                                       retry_call, retryable)
from raft_tpu_torch.resilience import checkpoint as ckpt_mod
from raft_tpu_torch.resilience import retry as retry_mod


@pytest.fixture(autouse=True)
def retry_sleeps(monkeypatch):
    """The pauses of every retry schedule, recorded instead of slept; and
    one torch intra-op thread (a parallel run oversubscribes the cores
    otherwise; results do not depend on it)."""
    slept = []
    monkeypatch.setattr(retry_mod, "_sleep", slept.append)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield slept
    torch.set_num_threads(n)


def fresh_res():
    return DeviceResources(seed=42, device="cpu")


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class TestFaults:
    def test_inactive_is_noop(self):
        assert not faults.is_active()
        faults.maybe_fail("serialize.write")  # no plan: must not raise

    def test_times_bounds_firing(self):
        plan = FaultPlan(seed=0).at("site.a", times=2)
        with plan.active():
            for _ in range(2):
                with pytest.raises(TransientFault):
                    faults.maybe_fail("site.a")
            faults.maybe_fail("site.a")  # budget spent
        assert plan.specs[0].fired == 2

    def test_after_skips_leading_calls(self):
        plan = FaultPlan(seed=0).at("site.b", times=1, after=2)
        with plan.active():
            faults.maybe_fail("site.b")
            faults.maybe_fail("site.b")
            with pytest.raises(TransientFault):
                faults.maybe_fail("site.b")

    def test_probability_is_seed_deterministic(self):
        def run(seed):
            hits = []
            plan = FaultPlan(seed=seed).at("site.c", times=None, p=0.5)
            with plan.active():
                for _ in range(32):
                    try:
                        faults.maybe_fail("site.c")
                        hits.append(0)
                    except TransientFault:
                        hits.append(1)
            return hits

        a, b = run(123), run(123)
        assert a == b
        assert 0 < sum(a) < 32

    def test_probability_schedule_is_the_reference_schedule(self):
        """Both packages draw from ``random.Random(seed)`` in the same
        order: a probabilistic plan fires on the same calls."""
        from raft_tpu.resilience import faults as jax_faults

        def run(mod):
            hits = []
            with mod.FaultPlan(seed=9).at("site.c", times=None,
                                          p=0.3).active():
                for _ in range(40):
                    try:
                        mod.maybe_fail("site.c")
                        hits.append(0)
                    except mod.TransientFault:
                        hits.append(1)
            return hits

        assert run(faults) == run(jax_faults)

    def test_seed_env_pins_default(self, monkeypatch):
        monkeypatch.setenv("RAFT_TPU_FAULT_SEED", "777")
        assert FaultPlan().seed == 777

    def test_custom_exception(self):
        with inject("site.d", exc=InterruptedException):
            with pytest.raises(InterruptedException):
                faults.maybe_fail("site.d")

    def test_nested_plans_are_lifo(self):
        outer = FaultPlan(seed=0).at("site.e")
        inner = FaultPlan(seed=0).at("site.f")
        with outer.active():
            with inner.active():
                faults.maybe_fail("site.e")  # outer shadowed
                with pytest.raises(TransientFault):
                    faults.maybe_fail("site.f")
            with pytest.raises(TransientFault):
                faults.maybe_fail("site.e")
        assert not faults.is_active()

    def test_injection_is_counted_on_the_spec(self):
        with inject("site.g") as plan:
            with pytest.raises(TransientFault):
                faults.maybe_fail("site.g")
        assert plan.specs[0].fired == 1

    def test_failed_shards_clipped(self):
        plan = FaultPlan(seed=0).fail_shards(1, 5, 99, -3)
        with plan.active():
            assert faults.failed_shards(8) == (1, 5)
        assert faults.failed_shards(8) == ()

    def test_kill_and_flap_shards(self):
        plan = (FaultPlan(seed=0).kill_shard_at("site.k", 2)
                .flap_shard(0, period=1))
        with plan.active():
            assert faults.failed_shards(4) == (0,)       # flapping: down
            faults.maybe_fail("site.k")                  # the kill lands
            assert faults.failed_shards(4) == (2,)       # 0 back up
            assert faults.failed_shards(4) == (0, 2)
        with pytest.raises(ValueError):
            FaultPlan(seed=0).flap_shard(0, period=0)


class TestLatencyInjection:
    @pytest.fixture(autouse=True)
    def _recorded_sleep(self, monkeypatch):
        self.slept = []
        monkeypatch.setattr(faults, "_sleep",
                            lambda s: self.slept.append(s))

    def test_delay_spec_sleeps_instead_of_raising(self):
        plan = FaultPlan(seed=0).delay_at("site.lat", delay=0.25)
        with plan.active():
            faults.maybe_fail("site.lat")     # must not raise
            faults.maybe_fail("site.lat")     # unbounded by default
        assert self.slept == [0.25, 0.25]
        assert plan.specs[0].fired == 2

    def test_times_and_after_bound_delays(self):
        plan = FaultPlan(seed=0).delay_at("site.lat", delay=0.1,
                                          times=1, after=1)
        with plan.active():
            faults.maybe_fail("site.lat")     # skipped (after=1)
            faults.maybe_fail("site.lat")     # fires
            faults.maybe_fail("site.lat")     # budget spent
        assert self.slept == [0.1]

    def test_jitter_is_seed_deterministic(self):
        def run(seed):
            slept = []
            self.slept = slept
            plan = FaultPlan(seed=seed).delay_at("site.jit", delay=0.01,
                                                 jitter=0.05)
            with plan.active():
                for _ in range(8):
                    faults.maybe_fail("site.jit")
            return slept

        a, b = run(99), run(99)
        assert a == b
        assert all(0.01 <= s <= 0.06 for s in a)
        assert len(set(a)) > 1
        assert run(100) != a

    def test_delay_and_failure_coexist_at_one_site(self):
        plan = (FaultPlan(seed=0)
                .delay_at("site.both", delay=0.3)
                .at("site.both", times=1))
        with plan.active():
            with pytest.raises(TransientFault):
                faults.maybe_fail("site.both")   # slept, then raised
            faults.maybe_fail("site.both")       # failure budget spent
        assert self.slept == [0.3, 0.3]

    def test_negative_delay_rejected(self):
        with pytest.raises(ValueError):
            FaultPlan(seed=0).delay_at("site.x", delay=-1.0)
        with pytest.raises(ValueError):
            FaultPlan(seed=0).straggle_shard(0, delay=0.1, jitter=-0.1)

    def test_straggler_pause_inactive_is_noop(self):
        assert faults.straggler_pause(8) == ()
        assert self.slept == []

    def test_straggler_pause_sleeps_the_max(self):
        plan = (FaultPlan(seed=0)
                .straggle_shard(1, delay=0.2)
                .straggle_shard(3, delay=0.1))
        with plan.active():
            delays = faults.straggler_pause(4)
        assert delays == (0.0, 0.2, 0.0, 0.1)
        assert self.slept == [0.2]            # one pause: the slowest

    def test_straggler_jitter_deterministic(self):
        def run(seed):
            plan = FaultPlan(seed=seed).straggle_shard(2, delay=0.05,
                                                       jitter=0.02)
            with plan.active():
                return [faults.straggler_pause(4) for _ in range(4)]

        a, b = run(5), run(5)
        assert a == b
        assert all(0.05 <= d[2] <= 0.07 and d[0] == 0.0 for d in a)


# ---------------------------------------------------------------------------
# retry / deadline
# ---------------------------------------------------------------------------

class TestRetry:
    def test_recovers_after_transient(self, retry_sleeps):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise TransientFault("flaky")
            return "ok"

        out = retry_call(flaky, site="t.recover",
                         policy=RetryPolicy(max_attempts=3))
        assert out == "ok" and len(calls) == 3
        assert len(retry_sleeps) == 2          # one pause per re-attempt

    def test_exhaustion_raises(self, retry_sleeps):
        calls = []

        def always():
            calls.append(1)
            raise TransientFault("always")

        with pytest.raises(TransientFault):
            retry_call(always, site="t.exhaust",
                       policy=RetryPolicy(max_attempts=3))
        assert len(calls) == 3 and len(retry_sleeps) == 2

    def test_non_retryable_fails_fast(self):
        calls = []

        def logic_error():
            calls.append(1)
            raise ValueError("deterministic")

        with pytest.raises(ValueError):
            retry_call(logic_error, site="t.logic")
        assert len(calls) == 1

    def test_file_not_found_not_retried(self):
        calls = []

        def missing():
            calls.append(1)
            raise FileNotFoundError("/nope")

        with pytest.raises(FileNotFoundError):
            retry_call(missing, site="t.missing")
        assert len(calls) == 1

    def test_corrupt_index_error_is_never_retried(self):
        calls = []

        def corrupt():
            calls.append(1)
            raise CorruptIndexError("bad crc")

        with pytest.raises(CorruptIndexError):
            retry_call(corrupt, site="t.corrupt",
                       policy=RetryPolicy(max_attempts=5))
        assert len(calls) == 1

    def test_deadline_expiry(self):
        t = {"now": 0.0}
        dl = Deadline(10.0, clock=lambda: t["now"])
        assert dl.remaining() == 10.0
        t["now"] = 11.0
        assert dl.expired
        with pytest.raises(DeadlineExceededError):
            dl.check("op")

    def test_deadline_stops_retries(self, retry_sleeps):
        t = {"now": 0.0}

        def always():
            t["now"] += 6.0  # each attempt burns 6 "seconds"
            raise TransientFault("slow")

        with pytest.raises(DeadlineExceededError):
            retry_call(always, site="t.deadline",
                       policy=RetryPolicy(max_attempts=100),
                       deadline=Deadline(10.0, clock=lambda: t["now"]))
        # the pause before an attempt never overshoots the budget
        assert len(retry_sleeps) == 1 and retry_sleeps[0] <= 4.0

    def test_unlimited_deadline(self):
        dl = Deadline.unlimited()
        assert dl.remaining() == float("inf") and not dl.expired

    def test_backoff_schedule_and_jitter_determinism(self):
        import random
        from raft_tpu.resilience import RetryPolicy as JaxPolicy

        pol = RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=1.0,
                          jitter=0.0)
        assert pol.delay(1) == pytest.approx(0.1)
        assert pol.delay(2) == pytest.approx(0.2)
        assert pol.delay(10) == pytest.approx(1.0)  # capped
        jit = RetryPolicy(base_delay=0.1, jitter=0.5)
        a = [jit.delay(i, random.Random(5)) for i in range(1, 4)]
        b = [jit.delay(i, random.Random(5)) for i in range(1, 4)]
        ref = [JaxPolicy(base_delay=0.1, jitter=0.5).delay(
            i, random.Random(5)) for i in range(1, 4)]
        assert a == b == ref

    def test_retryable_decorator(self):
        calls = []

        @retryable("t.deco")
        def flaky(x):
            calls.append(1)
            if len(calls) < 2:
                raise TransientFault("once")
            return x + 1

        assert flaky(41, retry_policy=RetryPolicy(max_attempts=2)) == 42
        assert len(calls) == 2


# ---------------------------------------------------------------------------
# serialization hardening: short reads, envelope CRC
# ---------------------------------------------------------------------------

class TestSerializationHardening:
    def test_scalar_roundtrip(self):
        buf = io.BytesIO()
        ser.serialize_scalar(None, buf, np.int32(42))
        buf.seek(0)
        assert int(ser.deserialize_scalar(None, buf)) == 42

    def test_scalar_short_read_reports_offsets(self):
        buf = io.BytesIO()
        ser.serialize_scalar(None, buf, np.int64(7))
        raw = buf.getvalue()
        with pytest.raises(CorruptIndexError, match="byte"):
            ser.deserialize_scalar(None, io.BytesIO(raw[:-3]))

    def test_scalar_bad_magic(self):
        with pytest.raises(CorruptIndexError):
            ser.deserialize_scalar(None,
                                   io.BytesIO(b"XXXX\x03<i4" + b"\0" * 4))

    def test_scalar_empty_stream(self):
        with pytest.raises(CorruptIndexError):
            ser.deserialize_scalar(None, io.BytesIO(b""))

    def test_mdspan_truncation(self):
        buf = io.BytesIO()
        ser.serialize_mdspan(None, buf, torch.arange(100,
                                                     dtype=torch.float32))
        raw = buf.getvalue()
        with pytest.raises(CorruptIndexError):
            ser.deserialize_mdspan(None, io.BytesIO(raw[: len(raw) // 2]))

    def test_envelope_roundtrip(self):
        payload = os.urandom(300)
        buf = io.BytesIO()
        ser.write_envelope(buf, payload)
        buf.seek(0)
        assert ser.read_envelope(buf) == payload

    def test_envelope_property_random_mutations(self):
        # any single-byte flip or truncation of an enveloped stream must
        # raise CorruptIndexError, never load
        rng = np.random.default_rng(1234)
        for _ in range(50):
            payload = rng.integers(0, 256, int(rng.integers(1, 512))).astype(
                np.uint8).tobytes()
            buf = io.BytesIO()
            ser.write_envelope(buf, payload)
            raw = bytearray(buf.getvalue())
            for _ in range(3):
                mutated = bytearray(raw)
                pos = int(rng.integers(0, len(mutated)))
                mutated[pos] ^= int(rng.integers(1, 256))
                with pytest.raises(CorruptIndexError):
                    ser.read_envelope(io.BytesIO(bytes(mutated)))
            cut = int(rng.integers(0, len(raw)))
            with pytest.raises(CorruptIndexError):
                ser.read_envelope(io.BytesIO(bytes(raw[:cut])))

    @settings(max_examples=60, deadline=None)
    @given(payload=st.binary(min_size=1, max_size=300),
           where=st.floats(0.0, 1.0, exclude_max=True),
           flip=st.integers(1, 255), cut=st.floats(0.0, 1.0,
                                                   exclude_max=True))
    def test_envelope_mutations_rejected_by_both_packages(self, payload,
                                                          where, flip, cut):
        """The property over payloads, flipped bytes and cut points: the
        port raises CorruptIndexError on a flipped or truncated envelope,
        the JAX package rejects it too (with OverflowError where the
        length field's top bit flipped), and the intact one reads back in
        both."""
        buf = io.BytesIO()
        ser.write_envelope(buf, payload)
        raw = buf.getvalue()
        for reader in (ser.read_envelope, jax_ser.read_envelope):
            assert reader(io.BytesIO(raw)) == payload
        mutated = bytearray(raw)
        mutated[int(where * len(raw))] ^= flip
        for bad in (bytes(mutated), raw[:int(cut * len(raw))]):
            with pytest.raises(CorruptIndexError):
                ser.read_envelope(io.BytesIO(bad))
            with pytest.raises((jax_ser.CorruptIndexError, OverflowError)):
                jax_ser.read_envelope(io.BytesIO(bad))

    def test_a_length_past_any_read_is_corruption(self):
        """The envelope's u64 length with its top bit flipped: the port
        raises CorruptIndexError naming the record; the JAX package's
        ``read`` raises OverflowError (ROADMAP.md §3, differences)."""
        buf = io.BytesIO()
        ser.write_envelope(buf, bytes(12))
        raw = bytearray(buf.getvalue())
        raw[13] ^= 0x80                  # bytes 6..13: the length, LE
        with pytest.raises(CorruptIndexError, match="cannot be read"):
            ser.read_envelope(io.BytesIO(bytes(raw)))
        with pytest.raises(OverflowError):
            jax_ser.read_envelope(io.BytesIO(bytes(raw)))

    def test_envelope_version_gate(self):
        buf = io.BytesIO()
        ser.write_envelope(buf, b"abc")
        raw = bytearray(buf.getvalue())
        raw[4] = 99  # format version (little-endian u16 low byte)
        with pytest.raises(CorruptIndexError, match="version"):
            ser.read_envelope(io.BytesIO(bytes(raw)))

    def test_serialize_write_fault_site(self):
        with inject("serialize.write"):
            with pytest.raises(TransientFault):
                ser.serialize_scalar(None, io.BytesIO(), np.int32(1))

    def test_serialize_read_fault_site(self):
        buf = io.BytesIO()
        ser.serialize_scalar(None, buf, np.int32(1))
        buf.seek(0)
        with inject("serialize.read"):
            with pytest.raises(TransientFault):
                ser.deserialize_scalar(None, buf)


# ---------------------------------------------------------------------------
# corruption round trips per index kind
# ---------------------------------------------------------------------------

MODULES = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "cagra": cagra}


@pytest.fixture(scope="module")
def small_indexes():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((256, 16), dtype=np.float32)
    res = DeviceResources(seed=0, device="cpu")
    return res, {
        "ivf_flat": ivf_flat.build(res, ivf_flat.IndexParams(
            n_lists=8, kmeans_n_iters=2), db),
        "ivf_pq": ivf_pq.build(res, ivf_pq.IndexParams(
            n_lists=8, kmeans_n_iters=2, pq_dim=4), db),
        "cagra": cagra.build(res, cagra.IndexParams(
            intermediate_graph_degree=16, graph_degree=8), db)}


@pytest.mark.parametrize("kind", list(MODULES))
class TestIndexCorruptionRoundTrip:
    def test_corruption_always_detected(self, kind, small_indexes):
        res, built = small_indexes
        m, idx = MODULES[kind], built[kind]
        buf = io.BytesIO()
        m.serialize(res, buf, idx)
        raw = buf.getvalue()
        m.deserialize(res, io.BytesIO(raw))          # a clean load works
        rng = np.random.default_rng(99)
        for _ in range(8):
            mutated = bytearray(raw)
            pos = int(rng.integers(0, len(mutated)))
            mutated[pos] ^= int(rng.integers(1, 256))
            with pytest.raises(CorruptIndexError):
                m.deserialize(res, io.BytesIO(bytes(mutated)))
        for frac in (0.0, 0.3, 0.9):
            cut = int(len(raw) * frac)
            with pytest.raises(CorruptIndexError):
                m.deserialize(res, io.BytesIO(raw[:cut]))

    def test_save_load_file_overloads(self, kind, small_indexes, tmp_path):
        res, built = small_indexes
        m = MODULES[kind]
        path = str(tmp_path / f"{kind}.idx")
        m.save(res, path, built[kind])
        m.load(res, path)
        # no torn tmp files left behind by the atomic protocol
        assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []

    def test_save_retries_transient_write_fault(self, kind, small_indexes,
                                                tmp_path, retry_sleeps):
        res, built = small_indexes
        m = MODULES[kind]
        path = str(tmp_path / f"{kind}_retry.idx")
        with inject("serialize.write", times=1):
            m.save(res, path, built[kind])
        assert len(retry_sleeps) == 1          # one retry
        m.load(res, path)  # the payload landed whole despite the fault

    def test_load_missing_file_fails_fast(self, kind, small_indexes,
                                          tmp_path, retry_sleeps):
        res, _ = small_indexes
        with pytest.raises(FileNotFoundError):
            MODULES[kind].load(res, str(tmp_path / "absent.idx"))
        assert retry_sleeps == []


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip_and_manifest_order(self, tmp_path):
        ck = CheckpointManager(str(tmp_path / "ck"))
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        b = np.array([1, -2, 3], dtype=np.int32)
        ck.save("one", {"a": a})
        ck.save("two", {"a": torch.from_numpy(a), "b": b})
        assert ck.completed == ["one", "two"]
        got = ck.load("two")
        np.testing.assert_array_equal(got["a"], a)
        np.testing.assert_array_equal(got["b"], b)
        ck2 = CheckpointManager(str(tmp_path / "ck"))
        assert ck2.has("one") and ck2.has("two")

    def test_clear(self, tmp_path):
        ck = CheckpointManager(str(tmp_path / "ck"))
        ck.save("s", {"x": np.zeros(2)})
        ck.clear()
        assert not ck.has("s") and ck.completed == []

    def test_corrupt_stage_raises(self, tmp_path):
        ck = CheckpointManager(str(tmp_path / "ck"))
        ck.save("s", {"x": np.arange(64, dtype=np.float64)})
        p = os.path.join(ck.path, "s.ckpt")
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0x40
        open(p, "wb").write(bytes(raw))
        with pytest.raises(CorruptIndexError):
            ck.load("s")

    def test_atomic_write_replaces(self, tmp_path):
        p = str(tmp_path / "f.bin")
        atomic_write(p, b"v1")
        atomic_write(p, b"v2-longer")
        assert open(p, "rb").read() == b"v2-longer"
        assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []

    def test_save_fault_site(self, tmp_path):
        ck = CheckpointManager(str(tmp_path / "ck"))
        with inject("checkpoint.save"):
            with pytest.raises(TransientFault):
                ck.save("s", {"x": np.zeros(1)})
        assert not ck.has("s")

    def test_bad_stage_name_rejected(self, tmp_path):
        from raft_tpu_torch.core.error import LogicError

        ck = CheckpointManager(str(tmp_path / "ck"))
        with pytest.raises(LogicError, match="bad stage name"):
            ck.save("a/b", {"x": np.zeros(1)})

    @pytest.mark.parametrize("writer", ["raft_tpu", "port"])
    def test_stage_files_read_in_either_package(self, tmp_path, writer):
        """The same arrays make the same stage file in both packages, and a
        stage either one wrote loads in the other to the same arrays."""
        arrays = {"centers": np.arange(24, dtype=np.float32).reshape(6, 4),
                  "ids": np.array([3, -1, 7], np.int32),
                  "state": np.arange(5, dtype=np.uint8)}
        a = JaxCheckpointManager(str(tmp_path / "jax"))
        b = CheckpointManager(str(tmp_path / "port"))
        a.save("kmeans", arrays)
        b.save("kmeans", arrays)
        files = [open(os.path.join(m.path, "kmeans.ckpt"), "rb").read()
                 for m in (a, b)]
        assert files[0] == files[1]
        src = a if writer == "raft_tpu" else b
        reader = (CheckpointManager if writer == "raft_tpu"
                  else JaxCheckpointManager)(src.path)
        assert reader.completed == ["kmeans"]
        got = reader.load("kmeans")
        assert sorted(got) == sorted(arrays)
        for name, arr in arrays.items():
            np.testing.assert_array_equal(got[name], arr)
            assert got[name].dtype == arr.dtype

    def test_port_resumes_from_a_raft_tpu_kmeans_stage(self, tmp_path):
        """A JAX build's ``kmeans`` stage (no generator state in it) is
        read by a resumed port build: its centers are the JAX centers, bit
        for bit, and the build completes."""
        rng = np.random.default_rng(0)
        db = rng.standard_normal((512, 32), dtype=np.float32)
        ckdir = str(tmp_path / "pq")
        p = dict(n_lists=16, kmeans_n_iters=2, pq_dim=8)
        from raft_tpu.core.interruptible import \
            InterruptedException as JaxInterrupted
        from raft_tpu.resilience import inject as jax_inject

        with jax_inject("interruptible.synchronize", times=1,
                        exc=JaxInterrupted):
            with pytest.raises(JaxInterrupted):
                jax_ivf_pq.build(JaxResources(seed=42),
                                 jax_ivf_pq.IndexParams(**p), db,
                                 checkpoint=ckdir)
        assert CheckpointManager(ckdir).completed == ["kmeans"]
        centers = JaxCheckpointManager(ckdir).load("kmeans")["centers"]
        out = ivf_pq.build(fresh_res(), ivf_pq.IndexParams(**p), db,
                           checkpoint=ckdir, resume=True)
        np.testing.assert_array_equal(out.centers.numpy(), centers)
        assert out.size == 512
        assert CheckpointManager(ckdir).completed == ["kmeans", "codebooks"]


# ---------------------------------------------------------------------------
# checkpointed builds: interruption + resume
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_calls(monkeypatch):
    """Counts of CheckpointManager.load / .save calls (the JAX tests read
    the resilience.checkpoint counters instead)."""
    calls = {"load": 0, "save": 0}
    for name in calls:
        orig = getattr(CheckpointManager, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(CheckpointManager, name, spy)
    return calls


PQ_LEAVES = ("centers", "codebooks", "list_codes", "list_indices",
             "list_sizes", "list_recon")


def _pq_data():
    rng = np.random.default_rng(0)
    return rng.standard_normal((512, 32), dtype=np.float32)


PQ = ivf_pq.IndexParams(n_lists=16, kmeans_n_iters=2, pq_dim=8)


class TestInterruptAndResume:
    def test_ivf_pq_injected_interrupt_then_resume(self, tmp_path,
                                                   ckpt_calls):
        db = _pq_data()
        ref = ivf_pq.build(fresh_res(), PQ, db)
        ckdir = str(tmp_path / "pq")
        # kill the build at its first sync point, after the kmeans stage
        # is durable (the save comes before synchronize)
        with inject("interruptible.synchronize", times=1,
                    exc=InterruptedException):
            with pytest.raises(InterruptedException):
                ivf_pq.build(fresh_res(), PQ, db, checkpoint=ckdir)
        assert CheckpointManager(ckdir).completed == ["kmeans"]
        ckpt_calls.update(load=0, save=0)
        resumed = ivf_pq.build(fresh_res(), PQ, db, checkpoint=ckdir,
                               resume=True)
        # the completed stage loaded once, not recomputed; only the
        # remaining stage saved
        assert ckpt_calls == {"load": 1, "save": 1}
        saved = CheckpointManager(ckdir).load("kmeans")
        np.testing.assert_array_equal(resumed.centers.numpy(),
                                      saved["centers"])
        for leaf in PQ_LEAVES:
            assert torch.equal(getattr(ref, leaf), getattr(resumed, leaf)), \
                leaf

    def test_cagra_thread_cancel_then_resume(self, tmp_path):
        rng = np.random.default_rng(0)
        db = rng.standard_normal((256, 16), dtype=np.float32)
        p = cagra.IndexParams(intermediate_graph_degree=16, graph_degree=8)
        ref = cagra.build(fresh_res(), p, db)
        ckdir = str(tmp_path / "cg")
        box = {}
        started, go = threading.Event(), threading.Event()

        def worker():
            box["tid"] = threading.get_ident()
            started.set()
            go.wait()
            try:
                cagra.build(fresh_res(), p, db, checkpoint=ckdir)
                box["err"] = None
            except InterruptedException as e:
                box["err"] = e

        t = threading.Thread(target=worker)
        t.start()
        started.wait()
        # cancel from this thread before the build reaches its first sync
        # point: a deterministic interruption there
        interruptible.get_token(box["tid"]).cancel()
        go.set()
        t.join(60)
        assert isinstance(box["err"], InterruptedException)
        assert CheckpointManager(ckdir).completed == ["knn_graph"]
        resumed = cagra.build(fresh_res(), p, db, checkpoint=ckdir,
                              resume=True)
        # the kNN stage was not redone (its stage never ran); pruning was
        assert "knn_exact" not in cagra.build.stage_seconds
        assert "prune" in cagra.build.stage_seconds
        assert torch.equal(ref.graph, resumed.graph)

    def test_resume_from_complete_checkpoint_is_bit_identical(
            self, tmp_path, ckpt_calls):
        db = _pq_data()
        ckdir = str(tmp_path / "pq_full")
        full = ivf_pq.build(fresh_res(), PQ, db, checkpoint=ckdir)
        ckpt_calls.update(load=0, save=0)
        resumed = ivf_pq.build(fresh_res(), PQ, db, checkpoint=ckdir,
                               resume=True)
        assert ckpt_calls == {"load": 2, "save": 0}
        for leaf in PQ_LEAVES:
            assert torch.equal(getattr(full, leaf), getattr(resumed, leaf)), \
                leaf

    def test_the_generator_state_rides_with_each_stage(self, tmp_path):
        """Each port stage keeps the handle generator's state after it, so
        a resumed build's later draws are an uninterrupted build's."""
        db = _pq_data()
        ckdir = str(tmp_path / "gen")
        res = fresh_res()
        ivf_pq.build(res, PQ, db, checkpoint=ckdir)
        ck = CheckpointManager(ckdir)
        for stage in ("kmeans", "codebooks"):
            assert ckpt_mod.GENERATOR_STATE in ck.load(stage)
        np.testing.assert_array_equal(
            ck.load("codebooks")[ckpt_mod.GENERATOR_STATE],
            res.generator.get_state().numpy())

    def test_canaries_are_checked_after_a_resume(self, tmp_path):
        db = _pq_data()
        ckdir = str(tmp_path / "canary")
        p = ivf_pq.IndexParams(n_lists=16, kmeans_n_iters=2, pq_dim=8,
                               canary_queries=8, canary_k=5)
        ivf_pq.build(fresh_res(), p, db, checkpoint=ckdir)
        resumed = ivf_pq.build(fresh_res(), p, db, checkpoint=ckdir,
                               resume=True)
        assert resumed.canaries is not None
        assert resumed.canaries.build_recall >= resumed.canaries.floor


def test_synchronize_checks_the_token_on_both_sides():
    """A pending cancel raises at the next sync point, once; the sync
    point is also the fault site ``interruptible.synchronize``."""
    tok = interruptible.get_token()
    tok.cancel()
    with pytest.raises(InterruptedException):
        interruptible.synchronize(torch.zeros(1))
    interruptible.synchronize()                      # the flag was consumed
    assert not tok.cancelled()
    with inject("interruptible.synchronize", times=1):
        with pytest.raises(TransientFault):
            interruptible.synchronize()
    interruptible.release_token()


def test_resilience_counters_match_the_reference(tmp_path, monkeypatch):
    """One script in both packages under collection — an injected fault,
    a delayed site, a retry that recovers, one that gives up, a deadline
    spent, checkpoint saves and loads — leaves the same ``resilience.*``
    counters."""
    import raft_tpu.observability as jobs
    import raft_tpu.resilience as jres
    import raft_tpu_torch.observability as tobs
    import raft_tpu_torch.resilience as tres
    from raft_tpu.resilience import faults as jfaults
    from raft_tpu.resilience import retry as jretry

    monkeypatch.setattr(jretry, "_sleep", lambda s: None)
    for mod in (jfaults, faults):
        monkeypatch.setattr(mod, "_sleep", lambda s: None)
    site = ".".join(("site", "g"))
    out = []
    for obs, res_mod, fmod in ((jobs, jres, jfaults), (tobs, tres, faults)):
        obs.reset()
        with obs.collecting():
            with res_mod.inject(site):
                with pytest.raises(res_mod.TransientFault):
                    fmod.maybe_fail(site)
            plan = res_mod.FaultPlan(seed=0).delay_at(site + "d", delay=0.1)
            with plan.active():
                fmod.maybe_fail(site + "d")
                fmod.maybe_fail(site + "d")
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) < 2:
                    raise res_mod.TransientFault("once")
                return 1

            res_mod.retry_call(flaky, site="t.recover",
                               policy=res_mod.RetryPolicy(max_attempts=3))

            def always():
                raise res_mod.TransientFault("always")

            with pytest.raises(res_mod.TransientFault):
                res_mod.retry_call(always, site="t.exhaust",
                                   policy=res_mod.RetryPolicy(max_attempts=2))
            with pytest.raises(res_mod.DeadlineExceededError):
                res_mod.retry_call(always, site="t.deadline",
                                   deadline=res_mod.Deadline(-1.0))
            mgr = res_mod.CheckpointManager(str(tmp_path / obs.__name__))
            mgr.save("a", {"x": np.arange(3)})
            mgr.save("b", {"x": np.arange(2)})
            mgr.load("a")
        out.append({n: v for n, v in obs.snapshot()["counters"].items()
                    if n.startswith("resilience")})
        obs.reset()
    assert out[0] == out[1]
    assert len(out[1]) == 8 and all(v >= 1 for v in out[1].values())

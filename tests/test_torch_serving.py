"""The port's serving layer (``raft_tpu_torch.serving``: buckets, admission,
the dynamic batcher, executors and the ``Server``) on the CPU, against the
JAX package where both can serve the same index.

- Served results: the port's ``Server`` and the JAX ``Server`` answer the
  same requests, at ``max_batch`` 8, over one ``raft_tpu`` build carried
  into the port through ``serialize``: ids equal but among ties at a
  row's edge, distances within 1e-4 relative (the recon scans' bf16
  products summed in another order).
- The cases of ``tests/test_serving.py:78-290`` on the port alone: the
  closed bucket set, token buckets, queue-full / quota / deadline sheds,
  the max-wait and full-bucket dispatch triggers, deadline expiry while
  queued, coalesced batches equal to direct searches, mixed k, padded and
  masked rows; then warm executors (no cache miss after warm-up, across a
  generation swap), IVF-Flat and brute-force executors, the generation
  watchdog and the serving flight events.

Every server runs in a ``with`` block and every ``Future.result`` takes a
timeout, so a hang fails one test.  Card tests (marked ``cuda``): zero new
captures over a traffic mix after warm-up and across ``swap_index``, a
replay equal to the live search; they need neither jax nor raft_tpu::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_serving.py
"""

import gc
import io
import threading
import time

import numpy as np
import pytest
import torch

try:
    from raft_tpu import DeviceResources as JaxResources
    from raft_tpu import serving as jax_serving
    from raft_tpu.neighbors import ivf_pq as jp
except ImportError:   # a machine with the port only: the card tests run
    JaxResources = jax_serving = jp = None
from raft_tpu_torch import DeviceResources, config, serving
from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import aot
from raft_tpu_torch.integrity import ValidationError
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.observability import flight, trace
from raft_tpu_torch.resilience.retry import Deadline, DeadlineExceededError

CPU = DeviceResources(device="cpu", seed=42)
N, DIM, K = 3000, 32, 5
TIMEOUT = 30
SEP = "."
# served distances against the JAX server's: relative
RTOL = 1e-4


def dotted(*parts):
    return SEP.join(parts)


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.disable()
    obs.reset()
    trace.disable_tracing()
    flight.clear()
    yield
    obs.disable()
    obs.reset()
    trace.disable_tracing()
    flight.clear()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, DIM)).astype(np.float32),
            rng.standard_normal((64, DIM)).astype(np.float32))


@pytest.fixture(scope="module")
def pq(data):
    db, q = data
    index = ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=32, pq_dim=8,
                                                 kmeans_n_iters=4), db)
    return index, ivf_pq.SearchParams(n_probes=8), q


def _executor(pq, max_batch=16, ks=(K,), warm="aot", index=None):
    idx, sp, _ = pq
    return serving.Executor(CPU, "ivf_pq", index or idx, ks=ks,
                            max_batch=max_batch, search_params=sp,
                            warm=warm)


def _same(d, i, rd, ri, rtol=0.0):
    """Distances within ``rtol`` (relative); ids equal wherever a row's
    distance is not tied with the row's last kept one."""
    d, i, rd, ri = (np.asarray(x) for x in (d, i, rd, ri))
    np.testing.assert_allclose(d, rd, rtol=rtol, atol=rtol)
    edge = rd[:, -1:] - np.abs(rd[:, -1:]) * rtol * 4
    inner = rd < edge
    np.testing.assert_array_equal(np.where(inner, i, -2),
                                  np.where(inner, ri, -2))


# ---------------------------------------------------------------------------
# served results against the JAX server
# ---------------------------------------------------------------------------

def test_served_results_equal_the_jax_servers(data):
    if jp is None:
        pytest.skip("needs jax and raft_tpu (the reference package)")
    db, q = data
    jidx = jp.build(JaxResources(seed=0), jp.IndexParams(
        n_lists=16, pq_dim=8, kmeans_n_iters=4), db)
    buf = io.BytesIO()
    jp.serialize(JaxResources(seed=0), buf, jidx)
    port = ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()))
    sizes = (1, 3, 8, 5, 2, 7)
    cfg = dict(max_batch=8, max_wait_us=2_000)
    jex = jax_serving.Executor(JaxResources(seed=0), "ivf_pq", jidx,
                               ks=(K,), max_batch=8,
                               search_params=jp.SearchParams(n_probes=4))
    tex = serving.Executor(CPU, "ivf_pq", port, ks=(K,), max_batch=8,
                           search_params=ivf_pq.SearchParams(n_probes=4))
    outs = {}
    for name, mod, ex in (("jax", jax_serving, jex), ("port", serving, tex)):
        with mod.Server(ex, mod.ServerConfig(**cfg)) as srv:
            s, got = 0, []
            for m in sizes:
                got.append(srv.search(q[s:s + m], K, timeout=TIMEOUT))
                s += m
        outs[name] = got
    for (jd, ji), (td, ti) in zip(outs["jax"], outs["port"]):
        _same(td, ti, np.asarray(jd), np.asarray(ji), RTOL)


# ---------------------------------------------------------------------------
# buckets and admission
# ---------------------------------------------------------------------------

def test_bucket_sizes_and_bucket_for():
    assert serving.bucket_sizes(16) == (1, 2, 4, 8, 16)
    assert serving.bucket_sizes(24) == (1, 2, 4, 8, 16, 24)
    assert serving.bucket_sizes(16, min_bucket=4) == (4, 8, 16)
    assert [serving.bucket_for(n, 16) for n in (1, 3, 16)] == [1, 4, 16]
    with pytest.raises(Exception):
        serving.bucket_for(17, 16)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pad_rows_and_valid_rows_mask(as_tensor):
    x = torch.ones(3, 4) if as_tensor else np.ones((3, 4), np.float32)
    p = serving.pad_rows(x, 8)
    assert tuple(p.shape) == (8, 4) and isinstance(p, type(x))
    assert (np.asarray(p[3:]) == 0).all() and (np.asarray(p[:3]) == 1).all()
    assert serving.pad_rows(x, 3) is x
    m = serving.valid_rows_mask(3, 8)
    assert m.dtype == torch.bool and m.tolist() == [True] * 3 + [False] * 5


def test_token_bucket():
    t = [0.0]
    tb = serving.TokenBucket(rate=10.0, burst=5.0, clock=lambda: t[0])
    assert tb.try_acquire(5) and not tb.try_acquire(1)
    t[0] += 0.5
    assert tb.try_acquire(5) and not tb.try_acquire(1)


def test_queue_full_sheds_and_parked_request_completes(pq):
    cfg = serving.ServerConfig(max_batch=16, max_queue_rows=4,
                               max_wait_us=50_000)
    q = pq[2]
    with serving.Server(_executor(pq, warm="jit"), cfg) as srv:
        srv.batcher.stop(drain=False)
        fut = srv.submit(q[:3], K)
        with pytest.raises(serving.Overloaded):
            srv.submit(q[:3], K)
        srv.batcher.start()
        assert fut.result(timeout=TIMEOUT)[0].shape == (3, K)


def test_oversized_unknown_k_and_expired_deadline_are_refused(pq):
    q = pq[2]
    with serving.Server(_executor(pq, warm="jit"),
                        serving.ServerConfig(max_batch=16)) as srv:
        with pytest.raises(serving.Overloaded):
            srv.submit(q[:17], K)
        with pytest.raises(Exception):
            srv.submit(q[:2], 7)
        with pytest.raises(serving.Overloaded):
            srv.submit(q[:2], K, deadline=Deadline(0.0))


def test_tenant_quota_exhaustion(pq):
    cfg = serving.ServerConfig(max_batch=16, max_wait_us=100.0,
                               tenant_quotas={"metered": (1.0, 4.0)})
    q = pq[2]
    with serving.Server(_executor(pq, warm="jit"), cfg) as srv:
        srv.search(q[:4], K, tenant="metered", timeout=TIMEOUT)
        with pytest.raises(serving.QuotaExceeded):
            srv.submit(q[:4], K, tenant="metered")
        assert srv.search(q[:4], K, tenant="other",
                          timeout=TIMEOUT)[0].shape == (4, K)
    assert issubclass(serving.QuotaExceeded, serving.Overloaded)
    assert issubclass(serving.BrownedOut, serving.Overloaded)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

def test_single_query_dispatches_on_max_wait(pq):
    cfg = serving.ServerConfig(max_batch=16, max_wait_us=20_000)
    q = pq[2]
    with serving.Server(_executor(pq, warm="jit"), cfg) as srv:
        t0 = time.monotonic()
        d, i = srv.submit(q[:1], K).result(timeout=TIMEOUT)
        assert time.monotonic() - t0 < 5.0
        assert d.shape == (1, K) and i.min() >= 0


def test_full_bucket_dispatches_before_max_wait(pq):
    cfg = serving.ServerConfig(max_batch=8, max_wait_us=60_000_000)
    q = pq[2]
    with serving.Server(_executor(pq, max_batch=8, warm="jit"), cfg) as srv:
        futs = [srv.submit(q[j:j + 1], K) for j in range(8)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert all(o[0].shape == (1, K) for o in outs)


def test_deadline_expiry_while_queued(pq):
    cfg = serving.ServerConfig(max_batch=16, max_wait_us=200_000)
    q = pq[2]
    t = [0.0]
    with serving.Server(_executor(pq, warm="jit"), cfg) as srv:
        doomed = srv.submit(q[:2], K, deadline=Deadline(
            0.05, clock=lambda: t[0]))
        t[0] += 1.0
        ok = srv.submit(q[:3], K)
        assert ok.result(timeout=TIMEOUT)[0].shape == (3, K)
        with pytest.raises(DeadlineExceededError):
            doomed.result(timeout=TIMEOUT)


def test_coalesced_batches_equal_direct_searches(pq):
    idx, sp, q = pq
    cfg = serving.ServerConfig(max_batch=16, max_wait_us=50_000)
    with serving.Server(_executor(pq), cfg) as srv:
        futs = [srv.submit(q[j * 3:(j + 1) * 3], K) for j in range(4)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    for j, (d, i) in enumerate(outs):
        dd, ii = ivf_pq.search(CPU, sp, idx, q[j * 3:(j + 1) * 3], K)
        np.testing.assert_array_equal(i, ii.numpy())
        np.testing.assert_allclose(d, dd.numpy(), rtol=1e-6)


def test_mixed_k_split_into_separate_batches(pq):
    cfg = serving.ServerConfig(max_batch=16, max_wait_us=10_000)
    q = pq[2]
    with serving.Server(_executor(pq, ks=(K, 10), warm="jit"), cfg) as srv:
        f5 = srv.submit(q[:2], K)
        f10 = srv.submit(q[:2], 10)
        assert f5.result(timeout=TIMEOUT)[0].shape == (2, K)
        assert f10.result(timeout=TIMEOUT)[0].shape == (2, 10)


def test_many_client_threads(pq):
    idx, sp, q = pq
    cfg = serving.ServerConfig(max_batch=16, max_wait_us=1_000)
    got = {}
    with serving.Server(_executor(pq), cfg) as srv:
        def client(c):
            for j in range(4):
                s = (c * 4 + j) % 60
                got[(c, j)] = (s, srv.search(q[s:s + 3], K,
                                             timeout=TIMEOUT))
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
    assert len(got) == 24
    for s, (d, i) in got.values():
        np.testing.assert_array_equal(
            i, ivf_pq.search(CPU, sp, idx, q[s:s + 3], K)[1].numpy())


# ---------------------------------------------------------------------------
# padded and masked rows
# ---------------------------------------------------------------------------

def test_padded_rows_are_masked(pq):
    ex = _executor(pq)
    ex.warmup()
    d, i = ex.search_bucket(ex.pad(pq[2][:3], 8), 3, K)
    d, i = d.numpy(), i.numpy()
    assert (i[3:] == -1).all() and np.isposinf(d[3:]).all()
    assert (i[:3] >= 0).all() and np.isfinite(d[:3]).all()


def test_nonfinite_rows_masked_under_mask_and_refused_under_raise(pq):
    q = pq[2][:4].copy()
    q[1] = np.nan
    with serving.Server(_executor(pq, warm="jit"),
                        serving.ServerConfig(max_batch=16,
                                             max_wait_us=5_000)) as srv:
        with config.validation_policy("mask"):
            d, i = srv.search(q, K, timeout=TIMEOUT)
        assert (i[1] == -1).all() and np.isposinf(d[1]).all()
        assert (i[[0, 2, 3]] >= 0).all()
        with config.validation_policy("raise"):
            with pytest.raises(ValidationError):
                srv.submit(q, K)


# ---------------------------------------------------------------------------
# warm executors, swaps, other kinds
# ---------------------------------------------------------------------------

def _misses():
    return obs.registry().counter(dotted("aot", "cache", "misses")).value


@pytest.mark.parametrize("mode", ["auto", "fused"])
def test_no_cache_miss_after_warmup_or_across_a_swap(pq, mode):
    idx, _, q = pq
    sp = ivf_pq.SearchParams(n_probes=8, scan_mode=mode, per_probe_topk=4)
    ex = serving.Executor(CPU, "ivf_pq", idx, ks=(K,), max_batch=16,
                          search_params=sp)
    with obs.collecting():
        with serving.Server(ex, serving.ServerConfig(
                max_batch=16, max_wait_us=2_000)) as srv:
            for m in (1, 3, 8, 16, 5, 2):
                srv.search(q[:m], K, timeout=TIMEOUT)
            m0 = _misses()
            for m in (2, 16, 1, 7):
                srv.search(q[:m], K, timeout=TIMEOUT)
            assert _misses() == m0
            mutated = ivf_pq.delete(CPU, idx, [0, 1, 2])
            assert srv.swap_index(mutated) == len(ex.buckets)
            m1 = _misses()
            for m in (4, 16, 3):
                _, i = srv.search(q[:m], K, timeout=TIMEOUT)
                assert not np.isin(i, [0, 1, 2]).any()
            assert _misses() == m1
        swaps = obs.registry().counter(
            dotted("serving", "generation_swaps")).value
    assert swaps == 1 and ex.fallbacks == {}
    assert aot.executables().captures == 0


def _swap_repeatedly(srv, index, res, q, n_swaps=4):
    """``(cache entries, pool bytes)`` after each of ``n_swaps`` swaps to
    a new generation (one more row deleted each time), with one search
    between swaps.  The caller holds ``index``; the server holds its last
    good generation, so from the second swap on three tables are alive."""
    sizes = []
    cur = index
    for s in range(n_swaps):
        cur = ivf_pq.delete(res, cur, [s])
        srv.swap_index(cur)
        gc.collect()
        srv.search(q[:3], K, timeout=TIMEOUT)
        sizes.append((len(aot.executables()), srv.executor.pool.bytes()))
    return sizes


def test_a_dead_generation_leaves_the_executable_cache(pq):
    """Repeated swaps keep the cache at the same size: a generation no one
    holds takes its bucket searches with it."""
    idx, sp, q = pq
    ex = serving.Executor(CPU, "ivf_pq", idx, ks=(K,), max_batch=4,
                          search_params=sp)
    with serving.Server(ex, serving.ServerConfig(max_batch=4,
                                                 max_wait_us=500)) as srv:
        sizes = _swap_repeatedly(srv, idx, CPU, q)
    assert [n for n, _ in sizes[1:]] == [sizes[1][0]] * 3, sizes


def test_swap_rejects_a_dim_mismatch(pq, data):
    narrow = ivf_pq.build(CPU, ivf_pq.IndexParams(
        n_lists=8, pq_dim=4, kmeans_n_iters=2), data[0][:500, :16])
    with pytest.raises(Exception, match="dim"):
        _executor(pq, warm="jit").swap_index(narrow)


def test_extend_then_swap_serves_the_new_row_at_every_bucket(pq):
    idx, _, _ = pq
    far = np.full((1, DIM), 50.0, np.float32)
    with serving.Server(_executor(pq), serving.ServerConfig(
            max_batch=16, max_wait_us=2_000)) as srv:
        extended = ivf_pq.extend(CPU, idx, far, np.asarray([N], np.int64))
        srv.swap_index(extended)
        for m in (1, 3, 16):
            _, ids = srv.search(np.repeat(far, m, 0), K, timeout=TIMEOUT)
            assert (ids[:, 0] == N).all()


def test_ivf_flat_and_brute_force_executors(data):
    db, q = data
    flat = ivf_flat.build(CPU, ivf_flat.IndexParams(n_lists=16,
                                                    kmeans_n_iters=4), db)
    fsp = ivf_flat.SearchParams(n_probes=8)
    for kind, index, sp, ref in (
            ("ivf_flat", flat, fsp,
             ivf_flat.search(CPU, fsp, flat, q[:3], K)),
            ("brute_force", db, None, brute_force.knn(CPU, db, q[:3], K))):
        ex = serving.Executor(CPU, kind, index, ks=(K,), max_batch=8,
                              search_params=sp)
        with serving.Server(ex, serving.ServerConfig(max_batch=8)) as srv:
            d, i = srv.search(q[:3], K, timeout=TIMEOUT)
        np.testing.assert_array_equal(i, ref[1].numpy())


def test_refused_exports_warn_and_serve_live(pq, monkeypatch):
    def refuse(*a, **kw):
        raise RuntimeError("refused")

    monkeypatch.setattr(aot, "_bake_ivf_pq", refuse)
    monkeypatch.setattr(aot, "_EXECUTABLES", aot.ExecutableCache())
    ex = _executor(pq, max_batch=2)
    with pytest.warns(UserWarning, match="falling back to live search"):
        ex.warmup()
    assert set(ex.fallbacks) == {(1, K, 0), (2, K, 0)}
    assert len(flight.events(dotted("serving", "aot_fallback"))) == 2
    d, _ = ex.search_bucket(pq[2][:2], 2, K)
    assert d.shape == (2, K)


def test_stats_and_serving_metrics(pq):
    with obs.collecting():
        with serving.Server(_executor(pq, warm="jit"), serving.ServerConfig(
                max_batch=16, max_wait_us=2_000)) as srv:
            for m in (1, 3, 5):
                srv.search(pq[2][:m], K, timeout=TIMEOUT)
            stats = srv.stats()
        snap = obs.snapshot()
    assert snap["counters"][dotted("serving", "admitted")] == 3
    assert snap["histograms"][dotted("serving", "latency", "total")][
        "count"] == 3
    assert stats["buckets"] == [1, 2, 4, 8, 16] and stats["routing"] is None
    with pytest.raises(NotImplementedError, match="item 7"):
        srv.refresh_routing()


def test_watchdog_rolls_back_after_strikes(pq):
    idx, _, q = pq
    cfg = serving.ServerConfig(max_batch=4, rollback_strikes=2,
                               rollback_window_s=60.0)
    with serving.Server(_executor(pq, max_batch=4, warm="jit"), cfg) as srv:
        mutated = ivf_pq.delete(CPU, idx, [5])
        srv.swap_index(mutated)
        assert not srv.note_integrity_strike("one")
        assert srv.note_integrity_strike("two")
        assert srv.executor.index is idx
    assert flight.events(dotted("serving", "auto_rollback"))


def test_shed_and_swap_land_flight_events(pq):
    with serving.Server(_executor(pq, warm="jit"), serving.ServerConfig(
            max_batch=16, max_queue_rows=2)) as srv:
        srv.batcher.stop(drain=False)
        srv.submit(pq[2][:2], K)
        with pytest.raises(serving.Overloaded):
            srv.submit(pq[2][:1], K)
        srv.batcher.start()
        srv.swap_index(pq[0])
    assert flight.events(dotted("serving", "shed", "queue_full"))
    assert flight.events(dotted("serving", "generation_swap"))


def test_traced_request_records_its_span_chain(pq):
    trace.enable_tracing()
    with serving.Server(_executor(pq, warm="jit"), serving.ServerConfig(
            max_batch=16, max_wait_us=2_000)) as srv:
        srv.search(pq[2][:2], K, timeout=TIMEOUT)
    names = {s.name for rec in flight.traces() for s in rec.spans}
    assert {dotted("serving", part) for part in
            ("admission", "queue", "exec", "result_slice")} <= names


def test_shadow_monitor_samples_and_estimates_recall(pq):
    """Served rows replay at full probe (``ground_truth_search_params``,
    the JAX package's point: every list, exact coarse ranking, no
    per-probe cut) on the served generation; at n_probes 8 of 32 the
    estimate is a recall, and the shadow's buckets are warm before
    start."""
    idx, sp, q = pq
    gt = serving.ground_truth_search_params("ivf_pq", idx, sp)
    assert (gt.n_probes, gt.scan_mode, gt.per_probe_topk,
            gt.exact_coarse) == (32, "recon", 0, True)
    monitor = serving.ShadowMonitor(serving.ShadowConfig(
        sample_rows_per_s=1e6, burst_rows=1e6, max_batch=8,
        window_s=3600.0))
    srv = serving.Server(_executor(pq), serving.ServerConfig(
        max_batch=16, max_wait_us=1_000))
    srv.attach_shadow(monitor)
    with srv:
        with pytest.raises(Exception, match="before Server.start"):
            srv.attach_shadow(serving.ShadowMonitor())
        for m in (4, 8, 3):
            srv.search(q[:m], K, timeout=TIMEOUT)
    monitor.flush()
    est = monitor.estimator.estimate()
    assert est is not None and est.rows == 15
    assert 0.5 <= est.recall <= 1.0
    assert monitor.executor.params.n_probes == 32
    with pytest.raises(ValueError):
        serving.ground_truth_search_params("cagra", idx)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "auto"])
def test_no_new_capture_after_warmup_or_across_a_swap_on_the_card(dev,
                                                                  mode):
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.standard_normal((20_000, 64)).astype(
        np.float32)).to(dev)
    q = rng.standard_normal((64, 64)).astype(np.float32)
    res = DeviceResources(seed=0)
    idx = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=64, pq_dim=32), db)
    sp = ivf_pq.SearchParams(n_probes=16, scan_mode=mode)
    ex = serving.Executor(res, "ivf_pq", idx, ks=(K,), max_batch=16,
                          search_params=sp)
    cache = aot.executables()
    with serving.Server(ex, serving.ServerConfig(max_batch=16,
                                                 max_wait_us=500)) as srv:
        c0 = cache.captures
        for m in (1, 3, 8, 16, 5, 2):
            d, i = srv.search(q[:m], K, timeout=TIMEOUT)
            _, ri = ivf_pq.search(res, ivf_pq.SearchParams(
                n_probes=16, scan_mode="recon"), idx, q[:m], K)
            assert (i == ri.cpu().numpy()).mean() > 0.99
        assert cache.captures == c0 and ex.fallbacks == {}
        srv.swap_index(ivf_pq.delete(res, idx, [0, 1]))
        c1 = cache.captures
        assert c1 - c0 == len(ex.buckets)
        for m in (2, 16, 7):
            srv.search(q[:m], K, timeout=TIMEOUT)
        assert cache.captures == c1


@pytest.mark.cuda
def test_graph_pool_stays_flat_across_repeated_swaps(dev):
    """A dead generation's graphs go with it, and a new generation's
    captures reuse their blocks: the executor's pool and the cache keep
    one size across repeated swaps."""
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.standard_normal((20_000, 64)).astype(
        np.float32)).to(dev)
    q = rng.standard_normal((64, 64)).astype(np.float32)
    res = DeviceResources(seed=0)
    idx = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=64, pq_dim=32), db)
    ex = serving.Executor(res, "ivf_pq", idx, ks=(K,), max_batch=16,
                          search_params=ivf_pq.SearchParams(
                              n_probes=16, scan_mode="fused"))
    with serving.Server(ex, serving.ServerConfig(max_batch=16,
                                                 max_wait_us=500)) as srv:
        sizes = _swap_repeatedly(srv, idx, res, q, n_swaps=5)
    assert sizes[1][1] > 0
    assert sizes[1:] == [sizes[1]] * 4, sizes

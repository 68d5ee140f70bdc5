"""Shadow-replay quality monitoring for the serving path (port of
``raft_tpu.serving.shadow``).

The serving stack's quality loop: a budgeted fraction of admitted query
rows is sampled AFTER their batch completes (the arrays are already
host-side — sampling adds zero device readbacks to the dispatch
thread), re-executed off the hot path at a **ground-truth operating
point** (full coarse probe, no per-probe candidate truncation) against
the SAME index generation that served them, and compared top-k against
top-k.  The per-window estimates, drift checks and operating-point log
live in :mod:`raft_tpu_torch.observability.quality`; this module owns the
sampling, the budget, the replay thread and its pre-warmed executor.

Contracts (the same ones the rest of serving holds):

- **zero steady-state captures** — the shadow executor warms its own
  closed (bucket, k) set at the ground-truth params during
  ``Server.start()``, and follows generation swaps by rebuilding its
  table inside ``Server.swap_index`` (already the slow path).  Samples
  from a generation the shadow executor has moved past are dropped
  (``serving.shadow.dropped.generation``) — an estimate never mixes
  generations.
- **zero added host syncs on the request path** — ``offer()`` touches
  only numpy arrays the batcher already read back; the replay's own
  device round-trip happens on the shadow thread.
- **zero cost when disabled** — ``offer()`` is one flag check; with no
  monitor attached the batcher pays one ``None`` check.

Degradation verdicts reuse the integrity layer's canary floor: when the
Wilson lower confidence bound of a (tenant, k) window falls below the
floor, a ``serving.quality.degraded`` flight event fires, and (opt-in)
the generation watchdog takes a strike — live recall loss becomes a
rollback signal with the same machinery as a canary failure.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.observability import quality as _quality
from raft_tpu_torch.serving.admission import TokenBucket
from raft_tpu_torch.serving.buckets import bucket_for


def _count(name: str, n: int = 1) -> None:
    if obs.enabled():
        obs.registry().counter(name).inc(n)


@dataclasses.dataclass
class ShadowConfig:
    """Shadow sampling knobs.

    ``sample_rows_per_s`` / ``burst_rows`` meter the GLOBAL replay
    budget in query rows per second (the same token-bucket units as
    admission quotas); ``tenant_budgets`` overrides per tenant.  The
    budget bounds replay device work, so the replay overhead is a
    configuration property, not luck.  ``max_batch`` caps the shadow
    executor's bucket set — larger sampled batches are truncated.
    ``recall_floor`` defaults to the served index's canary floor (the
    build-time quality contract); ``arm_watchdog`` additionally files an
    integrity strike per degraded window, making sustained live recall
    loss a rollback trigger.  ``ground_truth_params`` overrides the
    derived full-probe operating point (required for index kinds
    without a derivable exact point, e.g. CAGRA).
    """

    sample_rows_per_s: float = 64.0
    burst_rows: float = 128.0
    tenant_budgets: Optional[Dict[str, Tuple[float, float]]] = None
    max_backlog: int = 16
    max_batch: int = 64
    window_s: float = 30.0
    # rows a window needs before a degraded verdict may fire — a 2-row
    # window's lower bound is meaninglessly wide
    min_rows: int = 8
    z: float = _quality.DEFAULT_Z
    recall_floor: Optional[float] = None
    arm_watchdog: bool = False
    op_log_path: Optional[str] = None
    op_log_max_bytes: int = 1 << 20
    op_log_keep: int = 8
    ground_truth_params: Optional[object] = None
    drift: Optional[_quality.DriftThresholds] = None
    track_swaps: bool = True


@dataclasses.dataclass
class ShadowSample:
    """One sampled slice of a served request, host-side."""

    queries: np.ndarray       # (n, dim) as served
    served_ids: np.ndarray    # (n, k) ids the request was answered with
    k: int
    tenant: str
    rung: int
    index: Any                # the generation snapshot that served it
    t: float
    # the request's packed admission bitset (host numpy, (n, n_words))
    # — the ground-truth replay runs under the SAME filter the served
    # answer did, so a selective filter never reads as recall loss
    filter_words: Optional[np.ndarray] = None


def ground_truth_search_params(kind: str, index, params=None):
    """The derived ground-truth operating point for a local executor:
    every coarse list probed, exact coarse ranking, no per-probe
    candidate truncation — the strongest answer the SAME index can give
    (RAFT's recall-vs-reference methodology, with the index itself as
    the reference since raw vectors are gone at serve time)."""
    if kind == "brute_force":
        return None               # already exact
    if kind == "ivf_pq":
        from raft_tpu_torch.neighbors import ivf_pq as _pq
        base = params if params is not None else _pq.SearchParams()
        mode = ("recon" if getattr(index, "list_recon", None) is not None
                else "lut")
        return dataclasses.replace(
            base, n_probes=int(index.n_lists), scan_mode=mode,
            per_probe_topk=0, exact_coarse=True, use_reconstruction=None)
    if kind == "ivf_flat":
        from raft_tpu_torch.neighbors import ivf_flat as _flat
        base = params if params is not None else _flat.SearchParams()
        return dataclasses.replace(base, n_probes=int(index.n_lists))
    raise ValueError(
        f"serving.shadow: no derivable ground-truth operating point for "
        f"executor kind {kind!r} — pass ShadowConfig.ground_truth_params")


class ShadowMonitor:
    """The live quality monitor: sampler + replay thread + estimator.

    Wiring (mirrors ``attach_ingest``)::

        monitor = serving.ShadowMonitor(serving.ShadowConfig(...))
        server.attach_ingest(ingest)      # first, if any — the shadow
        server.attach_shadow(monitor)     # executor shares the delta view
        server.start()                    # warms shadow executables too

    ``attach_shadow`` must run BEFORE ``start()`` (the shadow bucket set
    is part of the warmed-shape contract) and AFTER ``attach_ingest``
    when an ingest tier exists — the ground-truth replay must see the
    same memtable merge the served answer saw, or fresh delta-tier hits
    would read as recall loss."""

    def __init__(self, config: Optional[ShadowConfig] = None, *,
                 clock=time.monotonic) -> None:
        self.config = config or ShadowConfig()
        self._clock = clock
        self._enabled = True
        self._server = None
        self._executor = None
        self._delta_attached = False
        self._budget = TokenBucket(self.config.sample_rows_per_s,
                                   self.config.burst_rows, clock)
        self._tenant_budgets = {
            t: TokenBucket(r, b, clock)
            for t, (r, b) in (self.config.tenant_budgets or {}).items()}
        self.estimator = _quality.RecallEstimator(
            window_s=self.config.window_s, z=self.config.z)
        self.detector = _quality.DriftDetector(self.config.drift)
        self.op_log = (_quality.OperatingPointLog(
            self.config.op_log_path,
            max_bytes=self.config.op_log_max_bytes,
            keep=self.config.op_log_keep)
            if self.config.op_log_path else None)
        self._cond = threading.Condition()
        self._samples: deque = deque()
        self._stop = False
        self._flush_now = False
        self._thread: Optional[threading.Thread] = None
        self._last_flush = clock()
        # queries retained for the window's drift measurement (bounded)
        self._drift_queries: List[np.ndarray] = []
        self._drift_rows = 0
        self.last_records: List[Dict[str, Any]] = []

    # ---- wiring ----------------------------------------------------------

    def bind(self, server) -> None:
        """Attach to a Server (call via ``server.attach_shadow``)."""
        expects(self._server is None,
                "serving.shadow: monitor is already bound to a server")
        self._server = server
        self._executor = self._make_executor(server)

    def _make_executor(self, server):
        from raft_tpu_torch.serving.executor import Executor

        ex = server.executor
        mb = min(int(self.config.max_batch), ex.max_batch)
        params = (self.config.ground_truth_params
                  or ground_truth_search_params(ex.kind, ex.index,
                                                ex.params))
        return Executor(ex.res, ex.kind, ex.index, ks=ex.ks, max_batch=mb,
                        search_params=params, warm=ex.warm,
                        filter_rows=ex.filter_rows)

    @property
    def executor(self):
        return self._executor

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        """Freeze sampling: ``offer()`` becomes one flag check (the
        disabled-cost contract — no lock, no budget read, no copy)."""
        self._enabled = False

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "ShadowMonitor":
        """Warm the shadow executables and start the replay thread —
        called by ``Server.start()`` after the live executor warms."""
        expects(self._executor is not None,
                "serving.shadow: start before attach_shadow")
        server = self._server
        if (server is not None and server.ingest is not None
                and not self._delta_attached):
            self._executor.attach_delta(server.ingest.memtable.device_view)
            self._delta_attached = True
        n = self._executor.warmup()
        if obs.enabled():
            obs.registry().gauge("serving.shadow.warmed_executables").set(n)
        if self._thread is None:
            self._stop = False
            self._last_flush = self._clock()
            self._thread = threading.Thread(target=self._loop,
                                            name="raft-tpu-torch-serving-shadow",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the backlog, flush the final window, stop the thread."""
        if self._thread is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
        self._thread = None
        if self.op_log is not None:
            self.op_log.flush()

    def on_swap(self, new_index) -> None:
        """Follow a generation swap: rebuild the shadow fn table against
        the new generation (inside ``Server.swap_index`` — already the
        slow path), at the ground-truth point re-derived for it."""
        if not self.config.track_swaps or self._executor is None:
            return
        if self.config.ground_truth_params is None:
            self._executor.params = ground_truth_search_params(
                self._executor.kind, new_index,
                self._server.executor.params)
            self._executor._rung_params = (self._executor.params,)
        self._executor.swap_index(new_index)

    def mark_transition(self) -> None:
        """Flush the window at the next loop tick — called by the
        brownout controller on rung transitions so one operating-point
        record never straddles two rungs."""
        with self._cond:
            self._flush_now = True
            self._cond.notify_all()

    # ---- the sampling hook (dispatch thread — keep it readback-free) -----

    def offer(self, results, k, index, rung: int = 0) -> None:
        """Sample completed requests from one dispatched batch.

        ``results`` is the batcher's ``[(request, distances, ids), ...]``
        with HOST-side arrays — this method must never touch the device
        or read anything back (it runs on the dispatch thread, like the
        rest of the hot path).
        Disabled: one flag check."""
        if not self._enabled:
            return
        sampled = 0
        backlogged = 0
        for r, _rd, ri in results:
            budget = self._tenant_budgets.get(r.tenant, self._budget)
            if not budget.try_acquire(r.n):
                _count("serving.shadow.skipped.budget", r.n)
                continue
            q = r.queries
            ids = ri
            fw = getattr(r, "filter_words", None)
            if r.ok_rows is not None:
                ok = r.ok_rows
                q = q[ok]
                ids = ids[ok]
                if fw is not None:
                    fw = fw[np.asarray(ok)]
            if q.shape[0] == 0:
                continue
            sample = ShadowSample(queries=q.copy(), served_ids=ids.copy(),
                                  k=k, tenant=r.tenant, rung=rung,
                                  index=index, t=self._clock(),
                                  filter_words=(np.array(fw, np.int32)
                                                if fw is not None else None))
            sampled += sample.queries.shape[0]
            with self._cond:
                self._samples.append(sample)
                while len(self._samples) > self.config.max_backlog:
                    self._samples.popleft()
                    backlogged += 1
                self._cond.notify()
        if sampled:
            _count("serving.shadow.sampled", sampled)
        if backlogged:
            _count("serving.shadow.dropped.backlog", backlogged)

    # ---- the replay thread -----------------------------------------------

    def _loop(self) -> None:
        while True:
            sample = None
            flush_now = False
            with self._cond:
                if not self._samples and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._samples:
                    sample = self._samples.popleft()
                flush_now, self._flush_now = self._flush_now, False
                stopping = self._stop and sample is None
            if sample is not None:
                self._replay(sample)
            if stopping:
                break
            if (flush_now
                    or self._clock() - self._last_flush
                    >= self.config.window_s):
                self.flush()
        self.flush()

    def _replay(self, sample: ShadowSample) -> None:
        ex = self._executor
        if sample.index is not ex.index:
            # the served generation was swapped out before replay — an
            # estimate must never mix generations, so the sample dies
            _count("serving.shadow.dropped.generation")
            return
        q = sample.queries
        served = sample.served_ids
        fw = sample.filter_words
        if q.shape[0] > ex.max_batch:
            _count("serving.shadow.truncated",
                   q.shape[0] - ex.max_batch)
            q = q[:ex.max_batch]
            served = served[:ex.max_batch]
            if fw is not None:
                fw = fw[:ex.max_batch]
        n = int(q.shape[0])
        bucket = bucket_for(n, ex.max_batch)
        buf = np.zeros((bucket, ex.dim), dtype=ex.query_np_dtype)
        buf[:n] = q
        # filtered-recall accounting: the ground truth is computed under
        # the SAME admission bitset the served answer used — padded rows
        # get all-ones (they are sliced away below)
        fwords = None
        if fw is not None:
            nw = int(ex.n_filter_words)
            fbuf = np.full((bucket, nw), -1, dtype=np.int32)
            fbuf[:n] = fw
            fwords = torch.from_numpy(fbuf)
            _count("serving.shadow.replayed.filtered", n)
        with obs.stage("serving.shadow.replay"):
            _d, i = ex.search_bucket(torch.from_numpy(buf), n, sample.k,
                                     rung=0, filter_words=fwords)
            gt = i.cpu().numpy()[:n]
        hits = total = 0
        h_sample = (obs.registry().histogram("serving.quality.sample_recall")
                    if obs.enabled() else None)
        for row in range(n):
            g = gt[row]
            g = g[g >= 0]
            if g.size == 0:
                continue
            s = served[row]
            s = s[s >= 0]
            h = int(np.intersect1d(s, g).size)
            hits += h
            total += int(g.size)
            if h_sample is not None:
                h_sample.observe(h / g.size)
        if total:
            self.estimator.record(sample.tenant, sample.k, hits, total,
                                  rows=n)
        _count("serving.shadow.replayed", n)
        if self._drift_rows < self.config.max_batch:
            self._drift_queries.append(q)
            self._drift_rows += n

    # ---- the window flush ------------------------------------------------

    def _floor(self) -> Optional[float]:
        if self.config.recall_floor is not None:
            return float(self.config.recall_floor)
        if self._server is None:
            return None
        from raft_tpu_torch.integrity import canary as _canary
        return _canary.floor_of(self._server.executor.index)

    def flush(self) -> List[Dict[str, Any]]:
        """Close the current window: export gauges, emit degraded /
        drift verdicts, append operating-point records.  Runs on the
        replay thread (or synchronously from tests / bench)."""
        self._last_flush = self._clock()
        server = self._server
        ests = self.estimator.estimates()
        overall = self.estimator.estimate()
        latency = None
        if obs.enabled():
            reg = obs.registry()
            reg.counter("serving.quality.windows").inc()
            latency = reg.histogram("serving.latency.total").windowed_dict()
            if overall is not None:
                reg.gauge("serving.quality.recall").set(overall.recall)
                reg.gauge("serving.quality.recall_lo").set(overall.lo)
                reg.gauge("serving.quality.recall_hi").set(overall.hi)
                reg.gauge("serving.quality.samples").set(overall.rows)
            for (tenant, _k), est in ests.items():
                reg.gauge(f"serving.quality.recall.{tenant}").set(est.recall)
        floor = self._floor()
        p99 = (float(latency["p99"])
               if latency and latency.get("count") else None)
        records: List[Dict[str, Any]] = []
        for (tenant, k), est in ests.items():
            rec = {"tenant": tenant, "k": k, **est.as_dict(),
                   "p99_s": p99, "floor": floor}
            rec["degraded"] = bool(
                floor is not None and est.rows >= self.config.min_rows
                and est.lo < floor)
            records.append(rec)
            if rec["degraded"]:
                # always-on anomaly event: the live-quality analogue of
                # integrity.canary_failure, with the CI bound that fired
                _flight.record_event("serving.quality.degraded",
                                     tenant=tenant, k=k,
                                     recall=est.recall, lo=est.lo,
                                     hi=est.hi, rows=est.rows, floor=floor)
                _count("serving.quality.degraded")
                if self.config.arm_watchdog and server is not None:
                    server.note_integrity_strike(
                        f"shadow recall lower bound {est.lo:.3f} < floor "
                        f"{floor:.3f} (tenant {tenant!r}, k={k})")
        self.last_records = records
        if server is None:
            self._drift_queries, self._drift_rows = [], 0
            return records
        # drift + op-point log share one probe-stats measurement over
        # the window's sampled queries (off the hot path — syncs fine)
        index = server.executor.index
        knobs = server.executor.operating_knobs(server.brownout.rung)
        queries = (np.concatenate(self._drift_queries)
                   if self._drift_queries else None)
        self._drift_queries, self._drift_rows = [], 0
        probe_stats = None
        n_probes = knobs.get("n_probes")
        if queries is not None and n_probes:
            probe_stats = _quality.measure_probe_stats(
                index, queries[:self.config.max_batch], n_probes)
        memtable = (server.ingest.memtable
                    if server.ingest is not None else None)
        self.detector.check(index=index, memtable=memtable,
                            probe_stats=probe_stats)
        if self.op_log is not None and ests:
            from raft_tpu_torch.neighbors import mutate as _mutate
            gen = _mutate.generation(index)
            for (tenant, k), est in ests.items():
                kn = dict(knobs)
                kn["k"] = int(k)
                measured = est.as_dict()
                if latency and latency.get("count"):
                    for qtile in ("p50", "p95", "p99"):
                        measured[qtile] = float(latency[qtile])
                if probe_stats and "probed_rows_per_query" in probe_stats:
                    measured["scan_rows"] = (
                        probe_stats["probed_rows_per_query"])
                self.op_log.append(_quality.OpPoint(
                    t=time.time(), generation=gen, knobs=kn,
                    measured=measured, tenant=tenant))
        return records

    # ---- introspection ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "enabled": self._enabled,
            "backlog": len(self._samples),
            "estimates": {f"{t}/k={k}": e.as_dict()
                          for (t, k), e in self.estimator.estimates().items()},
            "records": list(self.last_records),
        }

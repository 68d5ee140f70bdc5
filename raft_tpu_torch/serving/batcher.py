"""Dynamic batcher — coalesce submissions into padded bucket batches (port
of ``raft_tpu.serving.batcher``).

One dispatcher thread drains the admission queue and cuts batches under
the policy the reference-class serving stacks use:
dispatch when the pending rows reach ``max_batch`` OR the oldest queued
request has waited ``max_wait_us`` — whichever comes first.  A cut batch
is concatenated, zero-padded up to its bucket (powers of two — see
:mod:`raft_tpu_torch.serving.buckets`), searched through the warmed executor,
and sliced back per request.  The dispatcher is the one thread that
replays an executor's captured graphs, so they never replay at once.

Timing uses ``time.monotonic`` (the deadline clock) — wall-profiling
belongs to :func:`raft_tpu_torch.observability.stage`, but the batcher needs
timestamps even when collection is off, because ``max_wait`` and
deadlines are control flow, not telemetry.  Histograms
(``serving.latency.queue``, ``.exec``, ``.total`` seconds and
``serving.batch_fill``) are recorded only while collection is enabled.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.observability import trace as _trace
from raft_tpu_torch.resilience import faults as _faults
from raft_tpu_torch.resilience.retry import DeadlineExceededError
from raft_tpu_torch.serving.admission import AdmissionQueue
from raft_tpu_torch.serving.buckets import bucket_for


class DynamicBatcher:
    """Owns the dispatcher thread between an admission queue and an
    executor (``raft_tpu_torch.serving.executor.Executor``).

    ``brownout`` is the server's shared
    :class:`~raft_tpu_torch.serving.brownout.BrownoutState`: each cut batch
    executes at the state's current executor rung (one lock-free int
    read — every rung is pre-warmed, so a level change never captures).
    ``on_error`` is called with the exception after a batch dispatch
    fails (after the per-request futures are failed) — the server's
    generation watchdog listens here for :class:`IntegrityError`.
    """

    def __init__(self, queue: AdmissionQueue, executor, *,
                 max_batch: int, max_wait_us: float,
                 on_batch: Optional[Callable] = None,
                 brownout=None,
                 on_error: Optional[Callable] = None) -> None:
        self.queue = queue
        self.executor = executor
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) * 1e-6
        self._on_batch = on_batch
        self._on_error = on_error
        self.brownout = brownout
        # live quality monitor (serving.shadow) — set by Server.start();
        # None costs one check per dispatched batch
        self.shadow = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._run,
                                        name="raft-tpu-torch-serving-batcher",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher.  With ``drain`` (default) queued requests
        are dispatched first; otherwise they fail with Overloaded."""
        if self._thread is None:
            return
        with self.queue.cond:
            self._drain = drain
            self._stop = True
            self.queue.cond.notify_all()
        self._thread.join(timeout=30.0)
        self._thread = None

    # ---- dispatcher loop ------------------------------------------------

    def _run(self) -> None:
        self._drain = True
        while True:
            batch = None
            with self.queue.cond:
                while True:
                    if self._stop and (not self._drain or not len(self.queue)):
                        break
                    oldest = self.queue.peek_oldest()
                    if oldest is None:
                        self.queue.cond.wait(timeout=0.1)
                        continue
                    waited = time.monotonic() - oldest.t_enqueue
                    if (self.queue.rows >= self.max_batch
                            or waited >= self.max_wait_s
                            or self._stop):
                        batch = self.queue.cut_batch(self.max_batch)
                        break
                    # no timeout underrun: wake exactly when the oldest
                    # request hits max_wait (or earlier on new arrivals)
                    self.queue.cond.wait(timeout=self.max_wait_s - waited)
            if batch:
                self._dispatch(batch)
            elif self._stop:
                self._fail_remaining()
                return

    def _fail_remaining(self) -> None:
        from raft_tpu_torch.serving.admission import Overloaded
        with self.queue.cond:
            rest = self.queue.cut_batch(10 ** 9)
            while rest:
                for r in rest:
                    r.future.set_exception(
                        Overloaded("serving: server stopped"))
                rest = self.queue.cut_batch(10 ** 9)

    # ---- one batch ------------------------------------------------------

    def _dispatch(self, batch) -> None:
        t_dispatch = time.monotonic()
        bo = self.brownout
        level = bo.level if bo is not None else 0
        rung = bo.rung if bo is not None else 0
        live = []
        for r in batch:
            if r.deadline is not None and r.deadline.expired:
                # the dispatch-phase half of the deadline-shed ledger:
                # SAME counter as the submit-phase check in admission
                # (phase distinguishes them on the flight event), so
                # `serving.shed.deadline` is the one total a dashboard
                # needs, and each request ticks it exactly once —
                # admission raises before enqueue, this path only sees
                # requests admission let through
                _count("serving.shed.deadline")
                _flight.record_event("serving.shed.deadline",
                                     trace_id=r.trace_id, tenant=r.tenant,
                                     rows=r.n, phase="dispatch",
                                     queued_s=t_dispatch - r.t_enqueue,
                                     level=level)
                if r.trace is not None:
                    r.trace.span("serving.queue", r.t_enqueue, t_dispatch)
                    r.trace.annotate("shed", True)
                    if level:
                        r.trace.annotate("brownout_level", level)
                    _flight.record_trace(r.trace.close(t_dispatch))
                r.future.set_exception(DeadlineExceededError(
                    f"serving: deadline expired after "
                    f"{t_dispatch - r.t_enqueue:.3f}s in queue"))
            else:
                live.append(r)
        if not live:
            return
        k = live[0].k
        n = sum(r.n for r in live)
        bucket = bucket_for(n, self.max_batch)
        # batch-level recorder: the batch's cut/exec spans and whatever the
        # executor path annotates are recorded once here and adopted
        # into every live request's trace afterwards.  Spans are immutable,
        # so sharing them across traces is safe.
        traced = [r for r in live if r.trace is not None]
        batch_rec = (_trace.SpanRecorder("serving.batch",
                                         trace_id=traced[0].trace.trace_id,
                                         t0=t_dispatch)
                     if traced else None)
        # batch assembly and result slicing are HOST-side numpy: request
        # sizes vary continuously, and the device only ever sees the
        # warmed (bucket, dim) shapes the graphs were captured at.
        buf = np.zeros((bucket, self.executor.dim),
                       dtype=self.executor.query_np_dtype)
        off = 0
        for r in live:
            buf[off:off + r.n] = np.asarray(r.queries)
            off += r.n
        # per-query admission bitsets ride the SAME assembly path: a
        # fixed (bucket, n_words) int32 buffer — data, not shape — with
        # all-ones rows (admit everything) for unfiltered requests and
        # padding.  Skipped entirely (None -> the executor's cached
        # all-ones buffer) when no live request carries a filter.
        fbuf = None
        nw = getattr(self.executor, "n_filter_words", 0)
        if nw and any(r.filter_words is not None for r in live):
            fbuf = np.full((bucket, nw), -1, dtype=np.int32)
            off = 0
            for r in live:
                if r.filter_words is not None:
                    fbuf[off:off + r.n] = r.filter_words
                off += r.n
        t_exec0 = time.monotonic()
        # the generation snapshot this batch serves from — pinned here so
        # the shadow monitor can refuse to compare across a swap
        idx_gen = self.executor.index
        try:
            # named fault site: latency plans here (faults.delay_at) are
            # how the chaos bench/CI slow the serving path down on
            # demand; inactive it is one None check on the hot path
            _faults.maybe_fail("serving.dispatch")
            with _trace.activating(batch_rec):
                # kwarg only when a live request carries a filter, so
                # executors (and test doubles) with the pre-filter
                # search_bucket signature keep working unfiltered
                fkw = ({"filter_words": torch.from_numpy(fbuf)}
                       if fbuf is not None else {})
                d, i = self.executor.search_bucket(
                    torch.from_numpy(buf), n, k, rung=rung, **fkw)
                # THE one readback: results must leave the device to
                # resolve request futures
                d, i = d.cpu().numpy(), i.cpu().numpy()
        except BaseException as e:  # noqa: BLE001 - forwarded per request
            _flight.record_event("serving.batch_error",
                                 trace_id=(traced[0].trace.trace_id
                                           if traced else None),
                                 error=repr(e), rows=n, bucket=bucket, k=k)
            for r in traced:
                r.trace.annotate("error", repr(e))
                _flight.record_trace(r.trace.close())
            # post-mortem artifact: if RAFT_TPU_FLIGHT_DUMP is set, the
            # ring (this error included) is written before futures fail
            _flight.maybe_auto_dump("serving.batch_error")
            for r in live:
                r.future.set_exception(e)
            if self._on_error is not None:
                self._on_error(e)
            return
        t_done = time.monotonic()
        if batch_rec is not None:
            batch_rec.span("serving.batch_cut", t_dispatch, t_exec0,
                           rows=n, bucket=bucket, requests=len(live))
            batch_rec.span("serving.exec", t_exec0, t_done)
            if level:
                batch_rec.annotate("brownout_level", level)
                batch_rec.annotate("rung", rung)
        self._record(live, n, bucket, t_dispatch, t_done)
        off = 0
        worst = np.inf if self.executor.select_min else -np.inf
        results = []
        for r in live:
            rd = d[off:off + r.n]
            ri = i[off:off + r.n]
            if r.ok_rows is not None:
                # per-request boundary mask (policy "mask"): same output
                # contract as integrity.boundary.mask_search_outputs,
                # applied host-side on the already-fetched slice
                bad = ~np.asarray(r.ok_rows)[:, None]
                rd = np.where(bad, np.asarray(worst, rd.dtype), rd)
                ri = np.where(bad, np.asarray(-1, ri.dtype), ri)
            off += r.n
            results.append((r, rd, ri))
        t_sliced = time.monotonic()
        for r, rd, ri in results:
            if r.trace is not None:
                rt = r.trace
                rt.span("serving.queue", r.t_enqueue, t_dispatch)
                rt.adopt(batch_rec)
                rt.span("serving.result_slice", t_done, t_sliced)
                _flight.record_trace(rt.close(t_sliced))
            r.future.set_result((rd, ri))
        sh = self.shadow
        if sh is not None:
            # host-side arrays only — the sampler must add no device
            # work to this thread (see ShadowMonitor.offer)
            sh.offer(results, k, idx_gen, rung)
        if self._on_batch is not None:
            self._on_batch(n, bucket)

    def _record(self, live, n, bucket, t_dispatch, t_done) -> None:
        if not obs.enabled():
            return
        reg = obs.registry()
        reg.counter("serving.batches").inc()
        reg.counter("serving.batched_rows").inc(n)
        reg.counter("serving.padded_rows").inc(bucket - n)
        reg.histogram("serving.batch_fill",
                      bounds=[i / 16 for i in range(1, 17)]).observe(
                          n / bucket)
        h_queue = reg.histogram("serving.latency.queue")
        h_total = reg.histogram("serving.latency.total")
        for r in live:
            h_queue.observe(t_dispatch - r.t_enqueue)
            h_total.observe(t_done - r.t_enqueue)
        reg.histogram("serving.latency.exec").observe(t_done - t_dispatch)


def _count(name: str) -> None:
    if obs.enabled():
        obs.registry().counter(name).inc()

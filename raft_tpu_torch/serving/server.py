"""The online serving front end — submit/search over a warmed executor
(port of ``raft_tpu.serving.server``).

Wiring: ``submit()`` boundary-validates the request (per-request batch),
stamps it with the enqueue time, and offers it to
the admission queue (shedding / quotas / deadline checks live there).
The dynamic batcher's dispatcher thread coalesces queued requests into
padded bucket batches and completes each request's Future.

Lifecycle::

    server = serving.Server(executor, serving.ServerConfig(...))
    server.start()                      # warms (captures) every bucket
    fut = server.submit(q, k=10)        # -> Future[(distances, indices)]
    d, i = server.search(q, k=10)       # submit + wait
    server.stop()

Zero-capture contract: ``start()`` warms every (bucket, k) executable;
afterwards the ``aot.captures`` counter stays flat under any traffic mix
that respects the closed shape set.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.integrity import IntegrityError
from raft_tpu_torch.integrity import boundary as _boundary
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.observability import trace as _trace
from raft_tpu_torch.resilience.retry import Deadline
from raft_tpu_torch.serving.admission import AdmissionQueue, Overloaded, Request
from raft_tpu_torch.serving.batcher import DynamicBatcher
from raft_tpu_torch.serving.brownout import BrownoutState


def _host_filter_words(filter, n: int, nw: int) -> np.ndarray:
    """Normalize a per-request filter to HOST-side ``(n, nw)`` packed
    int32 words.  Accepts a :class:`~raft_tpu_torch.filters.SampleFilter` (one
    row broadcasts to the request) or a bool mask (``(n_rows,)`` or
    ``(n, n_rows)``).  Narrower filters zero-pad — ids beyond the
    filter's coverage stay rejected, matching the device-side coverage
    check in :func:`raft_tpu_torch.filters.bitset.query_bits`."""
    from raft_tpu_torch.filters import SampleFilter
    if isinstance(filter, SampleFilter):
        w = filter.words.cpu().numpy().astype(np.int32, copy=False)
    else:
        if isinstance(filter, torch.Tensor):
            filter = filter.cpu().numpy()
        m = np.asarray(filter, dtype=bool)
        if m.ndim == 1:
            m = m[None, :]
        expects(m.ndim == 2,
                "serving: filter mask must be 1-D or (n, n_rows)")
        pad = (-m.shape[1]) % 32
        if pad:
            m = np.pad(m, ((0, 0), (0, pad)))
        w = np.packbits(m, axis=1, bitorder="little").view(np.int32)
    expects(w.shape[0] in (1, n),
            f"serving: filter has {w.shape[0]} rows for a {n}-row request")
    expects(w.shape[1] <= nw,
            f"serving: filter coverage ({w.shape[1]} words) exceeds the "
            f"executor's filter_rows bound ({nw} words)")
    if w.shape[1] < nw:
        w = np.pad(w, ((0, 0), (0, nw - w.shape[1])))
    if w.shape[0] == 1 and n > 1:
        w = np.broadcast_to(w, (n, nw))
    return w


@dataclasses.dataclass
class ServerConfig:
    """Serving knobs.

    ``max_wait_us`` is the latency the batcher may spend waiting to fill
    a bucket — it bounds added p99; size it well below the latency SLO.
    ``max_queue_rows`` bounds queue memory and worst-case queueing delay;
    beyond it, submissions shed with :class:`Overloaded`.
    ``tenant_quotas`` maps tenant -> (rate_rows_per_s, burst_rows).
    """

    max_batch: int = 1024
    max_wait_us: float = 2000.0
    max_queue_rows: int = 8192
    tenant_quotas: Optional[Dict[str, Tuple[float, float]]] = None
    # tenant NAMESPACES: a raft_tpu_torch.filters.TenantFilter
    # mapping tenant -> disjoint id range.  When set, every submit's
    # tenant= resolves to its namespace bitset (ANDed with any request
    # filter) so a tenant can only ever surface its own ids; requires an
    # executor constructed with filter_rows > 0.
    tenants: Optional[object] = None
    # default per-request deadline (seconds); None = no deadline
    default_deadline_s: Optional[float] = None
    # generation watchdog (auto-rollback): N integrity strikes within
    # rollback_window_s seconds swap back to the retained last-known-good
    # index generation.  0 disables the watchdog.
    rollback_strikes: int = 0
    rollback_window_s: float = 30.0


class Server:
    """Online request path over one warmed :class:`Executor`."""

    def __init__(self, executor, config: Optional[ServerConfig] = None
                 ) -> None:
        self.executor = executor
        self.config = config or ServerConfig()
        expects(self.config.max_batch <= executor.max_batch,
                "serving: config.max_batch exceeds the executor's bucket set")
        # one BrownoutState shared with admission and the batcher: the
        # controller (serving.brownout) writes it, the hot path reads it
        # lock-free.  Level 0 with no controller attached — a plain
        # server behaves exactly as before.
        self.brownout = BrownoutState()
        if self.config.tenants is not None:
            expects(getattr(executor, "n_filter_words", 0) > 0,
                    "serving: tenant namespaces need a filter-configured "
                    "executor — construct with filter_rows=<id bound>")
        self.queue = AdmissionQueue(self.config.max_queue_rows,
                                    self.config.tenant_quotas,
                                    brownout=self.brownout)
        self.batcher = DynamicBatcher(self.queue, executor,
                                      max_batch=self.config.max_batch,
                                      max_wait_us=self.config.max_wait_us,
                                      brownout=self.brownout,
                                      on_error=self._on_batch_error)
        self._started = False
        self.ingest = None          # durable write path (attach_ingest)
        self.shadow = None          # quality monitor (attach_shadow)
        # generation watchdog state: the last-known-good index retained
        # by swap_index, and the strike timestamps within the window
        self._last_good = None
        self._strikes: List[float] = []
        self._watchdog_lock = threading.Lock()

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "Server":
        """Warm every bucket executable, then start dispatching."""
        with obs.stage("serving.warmup") as st:
            n = self.executor.warmup()
            st.fence()
        if obs.enabled():
            obs.registry().gauge("serving.warmed_executables").set(n)
        if self.shadow is not None:
            # the shadow executor warms its own (bucket, k) set at the
            # ground-truth params — part of the same pre-start capture
            # budget, so steady state captures nothing with the monitor on
            self.shadow.start()
            self.batcher.shadow = self.shadow
        self.batcher.start()
        self._started = True
        return self

    def stop(self, drain: bool = True) -> None:
        self.batcher.stop(drain=drain)
        if self.shadow is not None:
            self.shadow.stop()
        self._started = False

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def attach_ingest(self, ingest) -> "Server":
        """Attach a durable write path (:class:`serving.IngestServer`)
        BEFORE :meth:`start`: binding joins the memtable's device view to
        the executor's delta-merge seam (part of every warmed shape) and
        routes fold publications through :meth:`swap_index`.  Run
        ``ingest.recover(...)`` first — writes refuse until recovery has
        replayed the WAL."""
        expects(not self._started,
                "serving: attach_ingest after start would put a capture on "
                "the serving path — attach before Server.start()")
        self.ingest = ingest
        ingest.bind(self)
        return self

    def attach_shadow(self, monitor) -> "Server":
        """Attach a live quality monitor
        (:class:`serving.ShadowMonitor`) BEFORE :meth:`start` — its
        ground-truth executables join the warmed closed-shape set — and
        AFTER :meth:`attach_ingest` when an ingest tier exists, so the
        shadow replay merges the same memtable view the served answers
        saw.  The batcher then offers every completed batch's host-side
        results to the monitor's sampler (one flag check per batch when
        sampling is off)."""
        expects(not self._started,
                "serving: attach_shadow after start would put a capture on "
                "the serving path — attach before Server.start()")
        monitor.bind(self)
        self.shadow = monitor
        return self

    def write(self, ids, vectors=None, *, op: str = "upsert",
              tenant: str = "default") -> int:
        """Durably ingest one upsert/delete batch; returns the record's
        LSN once it is fsync-durable AND searchable (see
        :meth:`serving.IngestServer.write` for the ack contract and the
        :class:`Overloaded` shed taxonomy)."""
        expects(self.ingest is not None,
                "serving: no ingest tier attached — Server.write needs "
                "attach_ingest before start()")
        return self.ingest.write(ids, vectors, op=op, tenant=tenant)

    def swap_index(self, new_index) -> int:
        """Swap the executor onto a new index generation while serving.

        Delegates to :meth:`Executor.swap_index`: a complete replacement
        executable table is built and warmed against ``new_index`` before
        one atomic publish, so requests in flight finish on the
        generation they started on, later requests see only the new one,
        and steady-state traffic after the swap captures nothing.
        The swapped-out index is RETAINED as the last-known-good
        generation for the watchdog (see :meth:`note_integrity_strike`),
        and the strike window resets — strikes against the old
        generation must not indict the new one.  Returns the number of
        bucket executables built."""
        old = self.executor.index
        with obs.stage("serving.generation_swap") as st:
            n = self.executor.swap_index(new_index)
            st.fence()
        if self.shadow is not None:
            # rebuild the shadow table against the new generation (still
            # on the swap path); backlog samples from the old generation
            # drop rather than replay cross-generation
            self.shadow.on_swap(new_index)
        with self._watchdog_lock:
            self._last_good = old
            self._strikes.clear()
        return n

    # ---- generation watchdog (auto-rollback) ----------------------------

    def _on_batch_error(self, exc: BaseException) -> None:
        # integrity failures are the watchdog's signal: a bad generation
        # corrupts results; transient executor errors (OOM, interrupt)
        # are the retry layer's problem, not a generation's guilt
        if isinstance(exc, IntegrityError):
            self.note_integrity_strike(f"batch_error: {exc}")

    def check_canary(self, res) -> bool:
        """Run the canary health check against the CURRENT generation;
        a floor violation is one watchdog strike.  Returns True when the
        index passes (or carries no canaries).  Call this from the ops
        loop (or a rebalancer hook) after swaps — sustained post-swap
        canary failure is exactly the regime auto-rollback exists for."""
        from raft_tpu_torch.integrity import canary as _canary
        report = _canary.health_check(res, self.executor.index,
                                      raise_on_fail=False)
        if report is not None and not report.ok:
            self.note_integrity_strike(
                f"canary: recall {report.recall:.3f} < floor "
                f"{report.floor:.3f}")
            return False
        return True

    def note_integrity_strike(self, reason: str) -> bool:
        """Record one integrity strike against the current generation;
        on the Nth strike (``rollback_strikes``) within
        ``rollback_window_s``, swap back to the retained last-known-good
        generation.  Returns True when this strike triggered the
        rollback."""
        limit = self.config.rollback_strikes
        if limit <= 0:
            return False
        now = time.monotonic()
        if obs.enabled():
            obs.registry().counter("serving.integrity_strikes").inc()
        with self._watchdog_lock:
            horizon = now - self.config.rollback_window_s
            self._strikes = [t for t in self._strikes if t > horizon]
            self._strikes.append(now)
            n_strikes = len(self._strikes)
            if n_strikes < limit or self._last_good is None:
                return False
            # rollback: take the retained generation and clear it so a
            # still-failing environment cannot ping-pong the swap —
            # the NEXT rollback needs a NEW good generation first
            target, self._last_good = self._last_good, None
            self._strikes.clear()
        bad_gen = getattr(self.executor.index, "generation", None)
        with obs.stage("serving.generation_swap") as st:
            self.executor.swap_index(target)
            st.fence()
        if self.shadow is not None:
            self.shadow.on_swap(target)
        if obs.enabled():
            obs.registry().counter("serving.auto_rollbacks").inc()
        # always-on flight event: THE post-mortem marker — which
        # generation was indicted, by how many strikes, and why
        _flight.record_event("serving.auto_rollback",
                             bad_generation=bad_gen,
                             restored_generation=getattr(
                                 target, "generation", None),
                             strikes=n_strikes, reason=reason)
        return True

    # ---- request path ---------------------------------------------------

    def submit(self, queries, k: Optional[int] = None, *,
               tenant: str = "default",
               deadline: Optional[Deadline] = None,
               filter=None) -> Future:
        """Enqueue one request; returns a Future resolving to
        ``(distances, indices)`` of shape (n, k).

        Raises :class:`Overloaded` / :class:`QuotaExceeded` when shed at
        admission; the Future fails with
        :class:`~raft_tpu_torch.resilience.retry.DeadlineExceededError` when
        the deadline expires while queued.  Under validation policy
        ``mask``, non-finite query rows resolve to id -1 / worst
        distance (the integrity mask path).

        ``filter``: a per-request admission predicate — a
        :class:`~raft_tpu_torch.filters.SampleFilter` or a bool mask over
        global row ids (one row broadcasts to the request; (n, n_rows)
        applies per query).  Needs an executor constructed with
        ``filter_rows > 0``.  With :attr:`ServerConfig.tenants`
        configured, the request's ``tenant=`` resolves to its namespace
        bitset and is ANDed in — a tenant can only surface its own ids
        regardless of the request filter.  Filters are data, not shape:
        they ride the queue host-side and never change the warmed
        bucket executables (zero steady-state captures).
        """
        expects(self._started, "serving: server not started")
        # per-request trace: minted HERE, at the front door, so spans from
        # admission / queue / batch / exec all hang off one trace id.  One
        # flag check when tracing is off.
        rt = _trace.start_request() if _trace.tracing() else None
        t_sub = rt.t0 if rt is not None else 0.0
        k = int(k) if k is not None else self.executor.ks[0]
        expects(k in self.executor.ks,
                f"serving: k={k} is not in the warmed set {self.executor.ks}")
        # requests stay HOST-side through admission: their shapes are
        # unbounded, so validation runs the numpy twin of the boundary
        # guard (host=True) and the batcher assembles the device batch
        # at the fixed bucket shape — no per-request device work
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        queries = np.asarray(queries)
        queries, ok_rows = _boundary.check_matrix(
            queries, "queries", site="serving.submit",
            dim=self.executor.dim, allow_empty=False, host=True)
        expects(queries.ndim == 2 and queries.shape[1] == self.executor.dim,
                "serving.submit: query dim mismatch")
        n = int(queries.shape[0])
        if n > self.config.max_batch:
            raise Overloaded(
                f"serving: request of {n} rows exceeds max_batch="
                f"{self.config.max_batch}; split the request")
        if deadline is None and self.config.default_deadline_s is not None:
            deadline = Deadline(self.config.default_deadline_s)
        # per-request admission bitset: normalized host-side (numpy) so
        # the queue carries no device arrays; the tenant namespace ANDs
        # in last, making isolation non-bypassable by the request filter
        nw = getattr(self.executor, "n_filter_words", 0)
        fw = None
        if filter is not None:
            expects(nw > 0,
                    "serving: executor not configured for filters — "
                    "construct with filter_rows=<id bound>")
            fw = _host_filter_words(filter, n, nw)
        if self.config.tenants is not None:
            tw = self.config.tenants.words_for(tenant)
            expects(tw.size == nw,
                    "serving: tenant namespace width "
                    f"({tw.size} words) != executor filter width ({nw}) "
                    "— configure TenantFilter with n_rows=filter_rows")
            fw = (np.broadcast_to(tw, (n, nw)) if fw is None
                  else fw & tw[None, :])
        req = Request(queries=queries, k=k, tenant=tenant,
                      deadline=deadline, future=Future(), n=n,
                      t_enqueue=time.monotonic(), ok_rows=ok_rows,
                      trace=rt, filter_words=fw)
        if rt is not None:
            rt.annotate("tenant", tenant)
            rt.annotate("rows", n)
            rt.annotate("k", k)
            if fw is not None:
                rt.annotate("filtered", True)
            # a degraded bucket stamps every trace — including one shed
            # below — with the level that served (or refused) it
            lvl = self.brownout.level
            if lvl:
                rt.annotate("brownout_level", lvl)
        try:
            self.queue.offer(req)
        except Overloaded:
            if rt is not None:
                # shed at the door: the trace still lands in the flight
                # recorder (the shed event itself is recorded by offer())
                rt.span("serving.admission", t_sub, _trace.now())
                rt.annotate("shed", True)
                _flight.record_trace(rt.close())
            raise
        if rt is not None:
            rt.span("serving.admission", t_sub, _trace.now())
        return req.future

    def search(self, queries, k: Optional[int] = None, *,
               tenant: str = "default",
               deadline: Optional[Deadline] = None,
               timeout: Optional[float] = None,
               filter=None):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(queries, k, tenant=tenant, deadline=deadline,
                           filter=filter).result(timeout=timeout)

    # ---- routing maintenance --------------------------------------------

    def refresh_routing(self) -> int:
        """Fold a routed executor's probe histograms into its routing
        policy: routed indexes are not ported yet."""
        raise not_ported("serving.Server", "refresh_routing",
                         "distributed (item 7)")

    # ---- introspection --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Point-in-time serving stats (cheap; registry-backed numbers
        appear only while collection is enabled)."""
        snap = obs.snapshot() if obs.enabled() else {}
        return {
            "queue_rows": self.queue.rows,
            "queue_requests": len(self.queue),
            "buckets": list(self.executor.buckets),
            "ks": list(self.executor.ks),
            "brownout_level": self.brownout.level,
            "routing": None,
            "counters": {name: v
                         for name, v in snap.get("counters", {}).items()
                         if name.startswith(("serving.", "aot."))},
            "histograms": {name: {q: h[q] for q in ("count", "p50", "p95",
                                                    "p99")}
                           for name, h in snap.get("histograms", {}).items()
                           if name.startswith("serving.")},
        }

"""Load-aware replica routing for the routed (``by_list``) index (port of
``raft_tpu.distributed.routing``).

A replicated placement makes replica choice *data*: the routed search reads
a pair of host-side ``(n_lists,)`` tables (owner, slot), and swapping them
changes no shape.  Failover and hedging swap them when a shard is down;
this policy swaps them on the healthy path too, so the replicas carry load:

**Replica-rank selection as data.**  :meth:`RoutingPolicy.plan` builds the
effective tables for one batch by walking the lists in descending expected
probe weight and giving each list to the live owner (over all ``r`` ranks)
with the lowest accumulated *load score* — greedy LPT over the replica
ranks.  The per-shard score is::

    score[s] = ewma_rows[s] * (1 + w_q * queue_depth + w_p * p99_ms)
               + w_pen * load_penalty[s]

``ewma_rows`` is an EWMA of the probe weight this policy planned onto each
shard, ``queue_depth`` / ``p99_ms`` the windowed serving telemetry of the
port's registry (``serving.queue_depth``, ``serving.latency.exec``, read
while collection is on), and ``load_penalty`` the health tracker's
per-shard overload demotion.  At full probe every live assignment answers
bit for bit as the primaries do: a global top-k candidate is in the local
top k of whichever shard serves its list, and replica copies are the same
rows.

**Probe frequency without host syncs.**  The routed search hands each
batch's per-list probe histogram (a tensor on the queries' device, the
same on every rank) to :meth:`observe_probes`, which only keeps the
reference; :meth:`refresh`, called off the search path, reads the pending
histograms into a rotating window, and :meth:`expected_probe_load` gives
the decayed per-list probe rate.

**Per-bucket replica groups.**  :meth:`spread_bucket` says which serving
buckets spread over every replica rank (small, hot batches) and which stay
on the primaries.

With one process a rank, each rank keeps its own policy, and the scores
read per-process telemetry: two ranks would plan different tables and
feed their trackers different overload.  The routed search therefore
plans on rank 0 alone and broadcasts the whole route
(:mod:`raft_tpu_torch.distributed.ann`); the other ranks' policies only
keep the probe histograms.  Every score mutation happens in
:meth:`RoutingPolicy._fold_load_scores`, which sends overload evidence
through the health tracker.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects


@dataclasses.dataclass
class RoutingConfig:
    """Knobs for the load score and the probe-heat window (the JAX
    package's fields and defaults).  With no telemetry and no penalties
    the policy is greedy LPT over the replica ranks."""

    #: EWMA factor folding each plan's per-shard assigned weight into the
    #: in-flight estimate
    ewma_alpha: float = 0.3
    #: score multiplier per queued row (``serving.queue_depth`` gauge)
    queue_depth_weight: float = 0.0005
    #: score multiplier per millisecond of windowed exec p99
    p99_weight: float = 0.01
    #: rows added to the score per unit of tracker load penalty
    penalty_rows: float = 1024.0
    #: shards whose EWMA rows exceed this multiple of the mean report
    #: overload evidence to the health tracker
    overload_factor: float = 2.0
    #: probe-heat rotating window: refresh slots retained
    window_slots: int = 8
    #: per-slot decay when summing the window (newest slot weight 1.0)
    window_decay: float = 0.7
    #: most un-refreshed histograms retained (the oldest is dropped)
    max_pending: int = 64
    #: buckets at or below this row count spread across every replica
    #: rank; larger buckets stay on the primaries
    hot_bucket_rows: int = 64

    def validate(self) -> "RoutingConfig":
        expects(0.0 < self.ewma_alpha <= 1.0,
                "routing: ewma_alpha must be in (0, 1]")
        expects(self.window_slots >= 1,
                "routing: window_slots must be >= 1")
        expects(0.0 < self.window_decay <= 1.0,
                "routing: window_decay must be in (0, 1]")
        expects(self.max_pending >= 1,
                "routing: max_pending must be >= 1")
        expects(self.overload_factor >= 1.0,
                "routing: overload_factor must be >= 1")
        expects(self.hot_bucket_rows >= 0,
                "routing: hot_bucket_rows must be >= 0")
        return self


def _host(hist) -> np.ndarray:
    """A retained histogram (a tensor on any device, or an array) as
    float64 numpy."""
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    return np.asarray(hist, np.float64)


class RoutingPolicy:
    """Load-aware replica-rank selection and probe-heat accumulation.
    Thread-safe: all state is host numpy behind one lock."""

    def __init__(self, n_shards: int,
                 config: Optional[RoutingConfig] = None, *,
                 tracker=None) -> None:
        expects(n_shards >= 1, "routing: n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.config = (config or RoutingConfig()).validate()
        self.tracker = tracker
        self._lock = threading.Lock()
        #: EWMA of planned per-shard probe weight; mutated only in
        #: _fold_load_scores
        self._load_score_rows: np.ndarray = np.zeros(
            self.n_shards, np.float64)
        #: per-list per-probe scan cost (host; fed at build / swap)
        self._list_rows: Optional[np.ndarray] = None
        #: histograms awaiting refresh (never read on the search path)
        self._pending: List = []
        #: rotating window of refreshed per-list probe counts (host)
        self._window: List[np.ndarray] = []
        #: the last plan's summary (the ``distributed.replica_choice``
        #: event payload)
        self._last_choice: Dict[str, object] = {}

    # ---- per-bucket replica groups --------------------------------------

    def spread_bucket(self, bucket: int) -> bool:
        """True when ``bucket`` routes across every replica rank (hot,
        small batch); False keeps it on the primaries (a large batch)."""
        return int(bucket) <= self.config.hot_bucket_rows

    # ---- probe-frequency window ------------------------------------------

    def observe_probes(self, hist) -> None:
        """Retain one batch's per-list probe histogram without reading it
        (a tensor stays on its device until :meth:`refresh`)."""
        with self._lock:
            self._pending.append(hist)
            if len(self._pending) > self.config.max_pending:
                self._pending.pop(0)

    def refresh(self) -> int:
        """Read the pending histograms into one window slot; returns the
        number of batches folded.  Off the search path: the one place the
        probe counters reach the host."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        total: Optional[np.ndarray] = None
        for h in pending:
            a = _host(h)
            total = a if total is None else total + a
        with self._lock:
            self._window.append(total)
            while len(self._window) > self.config.window_slots:
                self._window.pop(0)
        return len(pending)

    def expected_probe_load(self) -> Optional[np.ndarray]:
        """Decayed per-list probe rate from the window, normalized to sum
        1; None before the first refresh."""
        with self._lock:
            window = list(self._window)
        if not window:
            return None
        decay = self.config.window_decay
        acc = np.zeros_like(window[-1])
        w = 1.0
        for slot in reversed(window):
            acc = acc + w * slot
            w *= decay
        s = float(acc.sum())
        if s <= 0.0:
            return None
        return acc / s

    def note_list_rows(self, rows) -> None:
        """Install the per-list per-probe scan cost (host numpy): the plan
        weight of list ``g`` is ``probe_rate[g] * rows[g]``.  The routed
        scans read a probed list's whole ``(cap,)`` slot row, so callers
        feed the capacity, which leaves the weight to the measured
        heat."""
        rows = np.asarray(rows, np.float64).reshape(-1)
        with self._lock:
            self._list_rows = rows

    # ---- the load score -------------------------------------------------

    def shard_scores(self) -> np.ndarray:
        """The per-shard load score (row units), the formula of the module
        docstring.  The telemetry terms read the registry only while
        collection is on; off, the EWMA term alone spreads load."""
        qd = 0.0
        p99 = 0.0
        if obs.enabled():
            reg = obs.registry()
            qd = float(reg.gauge("serving.queue_depth").value)
            hist = reg.histogram("serving.latency.exec").windowed_dict()
            p99 = float(hist.get("p99") or 0.0) * 1e3  # s -> ms
        pressure = (1.0 + self.config.queue_depth_weight * qd
                    + self.config.p99_weight * p99)
        with self._lock:
            rows = self._load_score_rows.copy()
        scores = rows * pressure
        if self.tracker is not None:
            pen = getattr(self.tracker, "load_penalties", None)
            if pen is not None:
                scores = scores + self.config.penalty_rows * np.asarray(
                    pen(), np.float64)
        return scores

    def _fold_load_scores(self, planned_rows: np.ndarray) -> None:
        # the one load-score mutation site: every plan folds its per-shard
        # weight into the EWMA here, and overload evidence goes out
        # through the health tracker
        a = self.config.ewma_alpha
        overloaded: List[Tuple[int, float]] = []
        with self._lock:
            self._load_score_rows = ((1.0 - a) * self._load_score_rows
                                     + a * planned_rows)
            mean = float(self._load_score_rows.mean())
            if mean > 0.0:
                bar = self.config.overload_factor * mean
                for s in range(self.n_shards):
                    if self._load_score_rows[s] > bar:
                        overloaded.append(
                            (s, float(self._load_score_rows[s] / mean)))
        if self.tracker is not None:
            for s, ratio in overloaded:
                self.tracker.note_overload(s, ratio)

    # ---- the plan -------------------------------------------------------

    def _list_weights(self, n_lists: int) -> np.ndarray:
        heat = self.expected_probe_load()
        with self._lock:
            rows = self._list_rows
        if heat is None or heat.shape[0] != n_lists:
            heat = np.full(n_lists, 1.0 / n_lists)
        if rows is None or rows.shape[0] != n_lists:
            rows = np.ones(n_lists)
        return heat * rows

    def plan(self, placement, down: Sequence[int] = ()
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Effective ``(owner, slot)`` tables for one batch: lists in
        descending expected probe weight, each to the live owner with the
        smallest accumulated score.  Shards in ``down`` are excluded; a
        list all of whose owners are down keeps its rank-0 primary (the
        contract of :meth:`~raft_tpu_torch.distributed.ann.Placement.
        healthy_routing`).  Both arrays are host numpy shaped like the
        primary tables."""
        owners, slots = placement.rank_tables()
        r, n_lists = owners.shape
        expects(placement.n_shards == self.n_shards,
                f"routing: policy sized for {self.n_shards} shards, "
                f"placement has {placement.n_shards}")
        eff_owner = placement.owner.copy()
        eff_slot = placement.local_slot.copy()
        downset = {int(s) for s in down}
        expects(all(0 <= s < self.n_shards for s in downset),
                f"routing: down shard ids {sorted(downset)} out of range "
                f"for {self.n_shards} shards")
        weights = self._list_weights(n_lists)
        scores = self.shard_scores()
        assigned = scores.copy()
        planned = np.zeros(self.n_shards, np.float64)
        if r > 1:
            order = np.argsort(-weights, kind="stable")
            for g in order:
                cand = [j for j in range(r)
                        if int(owners[j, g]) not in downset]
                if not cand:
                    continue  # uncovered: the primary stays (masked)
                j = min(cand, key=lambda jj: assigned[int(owners[jj, g])])
                s = int(owners[j, g])
                eff_owner[g] = s
                eff_slot[g] = int(slots[j, g])
                assigned[s] += weights[g]
                planned[s] += weights[g]
        else:
            np.add.at(planned, eff_owner, weights)
        self._fold_load_scores(planned)
        # anti-co-location makes the rank of each choice unambiguous
        per_rank = [int(np.sum(eff_owner == owners[j]))
                    for j in range(r)]
        with self._lock:
            self._last_choice = {
                "scores": [round(float(v), 3) for v in scores],
                "per_rank_lists": per_rank,
                "per_shard_lists": np.bincount(
                    eff_owner, minlength=self.n_shards).tolist(),
                "down": sorted(downset),
            }
        return eff_owner, eff_slot

    def ack_plan(self, placement, down: Sequence[int] = (), *,
                 lists: Optional[Sequence[int]] = None
                 ) -> Dict[int, List[int]]:
        """Write-side companion of :meth:`plan`: for each global list (or
        each of ``lists``), its live owner shards in the order the write
        path appends to them, replica-rank order re-ranked by load score
        (least loaded first, shard id breaking ties).  Shards in ``down``
        are left out; an empty entry means every replica of the list is
        down."""
        owners, _ = placement.rank_tables()
        r, n_lists = owners.shape
        expects(placement.n_shards == self.n_shards,
                f"routing: policy sized for {self.n_shards} shards, "
                f"placement has {placement.n_shards}")
        downset = {int(s) for s in down}
        scores = self.shard_scores()
        targets = (range(n_lists) if lists is None
                   else [int(g) for g in lists])
        out: Dict[int, List[int]] = {}
        for g in targets:
            live = [int(owners[j, g]) for j in range(r)
                    if int(owners[j, g]) not in downset]
            live.sort(key=lambda s: (float(scores[s]), s))
            out[int(g)] = live
        return out

    def choice_summary(self) -> Dict[str, object]:
        """The last plan's record: per-rank and per-shard list counts and
        the scores they were chosen against."""
        with self._lock:
            return dict(self._last_choice)

    def stats(self) -> Dict[str, object]:
        """Point-in-time policy snapshot."""
        with self._lock:
            return {
                "ewma_rows": self._load_score_rows.tolist(),
                "pending_batches": len(self._pending),
                "window_slots": len(self._window),
                "last_choice": dict(self._last_choice),
            }

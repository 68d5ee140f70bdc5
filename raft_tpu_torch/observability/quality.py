"""Live quality observability: recall estimation, drift, op-point log
(port of ``raft_tpu.observability.quality``).

The serving stack measures *latency* deeply (per-request tracing,
windowed telemetry, brownout steering) but says nothing about the
recall actually delivered to live traffic.  This module holds the
math and persistence for closing that loop; the sampling/replay
machinery that feeds it is the serving tier's shadow sampler.

Three pieces:

:class:`RecallEstimator`
    Windowed (hits, total) accumulators keyed by ``(tenant, k)`` fed by
    shadow replays — each sampled query row contributes ``hits`` =
    |served top-k ∩ ground-truth top-k| out of ``total`` ground-truth
    neighbors.  :meth:`RecallEstimator.estimate` pools a window into a
    live recall estimate with a **Wilson score interval**: every
    (served, ground-truth) pair is a Bernoulli trial, so the interval
    is exact in the same way a canary floor is — a lower bound that
    only real quality loss (or too few samples) can push down.

:class:`DriftDetector`
    Calibrated-vs-measured checks, run once per window OFF the serving
    path (host syncs are fine here).  The catalogue:

    - ``group_est`` — the calibrated grouped-scan capacity estimate
      (:func:`raft_tpu_torch.neighbors.ivf_pq.calibrate_group_capacity`)
      against the touched-list fraction measured on the window's
      sampled queries.  A measured fraction past the calibration margin
      means the overflow re-dispatch fallback is no longer rare.
    - ``scan_skew`` — mean probed rows per query against the
      uniform-list cost model (``live_rows * n_probes / n_lists``).
      Hot lists growing past the threshold ratio mean the latency
      model (and any planner fitted on it) is stale.
    - ``fused_fallback`` — windowed ``ivf_pq.search.fused_fallback``
      count; a warmed steady state should never fall back, so any
      window activity names its reason mix.
    - ``memtable_dead`` — tombstoned fraction of the delta tier; past
      the threshold, every probe is paying dead-row scan work that a
      fold would reclaim.

    Each finding ticks ``serving.quality.drift`` (plus a per-kind
    counter) and records a ``serving.quality.drift`` flight event —
    always-on, like every anomaly event.

:class:`OperatingPointLog`
    Persistent JSONL log of ``(knobs, generation, measured)`` records —
    one per quality window — with RTIE-enveloped rotation: the active
    file is plain append-only JSONL (tail-able, torn-tail tolerant);
    when it exceeds ``max_bytes`` it is sealed into a CRC-protected
    ``<path>.NNNNNN.rtie`` segment (atomic rename) and the oldest
    segments beyond ``keep`` are pruned.  :func:`read_operating_points`
    parses segments + active file back into :class:`OpPoint` records,
    and :func:`calibrator_table` groups them by knob tuple — exactly
    the fitted-surface input an SLO planner consumes.  The log's bytes are
    the JAX package's: a log either package wrote reads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.observability import flight as _flight
# the package __init__ rebinds its ``registry`` attribute to the accessor
# function, so pull the gate/accessor pair straight from the submodule
from raft_tpu_torch.observability.registry import enabled as _enabled
from raft_tpu_torch.observability.registry import registry as _registry

#: the window clock — module-level and monkeypatchable, same contract as
#: ``registry._now`` (tests inject a fake clock)
_now = time.monotonic

#: default two-sided confidence level: z for 95%
DEFAULT_Z = 1.96


# ---------------------------------------------------------------------------
# Wilson interval
# ---------------------------------------------------------------------------


def wilson_interval(hits: float, total: float, z: float = DEFAULT_Z
                    ) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion ``hits/total``.

    Preferred over the normal approximation because shadow windows are
    small (tens of rows) and live recall sits near 1.0 — exactly the
    regime where the Wald interval collapses to a zero-width lie.  An
    empty window returns the vacuous ``(0, 1)``.
    """
    if total <= 0:
        return 0.0, 1.0
    n = float(total)
    p = min(1.0, max(0.0, hits / n))
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return max(0.0, center - half), min(1.0, center + half)


@dataclasses.dataclass
class RecallEstimate:
    """One pooled window estimate: ``recall`` = hits/total with the
    Wilson ``(lo, hi)`` bound, over ``rows`` sampled query rows."""

    recall: float
    lo: float
    hi: float
    hits: int
    total: int
    rows: int
    window_s: float

    def as_dict(self) -> Dict[str, Any]:
        return {"recall": self.recall, "lo": self.lo, "hi": self.hi,
                "hits": self.hits, "total": self.total, "rows": self.rows,
                "window_s": self.window_s}


class RecallEstimator:
    """Windowed recall accumulators keyed by ``(tenant, k)``.

    Thread-safe but never on the serving hot path: only the shadow
    replay thread records, and readers (flush / stats / tests) take the
    same short lock.  Samples age out of a rolling ``window_s`` horizon
    on every record/read — no background maintenance."""

    def __init__(self, window_s: float = 60.0, z: float = DEFAULT_Z) -> None:
        self.window_s = float(window_s)
        self.z = float(z)
        self._lock = threading.Lock()
        # (tenant, k) -> deque of (t, rows, hits, total)
        self._samples: Dict[Tuple[str, int], deque] = {}

    def record(self, tenant: str, k: int, hits: int, total: int,
               rows: int = 1) -> None:
        t = _now()
        with self._lock:
            dq = self._samples.get((tenant, k))
            if dq is None:
                dq = self._samples[(tenant, k)] = deque()
            dq.append((t, int(rows), int(hits), int(total)))
            self._prune(dq, t)

    def _prune(self, dq: deque, t: float) -> None:
        horizon = t - self.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def _pool(self, keys) -> Tuple[int, int, int]:
        t = _now()
        rows = hits = total = 0
        for key in keys:
            dq = self._samples.get(key)
            if dq is None:
                continue
            self._prune(dq, t)
            for _, r, h, tot in dq:
                rows += r
                hits += h
                total += tot
        return rows, hits, total

    def estimate(self, tenant: Optional[str] = None,
                 k: Optional[int] = None) -> Optional[RecallEstimate]:
        """Pooled estimate over the window — all keys, one tenant's
        keys, or one exact ``(tenant, k)``.  None when no sample in the
        window matches."""
        with self._lock:
            keys = [key for key in self._samples
                    if (tenant is None or key[0] == tenant)
                    and (k is None or key[1] == k)]
            rows, hits, total = self._pool(keys)
        if total <= 0:
            return None
        lo, hi = wilson_interval(hits, total, self.z)
        return RecallEstimate(recall=hits / total, lo=lo, hi=hi,
                              hits=hits, total=total, rows=rows,
                              window_s=self.window_s)

    def estimates(self) -> Dict[Tuple[str, int], RecallEstimate]:
        """Per-(tenant, k) window estimates, empty keys dropped."""
        with self._lock:
            keys = list(self._samples)
        out = {}
        for key in keys:
            est = self.estimate(tenant=key[0], k=key[1])
            if est is not None:
                out[key] = est
        return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DriftThresholds:
    """Flag bounds for the calibrated-vs-measured checks.  Defaults err
    toward quiet: a finding should mean "recalibrate / fold now", not
    background noise."""

    # measured touched-list fraction beyond group_est * margin means the
    # calibrated capacity no longer covers real batches (1.25 is the
    # safety margin grouped.group_capacity already applies)
    group_est_margin: float = 1.25
    # measured probed rows per query vs the uniform-list model
    scan_skew_ratio: float = 2.0
    # windowed fused-fallback count tolerated in steady state
    fused_fallback_max: int = 0
    # tombstoned fraction of the delta tier / main index
    dead_fraction_max: float = 0.3


@dataclasses.dataclass
class DriftFinding:
    """One calibrated-vs-measured violation."""

    kind: str            # group_est | scan_skew | fused_fallback | memtable_dead
    calibrated: float    # the modeled / stored value
    measured: float
    threshold: float
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "calibrated": self.calibrated,
                "measured": self.measured, "threshold": self.threshold,
                **self.detail}


def measure_probe_stats(index, queries, n_probes: int
                        ) -> Optional[Dict[str, float]]:
    """Coarse-rank ``queries`` against ``index`` and measure what the
    calibration layer models: the touched-list fraction (group_est's
    quantity) and the mean probed rows per query (the scan-traffic cost
    model's quantity).  Runs the same ``_select_clusters`` ranking the
    search path uses — host syncs included, so call this OFF the serving
    path only (the shadow thread's window flush).  Returns None for
    indexes without the IVF coarse structure."""
    centers = getattr(index, "centers", None)
    rotation = getattr(index, "rotation", None)
    list_sizes = getattr(index, "list_sizes", None)
    if centers is None or rotation is None or queries is None:
        return None
    import torch

    from raft_tpu_torch.neighbors import ivf_flat as _flat
    from raft_tpu_torch.utils import precision

    n_lists = int(centers.shape[0])
    n_probes = max(1, min(int(n_probes), n_lists))
    queries = np.array(queries.cpu() if isinstance(queries, torch.Tensor)
                       else queries, np.float32)
    with precision.highest():
        qrot = torch.as_tensor(queries, device=centers.device) @ rotation
        probes = _flat._select_clusters(
            centers, qrot, n_probes,
            getattr(index, "metric", None)).cpu().numpy()
    flat = probes.reshape(-1)
    flat = flat[(flat >= 0) & (flat < n_lists)]
    pairs = int(queries.shape[0]) * n_probes
    touched = int(np.unique(flat).size)
    out = {"touched_fraction": touched / max(min(n_lists, pairs), 1),
           "touched_lists": float(touched),
           "n_probes": float(n_probes), "n_lists": float(n_lists)}
    if list_sizes is not None:
        sizes = (list_sizes.cpu().numpy().astype(np.int64)
                 if isinstance(list_sizes, torch.Tensor)
                 else np.asarray(list_sizes, np.int64))
        probed = sizes[probes.reshape(probes.shape[0], -1)]
        out["probed_rows_per_query"] = float(probed.sum(axis=1).mean())
        out["live_rows"] = float(sizes.sum())
    return out


class DriftDetector:
    """Run the calibrated-vs-measured catalogue once per quality window.

    Every check degrades to "skip" when its signal is unavailable (no
    calibration stored, metrics collection off, no delta tier) — a
    detector must never invent drift out of missing data."""

    def __init__(self, thresholds: Optional[DriftThresholds] = None
                 ) -> None:
        self.thresholds = thresholds or DriftThresholds()

    # -- individual checks --------------------------------------------------

    def check_group_est(self, index, probe_stats: Optional[Dict[str, float]]
                        ) -> Optional[DriftFinding]:
        est = float(getattr(index, "group_est", 0.0) or 0.0)
        if est <= 0.0 or not probe_stats:
            return None          # uncalibrated dispatch is always correct
        measured = probe_stats["touched_fraction"]
        bound = est * self.thresholds.group_est_margin
        if measured <= bound:
            return None
        return DriftFinding(
            kind="group_est", calibrated=est, measured=measured,
            threshold=bound,
            detail={"touched_lists": probe_stats["touched_lists"],
                    "n_probes": probe_stats["n_probes"]})

    def check_scan_skew(self, index, probe_stats: Optional[Dict[str, float]]
                        ) -> Optional[DriftFinding]:
        if not probe_stats or "probed_rows_per_query" not in probe_stats:
            return None
        live = probe_stats.get("live_rows", 0.0)
        n_lists = probe_stats["n_lists"]
        if live <= 0 or n_lists <= 0:
            return None
        modeled = live * probe_stats["n_probes"] / n_lists
        measured = probe_stats["probed_rows_per_query"]
        if modeled <= 0 or measured <= self.thresholds.scan_skew_ratio * modeled:
            return None
        return DriftFinding(
            kind="scan_skew", calibrated=modeled, measured=measured,
            threshold=self.thresholds.scan_skew_ratio * modeled,
            detail={"live_rows": live})

    def check_fused_fallback(self) -> Optional[DriftFinding]:
        if not _enabled():
            return None
        reg = _registry()
        fallbacks = reg.counter("ivf_pq.search.fused_fallback").windowed()
        if fallbacks <= self.thresholds.fused_fallback_max:
            return None
        prefix = "ivf_pq.search.fused_fallback.reason."
        reasons = {}
        for name, c in reg.snapshot().get("counters", {}).items():
            if name.startswith(prefix):
                w = reg.counter(name).windowed()
                if w:
                    reasons[name[len(prefix):]] = w
        return DriftFinding(
            kind="fused_fallback", calibrated=0.0, measured=float(fallbacks),
            threshold=float(self.thresholds.fused_fallback_max),
            detail={"reasons": reasons})

    def check_memtable_dead(self, memtable) -> Optional[DriftFinding]:
        if memtable is None:
            return None
        live = int(memtable.live_rows)
        dead = int(memtable.n_tombstones)
        total = live + dead
        if total == 0:
            return None
        frac = dead / total
        if frac <= self.thresholds.dead_fraction_max:
            return None
        return DriftFinding(
            kind="memtable_dead", calibrated=0.0, measured=frac,
            threshold=self.thresholds.dead_fraction_max,
            detail={"live_rows": live, "tombstones": dead})

    # -- the window pass ----------------------------------------------------

    def check(self, *, index=None, queries=None, n_probes: Optional[int] = None,
              memtable=None, probe_stats: Optional[Dict[str, float]] = None
              ) -> List[DriftFinding]:
        """One pass over the catalogue; emits metrics + flight events for
        every finding and returns them.  ``probe_stats`` short-circuits
        the measurement when the caller already ran
        :func:`measure_probe_stats` this window (the shadow flush shares
        one measurement between drift and the op-point log)."""
        if (probe_stats is None and index is not None
                and queries is not None and n_probes is not None):
            probe_stats = measure_probe_stats(index, queries, n_probes)
        findings = [f for f in (
            self.check_group_est(index, probe_stats)
            if index is not None else None,
            self.check_scan_skew(index, probe_stats)
            if index is not None else None,
            self.check_fused_fallback(),
            self.check_memtable_dead(memtable),
        ) if f is not None]
        for f in findings:
            self._emit(f)
        return findings

    @staticmethod
    def _emit(f: DriftFinding) -> None:
        if _enabled():
            reg = _registry()
            reg.counter("serving.quality.drift").inc()
            reg.counter(f"serving.quality.drift.{f.kind}").inc()
        # always-on anomaly event: drift is rare and exactly what the
        # post-mortem / recalibration runbook needs to see with values
        _flight.record_event("serving.quality.drift", **f.as_dict())


# ---------------------------------------------------------------------------
# the operating-point log
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpPoint:
    """One logged operating point: the knobs a window served at, the
    index generation, and what was measured there.

    ``knobs`` keys (the serving executor's closed-shape coordinates):
    ``kind / scan_mode / n_probes / kt / merge_window / bucket / rung /
    k / filtered`` (``filtered`` marks a filter-configured
    executor: recall under admission predicates is a different operating
    regime than unfiltered recall, so the calibrator must not mix the
    two).  ``measured`` keys: the recall estimate (``recall / lo / hi /
    hits / total / rows``), window latency quantiles (``p50 / p95 /
    p99`` seconds), and whatever scan-traffic numbers were available
    (``scan_rows``).  The calibrator treats both as open dicts."""

    t: float
    generation: int
    knobs: Dict[str, Any]
    measured: Dict[str, Any]
    tenant: str = "*"

    def as_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "generation": self.generation,
                "tenant": self.tenant, "knobs": self.knobs,
                "measured": self.measured}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpPoint":
        return cls(t=float(d.get("t", 0.0)),
                   generation=int(d.get("generation", 0)),
                   tenant=str(d.get("tenant", "*")),
                   knobs=dict(d.get("knobs", {})),
                   measured=dict(d.get("measured", {})))


_SEGMENT_SUFFIX = ".rtie"


def _segment_paths(path: str) -> List[str]:
    """Sealed segments for ``path``, oldest first."""
    d, base = os.path.split(os.path.abspath(path))
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        if not (name.startswith(base + ".")
                and name.endswith(_SEGMENT_SUFFIX)):
            continue
        seq = name[len(base) + 1:-len(_SEGMENT_SUFFIX)]
        if seq.isdigit():
            out.append((int(seq), os.path.join(d, name)))
    return [p for _, p in sorted(out)]


class OperatingPointLog:
    """Append-only JSONL operating-point log with RTIE-sealed rotation.

    The ACTIVE file is plain JSONL — one :meth:`append` is one
    ``json.dumps`` line on a line-buffered handle, so a crash can tear
    at most the final line (the reader drops a torn tail, the same
    tolerance the WAL gives its own tail).  When the active file grows
    past ``max_bytes`` it is sealed: the raw JSONL bytes are wrapped in
    one RTIE envelope (magic/version/length/CRC32 — the index
    serialization's framing) and atomically renamed to
    ``<path>.NNNNNN.rtie``; segments beyond ``keep`` are pruned oldest
    first.  Sealed history is CRC-verified on read — a flipped bit in
    the planner's training data is rejected, not fitted."""

    def __init__(self, path: str, *, max_bytes: int = 1 << 20,
                 keep: int = 8) -> None:
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", buffering=1)
        self._size = self._f.tell()

    def append(self, op: OpPoint) -> None:
        line = json.dumps(op.as_dict(), sort_keys=True) + "\n"
        with self._lock:
            self._f.write(line)
            self._size += len(line)
            if self._size >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        """Seal the active file into the next RTIE segment (caller holds
        the lock)."""
        from raft_tpu_torch.core import serialize as ser
        from raft_tpu_torch.resilience.checkpoint import atomic_write

        self._f.close()
        with open(self.path, "rb") as f:
            payload = f.read()
        segments = _segment_paths(self.path)
        seq = 0
        if segments:
            tail = os.path.basename(segments[-1])
            base = os.path.basename(self.path)
            seq = int(tail[len(base) + 1:-len(_SEGMENT_SUFFIX)]) + 1
        import io as _io

        buf = _io.BytesIO()
        ser.write_envelope(buf, payload)
        atomic_write(f"{self.path}.{seq:06d}{_SEGMENT_SUFFIX}",
                     buf.getvalue())
        for stale in _segment_paths(self.path)[:-self.keep]:
            try:
                os.remove(stale)
            except OSError:
                pass
        self._f = open(self.path, "w", buffering=1)
        self._size = 0

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()

    def __enter__(self) -> "OperatingPointLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_operating_points(path: str) -> List[OpPoint]:
    """Parse an operating-point log (sealed segments oldest-first, then
    the active JSONL) back into :class:`OpPoint` records — the
    calibrator's input shape.

    Sealed segments are CRC-verified (:class:`CorruptIndexError` on
    damage — history the planner fits on must be intact); the active
    file tolerates exactly one torn FINAL line (the crash window of a
    line-buffered append)."""
    from raft_tpu_torch.core import serialize as ser
    from raft_tpu_torch.core.serialize import CorruptIndexError

    chunks: List[Tuple[str, bytes]] = []
    for seg in _segment_paths(path):
        with open(seg, "rb") as f:
            chunks.append((seg, ser.read_envelope(f)))
    if os.path.exists(path):
        with open(path, "rb") as f:
            chunks.append((path, f.read()))
    out: List[OpPoint] = []
    for src, data in chunks:
        lines = data.decode("utf-8", errors="replace").splitlines()
        sealed = src != path
        for j, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(OpPoint.from_dict(json.loads(line)))
            except (ValueError, TypeError) as e:
                if not sealed and j == len(lines) - 1:
                    continue          # torn final line of the active file
                raise CorruptIndexError(
                    f"corrupt operating-point log {src!r} line {j + 1}: "
                    f"{e}") from e
    return out


def calibrator_table(points: List[OpPoint]
                     ) -> Dict[Tuple[Tuple[str, Any], ...],
                               Dict[str, Any]]:
    """Group logged points by knob tuple and aggregate the measured
    surface — the ``knobs -> measured`` table a planner fits.

    Keys are sorted ``(knob, value)`` tuples (hashable, stable across
    runs); values carry the per-point measured dicts plus pooled
    recall (hits/total re-pooled, NOT averaged — windows have unequal
    sample counts) and mean latency quantiles."""
    table: Dict[Tuple[Tuple[str, Any], ...], Dict[str, Any]] = {}
    for p in points:
        key = tuple(sorted(p.knobs.items(),
                           key=lambda kv: kv[0]))
        row = table.setdefault(key, {"points": [], "hits": 0, "total": 0})
        row["points"].append(p.measured)
        row["hits"] += int(p.measured.get("hits", 0) or 0)
        row["total"] += int(p.measured.get("total", 0) or 0)
    for row in table.values():
        total = row["total"]
        row["recall"] = (row["hits"] / total) if total else None
        if total:
            row["recall_lo"], row["recall_hi"] = wilson_interval(
                row["hits"], total)
        for q in ("p50", "p95", "p99"):
            vals = [m[q] for m in row["points"]
                    if isinstance(m.get(q), (int, float))]
            row[q] = (sum(vals) / len(vals)) if vals else None
    return table

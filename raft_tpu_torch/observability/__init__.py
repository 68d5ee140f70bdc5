"""raft_tpu_torch.observability — stage-level metrics, tracing, and exporters
(port of ``raft_tpu.observability``, under the JAX package's metric names).

The aggregation layer on top of ``core/tracing`` (NVTX ranges and
``torch.profiler`` ranges): a process-global :class:`MetricsRegistry` of
counters / gauges / timers / histograms, a :func:`stage` context manager
that times algorithm phases under the same labels the profiler sees,
per-build :func:`build_report` breakdowns, per-request traces, a flight
recorder, live-quality math, and JSON / Prometheus exporters.  The JAX
package's XLA compile-event metrics (``xla.*``) have no counterpart: the
port compiles nothing through XLA.

Contract: collection is **off by default**.  While off, instrumented library
code performs no timing and — the part that matters for QPS — **no device
waits (fences)**; ``stage`` yields a shared no-op handle.  Turn it on with
:func:`enable` or scoped via ``with collecting(): ...``.

Quick tour::

    from raft_tpu_torch import observability as obs

    with obs.collecting():
        index = ivf_pq.build(res, params, dataset)
    print(obs.build_report(index)["stages"])   # per-stage seconds
    print(obs.to_prometheus())                 # scrape-ready text
"""

from raft_tpu_torch.observability.registry import (
    Counter,
    DEFAULT_HISTOGRAM_BOUNDS,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
    WINDOW_INTERVAL_S,
    WINDOW_SLOTS,
    collecting,
    disable,
    enable,
    enabled,
    registry,
    reset,
    snapshot,
)
from raft_tpu_torch.observability.stage import fence, stage
from raft_tpu_torch.observability.export import to_json, to_prometheus
from raft_tpu_torch.observability.report import BuildReport, build_report, build_scope
from raft_tpu_torch.observability import flight
from raft_tpu_torch.observability import quality
from raft_tpu_torch.observability.quality import (
    DriftDetector,
    DriftFinding,
    DriftThresholds,
    OperatingPointLog,
    OpPoint,
    RecallEstimate,
    RecallEstimator,
    calibrator_table,
    read_operating_points,
    wilson_interval,
)
from raft_tpu_torch.observability import trace
from raft_tpu_torch.observability.trace import (
    Span,
    SpanRecorder,
    disable_tracing,
    enable_tracing,
    start_request,
    tracing,
    tracing_scope,
)

__all__ = [
    "Counter",
    "DEFAULT_HISTOGRAM_BOUNDS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Timer",
    "WINDOW_INTERVAL_S",
    "WINDOW_SLOTS",
    "BuildReport",
    "DriftDetector",
    "DriftFinding",
    "DriftThresholds",
    "OperatingPointLog",
    "OpPoint",
    "RecallEstimate",
    "RecallEstimator",
    "Span",
    "SpanRecorder",
    "build_report",
    "build_scope",
    "calibrator_table",
    "collecting",
    "disable",
    "disable_tracing",
    "enable",
    "enable_tracing",
    "enabled",
    "fence",
    "flight",
    "quality",
    "read_operating_points",
    "registry",
    "reset",
    "snapshot",
    "stage",
    "start_request",
    "to_json",
    "to_prometheus",
    "trace",
    "tracing",
    "tracing_scope",
    "wilson_interval",
]

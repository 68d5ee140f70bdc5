"""Snapshot exporters: JSON and Prometheus text exposition format (port of
``raft_tpu.observability.export``; the same text, the same default
``raft_tpu`` metric prefix).

Both operate on the plain-dict snapshots produced by
``MetricsRegistry.snapshot()`` (or the global
:func:`raft_tpu_torch.observability.snapshot`),
so exports are consistent point-in-time views and never hold registry locks
during serialization.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional

from raft_tpu_torch.observability.registry import snapshot as _global_snapshot

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def to_json(snapshot: Optional[Dict] = None, *, indent: Optional[int] = None) -> str:
    """Serialize a snapshot (default: the global registry's) to JSON."""
    if snapshot is None:
        snapshot = _global_snapshot()
    return json.dumps(snapshot, indent=indent, sort_keys=True)


def _prom_name(name: str, prefix: str) -> str:
    """``cagra.build.scan`` -> ``raft_tpu_cagra_build_scan`` (Prometheus
    metric names admit only ``[a-zA-Z0-9_:]``)."""
    base = _PROM_NAME_RE.sub("_", name)
    return f"{prefix}_{base}" if prefix else base


def to_prometheus(snapshot: Optional[Dict] = None, *,
                  prefix: str = "raft_tpu") -> str:
    """Serialize a snapshot to the Prometheus text exposition format.

    Counters/gauges map directly; each timer ``t`` becomes five series:
    ``<t>_seconds_count|_total|_min|_max|_last``.
    """
    if snapshot is None:
        snapshot = _global_snapshot()
    lines = []
    for name, value in sorted(snapshot.get("counters", {}).items()):
        pname = _prom_name(name, prefix) + "_total"
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {value}")
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {value}")
    for name, t in sorted(snapshot.get("timers", {}).items()):
        pname = _prom_name(name, prefix) + "_seconds"
        lines.append(f"# TYPE {pname} summary")
        lines.append(f"{pname}_count {t['count']}")
        lines.append(f"{pname}_total {t['total_s']}")
        lines.append(f"{pname}_min {t['min_s']}")
        lines.append(f"{pname}_max {t['max_s']}")
        lines.append(f"{pname}_last {t['last_s']}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for le, c in zip(h["bounds"], h["counts"]):
            cum += c
            lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pname}_sum {h['sum']}")
        lines.append(f"{pname}_count {h['count']}")
        # pre-computed quantile gauges: native histograms carry no
        # quantiles, but p50/p95/p99 are the numbers dashboards want
        for q in ("p50", "p95", "p99"):
            lines.append(f"{pname}_{q} {h[q]}")
    # windowed telemetry: recent-interval counts and quantiles as
    # gauges — they rise AND fall with load, unlike the lifetime series
    win = snapshot.get("window") or {}
    for name, value in sorted(win.get("counters", {}).items()):
        pname = _prom_name(name, prefix) + "_window"
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {value}")
    for name, h in sorted(win.get("histograms", {}).items()):
        pname = _prom_name(name, prefix) + "_window"
        for field in ("count", "sum", "max", "p50", "p95", "p99"):
            lines.append(f"# TYPE {pname}_{field} gauge")
            lines.append(f"{pname}_{field} {h[field]}")
    return "\n".join(lines) + "\n"

"""Per-build stage breakdown, attached to index objects (port of
``raft_tpu.observability.report``).

``build_scope(...)`` wraps an index build; on exit it diffs global-registry
snapshots and keeps every metric that *changed* during the scope — the
build's own stage timers plus anything they pulled in (``kmeans_balanced.fit``,
the ``extend`` stages, boundary counters).  The resulting dict is attached to the
returned index (``object.__setattr__``, the same lazy-attach pattern the
index caches use) and retrieved with :func:`build_report`.

Stage timers are hierarchical by *name* only (``cagra.build.scan`` runs
inside ``cagra.build``): nested stage totals overlap their parents, so the
breakdown is attribution, not a partition.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

from raft_tpu_torch.observability.registry import (
    enabled as _enabled,
    snapshot as _global_snapshot,
)

_ATTR = "_raft_tpu_build_report"


class BuildReport:
    """Mutable handle yielded by :func:`build_scope`; finalized on exit."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.total_s = 0.0
        self.stages: Dict[str, Dict[str, float]] = {}
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "total_s": self.total_s,
            "stages": dict(self.stages),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
        }

    def attach(self, index: Any) -> Any:
        """Attach this report to ``index`` (works on frozen dataclasses) and
        return it.  The handle itself is stored — ``build_scope`` finalizes
        it on exit, so attaching inside or outside the scope both work;
        :func:`build_report` renders the dict at read time.  No-op handle
        when collection was disabled."""
        object.__setattr__(index, _ATTR, self)
        return index

    def _finalize(self, before: Dict, after: Dict, total_s: float) -> None:
        self.total_s = total_s
        b_t, a_t = before.get("timers", {}), after.get("timers", {})
        for name, t in a_t.items():
            prev = b_t.get(name)
            if prev is not None and prev["count"] == t["count"]:
                continue  # untouched during the scope
            delta = dict(t)
            if prev is not None:
                delta["count"] = t["count"] - prev["count"]
                delta["total_s"] = t["total_s"] - prev["total_s"]
                # min/max/last are not diffable; keep the scope-end values
            self.stages[name] = delta
        b_c, a_c = before.get("counters", {}), after.get("counters", {})
        for name, v in a_c.items():
            d = v - b_c.get(name, 0)
            if d:
                self.counters[name] = d
        b_g, a_g = before.get("gauges", {}), after.get("gauges", {})
        for name, v in a_g.items():
            if name not in b_g or b_g[name] != v:
                self.gauges[name] = v


class _NoopReport(BuildReport):
    """Disabled-path handle: ``attach`` leaves the index untouched."""

    def attach(self, index: Any) -> Any:
        return index


@contextlib.contextmanager
def build_scope(name: str) -> Iterator[BuildReport]:
    """Collect the stage breakdown of one build.

    Usage (inside ``cagra.build`` etc.)::

        with build_scope("cagra.build") as rep:
            index = ...
        return rep.attach(index)

    Disabled collection yields a no-op report; the build runs untouched."""
    if not _enabled():
        yield _NoopReport(name)
        return
    rep = BuildReport(name)
    before = _global_snapshot()
    t0 = time.perf_counter()
    try:
        yield rep
    finally:
        rep._finalize(before, _global_snapshot(), time.perf_counter() - t0)


def build_report(index: Any) -> Optional[Dict[str, Any]]:
    """The stage breakdown recorded while ``index`` was built (a plain dict:
    ``{name, total_s, stages, counters, gauges}``), or None if the build ran
    with collection disabled."""
    rep = getattr(index, _ATTR, None)
    return rep.as_dict() if rep is not None else None

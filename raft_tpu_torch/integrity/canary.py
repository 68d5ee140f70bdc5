"""Recall canaries — build-time sentinel queries with exact ground truth
(port of ``raft_tpu.integrity.canary``).

``build()`` samples a handful of dataset rows as sentinel queries,
computes their exact neighbors (:func:`raft_tpu_torch.neighbors.
brute_force.knn`) while the dataset is still in hand, and stores both in
the index, serialized inside a nested RTIE envelope of its own (byte for
byte the JAX package's block).  :func:`health_check` re-searches the
sentinels and compares recall against the stored floor; it runs after
``load()``, ``extend()`` and checkpoint ``resume=True``, so an index whose
invariants were silently violated is caught before it serves traffic.

Canary recall is a one-sided detector: corruption can only lower it, but
rows added by ``extend()`` can legitimately displace stored ground truth
too, so the floor should be conservative (default 0.5).

The JAX package also counts checks and failures in its observability
registry and records a flight event on a failure; the port has no
registry yet, so neither happens here.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.integrity.errors import IntegrityError

# build-time defaults: enough sentinels for a stable recall estimate, few
# enough that the stored block and the health-check search are noise
DEFAULT_QUERIES = 32
DEFAULT_K = 10
DEFAULT_FLOOR = 0.5


@dataclasses.dataclass
class CanarySet:
    """Sentinel queries + exact ground truth + acceptance floor."""

    queries: np.ndarray       # (c, dim) float32
    gt_ids: np.ndarray        # (c, k) int32, exact neighbors at build
    floor: float              # health_check fails below this recall
    build_recall: float = -1.0   # measured right after build (reporting)

    @property
    def k(self) -> int:
        return self.gt_ids.shape[1]

    @property
    def n_queries(self) -> int:
        return self.queries.shape[0]


@dataclasses.dataclass
class CanaryReport:
    """health_check outcome (returned, and raised-from on failure)."""

    recall: float
    floor: float
    n_queries: int
    k: int

    @property
    def ok(self) -> bool:
        return self.recall >= self.floor


def make(res, dataset, *, metric: int, n_queries: int = DEFAULT_QUERIES,
         k: int = DEFAULT_K, floor: float = DEFAULT_FLOOR) -> CanarySet:
    """Sample sentinel queries from ``dataset`` (a strided row sample:
    deterministic, and it draws nothing from the handle's generator) and
    compute their exact ground truth in one brute-force pass.  Ground-truth
    ids are dataset row positions, the ids ``build()`` assigns."""
    from raft_tpu_torch.core.outputs import raw
    from raft_tpu_torch.neighbors import brute_force

    dataset = ensure_tensor(dataset, res, "dataset")
    n = dataset.shape[0]
    c = min(n_queries, n)
    k = min(k, n)
    stride = max(1, n // c)
    queries = dataset[np.arange(c) * stride]
    _, gt = raw(brute_force.knn)(res, dataset, queries, k, metric=metric)
    return CanarySet(queries=queries.float().cpu().numpy(),
                     gt_ids=gt.int().cpu().numpy(), floor=float(floor))


def _search_canaries(res, index, cs: CanarySet, filter=None) -> np.ndarray:
    """Re-search the sentinels on ``index``: (c, k) found ids."""
    from raft_tpu_torch.core.outputs import raw
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    q = cs.queries
    if isinstance(index, ivf_flat.Index):
        p = ivf_flat.SearchParams(n_probes=min(32, index.n_lists))
        _, ids = raw(ivf_flat.search)(res, p, index, q, cs.k, filter=filter)
    elif isinstance(index, ivf_pq.Index):
        p = ivf_pq.SearchParams(n_probes=min(32, index.n_lists))
        _, ids = raw(ivf_pq.search)(res, p, index, q, cs.k, filter=filter)
    elif isinstance(index, cagra.Index):
        _, ids = raw(cagra.search)(res, cagra.SearchParams(), index, q,
                                   cs.k, filter=filter)
    else:
        raise TypeError(
            f"health_check: unsupported index type {type(index).__name__}")
    return ids.cpu().numpy()


def _deleted_ids(index) -> frozenset:
    """Deleted source ids: a graph index's ``deleted_ids``, else the
    tombstones ``-(id + 2)`` of ``list_indices`` (an index loaded from a
    file the JAX package wrote after a delete) whose id has no live copy
    in another slot."""
    ext = getattr(index, "deleted_ids", None)
    if ext is not None:
        return frozenset(int(v) for v in ext)
    li = getattr(index, "list_indices", None)
    if li is None:
        return frozenset()
    a = li.reshape(-1).cpu().numpy()
    dead = frozenset(int(-v - 2) for v in a[a <= -2])
    if not dead:
        return dead
    return dead - frozenset(int(v) for v in a[a >= 0])


def measure(res, index, cs: CanarySet, *, filter=None) -> float:
    """Canary recall of ``index`` against the stored ground truth.

    Deleted rows are excluded from both the per-query ground-truth sets
    and the denominator (a delete legitimately removes stored neighbors);
    an index whose every ground-truth id was deleted measures 1.0.
    ``filter`` goes to the sentinel search (filtered search is not ported
    yet, so it raises there)."""
    found = _search_canaries(res, index, cs, filter=filter)
    dropped = _deleted_ids(index)
    hits = total = 0
    for f, t in zip(found, cs.gt_ids):
        gt = set(t.tolist()) - dropped if dropped else set(t.tolist())
        total += len(gt)
        hits += len(set(f.tolist()) & gt)
    return hits / total if total else 1.0


def health_check(res, index, *, raise_on_fail: bool = True
                 ) -> Optional[CanaryReport]:
    """Re-search the index's stored sentinels and compare recall to the
    floor.  Returns the report (``None`` when the index carries no
    canaries); raises :class:`IntegrityError` on a floor violation unless
    ``raise_on_fail=False``."""
    cs = getattr(index, "canaries", None)
    if cs is None:
        return None
    rec = measure(res, index, cs)
    report = CanaryReport(recall=rec, floor=cs.floor,
                          n_queries=cs.n_queries, k=cs.k)
    if not report.ok and raise_on_fail:
        raise IntegrityError(
            f"canary recall {rec:.3f} below floor {cs.floor:.3f} "
            f"({cs.n_queries} sentinels, k={cs.k}; build-time recall "
            f"was {cs.build_recall:.3f})",
            invariant="canary.recall_floor")
    return report


def floor_of(index) -> Optional[float]:
    """The index's stored canary acceptance floor, or None for a
    canary-less index."""
    cs = getattr(index, "canaries", None)
    if cs is None:
        return None
    return float(cs.floor)


def auto_check(res, index, *, site: str) -> None:
    """The post-``load()`` / ``extend()`` / ``resume`` hook: a no-op for
    canary-less indexes, an :class:`IntegrityError` for a failing one.
    ``site`` names the hook (the JAX package counts checks by it)."""
    if getattr(index, "canaries", None) is None:
        return
    health_check(res, index, raise_on_fail=True)


# ---------------------------------------------------------------------------
# serialization: a nested RTIE envelope inside the index stream, so the
# canary block has its own CRC and a corrupt block fails fast on load
# ---------------------------------------------------------------------------

def to_stream(res, stream, cs: Optional[CanarySet]) -> None:
    ser.serialize_scalar(res, stream, np.int32(0 if cs is None else 1))
    if cs is None:
        return
    body = io.BytesIO()
    with ser.enveloped_writer(body) as env:
        ser.serialize_scalar(res, env, np.float64(cs.floor))
        ser.serialize_scalar(res, env, np.float64(cs.build_recall))
        ser.serialize_mdspan(res, env, cs.queries)
        ser.serialize_mdspan(res, env, cs.gt_ids)
    ser.serialize_mdspan(res, stream,
                         np.frombuffer(body.getvalue(), np.uint8))


def from_stream(res, stream) -> Optional[CanarySet]:
    present = int(ser.deserialize_scalar(res, stream))
    if not present:
        return None
    blob = np.asarray(ser.deserialize_mdspan(res, stream), np.uint8)
    env = ser.open_envelope(io.BytesIO(blob.tobytes()))
    floor = float(ser.deserialize_scalar(res, env))
    build_recall = float(ser.deserialize_scalar(res, env))
    queries = np.asarray(ser.deserialize_mdspan(res, env), np.float32)
    gt_ids = np.asarray(ser.deserialize_mdspan(res, env), np.int32)
    return CanarySet(queries=queries, gt_ids=gt_ids, floor=floor,
                     build_recall=build_recall)

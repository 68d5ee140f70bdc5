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

Checks and failures are counted in the observability registry
(``integrity.canary.*``), a check runs under the
``integrity.health_check`` stage, and a failure records the always-on
``integrity.canary_failure`` flight event, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np

from raft_tpu_torch import observability as obs
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
    elif type(index).__name__ == "RoutedIndex":
        # a rank of the routed distributed index (imported here: integrity
        # must not pull the comms fabric in); ``res`` is the rank's worker
        # handle, and the search is collective
        from raft_tpu_torch.distributed import ann as _dann
        p = ivf_pq.SearchParams(n_probes=min(32, index.n_lists))
        _, ids = _dann.search(res, p, index, q, cs.k, filter=filter)
    else:
        raise TypeError(
            f"health_check: unsupported index type {type(index).__name__}")
    return ids.cpu().numpy()


def _deleted_ids(index, res=None, among=None) -> frozenset:
    """Deleted source ids (:func:`raft_tpu_torch.neighbors.mutate.
    deleted_ids`: a graph index's ``deleted_ids``, else the tombstones of
    ``list_indices`` whose id has no live copy in another slot).  A routed
    rank holds only its own lists: there the ids of ``among`` deleted in
    the whole index, one collective over ``res``'s ranks."""
    if type(index).__name__ == "RoutedIndex":
        from raft_tpu_torch.distributed import ann as _dann
        return _dann._deleted_among(res, index, among)
    from raft_tpu_torch.neighbors.mutate import deleted_ids

    return deleted_ids(index)


def measure(res, index, cs: CanarySet, *, filter=None) -> float:
    """Canary recall of ``index`` against the stored ground truth.

    Deleted rows are excluded from both the per-query ground-truth sets
    and the denominator (a delete legitimately removes stored neighbors);
    an index whose every ground-truth id was deleted measures 1.0.
    ``filter`` goes to the sentinel search."""
    found = _search_canaries(res, index, cs, filter=filter)
    dropped = _deleted_ids(index, res, cs.gt_ids)
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
    with obs.stage("integrity.health_check"):
        rec = measure(res, index, cs)
    return _verdict(rec, cs.floor, cs.n_queries, cs.k, cs.build_recall,
                    raise_on_fail)


def _verdict(rec: float, floor: float, n_queries: int, k: int,
             build_recall: float, raise_on_fail: bool) -> CanaryReport:
    """Judge a measured canary recall against its floor: the check and
    failure counters, the ``integrity.canary_failure`` flight event and,
    with ``raise_on_fail``, the :class:`IntegrityError` of a floor
    violation.  Shared with the sharded indexes' ``health_check``, which
    judges every shard's measurement on every rank."""
    if obs.enabled():
        obs.registry().counter("integrity.canary.checks").inc()
    report = CanaryReport(recall=rec, floor=floor, n_queries=n_queries,
                          k=k)
    if not report.ok:
        if obs.enabled():
            obs.registry().counter("integrity.canary.failures").inc()
        # always-on flight event: a canary failure usually precedes a
        # rollback or a serving error
        from raft_tpu_torch.observability import flight as _flight
        _flight.record_event("integrity.canary_failure",
                             recall=rec, floor=floor,
                             n_queries=n_queries, k=k)
        if raise_on_fail:
            raise IntegrityError(
                f"canary recall {rec:.3f} below floor {floor:.3f} "
                f"({n_queries} sentinels, k={k}; build-time recall "
                f"was {build_recall:.3f})",
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
    ``site`` names the hook; checks are counted by it."""
    if getattr(index, "canaries", None) is None:
        return
    if obs.enabled():
        obs.registry().counter(f"integrity.canary.auto.{site}").inc()
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

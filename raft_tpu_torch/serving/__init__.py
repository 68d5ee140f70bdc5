"""raft_tpu_torch.serving — online query serving over the batch indexes
(port of ``raft_tpu.serving``).

Every entry point below this package is batch-shaped: ``search()`` wants
a pre-formed query matrix.  This package is the request scheduler that
turns those batch kernels into an online service (the layer every
RAFT-class deployment interposes between users and the card):

- :mod:`~raft_tpu_torch.serving.buckets` — the closed shape set: power-of-two
  query-count buckets, fixed k/n_probes per bucket, padded rows flagged
  through the integrity mask path (id -1 / worst distance);
- :mod:`~raft_tpu_torch.serving.admission` — bounded queue with typed
  :class:`Overloaded` load-shedding, per-tenant :class:`TokenBucket`
  quotas, deadline-aware queueing on
  :class:`~raft_tpu_torch.resilience.retry.Deadline`;
- :mod:`~raft_tpu_torch.serving.batcher` — the dynamic batcher: dispatch on
  ``max_batch`` OR ``max_wait_us``, whichever first;
- :mod:`~raft_tpu_torch.serving.executor` — bucket-warmed executors over
  IVF-PQ / IVF-Flat / CAGRA / brute force, each bucket a CUDA graph
  captured through ``core/aot`` (the sharded executor waits for
  ``distributed.ann``);
- :mod:`~raft_tpu_torch.serving.server` — the ``Server`` front end:
  ``submit() -> Future``, boundary validation per request, serving
  counters + latency histograms at enqueue→dispatch→complete, plus the
  generation watchdog: N integrity strikes within a window auto-roll
  the executor back to the retained last-known-good index;
- :mod:`~raft_tpu_torch.serving.brownout` — adaptive overload degradation:
  a :class:`BrownoutController` watches windowed latency/queue/shed
  telemetry and steps the bucket down/up a pre-declared, pre-warmed
  degradation ladder (reduced ``n_probes`` → … → best-effort-tenant
  shed) with hysteresis and dwell — goodput degrades instead of
  collapsing, with zero steady-state captures;
- :mod:`~raft_tpu_torch.serving.rebalancer` — crash-safe background index
  maintenance for the mutable IVF indexes: overfull-list re-clustering
  + tombstone compaction, checkpointed stages
  (``resilience.CheckpointManager``), every swap-in gated behind
  ``integrity.verify`` + the recall canary, atomic generation swaps
  through ``Server.swap_index``;
- :mod:`~raft_tpu_torch.serving.ingest` — the durable write path:
  ``Server.write()`` appends to a CRC-framed write-ahead log (fsync
  group commit) before acknowledging, applies to the always-mutable
  :class:`~raft_tpu_torch.neighbors.delta.Memtable` searched alongside the
  main index (the delta-as-extra-shard ``finalize_topk`` merge), and
  periodically folds the memtable into the main index as a
  checkpointed, gated compaction; ``recover()`` replays the WAL to
  bit-identical state after a kill at any boundary;
- :mod:`~raft_tpu_torch.serving.dist_ingest` — the replicated write path
  over routed indexes: a stand-in until ``distributed.ann`` and
  ``distributed.routing`` are ported, as
  are ``DistributedExecutor``, ``rebalance_routed`` and
  ``Server.refresh_routing``.

Quick tour::

    from raft_tpu_torch import serving
    ex = serving.Executor(res, "ivf_pq", index, ks=(10,),
                          max_batch=1024, search_params=sp)
    with serving.Server(ex, serving.ServerConfig(max_wait_us=500)) as srv:
        d, i = srv.search(queries[:3], k=10)
"""

from raft_tpu_torch.core.error import not_ported_stub as _stub
from raft_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionQueue,
    BrownedOut,
    Overloaded,
    QuotaExceeded,
    Request,
    TokenBucket,
)
from raft_tpu_torch.serving.batcher import DynamicBatcher  # noqa: F401
from raft_tpu_torch.serving.brownout import (  # noqa: F401
    BrownoutConfig,
    BrownoutController,
    BrownoutState,
    Rung,
)
from raft_tpu_torch.serving.buckets import (  # noqa: F401
    bucket_for,
    bucket_sizes,
    pad_rows,
    valid_rows_mask,
)
from raft_tpu_torch.serving.executor import (  # noqa: F401
    DistributedExecutor,
    Executor,
)
from raft_tpu_torch.serving.ingest import (  # noqa: F401
    IngestConfig,
    IngestServer,
    WriteAheadLog,
)
from raft_tpu_torch.serving.rebalancer import (  # noqa: F401
    RebalanceConfig,
    Rebalancer,
    rebalance_routed,
)
from raft_tpu_torch.serving.server import Server, ServerConfig  # noqa: F401
from raft_tpu_torch.serving.shadow import (  # noqa: F401
    ShadowConfig,
    ShadowMonitor,
    ground_truth_search_params,
)

_ITEM7 = "distributed (item 7)"
DistIngestConfig = _stub("serving", "DistIngestConfig", _ITEM7)
RoutedIngest = _stub("serving", "RoutedIngest", _ITEM7)
Unavailable = _stub("serving", "Unavailable", _ITEM7)

__all__ = [
    "AdmissionQueue",
    "BrownedOut",
    "BrownoutConfig",
    "BrownoutController",
    "BrownoutState",
    "DistIngestConfig",
    "DistributedExecutor",
    "DynamicBatcher",
    "Executor",
    "IngestConfig",
    "IngestServer",
    "Overloaded",
    "Rung",
    "QuotaExceeded",
    "RebalanceConfig",
    "Rebalancer",
    "rebalance_routed",
    "Request",
    "RoutedIngest",
    "Server",
    "ServerConfig",
    "Unavailable",
    "ShadowConfig",
    "ShadowMonitor",
    "TokenBucket",
    "WriteAheadLog",
    "bucket_for",
    "bucket_sizes",
    "ground_truth_search_params",
    "pad_rows",
    "valid_rows_mask",
]

"""Stand-in for ``raft_tpu.serving.dist_ingest``, the replicated durable
write path over the routed distributed index: it needs
``distributed.ann`` and ``distributed.routing``, which are not ported
yet.  Every public name raises
``NotImplementedError`` naming ROADMAP.md §1's 'distributed (item 7)'."""

from raft_tpu_torch.core.error import not_ported_getattr

__getattr__ = not_ported_getattr("raft_tpu_torch.serving.dist_ingest",
                                 "distributed (item 7)")

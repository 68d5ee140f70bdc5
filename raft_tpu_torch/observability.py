"""``raft_tpu.observability`` (metrics registry, stages, traces, flight
recorder, quality, export): not ported yet (ROADMAP.md §1 item 10,
*host-side subsystems*).  Every public attribute raises
``NotImplementedError`` naming the item."""

from raft_tpu_torch.core.error import not_ported_getattr

__getattr__ = not_ported_getattr("raft_tpu_torch.observability",
                                 "host-side subsystems")

"""Stand-in for ``raft_tpu.distributed.routing``: not ported yet.  Every
public name raises ``NotImplementedError`` naming ROADMAP.md §1's
'distributed (item 7)'."""

from raft_tpu_torch.core.error import not_ported_getattr

__getattr__ = not_ported_getattr("raft_tpu_torch.distributed.routing",
                                 "distributed (item 7)")

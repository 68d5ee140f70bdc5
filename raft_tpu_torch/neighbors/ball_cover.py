"""``raft_tpu.neighbors.ball_cover``: not ported yet (ROADMAP.md §1 item
13, *the tail*).  Every public attribute raises ``NotImplementedError``
naming the item."""

from raft_tpu_torch.core.error import not_ported_getattr

__getattr__ = not_ported_getattr("raft_tpu_torch.neighbors.ball_cover",
                                 "the tail")

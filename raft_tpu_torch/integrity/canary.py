"""``raft_tpu.integrity.canary`` (recall canaries): not ported yet
(ROADMAP.md §1 item 10, *canaries*).  Every public attribute raises
``NotImplementedError`` naming the item."""

from raft_tpu_torch.core.error import not_ported_getattr

__getattr__ = not_ported_getattr("raft_tpu_torch.integrity.canary",
                                 "canaries")

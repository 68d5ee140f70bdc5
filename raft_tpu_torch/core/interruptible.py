"""Cooperative cancellation (``raft_tpu.core.interruptible``): not ported
yet (ROADMAP.md §1 item 10, *host-side subsystems*).

:class:`InterruptedException` is the reference's error type;
``interruptible`` raises ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

from raft_tpu_torch.core.error import not_ported_stub


class InterruptedException(RuntimeError):
    """A cancelled wait (the reference's type)."""


interruptible = not_ported_stub("core.interruptible", "interruptible",
                                "host-side subsystems")

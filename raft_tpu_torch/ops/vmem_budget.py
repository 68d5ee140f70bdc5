"""The public ``merge_window`` knob (port of the parsing part of
``raft_tpu/ops/vmem_budget.py``).

On a TPU the JAX package sizes a VMEM staging ring for the windowed merge
of its fused kernels from this knob.  The port's kernels have no such
ring, so the value is validated — the same spellings accepted, the same
``ValueError`` otherwise — and selects nothing.  A Hopper shared-memory
model that would give ``"auto"`` a meaning is ROADMAP.md §2's work.
"""

from __future__ import annotations

# requested merge_window sentinel: pick the largest window that fits
MERGE_WINDOW_AUTO = 0


def merge_window_request(value) -> int:
    """Normalise ``SearchParams.merge_window`` ("auto" | int) to the
    integer request the JAX package's selectors take: 0 = auto, n >= 1 =
    upper bound (``raft_tpu/ops/vmem_budget.py:44``).  IVF-PQ and CAGRA
    search both parse the knob here."""
    if value is None or value == "auto":
        return MERGE_WINDOW_AUTO
    w = int(value)
    if w < 0:
        raise ValueError(
            f"merge_window must be 'auto' or an int >= 0, got {value!r}")
    return w

"""Tracing / profiling annotations (port of ``raft_tpu.core.tracing``).

Counterpart of the reference's NVTX ranges
(cpp/include/raft/core/nvtx.hpp:48-76): RAII ``common::nvtx::range<domain>``
plus ``push_range``/``pop_range``, used at every algorithm entry point.  A
range opens ``torch.profiler.record_function`` under the label
``f"{domain}:{name}"`` (the JAX package's label), so ``torch.profiler``
traces show it, and, when CUDA is available, pushes the same label as an
NVTX range, so Nsight shows it too.  Without CUDA the NVTX calls are
skipped: a CPU-only torch build raises on them, and a range is an
annotation, never a device path.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List

import torch


class domain:
    """Annotation domains (reference: core/nvtx.hpp ``domain::app`` /
    ``domain::raft``)."""

    app = "app"
    raft = "raft_tpu"


class _RangeStack(threading.local):
    """Per-thread stack — the imperative push/pop pairs up on the thread
    that pushed (the reference's nvtx ranges are per-thread)."""

    def __init__(self) -> None:
        self.items: List[Any] = []


_range_stack = _RangeStack()


@contextlib.contextmanager
def range(name: str, *fmt_args: Any,
          domain: str = domain.raft) -> Iterator[None]:
    """RAII-style trace range (reference: ``common::nvtx::range``,
    core/nvtx.hpp:76).

    Opens ``torch.profiler.record_function(label)`` and, with CUDA
    available, an NVTX range of the same label around the body."""
    if fmt_args:
        name = name % fmt_args
    label = f"{domain}:{name}"
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def push_range(name: str, *fmt_args: Any) -> None:
    """Imperative begin-range (reference: core/nvtx.hpp ``push_range``)."""
    cm = range(name, *fmt_args)
    cm.__enter__()
    _range_stack.items.append(cm)


def pop_range() -> None:
    """Imperative end-range (reference: core/nvtx.hpp ``pop_range``)."""
    if _range_stack.items:
        cm = _range_stack.items.pop()
        cm.__exit__(None, None, None)

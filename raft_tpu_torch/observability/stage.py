"""``stage(name)`` — the timing primitive, composed with tracing.range (port
of ``raft_tpu.observability.stage``).

A stage is one phase of an algorithm (``"cagra.build.scan"``,
``"ivf_pq.search.coarse"``).  Entering a stage while collection is enabled

  * opens the existing :func:`raft_tpu_torch.core.tracing.range` under the
    **same label**, so ``torch.profiler`` / Nsight timelines and the metrics
    registry agree on stage names, and
  * starts a wall clock whose reading is recorded into
    ``registry().timer(name)`` on exit.

CUDA launches are asynchronous, so a wall clock alone would measure enqueue
time; the yielded handle exposes :meth:`_StageHandle.fence` for the caller
to wait for the stage's outputs before the clock stops.  **When collection
is disabled (the default) the context manager yields a no-op singleton: no
range, no clock, and — critically — ``fence`` does nothing, so instrumented
hot paths never wait on the device.**  That contract is load-bearing for
search throughput.

A stage never catches: an exception inside it (a kernel that fails to
launch, a gate that raises) propagates after the timer records.

The JAX package also listens for XLA compile events here (``xla.*``
metrics); the port compiles nothing through XLA and has no counterpart.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, List, Optional

import torch

from raft_tpu_torch.core.tracing import range as _trace_range
from raft_tpu_torch.observability import trace as _request_trace
from raft_tpu_torch.observability.registry import (
    MetricsRegistry,
    enabled as _enabled,
    registry as _registry,
)


def _wait_device(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (nothing to
    wait for on the CPU, where torch ops return finished)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# Indirection so tests can observe (or forbid) fencing: the disabled-path
# test patches this and asserts it is never called.  Called once per
# distinct device among the fenced tensors.
_block_until_ready = _wait_device


def _leaves(values: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors in ``values``, through tuples, lists and dict values."""
    if isinstance(values, torch.Tensor):
        out.append(values)
    elif isinstance(values, (tuple, list)):
        for v in values:
            _leaves(v, out)
    elif isinstance(values, dict):
        for v in values.values():
            _leaves(v, out)
    return out


def fence(*values: Any) -> None:
    """Wait until every tensor in ``values`` is computed: one wait on the
    current stream of each distinct device among them (the counterpart of
    ``block_until_ready`` on each array)."""
    devices = []
    for t in _leaves(values, []):
        if t.device not in devices:
            devices.append(t.device)
    for dev in devices:
        _block_until_ready(dev)


class _StageHandle:
    """Yielded by an *enabled* stage; carries the fence."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def fence(self, *values: Any) -> None:
        fence(*values)


class _NoopHandle:
    """Yielded when collection is disabled — every method is free."""

    __slots__ = ()
    name = ""

    def fence(self, *values: Any) -> None:  # noqa: ARG002 - deliberate no-op
        return None


_NOOP = _NoopHandle()


@contextlib.contextmanager
def stage(name: str,
          registry: Optional[MetricsRegistry] = None) -> Iterator[Any]:
    """Time one algorithm phase under ``name`` (see module docstring).

    Usage::

        with stage("cagra.build.scan") as s:
            knn = run_the_scan(...)
            s.fence(knn)          # no-op when collection is off

    The final fence is the caller's responsibility — without it the timer
    records launch time only (still useful for host-loop stages)."""
    if not _enabled():
        yield _NOOP
        return
    reg = registry if registry is not None else _registry()
    with _trace_range(name):
        t0 = time.perf_counter()
        try:
            yield _StageHandle(name)
        finally:
            dt = time.perf_counter() - t0
            reg.timer(name).record(dt)
            # mirror onto the ambient request trace (one flag check when
            # per-request tracing is off) so stage timers nest inside
            # request spans under the same labels
            _request_trace.stage_hook(name, dt)

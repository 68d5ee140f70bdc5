"""Cooperative cancellation (port of ``raft_tpu.core.interruptible``).

Counterpart of the reference's ``raft::interruptible``
(cpp/include/raft/core/interruptible.hpp:66-130): a per-thread token that
other CPU threads can ``cancel()``, making the target thread's next
:meth:`interruptible.synchronize` raise :class:`InterruptedException`.
CUDA kernels cannot be aborted mid-flight, so the cancellation points are
the host-side sync points: long host loops (index build stages) call
:meth:`interruptible.synchronize` or :meth:`interruptible.yield_no_wait`,
which makes them cancellable from another thread.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch


class InterruptedException(RuntimeError):
    """Raised at a sync point after cancel() (reference:
    ``raft::interruptible::interrupted_exception``)."""


class interruptible:
    _tokens: Dict[int, "interruptible"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._cancelled = threading.Event()

    # -- token registry (reference: get_token / get_token(thread_id)) --------
    @classmethod
    def get_token(cls, thread_id: Optional[int] = None) -> "interruptible":
        # tokens persist for the process lifetime: one may be created for a
        # thread that has not started yet, so pruning by liveness would lose
        # pending cancellations; a thread that consumed an interruption
        # clears its own flag (yield_no_wait)
        tid = thread_id if thread_id is not None else threading.get_ident()
        with cls._lock:
            tok = cls._tokens.get(tid)
            if tok is None:
                tok = interruptible()
                cls._tokens[tid] = tok
            return tok

    @classmethod
    def release_token(cls, thread_id: Optional[int] = None) -> None:
        """Drop a thread's token (call when a worker thread retires)."""
        tid = thread_id if thread_id is not None else threading.get_ident()
        with cls._lock:
            cls._tokens.pop(tid, None)

    def cancel(self) -> None:
        """Flag the owning thread for interruption (reference: cancel)."""
        self._cancelled.set()

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    # -- sync points ---------------------------------------------------------
    @classmethod
    def yield_no_wait(cls) -> None:
        """Check the current thread's token without blocking (reference:
        yield_no_wait)."""
        tok = cls.get_token()
        if tok._cancelled.is_set():
            tok._cancelled.clear()
            raise InterruptedException("raft_tpu: thread interrupted")

    @classmethod
    def synchronize(cls, *tensors: torch.Tensor) -> None:
        """Wait for device work, raising if cancelled (reference:
        synchronize).  With tensors given, waits on the stream of each CUDA
        device they lie on; otherwise on the current device, if CUDA is in
        use.  Also the fault site ``interruptible.synchronize``
        (:mod:`raft_tpu_torch.resilience.faults`), so an interruption
        mid-build can be scripted."""
        cls.yield_no_wait()
        # lazy import: core stays importable before the resilience package
        from raft_tpu_torch.resilience import faults
        faults.maybe_fail("interruptible.synchronize")
        if tensors:
            for dev in {t.device for t in tensors if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        cls.yield_no_wait()

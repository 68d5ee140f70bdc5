"""A launcher of ranks on one host: ``world_size`` processes, each with the
``torch.distributed`` default group initialised, running one function.

The JAX package's ranks come from ``jax.distributed.initialize``; a
session here is built on a process group the launcher initialised (see
:mod:`raft_tpu_torch.comms.session`).  :func:`spawn` is such a launcher
for the ranks of one host, as the tests and ``chip_smoke.py`` use it: the
processes start with the ``spawn`` method, meet at a ``file://``
rendezvous (no port to share), and each returns ``fn(rank, world_size,
*args)`` through a queue.  Each group of ranks has a deadline: past it,
or as soon as a rank fails, every rank is killed and the call raises,
naming the rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(fn, rank, world_size, backend, init_method, collective_s,
               args, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=collective_s))
        try:
            out.put((rank, True, fn(rank, world_size, *args)))
            # no rank leaves (closing its connections) while another is
            # still in the group's set-up or its function; a rank that
            # failed breaks the barrier, and it reports for itself
            try:
                dist.barrier()
            except RuntimeError:
                pass
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], world_size: int, init_file: str, *,
          backend: str = "gloo", args: Sequence[Any] = (),
          timeout_s: float = 120.0, collective_s: float = 60.0
          ) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new
    processes, each in a default group of ``backend`` that meets at the
    file ``init_file`` (it must not exist yet); returns the ranks'
    results in rank order.  ``fn`` and its results must pickle; ``fn``
    must be importable by its module name.  ``collective_s`` is the
    group's timeout for one collective, ``timeout_s`` the deadline of the
    whole call.  Each rank runs torch on one thread: the ranks share the
    host's cores."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend,
                               f"file://{init_file}", collective_s,
                               tuple(args), out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(results))
                raise TimeoutError(
                    f"comms.launch: rank(s) {missing} of {world_size} did "
                    f"not finish within {timeout_s} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:    # what a rank reported before it died comes first
                    rank, ok, value = out.get(timeout=2.0)
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"comms.launch: rank {dead[0][0]} of {world_size} "
                        f"died with exit code {dead[0][1]}") from None
            if not ok:
                raise RuntimeError(f"comms.launch: rank {rank} of "
                                   f"{world_size} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world_size)]

"""Comms self-tests (port of ``raft_tpu.comms.self_test``).

Reference: cpp/include/raft/comms/comms_test.hpp:171 + detail/test.hpp —
``test_collective_allreduce`` etc. assert each collective's result inside
the workers; raft-dask drives them via ``perform_test_comms_*``
(comms_utils.pyx:78+).

Every rank calls each check, in the same order; each runs the collective
on its rank, and the ranks agree on the verdict (an allreduce of the
flags outside the communicator under test), so each returns the same bool
on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from raft_tpu_torch.comms.comms import op_t
from raft_tpu_torch.comms.session import CommsSession, grid_groups


def _agree(session: CommsSession, ok: bool) -> bool:
    """True on every rank iff ``ok`` on every rank."""
    flag = torch.tensor([int(bool(ok))], dtype=torch.int32)
    group = session.axes[session.axis_name]
    if dist.get_backend(group) == "nccl":
        flag = flag.to(session.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def perform_test_comms_allreduce(session: CommsSession) -> bool:
    """Each rank contributes 1; the result is n_ranks everywhere
    (reference: detail/test.hpp test_collective_allreduce)."""
    comms = session.comms()
    n = comms.get_size()
    out = comms.allreduce(torch.ones((), device=session.device), op_t.SUM)
    return _agree(session, float(out) == n)


def perform_test_comms_bcast(session: CommsSession, root: int = 0) -> bool:
    comms = session.comms()
    mine = torch.tensor(float(comms.get_rank() + 1), device=session.device)
    out = comms.bcast(mine, root=root)
    return _agree(session, float(out) == root + 1)


def perform_test_comms_reduce(session: CommsSession, root: int = 0) -> bool:
    comms = session.comms()
    n = comms.get_size()
    out = comms.reduce(torch.ones((), device=session.device), root=root)
    return _agree(session, comms.get_rank() != root or float(out) == n)


def perform_test_comms_allgather(session: CommsSession) -> bool:
    comms = session.comms()
    n = comms.get_size()
    mine = torch.tensor([float(comms.get_rank())], device=session.device)
    got = comms.allgather(mine).reshape(n).cpu()
    return _agree(session, bool((got == torch.arange(n).float()).all()))


def perform_test_comms_gatherv(session: CommsSession, root: int = 0) -> bool:
    """Ragged gather: rank r contributes r+1 elements of value r
    (reference: test.hpp test_collective_gatherv)."""
    comms = session.comms()
    n, rank = comms.get_size(), comms.get_rank()
    counts = [r + 1 for r in range(n)]
    mine = torch.full((rank + 1,), float(rank), device=session.device)
    got, _ = comms.gatherv(mine, counts, root=root)
    got = got.cpu()
    return _agree(session, all(bool((got[r, :counts[r]] == r).all())
                               for r in range(n)))


def perform_test_comms_reducescatter(session: CommsSession) -> bool:
    comms = session.comms()
    n = comms.get_size()
    out = comms.reducescatter(torch.ones(n, device=session.device),
                              op_t.SUM)
    return _agree(session, bool((out.cpu() == n).all()))


def perform_test_comms_device_sendrecv(session: CommsSession) -> bool:
    """Ring shift-by-one (reference: test.hpp
    test_pointToPoint_simple_send_recv)."""
    comms = session.comms()
    n, rank = comms.get_size(), comms.get_rank()
    mine = torch.tensor(float(rank), device=session.device)
    got = comms.device_send(mine, 1)   # send to rank+1
    return _agree(session, float(got) == (rank - 1) % n)


def perform_test_comm_split(session: CommsSession) -> bool:
    """2D split over the default group's ranks as a 2 x n/2 grid:
    allreduce along rows then along cols multiplies out to the full size
    (reference: test.hpp test_commsplit).  Every rank of the default
    group calls it."""
    n = dist.get_world_size()
    if n % 2 != 0:
        return True  # need an even grid
    grid = CommsSession(axis_name="row", device=session.device,
                        axes=grid_groups(2, n // 2))
    row = grid.comms()
    col = row.comm_split("col")
    a = row.allreduce(torch.ones((), device=session.device))
    b = col.allreduce(a)
    # MPI-style color split: ranks sharing a row index communicate along
    # "col" — summing row indices over that communicator gives
    # row_index * n_cols
    same_row = row.comm_split(grouped_by="row")
    ri = float(dist.get_rank() // (n // 2))
    row_sum = same_row.allreduce(torch.tensor(ri, device=session.device))
    ok = float(b) == n and float(row_sum) == ri * col.get_size()
    return _agree(session, ok)


def perform_test_comms_isend_irecv(session: CommsSession) -> bool:
    """Tagged p2p: a ring exchange and a pair swap posted under two tags,
    completed by one waitall (reference: test.hpp
    test_pointToPoint_simple_send_recv — UCX tags over absolute ranks)."""
    comms = session.comms()
    n, rank = comms.get_size(), comms.get_rank()
    if n < 2:
        return True
    ring_dst = [(r + 1) % n for r in range(n)]
    ring_src = [(r - 1) % n for r in range(n)]
    # pairwise swap; for odd n the last rank self-sends (a permutation)
    swap = [r + 1 if r % 2 == 0 and r + 1 < n
            else (r - 1 if r % 2 == 1 else r) for r in range(n)]
    mine = torch.tensor(float(rank), device=session.device)
    reqs = [comms.isend(mine, ring_dst, tag=0),
            comms.irecv(ring_src, tag=0),
            comms.isend(mine * 10.0, swap, tag=1),
            comms.irecv(swap, tag=1)]        # swap is its own inverse
    ring_got, swap_got = comms.waitall(reqs)
    ok = (float(ring_got) == (rank - 1) % n
          and float(swap_got) == swap[rank] * 10.0)
    return _agree(session, ok)

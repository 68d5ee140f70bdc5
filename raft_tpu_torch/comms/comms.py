"""comms_t — the collective / p2p communicator on ``torch.distributed``
(port of ``raft_tpu.comms.comms``).

Reference: cpp/include/raft/core/comms.hpp:125-230 ``comms_iface`` /
``comms_t`` (:242): allreduce, bcast, reduce, allgather(v), gather(v),
reducescatter, isend/irecv/waitall, device_send/recv/sendrecv/multicast,
comm_split, barrier, sync_stream; ops :33, status_t :39.

The JAX ``Comms`` is a traced-context object: its methods run inside one
``shard_map`` over a mesh axis, in one process.  Here each rank is a
process, and each method is an eager collective on a process group:

    allreduce     → dist.all_reduce (SUM / PRODUCT / MIN / MAX)
    bcast         → dist.broadcast
    reduce        → dist.all_reduce (the result on every rank: the JAX
                    superset of the reference's root-only contract)
    allgather     → dist.all_gather_into_tensor (a new leading axis)
    allgatherv    → allgather of buffers padded to max(recvcounts)
    gather(v)     → as allgather(v), on every rank (the JAX superset)
    reducescatter → dist.reduce_scatter_tensor (SUM, tiled along axis 0)
    isend / irecv → the JAX pattern API; waitall posts one
                    dist.batch_isend_irecv, matched by posting order
    comm_split    → a Comms over another axis's group of this rank

Every rank calls every method, in the same order, with tensors of the
same shape: the SPMD contract the JAX package's trace gives for free.
One collective program at a time per communicator: a lock is held around
each call, so two threads that share a communicator never interleave the
collectives of two calls (each thread's calls must still come in the same
order on every rank).

The backend is the process group's; nothing here switches it.  Gloo runs
the collectives on CUDA tensors itself, but reads a p2p tensor's address
as host memory: on a gloo group, p2p messages of CUDA tensors go through
host copies, and the op's name is kept in :data:`staged`.

Each call bumps ``comms.<op>.calls`` / ``comms.<op>.bytes`` when
collection is on, under the JAX package's op names, then gives the fault
harness its shot at ``comms.<op>``.  The JAX package counts traced
collectives; the port counts executed ones.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.resilience import faults

# the p2p ops this process ran on host copies of CUDA tensors (gloo)
staged = set()


def _record_collective(op: str, x=None) -> None:
    """Bump ``comms.<op>.calls`` / ``comms.<op>.bytes`` when collection is
    on, then give the fault harness its shot at ``comms.<op>``."""
    if obs.enabled():
        reg = obs.registry()
        reg.counter(f"comms.{op}.calls").inc()
        if x is not None:
            nbytes = int(x.numel()) * x.element_size()
            if nbytes:
                reg.counter(f"comms.{op}.bytes").inc(nbytes)
    faults.maybe_fail(f"comms.{op}")


class op_t:
    """Reduction ops (reference: core/comms.hpp:33 ``op_t``)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


class status_t:
    """Reference: core/comms.hpp:39 ``status_t``."""

    SUCCESS = 0
    ERROR = 1
    ABORT = 2


_REDUCE_OPS = {op_t.SUM: dist.ReduceOp.SUM, op_t.PROD: dist.ReduceOp.PRODUCT,
               op_t.MIN: dist.ReduceOp.MIN, op_t.MAX: dist.ReduceOp.MAX}


@dataclasses.dataclass
class P2pRequest:
    """A posted isend/irecv awaiting waitall (reference: the request_t
    handles of comms.hpp:146-168).  ``pattern`` is the full rank→peer map;
    ``data`` holds the delivered buffer for recv requests after waitall."""

    kind: str                    # "send" | "recv"
    comms: "Comms"
    payload: Optional[torch.Tensor]
    pattern: Tuple[int, ...]
    tag: int
    data: Optional[torch.Tensor] = None


class Comms:
    """Communicator over a process group (reference: comms_t,
    core/comms.hpp:242).  ``group`` is this rank's group along
    ``axis_name`` (None: the default group); ``axes`` maps each axis of
    the session's grid to this rank's group along it, for
    :meth:`comm_split`; ``device`` is where results are placed (tensors
    given on another device are moved there)."""

    def __init__(self, axis_name: str = "data", group=None, device=None,
                 axes: Optional[Dict[str, object]] = None) -> None:
        self.axis_name = axis_name
        self.group = group
        self.device = torch.device(device) if device is not None else None
        self.axes = dict(axes) if axes is not None else {axis_name: group}
        self._lock = threading.RLock()

    # -- topology ----------------------------------------------------------
    def get_size(self) -> int:
        """Number of ranks in the group (reference: get_size)."""
        return dist.get_world_size(self.group)

    def get_rank(self) -> int:
        """This process's rank in the group (reference: get_rank)."""
        return dist.get_rank(self.group)

    def _global(self, rank: int) -> int:
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))

    # -- plumbing ------------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        if self.device is not None and t.device != self.device:
            t = t.to(self.device)
        return t.contiguous()

    def _p2p(self, op: str, sends, recvs) -> None:
        """Post ``sends`` / ``recvs`` ((tensor, global peer, tag, group)
        each) in one ``batch_isend_irecv`` and wait for them.  Gloo passes
        a tensor's address to its transport as host memory, so on a gloo
        group CUDA tensors always go through host copies."""
        host = any(e[0].is_cuda for e in sends + recvs) and (
            dist.get_backend(self.group) == "gloo")
        dests = [e[0] for e in recvs]
        if host:
            staged.add(op)
            sends = [(t.cpu(),) + tuple(e) for t, *e in sends]
            recvs = [(t.new_empty(t.shape, device="cpu"),) + tuple(e)
                     for t, *e in recvs]
        ops = ([dist.P2POp(dist.isend, t, p, grp, tag)
                for t, p, tag, grp in sends]
               + [dist.P2POp(dist.irecv, t, p, grp, tag)
                  for t, p, tag, grp in recvs])
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if host:
            for dest, (t, *_) in zip(dests, recvs):
                dest.copy_(t)

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, x, op: str) -> torch.Tensor:
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduce op {op!r}")
        t = self._tensor(x).clone()
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
        return t

    def allreduce(self, x, op: str = op_t.SUM) -> torch.Tensor:
        """Reference: comms.hpp allreduce → ncclAllReduce."""
        with self._lock:
            _record_collective("allreduce", torch.as_tensor(x))
            return self._all_reduce(x, op)

    def bcast(self, x, root: int = 0) -> torch.Tensor:
        """Broadcast root's value to all ranks (reference: bcast →
        ncclBroadcast)."""
        with self._lock:
            _record_collective("bcast", torch.as_tensor(x))
            t = self._tensor(x).clone()
            dist.broadcast(t, src=self._global(root), group=self.group)
            return t

    def reduce(self, x, root: int = 0, op: str = op_t.SUM) -> torch.Tensor:
        """Reduce to root (reference: reduce → ncclReduce).  Every rank
        gets the result, as in the JAX package (a superset of the
        reference's root-only contract); counted under its own name."""
        del root
        with self._lock:
            _record_collective("reduce", torch.as_tensor(x))
            return self._all_reduce(x, op)

    def _all_gather(self, x) -> torch.Tensor:
        t = self._tensor(x)
        n = self.get_size()
        flat = t.reshape(-1) if t.ndim == 0 else t
        out = torch.empty((n * flat.shape[0],) + tuple(flat.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        return out.reshape((n,) + tuple(t.shape))

    def allgather(self, x) -> torch.Tensor:
        """Equal-size shards along a new leading axis (reference:
        allgather → ncclAllGather)."""
        with self._lock:
            _record_collective("allgather", torch.as_tensor(x))
            return self._all_gather(x)

    def _allgatherv(self, x, recvcounts: Sequence[int]):
        counts = tuple(int(c) for c in recvcounts)
        t = self._tensor(x)
        pad = max(counts) - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        return self._all_gather(t), counts

    def allgatherv(self, x, recvcounts: Sequence[int]):
        """Ragged allgather: shards padded to max(recvcounts) on axis 0;
        returns (n_ranks, max_count, ...) and the counts for unpadding."""
        with self._lock:
            _record_collective("allgatherv", torch.as_tensor(x))
            return self._allgatherv(x, recvcounts)

    def gather(self, x, root: int = 0) -> torch.Tensor:
        """Gather to root (reference: gather); every rank gets it, as in
        the JAX package.  Own counter name."""
        del root
        with self._lock:
            _record_collective("gather", torch.as_tensor(x))
            return self._all_gather(x)

    def gatherv(self, x, recvcounts: Sequence[int], root: int = 0):
        """Ragged gather-to-root (reference: gatherv); own counter name."""
        del root
        with self._lock:
            _record_collective("gatherv", torch.as_tensor(x))
            return self._allgatherv(x, recvcounts)

    def reducescatter(self, x, op: str = op_t.SUM) -> torch.Tensor:
        """Reference: reducescatter → ncclReduceScatter.  ``x`` is the
        full-size buffer on every rank; each rank gets its 1/n slice of the
        sum along axis 0."""
        with self._lock:
            _record_collective("reducescatter", torch.as_tensor(x))
            expects(op == op_t.SUM,
                    "reducescatter supports SUM (as XLA psum_scatter)")
            t = self._tensor(x)
            n = self.get_size()
            expects(t.ndim >= 1 and t.shape[0] % n == 0,
                    f"reducescatter: axis 0 ({tuple(t.shape)}) must divide "
                    f"over {n} ranks")
            out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
            dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM,
                                       group=self.group)
            return out

    # -- tagged point-to-point (UCX isend/irecv/waitall analogue) ----------
    #
    # The JAX package keeps the posting API (absolute ranks, tags, deferred
    # completion) but takes the full rank→rank pattern up front, since
    # every rank runs the same program.  The port keeps that API and its
    # checks, which are host logic every rank runs alike; waitall posts
    # the sends and receives of all tags in one batch, in the requests'
    # order on every rank, so messages between two ranks match in posting
    # order (NCCL has no tags).

    def isend(self, x, dst: Sequence[int], tag: int = 0) -> P2pRequest:
        """Post a send: rank r's buffer goes to rank ``dst[r]``
        (reference: comms.hpp:146 ``isend``); ``dst[r] = -1`` marks rank r
        as not sending.  Every rank posts it, with its own buffer of the
        common shape.  Completion at waitall()."""
        with self._lock:
            _record_collective("isend", torch.as_tensor(x))
            n = self.get_size()
            dsts = []
            for d in dst:
                d = int(d)
                expects(-1 <= d < n,
                        f"isend: dst ranks must be in [0, {n}) or the -1 "
                        "no-send sentinel")
                dsts.append(d)
            expects(len(dsts) == n, f"isend: dst must list all {n} ranks")
            return P2pRequest(kind="send", comms=self,
                              payload=self._tensor(x), pattern=tuple(dsts),
                              tag=tag)

    def irecv(self, src: Sequence[int], tag: int = 0) -> P2pRequest:
        """Post a receive: rank r expects the message sent by rank
        ``src[r]`` under ``tag`` (reference: comms.hpp:156 ``irecv``);
        ``src[r] = -1`` receives nothing (its buffer is zeros)."""
        n = self.get_size()
        srcs = []
        for s in src:
            s = int(s)
            expects(-1 <= s < n,
                    f"irecv: src ranks must be in [0, {n}) or the -1 "
                    "receive-nothing sentinel")
            srcs.append(s)
        expects(len(srcs) == n, f"irecv: src must list all {n} ranks")
        return P2pRequest(kind="recv", comms=self, payload=None,
                          pattern=tuple(srcs), tag=tag)

    def waitall(self, requests: Sequence[P2pRequest]):
        """Complete posted p2p requests (reference: comms.hpp:168
        ``waitall``): match send/recv pairs by tag, check that the
        patterns agree, exchange, and fill each recv request's ``.data``.
        Returns the delivered recv buffers in posting order."""
        sends = {r.tag: r for r in requests if r.kind == "send"}
        recvs = [r for r in requests if r.kind == "recv"]
        expects(len(sends) == len([r for r in requests
                                   if r.kind == "send"]),
                "waitall: one send per tag (batch distinct messages under "
                "distinct tags)")
        pairs = []
        for r in recvs:
            expects(r.tag in sends, f"waitall: no send posted for tag "
                                    f"{r.tag}")
            s = sends[r.tag]
            expects(s.comms.axis_name == r.comms.axis_name,
                    "waitall: send and recv posted on different "
                    "communicators for tag "
                    f"{r.tag} ({s.comms.axis_name} vs {r.comms.axis_name})")
            # consistency both ways: the sender targeting rank k must be
            # the rank k expects, and every posted send must be claimed
            for k, src_k in enumerate(r.pattern):
                if src_k >= 0:
                    expects(s.pattern[src_k] == k,
                            "waitall: send dst pattern and recv src "
                            f"pattern disagree at rank {k}")
            for j, dst_j in enumerate(s.pattern):
                if dst_j >= 0:
                    expects(r.pattern[dst_j] == j,
                            f"waitall: rank {j}'s send to rank {dst_j} "
                            "is not claimed by any receiver (two senders "
                            "to one rank need distinct tags)")
            pairs.append((s, r))
        with self._lock:
            sends, recvs = [], []
            for s, r in pairs:
                c = s.comms
                me = c.get_rank()
                dst, src = s.pattern[me], r.pattern[me]
                if dst == me and src == me:
                    r.data = s.payload.clone()
                    continue
                r.data = torch.zeros_like(s.payload)
                if dst >= 0:
                    sends.append((s.payload, c._global(dst), s.tag, c.group))
                if src >= 0:
                    recvs.append((r.data, c._global(src), s.tag, c.group))
            self._p2p("isend", sends, recvs)
        return [r.data for _, r in pairs]

    # -- point-to-point (shift patterns) -----------------------------------
    def _shift(self, op: str, x, shift: int) -> torch.Tensor:
        """Rank r sends ``x`` to rank (r + shift) % n and receives from
        (r - shift) % n."""
        t = self._tensor(x)
        n = self.get_size()
        if shift % n == 0:
            return t.clone()
        me = self.get_rank()
        out = torch.empty_like(t)
        self._p2p(op, [(t, self._global((me + shift) % n), 0, self.group)],
                  [(out, self._global((me - shift) % n), 0, self.group)])
        return out

    def device_sendrecv(self, x, dst: int, src: int) -> torch.Tensor:
        """Simultaneous send / recv (reference: device_sendrecv): as in the
        JAX package, every rank passes the same (dst, src), and the global
        pattern is the shift by ``dst - src``."""
        with self._lock:
            _record_collective("device_sendrecv", torch.as_tensor(x))
            return self._shift("device_sendrecv", x, dst - src)

    def device_send(self, x, dst_shift: int) -> torch.Tensor:
        """Shift-pattern send (reference: device_send): rank r's ``x`` goes
        to rank r + ``dst_shift``; returns what this rank received."""
        with self._lock:
            _record_collective("device_send", torch.as_tensor(x))
            return self._shift("device_send", x, dst_shift)

    def device_recv(self, x, src_shift: int) -> torch.Tensor:
        return self.device_send(x, -src_shift)

    def device_multicast_sendrecv(self, x, dsts: Sequence[int]
                                  ) -> torch.Tensor:
        """Multicast (reference: device_multicast_sendrecv): gather-based,
        every rank sees every shard."""
        with self._lock:
            _record_collective("multicast_sendrecv", torch.as_tensor(x))
            return self._all_gather(x)

    # -- split / sync ------------------------------------------------------
    def comm_split(self, axis_name: Optional[str] = None, key: int = 0, *,
                   grouped_by: Optional[str] = None) -> "Comms":
        """Sub-communicator (reference: comm_split, core/comms.hpp:272):
        ``comm_split("row")`` binds this rank's group along an axis of the
        session's grid (``session.make_2d_session``); ``comm_split(
        grouped_by="row")`` is the MPI-color form: ranks sharing a row
        index, i.e. the group along "col" (and vice versa).  ``key`` is
        accepted for signature parity."""
        del key
        expects((axis_name is None) != (grouped_by is None),
                "comm_split: pass exactly one of axis_name / grouped_by")
        if axis_name is None:
            expects(grouped_by in ("row", "col"),
                    "comm_split: grouped_by must be 'row' or 'col' (the "
                    "2D-grid contract); arbitrary groupings require "
                    "declaring them as a mesh axis up front")
            axis_name = "col" if grouped_by == "row" else "row"
        expects(axis_name in self.axes,
                f"comm_split: no axis '{axis_name}' in this communicator's "
                f"grid {sorted(self.axes)}")
        return Comms(axis_name, self.axes[axis_name], self.device, self.axes)

    def barrier(self) -> None:
        """Reference: barrier.  An allreduce of one value, as the JAX
        package's psum of a scalar."""
        with self._lock:
            _record_collective("barrier")
            dev = self.device if self.device is not None else "cpu"
            dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev),
                            group=self.group)

    def sync_stream(self) -> int:
        """Reference: sync_stream: waits for the current CUDA stream of the
        communicator's device (nothing on the CPU); returns SUCCESS."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return status_t.SUCCESS

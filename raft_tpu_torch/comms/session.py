"""Comms session bootstrap (port of ``raft_tpu.comms.session``) — the
raft-dask ``Comms`` analogue.

Reference: python/raft-dask/raft_dask/common/comms.py:37 ``Comms`` (init
:170 → NCCL uniqueId rendezvous → ``inject_comms_on_handle`` storing a
``comms_t`` into each worker's handle), ``local_handle(sessionId)`` :245.

The JAX package's launcher runs ``jax.distributed.initialize`` and the
session pins a mesh axis.  Here the launcher initialises the
``torch.distributed`` process group (one process a rank:
``init_process_group(backend, init_method, world_size, rank)``), and the
session wraps a group of it: the default group, or one the caller made.
The backend is the group's (NCCL on the card, gloo across CPU processes);
nothing here changes it.  NCCL takes one rank a device, so ranks sharing
one card must use gloo.
"""

from __future__ import annotations

import os
import uuid
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import DeviceResources

_sessions: Dict[str, "CommsSession"] = {}
# (rows, cols) -> this rank's ("row", "col") groups: dist.new_group is
# collective over the default group, so each grid is made once, by every
# rank, in the same order
_grids: Dict[Tuple[int, int], Dict[str, object]] = {}


def inject_comms_on_handle(handle: DeviceResources, comms: Comms) -> None:
    """Store a communicator in a handle (reference: comms_utils.pyx
    ``inject_comms_on_handle`` → handle COMMUNICATOR slot)."""
    handle.set_comms(comms)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:<local rank % device count>`` (the local rank from
    ``LOCAL_RANK``, else the global rank)."""
    if device is not None:
        return torch.device(device)
    expects(torch.cuda.is_available(),
            "CommsSession: no CUDA device is available (pass "
            "device='cpu')")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def grid_groups(rows: int, cols: int) -> Dict[str, object]:
    """This rank's groups on a row-major ``rows`` x ``cols`` grid of the
    default group's ranks: ``"row"`` the ranks sharing its column (along
    the row axis), ``"col"`` those sharing its row.  Every rank must call
    it, for the same grids in the same order."""
    key = (rows, cols)
    if key not in _grids:
        me = dist.get_rank()
        mine = {}
        for c in range(cols):
            g = dist.new_group([r * cols + c for r in range(rows)])
            if me % cols == c:
                mine["row"] = g
        for r in range(rows):
            g = dist.new_group([r * cols + c for c in range(cols)])
            if me // cols == r:
                mine["col"] = g
        _grids[key] = mine
    return _grids[key]


class CommsSession:
    """Session wiring a process group + axis to worker handles
    (reference: raft_dask/common/comms.py:37 ``Comms``).  ``group`` is a
    group of the initialised default group (None: the default group
    itself); ``device`` is this rank's (see :func:`rank_device`)."""

    def __init__(self, group=None, axis_name: str = "data", device=None,
                 *, axes: Optional[Dict[str, object]] = None) -> None:
        expects(dist.is_available() and dist.is_initialized(),
                "CommsSession: torch.distributed is not initialised (the "
                "launcher calls init_process_group first)")
        self.axis_name = axis_name
        self.axes = dict(axes) if axes is not None else {axis_name: group}
        expects(axis_name in self.axes,
                f"axis '{axis_name}' not in the session's grid "
                f"{sorted(self.axes)}")
        self.device = rank_device(device)
        self.session_id = uuid.uuid4().hex
        self._initialized = False

    @property
    def nccl_initialized(self) -> bool:  # API-parity alias
        return self._initialized

    @property
    def backend(self) -> str:
        return dist.get_backend(self.axes[self.axis_name])

    def init(self) -> "CommsSession":
        """Register the session (reference: Comms.init :170); the
        rendezvous is the launcher's ``init_process_group``."""
        _sessions[self.session_id] = self
        self._initialized = True
        return self

    def comms(self) -> Comms:
        return Comms(self.axis_name, self.axes[self.axis_name], self.device,
                     self.axes)

    def worker_handle(self, seed: int = 0) -> DeviceResources:
        """A handle on this rank's device with comms injected (reference:
        _func_build_handle :517 + inject_comms_on_handle)."""
        handle = DeviceResources(seed=seed, device=self.device)
        inject_comms_on_handle(handle, self.comms())
        return handle

    def destroy(self) -> None:
        """Tear down (reference: Comms.destroy); the process group stays
        the launcher's."""
        _sessions.pop(self.session_id, None)
        self._initialized = False


def make_2d_session(rows: int, cols: int, device=None,
                    axis_name: str = "row") -> CommsSession:
    """Session over a row-major ``rows`` x ``cols`` grid of the default
    group's ranks (reference: core/resource/sub_comms.hpp; comm_split
    core/comms.hpp:272).  ``comms().comm_split(grouped_by="row"|"col")``
    then yields the row / col communicators, as on the JAX package's
    ("row", "col") mesh.  Every rank calls it."""
    n = dist.get_world_size()
    expects(n == rows * cols,
            f"make_2d_session: the grid needs {rows * cols} ranks, the "
            f"group has {n}")
    return CommsSession(axis_name=axis_name, device=device,
                        axes=grid_groups(rows, cols))


def local_handle(session_id: str, seed: int = 0) -> DeviceResources:
    """A handle bound to a registered session (reference:
    raft_dask/common/comms.py:245 ``local_handle``)."""
    expects(session_id in _sessions, f"no comms session '{session_id}'")
    return _sessions[session_id].worker_handle(seed=seed)

"""Resource handle (port of ``raft_tpu.core.resources.DeviceResources``).

Reference: ``raft::device_resources`` (core/device_resources.hpp:60).  The
JAX handle carries devices, a mesh and a PRNG key chain; the port's handle
carries an explicit :class:`torch.device` and one :class:`torch.Generator`
on that device, which replaces ``next_key()``: every random draw of an
algorithm takes the handle's generator, so a handle built from one seed
replays the same draws.  Torch's Philox stream is not JAX's threefry
stream, so builds from the two packages differ draw for draw (see
ROADMAP.md, "Faults found in the port").
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects


class DeviceResources:
    """Device + random generator handle.

    ``device`` defaults to ``"cuda"``: asking for the card where there is
    none raises :class:`~raft_tpu_torch.core.error.LogicError`.  Tests pass
    ``device="cpu"``, where every kernel wrapper runs its plain version.
    """

    def __init__(self, seed: int = 0, device="cuda") -> None:
        dev = torch.device(device)
        if dev.type == "cuda":
            expects(torch.cuda.is_available(),
                    "DeviceResources: device='cuda' requested but no CUDA "
                    "device is available (pass device='cpu')")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)

"""Resource handle (port of ``raft_tpu.core.resources``).

Reference: ``raft::resources`` (core/resources.hpp:46, the registry of
lazily created resources keyed by ``resource_type``) and
``raft::device_resources`` (core/device_resources.hpp:60).  The JAX handle
carries devices, a mesh and a PRNG key chain; the port's handle carries
an explicit :class:`torch.device` and one :class:`torch.Generator` on that
device, which replaces ``next_key()``: every random draw of an algorithm
takes the handle's generator, so a handle built from one seed replays the
same draws.  Torch's Philox stream is not JAX's threefry stream, so builds
from the two packages differ draw for draw (see ROADMAP.md, "Faults found
in the port").
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from raft_tpu_torch.core.error import expects


class resource_type:
    """Well-known resource slots (reference:
    core/resource/resource_types.hpp:29-45), the JAX package's names.  The
    port's :class:`DeviceResources` fills ``DEVICE`` and ``RNG`` (its
    generator)."""

    DEVICE = "device"
    DEVICES = "devices"
    MESH = "mesh"
    COMMUNICATOR = "communicator"
    SUB_COMMUNICATOR = "sub_communicator"
    RNG = "rng"
    WORKSPACE = "workspace"
    DEVICE_PROPERTIES = "device_properties"


class Resources:
    """Registry of lazily created resources (reference: ``class
    resources``, core/resources.hpp:46): factories are registered with
    :meth:`add_resource_factory` (:90) and called at the first
    :meth:`get_resource` (:109).  A copy shares the factories and creates
    its own resources."""

    def __init__(self, other: Optional["Resources"] = None) -> None:
        self._factories: Dict[str, Callable[[], Any]] = (
            dict(other._factories) if other is not None else {})
        self._resources: Dict[str, Any] = {}

    def add_resource_factory(self, rtype: str,
                             factory: Callable[[], Any]) -> None:
        self._factories[rtype] = factory
        self._resources.pop(rtype, None)

    def has_resource_factory(self, rtype: str) -> bool:
        return rtype in self._factories

    def get_resource(self, rtype: str) -> Any:
        if rtype not in self._resources:
            expects(rtype in self._factories,
                    f"no factory registered for resource '{rtype}'")
            self._resources[rtype] = self._factories[rtype]()
        return self._resources[rtype]


class DeviceResources(Resources):
    """Device + random generator handle.

    ``device`` defaults to ``"cuda"``: asking for the card where there is
    none raises :class:`~raft_tpu_torch.core.error.LogicError`.  Tests pass
    ``device="cpu"``, where every kernel wrapper runs its plain version.
    The registry holds the device and the generator under
    ``resource_type.DEVICE`` and ``resource_type.RNG``, and a communicator
    once one is injected (:meth:`set_comms`, as
    ``comms.inject_comms_on_handle`` does).
    """

    def __init__(self, seed: int = 0, device="cuda") -> None:
        super().__init__()
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
        self.add_resource_factory(resource_type.DEVICE, lambda: dev)
        generator = self.generator
        self.add_resource_factory(resource_type.RNG, lambda: generator)

    # -- comms (reference: device_resources.hpp get_comms :209) -------------
    def set_comms(self, comms: Any) -> None:
        """Inject a communicator (reference: comms/std_comms.hpp inject
        pattern)."""
        self.add_resource_factory(resource_type.COMMUNICATOR, lambda: comms)

    def get_comms(self) -> Any:
        return self.get_resource(resource_type.COMMUNICATOR)

    def comms_initialized(self) -> bool:
        return self.has_resource_factory(resource_type.COMMUNICATOR)

    def set_sub_comms(self, key: str, comms: Any) -> None:
        """Register a sub-communicator by key (reference: sub_comms.hpp)."""
        subs = self._resources.setdefault(resource_type.SUB_COMMUNICATOR, {})
        subs[key] = comms

    def get_sub_comms(self, key: str) -> Any:
        subs = self._resources.get(resource_type.SUB_COMMUNICATOR, {})
        expects(key in subs, f"no sub-communicator '{key}'")
        return subs[key]

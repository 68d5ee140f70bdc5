"""Checkpointed index builds: atomic stage persistence and resume (port of
``raft_tpu.resilience.checkpoint``).

Builds persist each stage's carry (k-means centers, codebooks, the kNN
graph, the pruned graph) at their ``interruptible.synchronize`` points
through a :class:`CheckpointManager`; ``build(..., checkpoint=dir,
resume=True)`` then restarts from the last completed stage.

File layout, the JAX package's, so a stage file written by either package
reads in the other::

    <dir>/MANIFEST.json      # {"stages": [name, ...]} in completion order
    <dir>/<stage>.ckpt       # one CRC32 envelope (core/serialize) wrapping
                             # count + (name, array) records

Atomicity: every file is written to ``<name>.tmp.<pid>``, flushed,
``fsync``'d and ``os.replace``'d into place, then the directory entry is
fsync'd, so a crash mid-save leaves the old file or the new one, never a
torn one.  The MANIFEST is rewritten (same protocol) only after its stage
file landed.  A torn or bit-flipped stage file raises
:class:`~raft_tpu_torch.core.serialize.CorruptIndexError` at load.

The port's builds draw from the handle's ``torch.Generator``, where the
JAX package burns key draws for the stages it skips; so a port build
runs each stage through :func:`run_stage`, which saves the generator's
state with the stage (one more uint8 record) and restores it on resume,
keeping a resumed build's later draws those of an uninterrupted one.  A
stage file without that record (one the JAX package wrote) reads all the
same; the draws after it are then the handle's own.

Saves and loads are counted in the observability registry
(``resilience.checkpoint.save`` / ``.load``), as in the JAX package.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.resilience import faults


def _fsync_dir(path: str) -> None:
    # direntry durability (rename alone is atomic but not durable)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms / filesystems without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> None:
    """tmp + flush + fsync + rename: the file at ``path`` is either the
    previous version or all of ``data``, never a prefix."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class CheckpointManager:
    """Directory of atomically written, CRC-enveloped build stages."""

    _MANIFEST = "MANIFEST.json"

    def __init__(self, path: str) -> None:
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self._stages: List[str] = self._read_manifest()

    # -- manifest ----------------------------------------------------------
    def _read_manifest(self) -> List[str]:
        p = os.path.join(self.path, self._MANIFEST)
        if not os.path.exists(p):
            return []
        try:
            with open(p, "r") as f:
                doc = json.load(f)
            return list(doc.get("stages", []))
        except (OSError, ValueError):
            # a torn manifest (impossible given atomic_write): treat it as
            # empty rather than failing the resumed build
            return []

    def _write_manifest(self) -> None:
        doc = json.dumps({"stages": self._stages}).encode()
        atomic_write(os.path.join(self.path, self._MANIFEST), doc)

    @property
    def completed(self) -> List[str]:
        """Stage names in completion order."""
        return list(self._stages)

    def has(self, stage: str) -> bool:
        return stage in self._stages and os.path.exists(self._file(stage))

    def _file(self, stage: str) -> str:
        expects("/" not in stage and stage not in ("", ".", ".."),
                f"checkpoint: bad stage name {stage!r}")
        return os.path.join(self.path, f"{stage}.ckpt")

    # -- stage IO ----------------------------------------------------------
    def save(self, stage: str, arrays: Dict[str, object]) -> None:
        """Persist one stage's named arrays (numpy arrays or tensors)
        atomically; the stage enters the manifest only after its file is
        durable."""
        faults.maybe_fail("checkpoint.save")
        body = io.BytesIO()
        ser.serialize_scalar(None, body, np.int32(len(arrays)))
        for name, arr in arrays.items():
            ser.serialize_mdspan(None, body, np.asarray(name))
            ser.serialize_mdspan(None, body, arr)
        out = io.BytesIO()
        ser.write_envelope(out, body.getvalue())
        atomic_write(self._file(stage), out.getvalue())
        if stage in self._stages:
            self._stages.remove(stage)
        self._stages.append(stage)
        self._write_manifest()
        _count("resilience.checkpoint.save")

    def load(self, stage: str) -> Dict[str, np.ndarray]:
        """Restore one stage as numpy arrays; raises
        :class:`~raft_tpu_torch.core.serialize.CorruptIndexError` on a
        torn or bit-flipped file."""
        faults.maybe_fail("checkpoint.load")
        with open(self._file(stage), "rb") as f:
            payload = ser.read_envelope(f)
        body = io.BytesIO(payload)
        n = int(ser.deserialize_scalar(None, body))
        out: Dict[str, np.ndarray] = {}
        for _ in range(n):
            name = str(ser.deserialize_mdspan(None, body))
            out[name] = ser.deserialize_mdspan(None, body)
        _count("resilience.checkpoint.load")
        return out

    def clear(self) -> None:
        """Drop all stages (a completed build retires its checkpoints)."""
        for s in list(self._stages):
            try:
                os.remove(self._file(s))
            except OSError:
                pass
        self._stages = []
        self._write_manifest()


def as_manager(checkpoint: Optional[Union[str, CheckpointManager]]
               ) -> Optional[CheckpointManager]:
    """Builds accept a path or a manager; normalize (None passes
    through)."""
    if checkpoint is None or isinstance(checkpoint, CheckpointManager):
        return checkpoint
    return CheckpointManager(str(checkpoint))


# the extra record of a port build's stage: the generator's state after it
GENERATOR_STATE = "generator_state"


def _count(name: str) -> None:
    from raft_tpu_torch import observability as obs
    if obs.enabled():
        obs.registry().counter(name).inc()


def run_stage(ckpt: Optional[CheckpointManager], stage: str, resume: bool,
              generator: torch.Generator, device,
              compute: Callable[[], Dict[str, torch.Tensor]]
              ) -> Dict[str, torch.Tensor]:
    """One build stage: with ``resume`` and the stage in ``ckpt``, its
    arrays as tensors on ``device`` and ``generator`` set to the state
    saved with them (when the file has one); else ``compute()``, saved
    to ``ckpt`` (if any) with ``generator``'s state after it."""
    if resume and ckpt is not None and ckpt.has(stage):
        arrays = ckpt.load(stage)
        state = arrays.pop(GENERATOR_STATE, None)
        if state is not None:
            generator.set_state(torch.from_numpy(state.copy()))
        return {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for name, a in arrays.items()}
    arrays = compute()
    if ckpt is not None:
        ckpt.save(stage, {**arrays,
                          GENERATOR_STATE: generator.get_state().numpy()})
    return arrays

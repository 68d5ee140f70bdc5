"""Output auto-conversion (port of ``raft_tpu.core.outputs``).

Parity with ``pylibraft.common.outputs`` (``auto_convert_output``): the
port's public functions return ``torch.Tensor``s, converted to the type
configured in :mod:`raft_tpu_torch.config` — ``"torch"`` (the default:
returned as they are), ``"numpy"`` (a host copy), or a user callable
applied to each tensor.  The JAX package's native type, ``"jax"``, is not
offered: honouring it would mean importing jax.

Tuples, lists and NamedTuples of tensors are converted element-wise with
their container type preserved.
"""

from __future__ import annotations

import functools

import torch

import raft_tpu_torch.config


def convert_to_torch(t: torch.Tensor):
    """The port's native type: the tensor as it is."""
    return t


def convert_to_numpy(t: torch.Tensor):
    return t.detach().cpu().numpy()


def convert_output(t: torch.Tensor):
    """Apply the configured conversion to one tensor."""
    output_as = raft_tpu_torch.config.output_as_
    if callable(output_as):
        return output_as(t)
    if output_as == "torch":
        return convert_to_torch(t)
    if output_as == "numpy":
        return convert_to_numpy(t)
    raise ValueError(f"No valid type conversion found for {output_as!r}")


def _convert_value(value):
    if isinstance(value, torch.Tensor):
        return convert_output(value)
    if isinstance(value, tuple):
        converted = [_convert_value(v) for v in value]
        if hasattr(value, "_fields"):     # NamedTuple: rebuild by fields
            return type(value)(*converted)
        return tuple(converted)
    if isinstance(value, list):
        return [_convert_value(v) for v in value]
    return value


def auto_convert_output(f):
    """Decorator converting ``torch.Tensor`` returns (or containers of
    them) to the configured output type."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        return _convert_value(f(*args, **kwargs))

    return wrapper


def raw(f):
    """The undecorated implementation of an auto-converted public
    function: the library's own compositions stay in tensors whatever
    output type the user configured."""
    return getattr(f, "__wrapped__", f)

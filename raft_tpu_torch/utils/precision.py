"""Matmul precision policy (port of ``raft_tpu.utils.precision``).

The JAX package forces fp32 products to ``HIGHEST``.  On the card a float32
matmul runs in full fp32 unless ``torch.backends.cuda.matmul.allow_tf32``
is set, and a float32 convolution runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is cleared — TF32 keeps about three
decimal digits.  Every entry point of the port runs inside
:func:`highest`, which clears both flags for its duration and restores the
caller's settings afterwards.

The reference's global policy (``set_matmul_precision`` /
``get_matmul_precision`` / ``matmul_precision``) maps its names onto
torch's float32 matmul precision (``torch.set_float32_matmul_precision``,
which sets ``torch.backends.cuda.matmul.allow_tf32``): "highest" and
"float32" -> "highest" (fp32), "high" -> "high" (TF32), "default" and
"bfloat16" -> "medium" (bf16).  It governs the caller's own float32
products outside the entry points; an unknown name raises ``KeyError``,
as in the reference.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_NAMES = {
    "default": "medium",
    "high": "high",
    "highest": "highest",
    "bfloat16": "medium",
    "float32": "highest",
}

_current = "highest"


def _apply(level: str) -> None:
    global _current
    torch.set_float32_matmul_precision(level)
    _current = level


def set_matmul_precision(name: str) -> None:
    """Set torch's global float32 matmul precision by the reference's
    name."""
    _apply(_NAMES[name])


def get_matmul_precision() -> str:
    """The precision last set through this module (torch's name)."""
    return _current


@contextlib.contextmanager
def matmul_precision(name: str) -> Iterator[None]:
    """Scoped :func:`set_matmul_precision`; the previous setting is
    restored on exit."""
    prev = _current
    set_matmul_precision(name)
    try:
        yield
    finally:
        _apply(prev)


@contextlib.contextmanager
def highest() -> Iterator[None]:
    """fp32 products in full fp32 (TF32 off) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev

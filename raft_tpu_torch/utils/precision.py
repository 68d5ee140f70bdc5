"""Matmul precision policy (port of ``raft_tpu.utils.precision``).

The JAX package forces fp32 products to ``HIGHEST``.  On the card a float32
matmul runs in full fp32 unless ``torch.backends.cuda.matmul.allow_tf32``
is set, and a float32 convolution runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is cleared — TF32 keeps about three
decimal digits.  Every entry point of the port runs inside
:func:`highest`, which clears both flags for its duration and restores the
caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


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

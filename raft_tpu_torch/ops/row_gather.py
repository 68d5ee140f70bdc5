"""Kernel J: random row gather, ``out[i] = table[ids[i]]``.

Replaces ``profiles/gather_bench.py:70 pallas_gather`` (the TPU's per-row
DMA gather; the JAX yardstick is ``jnp.take``).  The CUDA kernel is
``csrc/row_gather.cu``; its source note says what bounds it on an H100
(bytes) and what the design does about it.
``raft_tpu_torch.profiles.gather_bench`` times it against
``torch.index_select``.

:func:`row_gather` launches the kernel for CUDA tensors and runs
:func:`row_gather_plain` for CPU tensors — nothing else picks between
them, and a failed build or launch raises.  ``row_gather.launches``
counts kernel launches.

Contract: ``table`` (N, D) float32 or bfloat16 with ``D`` elements a
multiple of 16 bytes, ``ids`` (M,) int32 in ``[0, N)`` — not checked, as
the TPU kernel does not check them; out-of-range ids are undefined
behaviour on the card.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda

DEFAULT_ROWS = 512               # output rows a block, as pallas_gather's


def _check(table, ids, rows: int):
    expects(table.ndim == 2 and ids.ndim == 1,
            "row_gather: table (N, D) and ids (M,) required")
    expects(table.dtype in (torch.float32, torch.bfloat16)
            and ids.dtype == torch.int32,
            "row_gather: float32 / bfloat16 table and int32 ids required")
    expects(table.device == ids.device,
            "row_gather: tensors on different devices")
    expects(rows >= 1, "row_gather: rows must be >= 1")


def row_gather_plain(table, ids, rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """Plain PyTorch version: ``table.index_select(0, ids)`` (``rows`` is
    the kernel's launch parameter and changes nothing here)."""
    _check(table, ids, rows)
    return table.index_select(0, ids)


def row_gather(table, ids, rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """``(M, D)`` rows of ``table`` at ``ids``, bit for bit.  ``rows``:
    output rows a block.  CUDA tensors launch Kernel J; CPU tensors run
    the plain version."""
    if not table.is_cuda:
        return row_gather_plain(table, ids, rows)
    _check(table, ids, rows)
    row_bytes = table.shape[1] * table.element_size()
    expects(row_bytes % 16 == 0,
            f"row_gather: rows of {row_bytes} bytes must be a multiple of "
            f"16 (16-byte loads)")
    expects(table.shape[0] < 2 ** 31 and ids.shape[0] < 2 ** 31,
            "row_gather: N and M must fit an int32")
    table = table.contiguous()
    ids = ids.contiguous()
    out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    expects(table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
            "row_gather: table must be 16-byte aligned")
    status = _cuda.library().raft_row_gather(
        table.data_ptr(), ids.data_ptr(), ids.shape[0], row_bytes, rows,
        out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream)
    _cuda.check(status, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0

"""Random row gather from a (1M, 128) table (port of
``profiles/gather_bench.py``, whose ``pallas_gather`` :70 is the Pallas
kernel Kernel J replaces).

CAGRA's walk gathers scattered dataset rows every hop; this times
``torch.index_select`` (the counterpart of the JAX script's ``jnp.take``)
and Kernel J (:func:`raft_tpu_torch.ops.row_gather.row_gather`) at 1,024
and 2,048 rows a block, in f32 and bf16: M = 5,000 × 64 = 320,000 random
int32 ids.  Each line: ``impl``, ``dtype``, ``rows``, ``ms`` (CUDA events
over the gather alone — the JAX script's scalar sum only forced a TPU
readback) and ``gb_per_s`` (gathered bytes over time, as the JAX script
counts them); then ``match:`` — Kernel J and ``index_select`` bit-equal
on 4,096 ids.

    python3 -m raft_tpu_torch.profiles.gather_bench
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops.row_gather import row_gather
from raft_tpu_torch.profiles import device_ms, require_cuda

N, D = 1_000_000, 128
M = 5_000 * 64          # rows one search iteration gathers (q * w * degree)
ROWS = (1024, 2048)


def inputs(n: int = N, d: int = D, m: int = M, seed: int = 0,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's table and ids: numpy seed ``seed``, a normal (n,
    d) f32 table, then m ids in [0, n)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, n, size=m).astype(np.int32))
    return table.to(device), ids.to(device)


def run(table, ids, rows=ROWS, reps: int = 20) -> Tuple[List[Dict], bool]:
    """Time ``index_select`` and Kernel J on ``table`` (f32, then bf16) at
    ``ids``; returns the lines and the ``match`` check.  ``ms`` is None off
    the card."""
    dev = table.device
    lines = []
    for name, t in (("f32", table), ("bf16", table.to(torch.bfloat16))):
        nbytes = ids.shape[0] * t.shape[1] * t.element_size()
        for impl, r in [("index_select", None)] + [("row_gather", r)
                                                    for r in rows]:
            if r is None:
                ms = device_ms(lambda: t.index_select(0, ids), reps, dev)
            else:
                ms = device_ms(lambda: row_gather(t, ids, r), reps, dev)
            lines.append({"impl": impl, "dtype": name, "rows": r, "ms": ms,
                          "gb_per_s": None if ms is None
                          else nbytes / (ms * 1e-3) / 1e9})
    head = ids[:4096]
    match = torch.equal(row_gather(table, head, rows[0]),
                        table.index_select(0, head))
    return lines, match


def profile(n: int = N, d: int = D, m: int = M, rows=ROWS, reps: int = 20,
            device="cuda") -> Tuple[List[Dict], bool]:
    """The whole profile at explicit sizes; lines printed as JSON."""
    table, ids = inputs(n, d, m, device=device)
    lines, match = run(table, ids, rows, reps)
    for line in lines:
        print(json.dumps(line), flush=True)
    print("match:", match, flush=True)
    return lines, match


def main() -> None:
    profile(device=require_cuda())


if __name__ == "__main__":
    main()

"""Kernel A's pass cut into its parts (port of
``profiles/kmeans_decomp_r5.py``, whose ``run`` :67 is the Pallas kernel
these Kernel A variants replace).

Cumulative cuts (:func:`raft_tpu_torch.ops.kmeans_update.kmeans_pass_cut`)
at 1M × 128 → 1,024 on normal data (numpy seed 0):

- ``mm``: the bf16 distance product alone (``dmin = d[:, 0]``);
- ``mmmin``: + the row min;
- ``mmargmin``: + the argmin labels;
- ``full``: + the epilogue sums and counts (``kmeans_kernel_r5``'s
  ``uw``).

Beside ``mm``, the yardstick: one bf16 ``torch.matmul(x, c.T)`` of the
same product (a library call, used nowhere in the port), which writes the
(n, k) matrix the cuts never write.  The JAX script sweeps its tile
(2,048 / 4,096 rows), a VMEM knob with no counterpart here: every cut
runs on ``nn_tile_mma.cuh``'s tensor-core tile, 256 rows (four
warpgroups) × 128 centroids at this size, and each line says so.  One
JSON line per cut: ``variant``, ``tile``, ``ms``; then the yardstick's.

    python3 -m raft_tpu_torch.profiles.kmeans_decomp_r5
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops.kmeans_update import kmeans_pass_cut
from raft_tpu_torch.profiles import device_ms, require_cuda

N, DIM, K = 1_000_000, 128, 1024
CUTS = ("mm", "mmmin", "mmargmin", "full")
TILE = "256x128"        # nn_tile_mma.cuh's rows x centroids at 1M rows


def inputs(n: int = N, dim: int = DIM, k: int = K, seed: int = 0,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's data: numpy seed ``seed``, normal (n, dim) rows,
    then normal (k, dim) centroids, f32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(k, dim)).astype(np.float32))
    return x.to(device), c.to(device)


def run(x, c, cuts=CUTS, reps: int = 10) -> List[Dict]:
    """Time each cut on bf16 rows (rounded once, outside the timing) and
    the bf16 ``torch.matmul`` yardstick; ``ms`` is None off the card."""
    xb = x.to(torch.bfloat16)
    dev = x.device
    lines = [{"variant": cut, "tile": TILE,
              "ms": device_ms(lambda: kmeans_pass_cut(xb, c, cut), reps,
                              dev)} for cut in cuts]
    cb = c.to(torch.bfloat16)
    lines.append({"yardstick": "torch.matmul(bf16 x, bf16 c.T)",
                  "ms": device_ms(lambda: torch.matmul(xb, cb.T), reps,
                                  dev)})
    return lines


def profile(n: int = N, dim: int = DIM, k: int = K, reps: int = 10,
            device="cuda") -> List[Dict]:
    """The whole profile at explicit sizes; lines printed as JSON."""
    x, c = inputs(n, dim, k, device=device)
    lines = run(x, c, reps=reps)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def main() -> None:
    profile(device=require_cuda())


if __name__ == "__main__":
    main()

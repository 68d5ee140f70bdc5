"""Kernel A and two of its variants (port of
``profiles/kmeans_kernel_r5.py``, whose ``run_variant`` :77 is the Pallas
kernel the variants replace):

- ``base``: Kernel A as the Lloyd loop runs it
  (:func:`raft_tpu_torch.ops.kmeans_update.kmeans_assign_update`, unit
  weights);
- ``uw``: the uniform-weight pass — no weight read or multiply, counts
  are row counts;
- ``mxuonly``: the product plus the row min, and each column's sum of the
  distances (what the JAX variant writes to ``counts`` to keep its
  product live).

At 1M × 128 → 1,024 on normal data (numpy seed 0), one JSON line per
variant (``variant``, ``tile``, ``ms``), then the JAX script's spot check
of ``uw`` against ``base`` on the first 65,536 rows: ``uw_sums_close``
(rtol 1e-3, atol 1e-2), ``uw_counts_equal``, ``uw_dmin_close``.  The JAX
script sweeps tiles (512 to 2,048 rows), a VMEM knob with no counterpart
here: ``nn_tile_mma.cuh``'s 256 × 128 tensor-core tile, printed in each
line.

    python3 -m raft_tpu_torch.profiles.kmeans_kernel_r5
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import torch

from raft_tpu_torch.ops.kmeans_update import (kmeans_assign_update,
                                              kmeans_pass_cut)
from raft_tpu_torch.profiles import device_ms, require_cuda
from raft_tpu_torch.profiles.kmeans_decomp_r5 import DIM, K, N, TILE, inputs

SPOT_ROWS = 65_536


def run(x, c, reps: int = 10) -> Tuple[List[Dict], Dict]:
    """Time ``base``, ``uw`` and ``mxuonly`` on bf16 rows (rounded once,
    outside the timing), then the spot check; ``ms`` is None off the
    card."""
    xb = x.to(torch.bfloat16)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    dev = x.device
    lines = [{"variant": "base", "tile": TILE, "ms": device_ms(
        lambda: kmeans_assign_update(xb, ones, c), reps, dev)}]
    lines += [{"variant": cut, "tile": TILE, "ms": device_ms(
        lambda: kmeans_pass_cut(xb, c, cut), reps, dev)}
        for cut in ("uw", "mxuonly")]
    head = xb[:SPOT_ROWS]
    s0, c0, d0 = kmeans_assign_update(head, ones[:head.shape[0]], c)
    s1, c1, d1, _ = kmeans_pass_cut(head, c, "uw")
    spot = {"uw_sums_close": torch.allclose(s0, s1, rtol=1e-3, atol=1e-2),
            "uw_counts_equal": torch.equal(c0, c1),
            "uw_dmin_close": torch.allclose(d0, d1, rtol=1e-3, atol=1e-2)}
    return lines, spot


def profile(n: int = N, dim: int = DIM, k: int = K, reps: int = 10,
            device="cuda") -> Tuple[List[Dict], Dict]:
    """The whole profile at explicit sizes; lines printed as JSON."""
    x, c = inputs(n, dim, k, device=device)
    lines, spot = run(x, c, reps)
    for line in lines + [spot]:
        print(json.dumps(line), flush=True)
    return lines, spot


def main() -> None:
    profile(device=require_cuda())


if __name__ == "__main__":
    main()

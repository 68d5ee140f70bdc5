"""Kernel I's walk with the steps of a hop cut off one at a time: where a
hop's time goes.  A profile of the port's own design
(``csrc/cagra_walk.cu`` over ``csrc/hop_merge.cuh``), with no JAX script
behind it.

Each variant is ``csrc/cagra_walk.cu`` rebuilt with its ``kHopSteps``
lowered (:data:`VARIANTS`) under ``build/raft_tpu_torch/cagra_walk_decomp/``,
all loaded in one process; a hop runs its first steps only:

- ``parents``: the parent selection (and the all-visited exit);
- ``+ ids and rows``: the candidates' ids and the parents' rows loaded
  (fat rows staged; the exact-row source's rows as it reads them);
- ``+ keys``: the candidates scored;
- ``+ dedupe``: duplicates killed;
- ``+ rank``: the candidates placed in the merge network;
- ``+ merge`` (as built): the bitonic merge, the walk that searches run.

All but ``+ merge`` compute wrong walks by design, and walk other hop
counts (without a merge the buffer never changes, so a walk visits its
first slots and stops): each line has the hops its walk ran, so a step's
cost a hop is the difference of two lines' ms over hops.  The shapes
(:data:`SHAPES`, the data of ``cagra_walk_turns.py`` from the same seed):
the walks past 256 (1,000 queries at itopk 512 width 1 and itopk 256
width 16), the search batch (5,000 queries, itopk 64, width 2), and the
direct walk's exact rows (5,000 queries, itopk 64, width 2, dim 128), on
1M random rows and random degree-32 graphs.  One JSON line per (shape,
variant): CUDA-event ms, hops (sum and most a query), and block size and
resident blocks per SM.  The card only::

    python3 -m raft_tpu_torch.profiles.cagra_walk_decomp
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, Tuple

import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.profiles import device_ms, list_scan_decomp, require_cuda

SOURCES = ("cagra_walk.cu",)
_STEPS = "constexpr int kHopSteps = 6;"
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "parents": ((_STEPS, "constexpr int kHopSteps = 1;"),),
    "+ ids and rows": ((_STEPS, "constexpr int kHopSteps = 2;"),),
    "+ keys": ((_STEPS, "constexpr int kHopSteps = 3;"),),
    "+ dedupe": ((_STEPS, "constexpr int kHopSteps = 4;"),),
    "+ rank": ((_STEPS, "constexpr int kHopSteps = 5;"),),
    "+ merge": (),
}
# label: (nq, itopk, width, deg, exact)
SHAPES = {"wide512": (1000, 512, 1, 32, False),
          "wide256": (1000, 256, 16, 32, False),
          "search": (5000, 64, 2, 32, False),
          "exact_1m": (5000, 64, 2, 32, True)}
ENTRIES = ("raft_cagra_walk", "raft_cagra_walk_exact")


class _Library:
    """The kernel library with one variant's walk entry points in place of
    the built ones (everything else from :func:`_cuda.library`)."""

    def __init__(self, variant: ctypes.CDLL):
        self.variant = variant

    def __getattr__(self, name):
        return getattr(self.variant if name in ENTRIES
                       else _cuda.library(), name)


def build(names=tuple(VARIANTS)) -> Dict[str, _Library]:
    """Each variant's library (its walk entry points), built in parallel."""
    list_scan_decomp.build_variants(names, VARIANTS, SOURCES,
                                    ENTRIES[0], "cagra_walk_decomp")
    libs = {}
    for i, name in enumerate(names):
        so = (_cuda.BUILD_DIR / "cagra_walk_decomp" / f"v{i}"
              / "libvariant.so")
        lib = ctypes.CDLL(str(so))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _cuda.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = _Library(lib)
    return libs


def run(libs, device, reps: int = 10):
    """Time each variant's walk at each of :data:`SHAPES`."""
    from raft_tpu_torch.ops import cagra_walk as cw
    from raft_tpu_torch.profiles.cagra_walk_turns import (DIM, N, exact_args,
                                                          walk_args)

    g = torch.Generator(device=device)
    g.manual_seed(22)
    x = torch.randn(N, DIM, generator=g, device=device)
    _cuda.library()
    lines = []
    for label, (nq, itopk, width, deg, exact) in SHAPES.items():
        if exact:
            args, kw = exact_args(g, device, x, nq, itopk, width, deg)
            fn, pdim = cw.cagra_walk_exact, DIM
        else:
            args, kw = walk_args(g, device, x, nq, itopk, width, deg)
            fn, pdim = cw.cagra_walk, args[0].shape[1]
        threads, blocks = cw.walk_resident(itopk, width, deg, pdim,
                                           exact=exact)
        for variant, lib in libs.items():
            built, _cuda._lib = _cuda._lib, lib
            try:
                hops = fn(*args, return_hops=True, **kw)[3]
                ms = device_ms(lambda: fn(*args, **kw), reps, device)
            finally:
                _cuda._lib = built
            lines.append({"shape": label, "variant": variant,
                          "nq": nq, "itopk": itopk, "width": width,
                          "deg": deg, "ms": ms,
                          "hops": [int(hops.sum()), int(hops.max())],
                          "threads": threads, "resident_blocks": blocks})
        del args
    return lines


def main() -> None:
    device = require_cuda()
    for line in run(build(), device):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

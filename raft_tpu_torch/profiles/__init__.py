"""Kernel-decomposition profiles of the port, one module for each of the
JAX package's round-5 profile scripts that runs a Pallas kernel:

- :mod:`.group_kernel_decomp_r5` (``profiles/group_kernel_decomp_r5.py``):
  Kernel F's scan split from its query gather and its top-kt selection;
- :mod:`.gather_bench` (``profiles/gather_bench.py``): Kernel J, the
  random row gather, against ``torch.index_select``;
- :mod:`.kmeans_decomp_r5` (``profiles/kmeans_decomp_r5.py``): Kernel A's
  pass cut into product, row min, argmin and epilogue;
- :mod:`.kmeans_kernel_r5` (``profiles/kmeans_kernel_r5.py``): Kernel A,
  its unit-weight pass and its product-plus-min cut.

and one of the port's own design, with no JAX script behind it:

- :mod:`.kmeans_tile_decomp`: Kernel A's tensor-core tile rebuilt with one
  part taken out at a time (the products, the centroid reloads, the
  256-row blocks);
- :mod:`.list_scan_decomp`: Kernels B and G's list-major pass 1 rebuilt
  with one part taken out at a time (the top-kt insertions, the fold, the
  epilogue, the products) and with other row counts in its fold.
- :mod:`.flat_scan_decomp`: Kernel F's list-major pass rebuilt likewise
  (and with one TF32 product for 3xTF32's three).
- :mod:`.pair_list_decomp`: Kernels F and G's pair-group pass (their
  route past kt 64) rebuilt with one part taken out at a time (the keep's
  merges, the keep, the epilogue, the products) and with its merge in
  shared memory;
- :mod:`.code_scan_decomp`: Kernels C and D's list-major pass over the
  PQ codes with its decode run after the products or taken out, beside
  Kernel G's pass 1 over the recon cache;
- :mod:`.cagra_walk_decomp`: Kernel I's walk with the steps of a hop cut
  off one at a time (parents; + ids and rows; + keys; + dedupe; + rank;
  + merge) at the walks past 256, the search batch and the direct walk's
  exact rows, with the hops each cut walk ran and the resident blocks;
- :mod:`.pair_cut_ties`: how often a tie at a pair's top-kt cut leaves
  Kernel C's merged rows and its plain version's with different ids and
  no equal distance beside them (a count, not a time);
- ``flagship_turns.py`` (run by path, with a checkout's root): the
  unfiltered flagship batch and Kernel B's pass 1 of that checkout, for
  parent and change in turns on one card; ``query_major_turns.py`` and
  ``cagra_walk_turns.py`` likewise for B-G's query-major kernels and for
  Kernel I's walk and hop kernels at chip_smoke's shapes;
  ``pair_list_turns.py`` (run by path from the root): F, G, D and E's
  pair-group pass at each group size beside the query-major kernel it
  replaced, in turns, and (``fused``) B and C's route, the pass then
  ``merge_pairs``, beside theirs, with pass 2 beside ``torch.topk``;
  ``cagra_deep_witness.py`` (run by path from a checkout's root): the
  CAGRA deep regime's intermediate graph recall stage by stage, at 1M
  rows against the default regime and at 10M under three walk-table
  plans.

Each runs on the card as ``python3 -m raft_tpu_torch.profiles.<name>``
and prints one JSON line per measurement.  Each of the four ports also has
a function with explicit sizes and a device; on the CPU it runs the plain
versions and reports no time (``"ms": null``): a CPU run measures no
device time.  ``kmeans_tile_decomp``, ``list_scan_decomp``,
``flat_scan_decomp``, ``code_scan_decomp``, ``pair_list_decomp`` and
``cagra_walk_decomp`` build kernel variants and run on the card only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def device_ms(fn: Callable[[], object], reps: int,
              device) -> Optional[float]:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events on ``device``; None for a CPU device, after one
    call."""
    fn()
    if torch.device(device).type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def require_cuda() -> torch.device:
    """The card, or an error: a profile measures device time only."""
    if not torch.cuda.is_available():
        raise SystemExit("this profile needs a CUDA device")
    return torch.device("cuda", 0)

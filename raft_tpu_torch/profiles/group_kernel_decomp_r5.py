"""Kernel F's per-pair scan, decomposed (port of
``profiles/group_kernel_decomp_r5.py``, whose ``run_var`` :50 is the
Pallas kernel this times the counterpart of).

The JAX script splits its grouped scan's flat per-group cost into the
one-hot query gather and the in-VMEM top-kt extraction.  The port's scan
is Kernels F and G's pair-group pass (``csrc/pair_list_scan.cu``: the
pairs grouped by list, a list read once per group), so its four variants
(:func:`raft_tpu_torch.ops.pair_scan.pair_scan_variant`, grouping
included) are:

- ``gather`` True: the kernel reads ``queries[pair // n_probes]``, as
  Kernel F does; False: each pair's query from a pre-gathered
  ``(nq · n_probes, dim)`` tensor (built by one ``index_select``, timed
  on its own as the JAX script times ``xla_query_gather_ms``);
- ``extract`` True: each pair's top kt (Kernel F); False: the raw
  ``(nq, n_probes, cap)`` distances, no selection.

Lists are scanned one by one (super-tile factor 1), as the JAX script
scans ``index.list_data``.  One JSON line per variant: ``nlist``,
``n_pairs``, ``gather``, ``extract``, ``ms`` and ``us_per_pair`` (the
JAX script has ``us_per_group`` over its groups of 128; the port's groups
hold up to 64 pairs, so a time per pair compares), then
``query_gather_ms``.

    python3 -m raft_tpu_torch.profiles.group_kernel_decomp_r5
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from raft_tpu_torch import DeviceResources
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.ops.pair_scan import pair_scan_variant
from raft_tpu_torch.profiles import device_ms, require_cuda

KT = 10
# (n_lists, n_probes) of the JAX script
CONFIGS = ((16384, 256), (4096, 128))
VARIANTS = ((True, True), (True, False), (False, True), (False, False))


def sift_like(n: int, n_queries: int, dim: int, latent: int = 16,
              noise: float = 0.05, seed: int = 0, device="cuda"):
    """The JAX script's data (bench.py's generator): a ``latent``-d draw
    mapped to ``dim`` plus ``noise``, numpy seed ``seed``; the database
    rows, then the queries."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n + n_queries, latent)).astype(np.float32)
    a = rng.normal(size=(latent, dim)).astype(np.float32) / np.sqrt(latent)
    x = (z @ a + noise * rng.normal(size=(n + n_queries, dim))).astype(
        np.float32)
    x = torch.from_numpy(x).to(device)
    return x[:n], x[n:]


def scan_inputs(index, queries, n_probes: int):
    """What every variant scans: the queries' exact ``n_probes``
    nearest lists and the lists as they are (F = 1)."""
    probes = ivf_flat._select_clusters(index.centers, queries, n_probes,
                                       index.metric)
    if index.list_data_sq is None:
        index.list_data_sq = ivf_flat._row_norms(index.list_data)
    return (probes, index.list_data, index.list_data_sq,
            index.list_indices)


def pregather(queries, n_probes: int):
    """The ``(nq · n_probes, dim)`` pre-gathered queries, pair-major: one
    ``index_select`` of each pair's query."""
    pair_q = torch.arange(queries.shape[0] * n_probes,
                          device=queries.device) // n_probes
    return queries.index_select(0, pair_q)


def run_on_index(index, queries, n_probes: int, kt: int = KT,
                 reps: int = 5) -> List[Dict]:
    """Time the four variants on ``index`` at ``n_probes``: one dict per
    variant, then the pre-gather's time.  ``ms`` is None off the card."""
    probes, data, dsq, ids = scan_inputs(index, queries, n_probes)
    dev = queries.device
    qg = pregather(queries, n_probes)
    n_pairs = probes.numel()
    lines = []
    for gather, extract in VARIANTS:
        q_in = queries if gather else qg
        ms = device_ms(lambda: pair_scan_variant(
            q_in, probes, data, dsq, ids, kt, gather=gather,
            extract=extract), reps, dev)
        lines.append({"nlist": index.n_lists, "n_pairs": n_pairs,
                      "gather": gather, "extract": extract, "ms": ms,
                      "us_per_pair": None if ms is None
                      else ms * 1e3 / n_pairs})
    lines.append({"nlist": index.n_lists, "query_gather_ms": device_ms(
        lambda: pregather(queries, n_probes), reps, dev)})
    return lines


def decompose(n: int, dim: int, n_queries: int, configs=CONFIGS,
              kt: int = KT, reps: int = 5, device="cuda") -> List[Dict]:
    """The whole profile at explicit sizes: data, one IVF-Flat build per
    ``(n_lists, n_probes)`` of ``configs``, the four variants on each;
    every line printed as JSON and returned."""
    db, queries = sift_like(n, n_queries, dim, device=device)
    res = DeviceResources(seed=0, device=device)
    lines = []
    for n_lists, n_probes in configs:
        index = ivf_flat.build(res, ivf_flat.IndexParams(n_lists=n_lists),
                               db)
        for line in run_on_index(index, queries, n_probes, kt, reps):
            print(json.dumps(line), flush=True)
            lines.append(line)
        del index
    return lines


def main() -> None:
    decompose(1_000_000, 128, 5000, device=require_cuda())


if __name__ == "__main__":
    main()

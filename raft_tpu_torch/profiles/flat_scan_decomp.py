"""Kernel F's list-major pass with one part taken out at a time: where its
time goes.  A profile of the port's own design
(``csrc/flat_list_scan.cu``), with no JAX script behind it.

Each variant is ``csrc/flat_list_scan.cu`` rebuilt with text
substitutions (:data:`VARIANTS`) in it and in the fold it includes
(``csrc/list_fold.cuh``) under ``build/raft_tpu_torch/flat_scan_decomp/``,
all loaded in one process:

- ``as built``: the pass as ``ivf_flat.search`` runs it;
- ``1 product``: hi·hi alone, one TF32 product for 3xTF32's three;
- ``no insertions``: each pair row's candidates filtered against its
  kt-th value, but none inserted;
- ``no fold``: the distances written to shared memory, no top-kt fold;
- ``no epilogue``: the row windows loaded, split and multiplied, no
  distances;
- ``no products``: the row windows loaded and split only;
- ``4 rows at once``: the fold with 4 pair rows side by side in a warp,
  as Kernels B and G fold (as built: 8).

All but ``as built`` and the row count compute wrong results by design:
only their time is kept.  On the IVF-Flat indexes the port builds at
chip_smoke's two configurations (1,000,000 × 128 rows of ``bench.py``'s
SIFT-like generator, numpy seed 0; ``n_lists`` 4096 searched at 64
probes, 16384 at 128), 5,000 queries at k 10 grouped once per index, one
JSON line per (index, variant): the CUDA-event ms of one pass launch and
the group count.

    python3 -m raft_tpu_torch.profiles.flat_scan_decomp
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.profiles import device_ms, list_scan_decomp, require_cuda

SCAN_SOURCES = ("flat_list_scan.cu", "list_fold.cuh")
_EPILOGUE = "    if (qc != nchunks - 1) continue;"
_PRODUCTS = ("      wgmma_m64n128k8_tf32(acc, dal, dbh, (qc == 0 && ks == 0)"
             " ? 0 : 1);\n"
             "      wgmma_m64n128k8_tf32(acc, dah, dbl, 1);\n"
             "      wgmma_m64n128k8_tf32(acc, dah, dbh, 1);")
_ROWS = "constexpr int kRowsAtOnce = 8;"
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "as built": (),
    "1 product": ((_PRODUCTS, "      wgmma_m64n128k8_tf32(acc, dah, dbh, "
                   "(qc == 0 && ks == 0) ? 0 : 1);\n"
                   "      (void)dal, (void)dbl;"),),
    "no insertions": (("      while (any) {",
                       "      while (false && any) {"),),
    "no fold": ((list_scan_decomp.FOLD, ""),),
    "no epilogue": ((_EPILOGUE, "    continue;"),),
    "no products": ((_EPILOGUE, "    continue;"),
                    (_PRODUCTS, "      (void)dal, (void)dah, (void)dbh, "
                     "(void)dbl;")),
    "4 rows at once": ((_ROWS, "constexpr int kRowsAtOnce = 4;"),),
}
# (n_lists, n_probes): chip_smoke's raft_ivf_flat.nlist4096 / .nlist16384
INDEXES = ((4096, 64), (16384, 128))
N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 5_000, 10


def variant_sources(name: str) -> Dict[str, str]:
    """:data:`SCAN_SOURCES` by file name, with variant ``name``'s
    substitutions; each must match exactly once in all of them."""
    return list_scan_decomp.variant_sources(name, VARIANTS, SCAN_SOURCES)


def build(names=tuple(VARIANTS)):
    """Each variant's entry point, ``raft_ivf_flat_list_scan``."""
    return list_scan_decomp.build_variants(
        names, VARIANTS, SCAN_SOURCES, "raft_ivf_flat_list_scan",
        "flat_scan_decomp")


def scan_operands(n_lists: int, n_probes: int, db, queries, device):
    """The pass's operands on a built IVF-Flat index, as
    ``ivf_flat.search`` hands them to it: the queries, the (super-)probes,
    the groups, the (L/F, F·cap) views of the lists, F and kt."""
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import grouped, ivf_flat

    index = ivf_flat.build(DeviceResources(seed=0, device=device),
                           ivf_flat.IndexParams(n_lists=n_lists), db)
    cap, dim = index.capacity, index.dim
    probes = ivf_flat._select_clusters(index.centers, queries, n_probes,
                                       index.metric)
    F, n_eff = ivf_flat.super_tile_factor(cap, n_lists, n_probes)
    if F > 1:
        probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
    probes = probes.to(torch.int32).contiguous()
    groups = grouped.build_groups(probes, n_eff)
    dsq = ivf_flat._row_norms(index.list_data)
    return (queries.contiguous(), probes, *groups,
            index.list_data.reshape(n_eff, F * cap, dim),
            dsq.reshape(n_eff, F * cap),
            index.list_indices.reshape(n_eff, F * cap), F, min(K, F * cap))


def run(fns, device, reps: int = 10) -> List[Dict]:
    """Time each loaded variant's pass on each index."""
    import ctypes

    from raft_tpu_torch.ops.pair_scan import flat_list_scan_layout

    db, queries = list_scan_decomp.sift_like(N_ROWS, DIM, device)
    lines = []
    for n_lists, n_probes in INDEXES:
        ops = scan_operands(n_lists, n_probes, db, queries, device)
        q, probes, group_list, slot_pairs, data, dsq, ids, F, kt = ops
        nq, npb = probes.shape
        vals = torch.empty(nq, npb, kt, device=device)
        out_ids = torch.empty(nq, npb, kt, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        layout = flat_list_scan_layout(DIM, kt).as_c()

        def launch(fn):
            return lambda: _cuda.check(fn(
                *(t.data_ptr() for t in (q, probes, group_list, slot_pairs,
                                         data, dsq, ids)),
                group_list.shape[0], nq, npb, data.shape[0], data.shape[1],
                F, DIM, kt, 0, ctypes.addressof(layout),
                vals.data_ptr(), out_ids.data_ptr(),
                *list_scan_decomp.NO_FILTER, stream),
                "flat_scan_decomp")

        for variant, fn in fns.items():
            lines.append({"n_lists": n_lists, "n_probes": n_probes,
                          "variant": variant,
                          "n_groups": int(group_list.shape[0]),
                          "pass_ms": device_ms(launch(fn), reps, device)})
        del ops, q, probes, group_list, slot_pairs, data, dsq, ids
        torch.cuda.empty_cache()
    return lines


def main() -> None:
    device = require_cuda()
    for line in run(build(), device):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

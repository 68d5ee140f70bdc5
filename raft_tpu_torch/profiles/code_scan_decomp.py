"""Kernels C and D's list-major pass over the PQ codes with its decode
moved or taken out: what decoding the codes in shared memory costs beside
Kernel G's pass 1 over the recon cache, and which overlap of the decode
with the products is faster.  A profile of the port's own design
(``csrc/pq_code_list_scan.cu``), with no JAX script behind it.

Each variant is ``csrc/pq_code_list_scan.cu`` rebuilt with text
substitutions (:data:`VARIANTS`) under
``build/raft_tpu_torch/code_scan_decomp/``, all loaded in one process:

- ``as built``: step s + 1's codes decoded while step s's ``wgmma`` runs;
- ``serial decode``: the same decode after step s's ``wgmma`` has
  finished (the raw codes still arrive by cp.async one step ahead);
- ``no decode``: zeros stored in place of the decoded rows (wrong
  results by design: only its time is kept).

Beside them, ``recon pass``: Kernel G's pass 1 (``pq_list_scan.cu`` as
the library builds it) over the index's recon cache with the codes'
norms, the same products and fold with no decode.  On the IVF-PQ indexes
of :mod:`.list_scan_decomp` (the flagship's 1,000,000 × 128 at
``n_lists=4096, pq_dim=64`` and the deep 10,000,000 × 96 at
``n_lists=8192, pq_dim=48``), 5,000 queries at n_probes 96 grouped once
per index, one JSON line per (index, kt, variant): the CUDA-event ms of
one pass launch and the group count.

    python3 -m raft_tpu_torch.profiles.code_scan_decomp
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.profiles import device_ms, list_scan_decomp, require_cuda

SCAN_SOURCES = ("pq_code_list_scan.cu",)
_OVERLAP = ("    // meanwhile step s + 1's rows (arrived) are decoded into the "
            "other\n"
            "    // stage, and step s + 2's start coming in\n")
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "as built": (),
    "serial decode": ((_OVERLAP, "    asm volatile(\"wgmma.wait_group.sync."
                       "aligned 0;\\n\" ::: \"memory\");\n"),),
    "no decode": (("    if (live && d0 < rot) {", "    if (false) {"),),
}


def variant_sources(name: str) -> Dict[str, str]:
    """:data:`SCAN_SOURCES` by file name, with variant ``name``'s
    substitutions; each must match exactly once."""
    return list_scan_decomp.variant_sources(name, VARIANTS, SCAN_SOURCES)


def build(names=tuple(VARIANTS)):
    """Each variant's entry point, ``raft_ivf_pq_code_list_scan``."""
    return list_scan_decomp.build_variants(
        names, VARIANTS, SCAN_SOURCES, "raft_ivf_pq_code_list_scan",
        "code_scan_decomp")


def index_operands(rows: int, dim: int, n_lists: int, pq_dim: int,
                   fraction: float, device):
    """A built IVF-PQ index with its codes' norms attached, its rotated
    queries, their probes and the probes' groups."""
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import grouped, ivf_flat, ivf_pq

    db, queries = list_scan_decomp.sift_like(rows, dim, device)
    index = ivf_pq.build(DeviceResources(seed=0, device=device),
                         ivf_pq.IndexParams(
                             n_lists=n_lists, pq_dim=pq_dim,
                             kmeans_trainset_fraction=fraction), db)
    del db
    ivf_pq._with_code_rsq(index)
    qrot = (queries @ index.rotation).contiguous()
    probes = ivf_flat._select_clusters(
        index.centers, qrot, list_scan_decomp.N_PROBES,
        index.metric).to(torch.int32).contiguous()
    return index, qrot, probes, grouped.build_groups(probes, n_lists)


def run(libs, device, reps: int = 10) -> List[Dict]:
    """Time each loaded variant, and Kernel G's pass 1 over the recon
    cache, on each index at each kt."""
    from raft_tpu_torch.ops.pq_code_scan import code_list_scan_smem_bytes
    from raft_tpu_torch.ops.pq_group_scan import list_scan_smem_bytes

    recon_pass = _cuda.library().raft_ivf_pq_list_scan
    lines = []
    for name, rows, dim, n_lists, pq_dim, fraction in (
            list_scan_decomp.INDEXES):
        index, qrot, probes, (gl, sp) = index_operands(
            rows, dim, n_lists, pq_dim, fraction, device)
        nq, n_probes = probes.shape
        cap, rot, bits = index.capacity, index.rot_dim, index.pq_bits
        centers = index.centers.float().contiguous()
        books = index.codebooks.to(torch.bfloat16).contiguous()
        common = (qrot, centers, probes, gl, sp)
        codes_ops = common + (index.list_codes.contiguous(), books,
                              index.list_code_rsq, index.list_indices)
        recon_ops = common + (index.list_recon.contiguous(),
                              index.list_code_rsq, index.list_indices)
        stream = torch.cuda.current_stream(device).cuda_stream
        for kt in list_scan_decomp.KTS:
            vals = torch.empty(nq, n_probes, kt, device=device)
            ids = torch.empty(nq, n_probes, kt, dtype=torch.int32,
                              device=device)
            out = (vals.data_ptr(), ids.data_ptr(),
                   *list_scan_decomp.NO_FILTER, stream)

            def codes(lib):
                return lambda: _cuda.check(lib(
                    *(t.data_ptr() for t in codes_ops), gl.shape[0], nq,
                    n_probes, n_lists, cap, rot, pq_dim, bits, kt,
                    code_list_scan_smem_bytes(rot, pq_dim, bits, kt), *out),
                    "code_scan_decomp")

            def recon():
                return _cuda.check(recon_pass(
                    *(t.data_ptr() for t in recon_ops), gl.shape[0], nq,
                    n_probes, n_lists, cap, rot, kt,
                    list_scan_smem_bytes(rot), *out), "code_scan_decomp")

            timed = {variant: codes(lib) for variant, lib in libs.items()}
            timed["recon pass"] = recon
            for variant, fn in timed.items():
                lines.append({"index": name, "kt": kt, "variant": variant,
                              "n_groups": int(gl.shape[0]),
                              "pass1_ms": device_ms(fn, reps, device)})
        del index, qrot, probes, gl, sp, common, codes_ops, recon_ops
        torch.cuda.empty_cache()
    return lines


def main() -> None:
    device = require_cuda()
    for line in run(build(), device):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

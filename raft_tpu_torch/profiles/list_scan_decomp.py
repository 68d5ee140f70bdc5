"""Kernels B and G's list-major pass 1 with one part taken out at a time:
where its time goes.  A profile of the port's own design
(``csrc/pq_list_scan.cu``), with no JAX script behind it.

Each variant is ``csrc/pq_list_scan.cu`` rebuilt with text substitutions
(:data:`VARIANTS`) in it and in the fold it includes
(``csrc/list_fold.cuh``) under ``build/raft_tpu_torch/list_scan_decomp/``, all
loaded in one process:

- ``as built``: pass 1 as Kernels B and G run it;
- ``no insertions``: each pair row's candidates filtered against its
  kt-th value, but none inserted;
- ``no fold``: the distances written to shared memory, no top-kt fold;
- ``no epilogue``: the row tiles loaded and multiplied, no distances;
- ``no products``: the row tiles loaded only;
- ``R rows at once``: the fold with R pair rows side by side in a warp
  (as built: ``kRowsAtOnce`` = 4).

All but ``as built`` and the row counts compute wrong results by design:
only their time is kept.  On an IVF-PQ index the port builds at the
flagship's configuration (1,000,000 × 128 rows of ``bench.py``'s
SIFT-like generator, numpy seed 0, ``IndexParams(n_lists=4096,
pq_dim=64)``) and at the deep one (10,000,000 × 96, ``n_lists=8192,
pq_dim=48``, train fraction 0.1), 5,000 queries at n_probes 96 grouped
once per index, one JSON line per (index, kt, variant): the CUDA-event ms
of one pass-1 launch at kt 20 (Kernel B's and G's flagship kt) and kt 4
(the deep ``recon`` mode's), and the group count.

    python3 -m raft_tpu_torch.profiles.list_scan_decomp
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.profiles import device_ms, require_cuda

SCAN_SOURCE = "pq_list_scan.cu"
# the files a variant may change: the scan, and the fold it includes
SCAN_SOURCES = (SCAN_SOURCE, "list_fold.cuh")
# the fold call in list_fold.cuh's window epilogue, which B, G and F share
FOLD = ("    fold_rows<E, R, kFilter>(top_v, top_s, stride, dist, s_pair, "
        "n_pairs,\n"
        "                             kt, row0 + kHalf * h, warp, lane, "
        "ids + kHalf * h,\n"
        "                             adm);")
_EPILOGUE = "    if (q != nchunks - 1) continue;"
_PRODUCTS = ("      wgmma_m64n128k16(acc, da, db, (q == 0 && ks == 0) ? 0 "
             ": 1);")
_ROWS = "constexpr int kRowsAtOnce = 4;"
# an entry point's filter arguments when unfiltered (words, stride, width)
NO_FILTER = (None, 0, 0)
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "as built": (),
    "no insertions": (("      while (any) {",
                       "      while (false && any) {"),),
    "no fold": ((FOLD, ""),),
    "no epilogue": ((_EPILOGUE, "    continue;"),),
    "no products": ((_EPILOGUE, "    continue;"),
                    (_PRODUCTS, "(void)da, (void)db;")),
    "2 rows at once": ((_ROWS, "constexpr int kRowsAtOnce = 2;"),),
    "8 rows at once": ((_ROWS, "constexpr int kRowsAtOnce = 8;"),),
}
# (name, rows, dim, n_lists, pq_dim, train fraction)
INDEXES = (("flagship", 1_000_000, 128, 4096, 64, 0.5),
           ("deep", 10_000_000, 96, 8192, 48, 0.1))
N_QUERIES, N_PROBES, KTS = 5_000, 96, (20, 4)


def variant_sources(name: str, variants=None, sources=SCAN_SOURCES
                    ) -> Dict[str, str]:
    """``sources`` (by default :data:`SCAN_SOURCES`) by file name, with
    variant ``name``'s substitutions from ``variants`` (by default
    :data:`VARIANTS`); each must match exactly once in all of them."""
    variants = VARIANTS if variants is None else variants
    texts = {f: (_cuda.SRC_DIR / f).read_text() for f in sources}
    for old, new in variants[name]:
        where = [f for f, text in texts.items() if old in text]
        if len(where) != 1 or texts[where[0]].count(old) != 1:
            raise RuntimeError(f"decomposition variant {name!r}: {old!r} "
                               f"is not in {sources} exactly once")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def build_variants(names, variants, sources, entry: str, subdir: str):
    """Each variant's entry point ``entry``: ``sources[0]`` rebuilt with
    the variant's substitutions under ``build/raft_tpu_torch/<subdir>/``,
    compiled in parallel (one nvcc each) and loaded."""
    root = _cuda.BUILD_DIR / subdir
    procs = {}
    for i, name in enumerate(names):
        d = root / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for src in _cuda.SRC_DIR.glob("*.cu*"):
            (d / src.name).write_text(src.read_text())
        for f, text in variant_sources(name, variants, sources).items():
            (d / f).write_text(text)
        so = d / "libvariant.so"
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
             str(d / sources[0]), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n"
                               + log.decode(errors="replace"))
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _cuda.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def build(names=tuple(VARIANTS)):
    """Each variant's pass-1 entry point, ``raft_ivf_pq_list_scan``."""
    return build_variants(names, VARIANTS, SCAN_SOURCES,
                          "raft_ivf_pq_list_scan", "list_scan_decomp")


def sift_like(n: int, dim: int, device, seed: int = 0,
              chunk: int = 1 << 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bench.py``'s generator: a 16-d latent mapped to ``dim`` plus 5%
    noise, ``n`` rows then the queries, drawn in row chunks onto the
    device."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n + N_QUERIES, 16)).astype(np.float32)
    a = rng.normal(size=(16, dim)).astype(np.float32) / np.sqrt(16)
    x = torch.empty(n + N_QUERIES, dim, device=device)
    for s in range(0, n + N_QUERIES, chunk):
        part = (z[s:s + chunk] @ a).astype(np.float32)
        part += 0.05 * rng.normal(size=part.shape).astype(np.float32)
        x[s:s + chunk] = torch.from_numpy(part)
    return x[:n], x[n:]


def index_inputs(rows: int, dim: int, n_lists: int, pq_dim: int,
                 fraction: float, device):
    """Pass 1's operands on a built index: rotated queries, centers,
    probes, the groups and the recon cache with its norms and ids."""
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import grouped, ivf_flat, ivf_pq

    db, queries = sift_like(rows, dim, device)
    index = ivf_pq.build(DeviceResources(seed=0, device=device),
                         ivf_pq.IndexParams(
                             n_lists=n_lists, pq_dim=pq_dim,
                             kmeans_trainset_fraction=fraction), db)
    del db
    qrot = queries @ index.rotation
    probes = ivf_flat._select_clusters(index.centers, qrot, N_PROBES,
                                       index.metric).to(torch.int32)
    group_list, slot_pairs = grouped.build_groups(probes, n_lists)
    return (qrot.contiguous(), index.centers.float().contiguous(),
            probes.contiguous(), group_list, slot_pairs,
            index.list_recon.contiguous(),
            index.list_recon_sq.contiguous(),
            index.list_indices.contiguous())


def run(libs, device, reps: int = 10
        ) -> List[Dict]:
    """Time pass 1 of each loaded variant on each index at each kt."""
    from raft_tpu_torch.ops.pq_group_scan import list_scan_smem_bytes

    lines = []
    for name, rows, dim, n_lists, pq_dim, fraction in INDEXES:
        ops = index_inputs(rows, dim, n_lists, pq_dim, fraction, device)
        qrot, _, probes, group_list, _, recon, _, _ = ops
        nq, n_probes = probes.shape
        _, cap, rot = recon.shape
        stream = torch.cuda.current_stream(device).cuda_stream
        for kt in KTS:
            vals = torch.empty(nq, n_probes, kt, device=device)
            ids = torch.empty(nq, n_probes, kt, dtype=torch.int32,
                              device=device)

            def launch(lib):
                return lambda: _cuda.check(lib(
                    *(t.data_ptr() for t in ops), group_list.shape[0], nq,
                    n_probes, n_lists, cap, rot, kt,
                    list_scan_smem_bytes(rot), vals.data_ptr(),
                    ids.data_ptr(), *NO_FILTER, stream), "list_scan_decomp")

            for variant, lib in libs.items():
                lines.append({"index": name, "kt": kt, "variant": variant,
                              "n_groups": int(group_list.shape[0]),
                              "pass1_ms": device_ms(launch(lib), reps,
                                                    device)})
        del ops, qrot, probes, group_list, recon
        torch.cuda.empty_cache()
    return lines


def main() -> None:
    device = require_cuda()
    for line in run(build(), device):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

"""Kernel A's tensor-core tile with one part taken out at a time: where its
time goes.  A profile of the port's own design (``csrc/nn_tile_mma.cuh``),
with no JAX script behind it.

Each variant is ``csrc/kmeans_update.cu`` rebuilt with one text
substitution in ``csrc/nn_tile_mma.cuh`` (:data:`VARIANTS`), under
``build/raft_tpu_torch/kmeans_tile_decomp/``, and timed in a process of
its own (with all four loaded in one process, the first launch at
256-row blocks failed with an invalid argument on an H100; one library a
process runs):

- ``as built``: the tile as Kernel A runs it;
- ``128-row blocks``: two warpgroups a block at every n, so twice the
  centroid-tile reloads of the 256-row blocks a large n gets;
- ``no products``: the ``wgmma`` instructions removed (loads, barriers
  and epilogue left);
- ``no reloads``: the two centroid stages loaded once and reused.

The last two compute wrong results by design: only their time is kept.
At 1M × 128 → 1,024 and 500,000 × 128 → 4,096 on normal data (numpy seed
0), one JSON line per (shape, variant): CUDA-event ms of the ``mm`` cut
(the product alone), the ``mmargmin`` cut (+ min and argmin) and the whole
pass (+ the update kernel).

    python3 -m raft_tpu_torch.profiles.kmeans_tile_decomp
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.profiles import device_ms, require_cuda

SHAPES = ((1_000_000, 128, 1024), (500_000, 128, 4096))
TILE_SOURCE = "nn_tile_mma.cuh"
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "as built": (),
    "128-row blocks": (
        ("return (n + 4 * kRowsWg - 1) / (4 * kRowsWg) >= sms ? 4 : 2;",
         "return 2;"),),
    "no products": (
        ("wgmma_m64n128k16(acc, da, db, (q == 0 && ks == 0) ? 0 : 1);",
         "(void)da, (void)db;"),),
    "no reloads": (("if (s + 1 < nsteps) load_step(s + 1, stage ^ 1);",
                    "if (s == 0 && nsteps > 1) load_step(1, 1);"),),
}


def variant_source(name: str) -> str:
    """``nn_tile_mma.cuh`` with variant ``name``'s substitutions; each must
    match the source exactly once."""
    text = (_cuda.SRC_DIR / TILE_SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"kmeans_tile_decomp {name!r}: {old!r} is "
                               f"not in {TILE_SOURCE} exactly once")
        text = text.replace(old, new)
    return text


def build(names=tuple(VARIANTS)) -> Dict[str, str]:
    """Each variant's library path, compiled in parallel (one nvcc
    each)."""
    root = _cuda.BUILD_DIR / "kmeans_tile_decomp"
    procs = {}
    for i, name in enumerate(names):
        d = root / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for src in _cuda.SRC_DIR.glob("*.cu*"):
            (d / src.name).write_text(src.read_text())
        (d / TILE_SOURCE).write_text(variant_source(name))
        so = d / "libkmeans_tile.so"
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
             str(d / "kmeans_update.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n"
                               + log.decode(errors="replace"))
        libs[name] = str(so)
    return libs


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn in ("raft_kmeans_assign_update", "raft_kmeans_pass_cut"):
        getattr(lib, fn).argtypes = _cuda.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run(libs: Dict[str, ctypes.CDLL], shapes=SHAPES, reps: int = 10,
        device="cuda") -> List[Dict]:
    """Time each loaded variant at every shape: ``mm`` / ``mmargmin`` /
    pass ms."""
    lines = []
    for n, dim, k in shapes:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)
                             ).to(device).to(torch.bfloat16)
        c = torch.from_numpy(rng.normal(size=(k, dim)).astype(np.float32)
                             ).to(device)
        cb, c_sq = c.to(torch.bfloat16), (c * c).sum(1)
        w = torch.ones(n, device=device)
        labels = torch.empty(n, dtype=torch.int32, device=device)
        sums = torch.empty(k, dim, device=device)
        counts = torch.empty(k, device=device)
        dmin = torch.empty(n, device=device)
        aux = torch.empty(-(-n // 256) * 16, device=device)
        label_sum = torch.empty(1, dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream

        def cut(lib, c_idx):
            return lambda: _cuda.check(lib.raft_kmeans_pass_cut(
                x.data_ptr(), cb.data_ptr(), c_sq.data_ptr(), n, k, dim,
                c_idx, labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                dmin.data_ptr(), aux.data_ptr(), label_sum.data_ptr(),
                stream), "kmeans_tile_decomp")

        def full(lib):
            return lambda: _cuda.check(lib.raft_kmeans_assign_update(
                x.data_ptr(), w.data_ptr(), cb.data_ptr(), c_sq.data_ptr(),
                n, k, dim, labels.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), dmin.data_ptr(), stream),
                "kmeans_tile_decomp")

        for name, lib in libs.items():
            lines.append({"shape": [n, dim, k], "variant": name,
                          "mm_ms": device_ms(cut(lib, 0), reps, device),
                          "mmargmin_ms": device_ms(cut(lib, 2), reps, device),
                          "pass_ms": device_ms(full(lib), reps, device)})
        del x, c, cb, c_sq, w, labels, sums, counts, dmin, aux
        torch.cuda.empty_cache()
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Build every variant and time each in a child process; with
    ``<variant> <library>`` arguments, be that child."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = require_cuda()
    if argv:
        name, path = argv
        for line in run({name: load(path)}, device=device):
            print(json.dumps(line), flush=True)
        return
    for name, path in build().items():
        child = subprocess.run(
            [sys.executable, "-m", __spec__.name, name, path],
            stdout=subprocess.PIPE, check=True, text=True)
        print(child.stdout, end="", flush=True)


if __name__ == "__main__":
    main()

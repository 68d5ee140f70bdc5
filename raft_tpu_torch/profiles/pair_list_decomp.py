"""Kernels F and G's pair-group pass with one part taken out at a time:
where its time goes.  A profile of the port's own design
(``csrc/pair_list_scan.cu``), with no JAX script behind it.

Each variant is ``csrc/pair_list_scan.cu`` rebuilt with text
substitutions (:data:`VARIANTS`) under
``build/raft_tpu_torch/pair_list_decomp/``, all loaded in one process:

- ``as built``: the pass as ``ivf_flat.search`` / ``ivf_pq.search`` run it;
- ``one row at a time``: a warp keeps one pair row at a time (as built:
  two side by side);
- ``no merges``: a pair's candidates buffered, a full buffer emptied
  without its bitonic merge into the kept rows (only the last flush
  merges);
- ``no keep``: the window's distances written to shared memory, no
  threshold, buffer or merge;
- ``no epilogue``: the row windows streamed and multiplied, no distances;
- ``no products``: the row windows streamed (F: and split) only.

All but ``as built`` compute wrong results by design: only their time is
kept.  On random lists drawn on the card from a fixed seed at the shapes
of ``pair_list_turns.py`` — F: 2,048 super-tiles of up to 832 fp32 rows of
dim 128, 1,000 queries × 64 probes, kt 100; G: 4,096 lists of up to 416
bf16 rows of rot 128, 1,000 queries × 96 probes, kt 128 — grouped once,
one JSON line per (kernel, variant): the CUDA-event ms of one pass launch
and the group count.

    python3 -m raft_tpu_torch.profiles.pair_list_decomp
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, List, Tuple

import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.profiles import device_ms, list_scan_decomp, require_cuda

SCAN_SOURCES = ("pair_list_scan.cu",)
_MERGE = "        flush_rows<R>(K, rows, cnt, thr, kt, lane);"
_F_KEEP = ("      fold_keep<kFilter>(K, dist, s_kid, s_pair, n_pairs, group, "
           "kt, row0,\n                         end, adm);")
_G_KEEP = ("      fold_keep<kFilter>(K, dist, kid, s_pair, n_pairs, group, "
           "kt, t * BN,\n                         extent, adm);")
_F_EPILOGUE = "    if (qc != nch - 1) continue;"
_G_EPILOGUE = "    if (qq != nch - 1) continue;"
_F_PRODUCTS = ("        wgmma_m64n128k8_tf32(acc, dal, dbh, (qc == 0 && ks == "
               "0) ? 0 : 1);\n"
               "        wgmma_m64n128k8_tf32(acc, dah, dbl, 1);\n"
               "        wgmma_m64n128k8_tf32(acc, dah, dbh, 1);")
_G_PRODUCTS = ("        wgmma_m64n128k16(acc, da, db, (qq == 0 && ks == 0) ? "
               "0 : 1);")
VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "as built": (),
    "one row at a time": (("constexpr int kRowsAtOnce = 2;",
                           "constexpr int kRowsAtOnce = 1;"),),
    "no merges": ((_MERGE, "        (void)rows;"),),
    "no keep": ((_F_KEEP, "      (void)s_kid;"),
                (_G_KEEP, "      (void)kid;")),
    "no epilogue": ((_F_EPILOGUE, "    continue;"),
                    (_G_EPILOGUE, "    continue;")),
    "no products": ((_F_EPILOGUE, "    continue;"),
                    (_G_EPILOGUE, "    continue;"),
                    (_F_PRODUCTS, "        (void)dal, (void)dah, (void)dbh, "
                     "(void)dbl;"),
                    (_G_PRODUCTS, "        (void)da, (void)db;")),
}
NQ = 1_000


def variant_sources(name: str) -> Dict[str, str]:
    """:data:`SCAN_SOURCES` by file name, with variant ``name``'s
    substitutions; each must match exactly once."""
    return list_scan_decomp.variant_sources(name, VARIANTS, SCAN_SOURCES)


def build(names=tuple(VARIANTS)):
    """Each variant's two entry points, ``(flat, recon)``."""
    flat = list_scan_decomp.build_variants(
        names, VARIANTS, SCAN_SOURCES, "raft_pair_list_scan_flat",
        "pair_list_decomp")
    out = {}
    for i, name in enumerate(names):
        so = _cuda.BUILD_DIR / "pair_list_decomp" / f"v{i}" / "libvariant.so"
        recon = ctypes.CDLL(str(so)).raft_pair_list_scan_recon
        recon.argtypes = _cuda.SIGNATURES["raft_pair_list_scan_recon"]
        recon.restype = ctypes.c_int
        out[name] = (flat[name], recon)
    return out


def _lists(g, n_lists, cap, dev):
    sizes = torch.randint(cap // 3, cap + 1, (n_lists, 1), generator=g,
                          device=dev)
    live = torch.arange(cap, device=dev)[None, :] < sizes
    ids = torch.cumsum(live.reshape(-1).int(), 0).reshape(n_lists, cap) - 1
    return torch.where(live, ids, torch.full_like(ids, -1)).int()


def _probes(g, n_lists, n_probes, dev):
    keys = torch.rand(NQ, n_lists, generator=g, device=dev)
    return keys.topk(n_probes, dim=1).indices.int().contiguous()


def run(fns, device, reps: int = 10) -> List[Dict]:
    """Time each loaded variant's pass at the F and G shapes."""
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps

    g = torch.Generator(device=device)
    g.manual_seed(19)
    stream = torch.cuda.current_stream(device).cuda_stream
    lines = []

    n_tiles, rows, dim, kt = 2048, 832, 128, 100
    data = torch.randn(n_tiles, rows, dim, generator=g, device=device)
    ids = _lists(g, n_tiles, rows, device)
    dsq = (data * data).sum(-1)
    q = torch.randn(NQ, dim, generator=g, device=device)
    probes = _probes(g, n_tiles, 64, device)
    layout = ps.pair_list_layout(dim, kt, True)
    gl, sp = grouped.build_groups(probes, n_tiles, layout.group)
    vals = torch.empty(NQ, 64, kt, device=device)
    out_ids = torch.empty(NQ, 64, kt, dtype=torch.int32, device=device)
    c_layout = layout.as_c()
    for variant, (flat, _) in fns.items():
        def launch(fn=flat):
            _cuda.check(fn(
                *(t.data_ptr() for t in (q, probes, gl, sp, data, dsq,
                                         ids)),
                gl.shape[0], NQ, 64, n_tiles, rows, 2, dim, kt, 0, 1, 1,
                ctypes.addressof(c_layout), vals.data_ptr(),
                out_ids.data_ptr(), *list_scan_decomp.NO_FILTER, stream),
                "pair_list_decomp")
        lines.append({"kernel": "F", "variant": variant,
                      "n_groups": int(gl.shape[0]),
                      "pass_ms": device_ms(launch, reps, device)})
    del data, dsq

    n_lists, cap, rot, kt = 4096, 416, 128, 128
    recon = torch.randn(n_lists, cap, rot, generator=g,
                        device=device).to(torch.bfloat16)
    rsq = (recon.float() ** 2).sum(-1)
    ids = _lists(g, n_lists, cap, device)
    centers = torch.randn(n_lists, rot, generator=g, device=device)
    qrot = torch.randn(NQ, rot, generator=g, device=device)
    probes = _probes(g, n_lists, 96, device)
    layout = ps.pair_list_layout(rot, kt, False)
    gl, sp = grouped.build_groups(probes, n_lists, layout.group)
    vals = torch.empty(NQ, 96, kt, device=device)
    out_ids = torch.empty(NQ, 96, kt, dtype=torch.int32, device=device)
    c_layout = layout.as_c()
    for variant, (_, rfn) in fns.items():
        def launch(fn=rfn):
            _cuda.check(fn(
                *(t.data_ptr() for t in (qrot, centers, probes, gl, sp,
                                         recon, rsq, ids)),
                gl.shape[0], NQ, 96, n_lists, cap, rot, kt, 1, 1,
                ctypes.addressof(c_layout), vals.data_ptr(),
                out_ids.data_ptr(), *list_scan_decomp.NO_FILTER, stream),
                "pair_list_decomp")
        lines.append({"kernel": "G", "variant": variant,
                      "n_groups": int(gl.shape[0]),
                      "pass_ms": device_ms(launch, reps, device)})
    return lines


def main() -> None:
    device = require_cuda()
    for line in run(build(), device):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

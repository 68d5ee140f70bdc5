#!/usr/bin/env python3
"""Drive raft_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.  No CUDA device is a failure.
2. Build: compile every kernel under ``raft_tpu_torch/csrc`` with nvcc.
3. Kernel A (``kmeans_assign_update``) against its plain PyTorch version on
   the flagship's first Lloyd pass: its 500,000 x 128 training set and its
   4,096 initial centroids.
4. Flagship path (BASELINE.md config 4, ``conf/sift-like-1m.json`` entry
   ``raft_ivf_pq.dim64``): a 1,000,000 x 128 SIFT-like database (the
   generator of ``bench.py``, numpy seed 0), ``ivf_pq.build`` at
   ``IndexParams(n_lists=4096, pq_dim=64)``, then batches of 5,000 queries
   searched at n_probes 96, k 20 and refined to k 10, recall@10 against
   ``brute_force.knn``.  Launch counts are zeroed just before and read
   just after; Kernels A, B and H (the build's balanced k-means
   assignments) must each be > 0.
5. Kernel B (``ivf_pq_scan_fused``) against its plain version on the
   flagship's batch: 5000 queries of the built index at n_probes 96, k 20;
   Kernel H (``fused_l2_nn``) against its plain version at the shapes the
   build gave it (the extend's assignment, 1,000,000 x 128 -> 4,096, and a
   codebook fit's, 65,536 x 2 -> 256).
6. IVF-PQ recon mode on the flagship index: ``scan_mode="recon"`` at
   n_probes 96, k 20, refined to k 10 (Kernel G, launches zeroed before,
   read after), and Kernel G (``ivf_pq_scan_recon``) against its plain
   version on that batch.
7. Where the flagship's time goes: one more build and one search+refine
   batch under ``torch.profiler`` — device busy time, idle share, heaviest
   kernels.
8. IVF-Flat at full width on the same data (``conf/sift-like-1m.json``
   entries ``raft_ivf_flat.nlist4096`` and ``.nlist16384``):
   ``ivf_flat.build`` at n_lists 4096 (seconds, stages, capacity), search
   at n_probes 32 / 64 / 128, k 10 (ms, QPS, recall@10, the super-tile
   factor F, Kernel F launches), Kernel F (``ivf_flat_scan``) against its
   plain version at n_probes 64, one batch under the profiler; then n_lists
   16384 (the hierarchical fit) at n_probes 128 with Kernel F against plain
   there, and Kernels A and H against plain at its fit's and extend's
   shapes.
9. k-means at full width (BASELINE.md config 3): ``kmeans.fit`` on the
   1,000,000 x 128 rows at ``KMeansParams(n_clusters=1024)`` (k-means++,
   max_iter 300, tol 1e-4) and ``predict`` — seconds, iterations, inertia,
   Kernel A and H launches — then Kernel H (``fused_l2_nn``) against its
   plain version at 1,000,000 x 128 -> 1,024 and at BASELINE.md config 2's
   100,000 x 128 -> 100,000, with ``torch.cdist(x, y).min(1)`` timed as a
   yardstick (no single PyTorch call computes min + first argmin), and
   Kernel A against plain at the Lloyd pass's shape.
10. CAGRA at full width (``conf/sift-like-1m.json`` entry
    ``raft_cagra.deg32``) on the same rows: ``cagra.build`` at
    ``IndexParams(graph_degree=32, intermediate_graph_degree=64)`` (seconds,
    stage seconds, the build's projected dimension, Kernel I / H / A
    launches zeroed before the build; I and H must be > 0), the conf's four
    search points (itopk 24, 32, 64 width 2, 128 width 2) at batch 5,000
    and k 10 (first batch, warm ms, QPS, recall@10 — at least 0.90 at
    itopk 64 and 128 — walk format, Kernel I launches), serving buckets of
    1 / 8 / 64 queries at itopk 32 and 64, one batch under the profiler,
    and Kernel I (``cagra_hop``) against its plain version on hops captured
    from the run: the search's 5,000 / itopk 64 / wd 64, a bucket's 64 /
    32 / 32, the build's self-walk 8,192 / 96 / 64 and its exact merge,
    with ``torch.topk`` over the [buffer | candidate] keys timed as a
    yardstick (it does no dedupe).
11. Deep path at full width (``conf/deep-like-10m.json`` entry
    ``raft_ivf_pq.dim48``): a 10,000,000 x 96 database + 5,000 queries
    from the same generator, ``ivf_pq.build`` at ``IndexParams(
    n_lists=8192, pq_dim=48, kmeans_trainset_fraction=0.1)`` (the
    hierarchical k-means build, Kernel A; its stages' wall seconds),
    Kernels A and H against their plain versions at the fit's three pass
    shapes and H at the codebook fits' shape, then per scan mode — ``auto`` (Kernel B), ``fused`` kt 4 (Kernel C),
    ``codes`` kt 4 (Kernel D), ``recon8`` kt 4 (Kernel E), ``recon`` kt 4
    (Kernel G), and ``auto`` on the index with its recon cache dropped
    (Kernel C at kt 20) — search at n_probes 96, k 20, refine to k 10: ms
    per batch, QPS and recall@10, each mode's launch counts zeroed before
    it and read after.  Kernels B, C, D, E and G against their plain
    versions on the full batch at each mode's shape, and each mode's batch
    under the profiler.
12. A JSON line with each kernel's route, source, launches, error, time
    (CUDA events), plain-version time and bound on its main path, and
    under ``also_checked`` the same measurements at the other shapes its
    paths give it; the ``nvidia-smi`` line; the result line ``{"ok":
    true, "device": {...}}`` last.

Bounds use the H100 SXM peaks: 3.35 TB/s of device memory, 989 TFLOP/s
for bf16 products (Kernels A-E and G multiply bf16 values, the int8 scan
by way of bf16) and 67 TFLOP/s of fp32 FFMA for Kernels F, H and I (F and
H: their contract fixes fp32 products, which TF32 tensor cores would
round to ten mantissa bits; I: its bf16 products are summed one by one in
dimension order, as its plain version sums them).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

N_DB, N_QUERIES, DIM, LATENT, NOISE = 1_000_000, 5_000, 128, 16, 0.05
N_LISTS, PQ_DIM, N_PROBES, K_SEARCH, K = 4096, 64, 96, 20, 10
DEEP_DB, DEEP_DIM, DEEP_LISTS, DEEP_PQ_DIM = 10_000_000, 96, 8192, 48
DEEP_TRAIN_FRACTION, DEEP_KT = 0.1, 4
SEARCH_REPS = 3
KERNEL_REPS = 5
# IVF-Flat (conf/sift-like-1m.json raft_ivf_flat.nlist4096 / .nlist16384)
FLAT_LISTS, FLAT_PROBES, FLAT_CHECK_PROBES = 4096, (32, 64, 128), 64
FLAT_FINE_LISTS, FLAT_FINE_PROBES = 16384, 128
# k-means (BASELINE config 3) and fusedL2NN (BASELINE config 2)
KMEANS_CLUSTERS, NN_ROWS = 1024, 100_000


def sift_like(n, n_queries, dim, latent, noise, device, seed=0,
              chunk=1 << 20):
    """bench.py's generator (``_make_dataset``): a 16-d latent mapped to
    ``dim`` plus 5% noise, numpy seed 0, database rows first, then the
    queries.  Drawn in row chunks straight onto the device, which gives
    the same numbers as one draw without a host copy of the whole set."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n + n_queries, latent)).astype(np.float32)
    A = rng.normal(size=(latent, dim)).astype(np.float32) / np.sqrt(latent)
    X = torch.empty(n + n_queries, dim, dtype=torch.float32, device=device)
    for s in range(0, n + n_queries, chunk):
        x = (Z[s:s + chunk] @ A).astype(np.float32)
        x += noise * rng.normal(size=x.shape).astype(np.float32)
        X[s:s + chunk] = torch.from_numpy(x)
    return X[:n], X[n:]


def counters():
    """Every kernel wrapper, by kernel name."""
    from raft_tpu_torch.ops import cagra_hop as chop
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    return {"kmeans_assign_update": ku.kmeans_assign_update,
            "ivf_pq_scan_fused": pgs.ivf_pq_scan_fused,
            "ivf_pq_scan_codes_fused": pcs.ivf_pq_scan_codes_fused,
            "ivf_pq_scan_codes": pcs.ivf_pq_scan_codes,
            "ivf_pq_scan_recon8": pcs.ivf_pq_scan_recon8,
            "ivf_flat_scan": ps.ivf_flat_scan,
            "ivf_pq_scan_recon": ps.ivf_pq_scan_recon,
            "fused_l2_nn": fnn.fused_l2_nn,
            "cagra_hop": chop.cagra_hop}


def zero_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in counters().items()}


def bound(nbytes, flops, peak=BF16_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their peak (bf16 products by
    default; the fp32 FFMA peak for Kernels F and H)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def peak_gb():
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, from CUDA
    events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps, kernel=""):
    """Mean device ms per call of the CUDA kernels whose name contains
    ``kernel`` (all of a call's kernels when empty), over ``reps`` calls
    after one warm-up, from torch.profiler: CUDA events around a run of
    ~30 us launches time the host's gaps between them, not the kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key
               ) / 1e3 / reps


def timed_once(fn):
    """``(fn(), ms)``: one call, its time from CUDA events.  The plain
    versions are timed by the call whose result is compared."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


MEASURED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def at_shape(row, shape, launches):
    """A kernel's check at one more shape its paths give it: the shape,
    the kernel's launches in the run of that path, and the row's
    measurements; listed under ``also_checked`` in the kernels line."""
    return {"shape": shape, "launches": launches,
            **{key: row[key] for key in MEASURED}}


_T0 = time.perf_counter()


def phase(name):
    """Start a phase: its name and the wall seconds since the start."""
    print(f"== {name} (t = {time.perf_counter() - _T0:.1f} s)", flush=True)


def device_breakdown(label, fn, top=6):
    """Run ``fn`` once under torch.profiler: wall time, the summed device
    time of its kernels, the device's idle share of the wall time, and its
    heaviest kernels (profiler overhead inflates the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{label} under the profiler: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.2f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def check_kernel_a(train, centroids, shape):
    """Kernel A vs plain on one Lloyd pass with unit weights (``shape``
    names it in the print).  dmin and the labels are the same arithmetic
    in the same order (exact bf16 products summed in dimension order), so
    counts of unit weights must be equal; sums differ by the order of
    fp32 atomic additions: |err| <= 1e-5 * count * max|x| per element."""
    import torch
    from raft_tpu_torch.ops import kmeans_update as ku

    xb = train.to(torch.bfloat16)
    w = torch.ones(train.shape[0], dtype=torch.float32, device=train.device)
    sums, counts, dmin = ku.kmeans_assign_update(xb, w, centroids)
    (p_sums, p_counts, p_dmin), plain_ms = timed_once(
        lambda: ku.kmeans_assign_update_plain(xb, w, centroids))
    assert torch.equal(counts, p_counts), (
        f"kernel A at {shape}: counts differ from the plain version in "
        f"{int((counts != p_counts).sum())} clusters")
    dmin_err = float((dmin - p_dmin).abs().max())
    assert dmin_err <= 1e-5, (
        f"kernel A at {shape}: dmin differs by {dmin_err}")
    tol = 1e-5 * p_counts[:, None] * float(xb.float().abs().max()) + 1e-6
    sums_err = (sums - p_sums).abs()
    assert bool((sums_err <= tol).all()), (
        f"kernel A at {shape}: sums differ by up to {float(sums_err.max())}")
    err = max(dmin_err, float(sums_err.max()))
    print(f"kernel A vs plain at {shape}: counts equal, max |dmin err| "
          f"{dmin_err}, max |sums err| {float(sums_err.max())}", flush=True)

    ms = cuda_ms(lambda: ku.kmeans_assign_update(xb, w, centroids),
                 KERNEL_REPS)
    n, dim = train.shape
    k = centroids.shape[0]
    flops = 2.0 * n * k * dim
    nbytes = (n * dim * 2 + n * 4 + k * dim * 2 + k * 4      # inputs
              + k * dim * 4 + k * 4 + n * 4)                 # outputs
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel A at {shape}: {ms:.3f} ms/pass "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"name": "kmeans_assign_update", "route": "cuda",
            "source": "raft_tpu_torch/csrc/kmeans_update.cu",
            "replaces": "raft_tpu/ops/kmeans_update_pallas.py:78",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def ties_only(v, i, ref_i, atol=1e-4):
    """True when every id that differs from the reference sits at a
    distance tie (within ``atol`` + 1e-4 relative): next to an equal
    distance in its sorted row, or on the row's last finite rank (whose tie
    partner may lie past the row)."""
    import torch

    tol = atol + 1e-4 * v.abs()
    tie = torch.zeros_like(v, dtype=torch.bool)
    near = (v[..., 1:] - v[..., :-1]).abs() <= tol[..., 1:]
    tie[..., 1:] |= near
    tie[..., :-1] |= near
    last = torch.isfinite(v) & ~torch.isfinite(
        torch.cat([v[..., 1:], torch.full_like(v[..., :1], float("inf"))],
                  -1))
    return bool(((i == ref_i) | tie | last).all())


def compare_with_plain(name, vk, ik, vp, ip, atol=1e-4):
    """Distances within 1e-4 relative + ``atol`` at every rank, the same
    exhausted ranks, -1 exactly there, ids equal except at distance
    ties."""
    import torch

    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)), f"{name}: exhausted ranks"
    assert torch.equal(ik < 0, ~fin), f"{name}: -1 ids off exhausted ranks"
    err = float((vk[fin] - vp[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(vk[fin], vp[fin], rtol=1e-4, atol=atol), (
        f"{name} distances differ by {err}")
    assert ties_only(vk, ik, ip, atol), (
        f"{name}: ids differ off distance ties")
    same = float((ik == ip).float().mean())
    print(f"{name} vs plain: max |dist err| {err}, ids equal at {same:.5f} "
          f"of ranks (others are distance ties)", flush=True)
    return err


def recompute(index, qrot, q_of, lists_of, vals, ids, rows_of, rsq,
              scales=None):
    """Every returned (query, id) distance recomputed from the index: the
    id's slot must lie in the list its query probed (``lists_of``: the
    lists allowed for each entry, (m, n)), and the distance must match."""
    import torch

    flat = index.list_indices.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    live = flat >= 0
    slot_of[flat[live].long()] = torch.nonzero(live)[:, 0]
    slot = slot_of[ids.long()]
    lst = slot // index.capacity
    assert bool((lists_of == lst[:, None]).any(1).all()), (
        "an id outside the lists its query probed")
    rows = rows_of(slot)
    sub = qrot[q_of] - index.centers[lst]
    sub = torch.nn.functional.pad(sub, (0, rows.shape[1] - sub.shape[1]))
    ip = (sub.to(torch.bfloat16).float() * rows).sum(1)
    if scales is not None:
        ip = scales[lst] * ip
    d = torch.clamp_min((sub * sub).sum(1) + rsq.reshape(-1)[slot]
                        - 2.0 * ip, 0.0)
    assert torch.allclose(d, vals, rtol=1e-4, atol=1e-4), (
        "returned ids do not match their distances")


def scan_bound(index, probes, row_bytes, extra_bytes, out_bytes, rot):
    """Each distinct probed list's live rows once, its center, the queries,
    probes, ``extra_bytes`` and the outputs; 2*rot bf16 operations per
    (query, probed live row)."""
    import torch

    nq = probes.shape[0]
    sizes = index.list_sizes.long()
    probed = torch.unique(probes.long())
    nbytes = (nq * index.rot_dim * 4 + probes.numel() * 4
              + probed.numel() * index.rot_dim * 4
              + int(sizes[probed].sum()) * row_bytes + extra_bytes
              + out_bytes)
    flops = 2.0 * rot * int(sizes[probes.long()].sum())
    ms, by = bound(nbytes, flops)
    return ms, by, nbytes, flops


def probe(index, queries):
    """The rotated queries and their exact n_probes-list ranking."""
    from raft_tpu_torch.neighbors.ivf_flat import _select_clusters

    qrot = queries.float() @ index.rotation
    return qrot, _select_clusters(index.centers, qrot, N_PROBES,
                                  index.metric)


def check_scans(index, qrot, probes, specs):
    """Each scan kernel against its plain version on the same batch
    (``compare_with_plain``), every returned id recomputed from the index
    (``recompute``), then its CUDA-event time, its plain version's time
    and its bound; one kernels-line row each.  A spec holds the kernel's
    name, source, the TPU kernel it replaces, wrapper, plain version,
    arguments, the rows and norms its distances read (with per-list
    scales for int8), bytes per live row, other input bytes, output
    bytes and the row width its products run over."""
    import torch

    nq, n_probes = probes.shape
    rows = []
    for (name, src, replaces, kernel, plain, args, rows_of, rsq, scales,
         row_bytes, extra, out_bytes, ops_rot) in specs:
        vk, ik = kernel(*args)
        (vp, ip), plain_ms = timed_once(lambda: plain(*args))
        err = compare_with_plain(name, vk, ik, vp, ip)
        fin = torch.isfinite(vk)
        if vk.ndim == 2:       # per query: any of its probed lists
            q_of = torch.nonzero(fin)[:, 0]
            lists_of = probes.long()[q_of]
        else:                  # per pair: exactly the pair's list
            kt = vk.shape[2]
            q_of = torch.arange(nq, device=qrot.device)[:, None, None]
            q_of = q_of.expand(nq, n_probes, kt)[fin]
            lists_of = probes.long()[:, :, None].expand(
                nq, n_probes, kt)[fin][:, None]
        recompute(index, qrot, q_of, lists_of, vk[fin], ik[fin], rows_of,
                  rsq, scales)
        ms = cuda_ms(lambda: kernel(*args), KERNEL_REPS)
        bound_ms, bound_by, nbytes, flops = scan_bound(
            index, probes, row_bytes, extra, out_bytes, ops_rot)
        print(f"{name}: {ms:.3f} ms/batch of {nq}, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.1f} GFLOP)", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"raft_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    return rows


def check_kernel_b(index, queries):
    """Kernel B vs plain on a path's batch of its built index (5000
    queries, n_probes 96, k 20, kt 20, as ``auto`` runs it)."""
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    nq, rot = qrot.shape
    kt = min(K_SEARCH, index.capacity)
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, K_SEARCH, kt)

    def recon_rows(slot):
        return index.list_recon.reshape(-1, rot)[slot].float()

    return check_scans(index, qrot, probes, [
        ("ivf_pq_scan_fused", "pq_group_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:410", pgs.ivf_pq_scan_fused,
         pgs.ivf_pq_scan_fused_plain, args, recon_rows,
         index.list_recon_sq, None, rot * 2 + 8, 0, nq * K_SEARCH * 8,
         rot)])[0]


def check_code_kernels(index, queries, kt, kernels=("C", "D", "E")):
    """Kernels C, D and E (those named in ``kernels``) against their plain
    versions on the deep batch (5000 queries, n_probes 96, k 20) at
    per-pair ``kt``."""
    from raft_tpu_torch.ops import pq_code_scan as pcs

    qrot, probes = probe(index, queries)
    nq, n_probes = probes.shape
    rot, W = index.rot_dim, index.code_width
    books = index.codebooks
    codes_args = (qrot, index.centers, probes, index.list_codes, books,
                  index.list_code_rsq, index.list_indices, index.pq_bits)

    def decoded(slot):
        return pcs.decode_codes(index.list_codes.reshape(-1, W)[slot], books,
                                index.pq_bits).float()

    pair_out = nq * n_probes * kt * 8
    codes_src = "raft_tpu/ops/pq_code_scan_pallas.py:"
    specs = []
    if "C" in kernels:
        specs.append((
            "ivf_pq_scan_codes_fused", "pq_code_scan.cu", codes_src + "282",
            pcs.ivf_pq_scan_codes_fused, pcs.ivf_pq_scan_codes_fused_plain,
            codes_args + (K_SEARCH, kt), decoded, index.list_code_rsq,
            None, W + 8, 2 * books.numel(), nq * K_SEARCH * 8, rot))
    if "D" in kernels:
        specs.append((
            "ivf_pq_scan_codes", "pq_code_scan.cu", codes_src + "367",
            pcs.ivf_pq_scan_codes, pcs.ivf_pq_scan_codes_plain,
            codes_args + (kt,), decoded, index.list_code_rsq, None,
            W + 8, 2 * books.numel(), pair_out, rot))
    if "E" in kernels:
        i8 = index.list_recon_i8
        rot_pad = i8.shape[2]
        specs.append((
            "ivf_pq_scan_recon8", "pq_recon8_scan.cu", codes_src + "441",
            pcs.ivf_pq_scan_recon8, pcs.ivf_pq_scan_recon8_plain,
            (qrot, index.centers, probes, i8, index.list_recon_scale,
             index.list_recon_i8_sq, index.list_indices, kt),
            lambda slot: i8.reshape(-1, rot_pad)[slot].float(),
            index.list_recon_i8_sq, index.list_recon_scale, rot_pad + 8,
            4 * index.n_lists, pair_out, rot_pad))
    return check_scans(index, qrot, probes, specs)


def check_kernel_g(index, queries, kt):
    """Kernel G vs plain on a path's batch (5000 queries, n_probes 96) at
    per-pair ``kt``, as ``scan_mode="recon"`` runs it."""
    from raft_tpu_torch.ops import pair_scan as ps

    qrot, probes = probe(index, queries)
    nq, n_probes = probes.shape
    rot = index.rot_dim
    kt = min(kt, index.capacity)
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, kt)

    def recon_rows(slot):
        return index.list_recon.reshape(-1, rot)[slot].float()

    return check_scans(index, qrot, probes, [
        ("ivf_pq_scan_recon", "pair_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:566", ps.ivf_pq_scan_recon,
         ps.ivf_pq_scan_recon_plain, args, recon_rows, index.list_recon_sq,
         None, rot * 2 + 8, 0, nq * n_probes * kt * 8, rot)])[0]


def flat_scan_args(index, queries, n_probes, k):
    """What ``ivf_flat.search`` hands Kernel F: the queries, the
    (super-tile) probes, the (L/F, F·cap) views of the lists, kt; and F."""
    from raft_tpu_torch.neighbors import ivf_flat

    probes = ivf_flat._select_clusters(index.centers, queries, n_probes,
                                       index.metric)
    cap, dim = index.capacity, index.dim
    F, n_eff = ivf_flat.super_tile_factor(cap, index.n_lists, n_probes)
    if F > 1:
        probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
    return (queries, probes, index.list_data.reshape(n_eff, F * cap, dim),
            index.list_data_sq.reshape(n_eff, F * cap),
            index.list_indices.reshape(n_eff, F * cap),
            min(k, F * cap)), F


def check_kernel_f(index, queries, n_probes, k):
    """Kernel F vs plain on an IVF-Flat batch at ``n_probes``: values
    within 1e-5 of the scale ‖q‖² + max ‖x‖² that fp32 cancellation moves
    them by, ids equal but at ties, every returned id found in its pair's
    tile with its distance recomputed; then its CUDA-event time, the plain
    version's and the bound (each probed tile's live rows read once, 2·dim
    fp32 operations per (query, probed live row))."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps

    args, F = flat_scan_args(index, queries, n_probes, k)
    q, probes, data, dsq, ids, kt = args
    vk, ik = ps.ivf_flat_scan(*args)
    (vp, ip), plain_ms = timed_once(lambda: ps.ivf_flat_scan_plain(*args))
    q_sq = (q * q).sum(1)
    scale = float(q_sq.max() + dsq.max())
    err = compare_with_plain("ivf_flat_scan", vk, ik, vp, ip,
                             atol=1e-5 * scale)
    fin = torch.isfinite(vk)
    flat = ids.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    slot_of[flat[flat >= 0].long()] = torch.nonzero(flat >= 0)[:, 0]
    slot = slot_of[ik[fin].long()]
    nq, n_pr = probes.shape
    pair_q = torch.arange(nq, device=q.device)[:, None, None].expand(
        nq, n_pr, kt)[fin]
    pair_tile = probes.long()[:, :, None].expand(nq, n_pr, kt)[fin]
    assert bool((slot // data.shape[1] == pair_tile).all()), (
        "ivf_flat_scan: an id outside its pair's tile")
    rows = data.reshape(-1, index.dim)[slot]
    d = torch.clamp_min(q_sq[pair_q] + dsq.reshape(-1)[slot]
                        - 2.0 * (q[pair_q] * rows).sum(1), 0.0)
    assert torch.allclose(d, vk[fin], rtol=0, atol=1e-5 * scale), (
        "ivf_flat_scan: returned ids do not match their distances")
    del rows, d
    ms = cuda_ms(lambda: ps.ivf_flat_scan(*args), KERNEL_REPS)
    live = (ids >= 0).sum(1)
    pr = probes.long()
    pr = pr[pr < data.shape[0]]
    nbytes = (int(live[torch.unique(pr)].sum()) * (index.dim * 4 + 8)
              + q.numel() * 4 + probes.numel() * 4 + vk.numel() * 8)
    flops = 2.0 * index.dim * int(live[pr].sum())
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    print(f"ivf_flat_scan at n_probes {n_probes} (F {F}, tile {data.shape[1]} "
          f"slots): {ms:.3f} ms/batch of {nq}, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.1f} GFLOP)", flush=True)
    return {"name": "ivf_flat_scan", "route": "cuda",
            "source": "raft_tpu_torch/csrc/pair_scan.cu",
            "replaces": "raft_tpu/ops/pq_group_scan_pallas.py:637",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "F": F}


def flat_searches(res, index, queries, truth, probes_list, label):
    """ivf_flat.search at each n_probes, k 10: a first search, then
    SEARCH_REPS timed batches; ms, QPS, recall@10, F and Kernel F
    launches per setting."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

    out = {}
    for n_probes in probes_list:
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        F, _ = ivf_flat.super_tile_factor(index.capacity, index.n_lists,
                                          n_probes)
        before = ps.ivf_flat_scan.launches
        ivf_flat.search(res, sp, index, queries, K)
        ms = []
        for _ in range(SEARCH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, found = ivf_flat.search(res, sp, index, queries, K)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
        recall = float(hits) / truth.numel()
        med = sorted(ms)[len(ms) // 2]
        out[n_probes] = {"ms": med, "recall": recall, "F": F}
        print(f"{label} n_probes {n_probes} (F {F}): search "
              f"{', '.join(f'{m:.2f}' for m in ms)} ms per batch of "
              f"{queries.shape[0]}; QPS {queries.shape[0] / (med / 1e3):.0f} "
              f"(median); recall@10 {recall:.4f}; Kernel F launches "
              f"{ps.ivf_flat_scan.launches - before}", flush=True)
    return out


def build_flat(res, db, n_lists, label):
    """ivf_flat.build with its seconds, stages and list sizes printed."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(res, ivf_flat.IndexParams(n_lists=n_lists), db)
    torch.cuda.synchronize()
    sizes = index.list_sizes.float()
    print(f"{label} build: {time.perf_counter() - t0:.2f} s; stages (s): "
          f"{json.dumps(ivf_flat.build.stage_seconds)}; {index.n_lists} "
          f"lists, capacity {index.capacity} (sizes mean "
          f"{float(sizes.mean()):.1f}, max {int(sizes.max())}, min "
          f"{int(sizes.min())})", flush=True)
    return index


def ivf_flat_path(db, queries, truth):
    """The IVF-Flat phases: ``raft_ivf_flat.nlist4096`` built and searched
    at n_probes 32 / 64 / 128 (launches zeroed before the build, read
    after the searches), Kernel F vs plain at n_probes 64, one batch under
    the profiler; then ``raft_ivf_flat.nlist16384`` (the hierarchical fit)
    at n_probes 128 with Kernel F vs plain there, and Kernels A and H vs
    plain at the shapes its hierarchical fit and its extend give them, on a
    trainset of the build's size (``also_checked``).  Returns F's kernels
    row and the A and H ``also_checked`` entries."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_flat

    res = DeviceResources(seed=0)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    index = build_flat(res, db, FLAT_LISTS, "IVF-Flat nlist 4096")
    results = flat_searches(res, index, queries, truth, FLAT_PROBES,
                            "IVF-Flat nlist 4096")
    launches = read_launches()
    print(f"IVF-Flat nlist 4096 launches (build + searches): "
          f"{json.dumps(launches)}; peak device memory {peak_gb():.2f} GB",
          flush=True)
    for name in ("ivf_flat_scan", "fused_l2_nn", "kmeans_assign_update"):
        assert launches[name] > 0, f"IVF-Flat: {name} never launched"
    assert results[FLAT_PROBES[-1]]["recall"] >= 0.90, (
        f"IVF-Flat recall@10 {results[FLAT_PROBES[-1]]['recall']} below "
        f"0.90 at n_probes {FLAT_PROBES[-1]}")
    row = check_kernel_f(index, queries, FLAT_CHECK_PROBES, K)
    row["launches"] = launches["ivf_flat_scan"]
    sp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
    device_breakdown(f"IVF-Flat search batch (n_probes {FLAT_CHECK_PROBES})",
                     lambda: ivf_flat.search(res, sp, index, queries, K))
    del index
    torch.cuda.empty_cache()

    zero_launches()
    fine = build_flat(res, db, FLAT_FINE_LISTS, "IVF-Flat nlist 16384")
    flat_searches(res, fine, queries, truth, (FLAT_FINE_PROBES,),
                  "IVF-Flat nlist 16384")
    fine_launches = read_launches()
    for name in ("ivf_flat_scan", "fused_l2_nn", "kmeans_assign_update"):
        assert fine_launches[name] > 0, f"IVF-Flat 16384: {name} never launched"
    row_fine = check_kernel_f(fine, queries, FLAT_FINE_PROBES, K)
    row["also_checked"] = [at_shape(
        row_fine, f"nlist 16384: {N_QUERIES:,} queries x {FLAT_FINE_PROBES} "
        f"probes, k {K}, F {row_fine['F']}, capacity {fine.capacity}",
        fine_launches["ivf_flat_scan"])]
    n_train = int(N_DB * ivf_flat.IndexParams().kmeans_trainset_fraction)
    sel = torch.randperm(N_DB, generator=DeviceResources(seed=0).generator,
                         device=db.device)[:n_train]
    a_rows, h_rows = hierarchical_checks(
        db[sel], FLAT_FINE_LISTS, "IVF-Flat nlist 16384",
        fine_launches["kmeans_assign_update"], fine_launches["fused_l2_nn"])
    h_rows.append(h_check(db, fine.centers, f"IVF-Flat nlist 16384 extend: "
                          f"{N_DB:,} x {DIM} -> {FLAT_FINE_LISTS:,}",
                          fine_launches["fused_l2_nn"]))
    del fine, sel
    torch.cuda.empty_cache()
    return row, a_rows, h_rows


def check_kernel_h(x, y, shape, yardstick):
    """Kernel H vs plain at one shape: dmin within 1e-5 of the scale ‖x‖²
    + max ‖y‖², each index equal to the plain version's or at a distance
    tie with it (both recomputed directly); its CUDA-event time, the plain
    version's, the bound (x and y read once, 2·m·n·k fp32 operations) and,
    with ``yardstick``, the two-call ``torch.cdist(x, y).min(1)``."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.utils import precision

    dk, ik = fnn.fused_l2_nn(x, y)
    (dp, ip), plain_ms = timed_once(lambda: fnn.fused_l2_nn_plain(x, y))
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    err = float((dk - dp).abs().max())
    assert err <= 1e-5 * scale, f"fused_l2_nn at {shape}: dmin off by {err}"
    gap = (((x - y[ik.long()]) ** 2).sum(1)
           - ((x - y[ip.long()]) ** 2).sum(1)).abs()
    assert bool(((ik == ip) | (gap <= 1e-5 * scale)).all()), (
        f"fused_l2_nn at {shape}: an index off a distance tie")
    same = float((ik == ip).float().mean())
    ms = cuda_ms(lambda: fnn.fused_l2_nn(x, y), KERNEL_REPS)
    (m, k), n = x.shape, y.shape[0]
    flops = 2.0 * m * n * k
    bound_ms, bound_by = bound((m + n) * k * 4 + m * 8, flops,
                               FP32_FLOP_PER_S)
    yard_ms = None
    if yardstick:
        with precision.highest():
            yard_ms = cuda_ms(lambda: torch.cdist(x, y).min(1), KERNEL_REPS)
    print(f"fused_l2_nn at {shape}: max |dmin err| {err} (scale {scale:.1f}), "
          f"indices equal at {same:.6f} (others at ties); {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); cdist+min yardstick "
          f"{yard_ms if yard_ms is None else round(yard_ms, 3)} ms",
          flush=True)
    return {"name": "fused_l2_nn", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_l2_nn.cu",
            "replaces": "raft_tpu/ops/fused_l2_nn_pallas.py:65",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "yardstick_cdist_min_ms": yard_ms}


def h_check(x, y, shape, launches):
    """Kernel H vs plain at one more shape a path gives it, as an
    ``also_checked`` entry."""
    return at_shape(check_kernel_h(x, y, shape, False), shape, launches)


def hierarchical_checks(train, n_clusters, label, a_launches, h_launches):
    """Kernels A and H against their plain versions at the three pass
    shapes of the hierarchical balanced fit of ``n_clusters`` clusters on
    ``train``: the mesocluster pass (all rows), a per-mesocluster pass (a
    sample of the fit's size) and a full-K pass, each from strided
    initial centroids as the fit starts.  Returns the ``also_checked``
    entries of A and of H."""
    from raft_tpu_torch.cluster.kmeans_balanced import _strided_init

    n_meso = round(n_clusters ** 0.5)
    k_max = -(-n_clusters // n_meso)
    per = max(2048, 32 * k_max)
    a_rows, h_rows = [], []
    for what, rows, k in (("mesocluster", train, n_meso),
                          ("per-mesocluster", train[:per], k_max),
                          ("full-K", train, n_clusters)):
        shape = (f"{label} {what} pass: {rows.shape[0]:,} x {rows.shape[1]} "
                 f"-> {k:,}")
        c0 = _strided_init(rows, k)
        a_rows.append(at_shape(check_kernel_a(rows, c0, shape), shape,
                               a_launches))
        h_rows.append(h_check(rows, c0, shape, h_launches))
    return a_rows, h_rows


def codebook_h_check(index, rows, label, launches):
    """Kernel H vs plain at the shape an IVF-PQ build's codebook fits give
    it: the first subspace of ``_BOOK_TRAIN_ROWS`` rotated residuals
    against its codebook (256 x pq_len)."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    rot = rows[:ivf_pq._BOOK_TRAIN_ROWS].float() @ index.rotation
    lab = fnn.fused_l2_nn_plain(rot, index.centers)[1].long()
    pq_len = index.rot_dim // index.pq_dim
    sub = (rot - index.centers[lab])[:, :pq_len].contiguous()
    book = index.codebooks[0].contiguous()
    return h_check(sub, book, f"{label} codebook fit: {sub.shape[0]:,} x "
                   f"{pq_len} -> {book.shape[0]}", launches)


def kmeans_path(db):
    """BASELINE config 3: ``kmeans.fit`` on the 1,000,000 x 128 rows at
    ``KMeansParams(n_clusters=1024)`` (k-means++, max_iter 300, tol 1e-4),
    then ``predict``; launches zeroed before the fit and read after the
    predict.  k-means++ alone is timed again from the same generator.
    Kernel H vs plain at 1,000,000 x 128 -> 1,024 and at BASELINE config
    2's 100,000 x 128 -> 100,000 (``also_checked``; no path of this script
    runs that shape, so its launches are 0), and Kernel A vs plain at the
    Lloyd loop's shape (1,000,000 x 128 -> 1,024).  Returns H's kernels
    row and A's ``also_checked`` entry."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import KMeansParams

    params = KMeansParams(n_clusters=KMEANS_CLUSTERS)
    res = DeviceResources(seed=0)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    centroids, inertia, n_iter = kmeans.fit(res, params, db)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    kmeans.predict(res, params, db, centroids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, inertia_p = kmeans.predict(res, params, db, centroids)
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    t0 = time.perf_counter()
    kmeans.init_plus_plus(res, db, KMEANS_CLUSTERS,
                          generator=kmeans._restart_generator(
                              params.seed, 0, db.device))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inertia, inertia_p = float(inertia), float(inertia_p)
    print(f"k-means 1M x 128 -> {KMEANS_CLUSTERS}: fit {fit_s:.2f} s "
          f"(k-means++ alone {init_s:.2f} s), n_iter {n_iter}, inertia "
          f"{inertia:.6e}; predict {predict_ms:.2f} ms, inertia "
          f"{inertia_p:.6e}; launches {json.dumps(launches)}", flush=True)
    for name in ("kmeans_assign_update", "fused_l2_nn"):
        assert launches[name] > 0, f"k-means: {name} never launched"
    assert centroids.shape == (KMEANS_CLUSTERS, DIM) and bool(
        torch.isfinite(centroids).all()), "k-means: bad centroids"
    assert int(labels.min()) >= 0 and int(labels.max()) < KMEANS_CLUSTERS
    assert 0 < inertia < float("inf") and abs(inertia_p - inertia) <= (
        1e-5 * inertia), "k-means: predict's inertia is not the fit's"
    row = check_kernel_h(db, centroids,
                         f"1,000,000 x 128 -> {KMEANS_CLUSTERS:,}", True)
    row["launches"] = launches["fused_l2_nn"]
    row["also_checked"] = [h_check(
        db[:NN_ROWS], db[NN_ROWS:2 * NN_ROWS],
        f"{NN_ROWS:,} x 128 -> {NN_ROWS:,} (BASELINE config 2)", 0)]
    shape = f"k-means Lloyd pass: 1,000,000 x 128 -> {KMEANS_CLUSTERS:,}"
    a_row = at_shape(check_kernel_a(db, centroids, shape), shape,
                     launches["kmeans_assign_update"])
    return row, a_row


def search_mode(res, index, db, queries, truth, label, sp, kernel):
    """One IVF-PQ scan mode on a built index: launch counts zeroed before
    and read after; a first search (which attaches the mode's lazy cache),
    then SEARCH_REPS batches of search + refine."""
    import torch
    from raft_tpu_torch.neighbors import ivf_pq, refine

    torch.cuda.synchronize()
    zero_launches()
    fallbacks = ivf_pq.search.fused_fallbacks
    t0 = time.perf_counter()
    ivf_pq.search(res, sp, index, queries, K_SEARCH)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    search_ms, batch_ms = [], []
    for _ in range(SEARCH_REPS):
        t0 = time.perf_counter()
        _, cand = ivf_pq.search(res, sp, index, queries, K_SEARCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, found = refine.refine(res, db, queries, cand, K)
        torch.cuda.synchronize()
        search_ms.append(1e3 * (t1 - t0))
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    fallbacks = ivf_pq.search.fused_fallbacks - fallbacks
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    med = sorted(batch_ms)[len(batch_ms) // 2]
    print(f"{label}: first search {first_ms:.2f} ms (lazy caches "
          f"included); search {', '.join(f'{m:.2f}' for m in search_ms)} "
          f"ms; search+refine {', '.join(f'{m:.2f}' for m in batch_ms)} ms "
          f"per batch of {queries.shape[0]}; QPS "
          f"{queries.shape[0] / (med / 1e3):.0f} (median); recall@10 "
          f"{recall:.4f}; launches {json.dumps(launches)}; fused codes "
          f"fallbacks {fallbacks}", flush=True)
    assert launches[kernel] > 0, f"{label}: {kernel} never launched"
    return {"label": label, "recall": recall, "launches": launches,
            "batch_ms": med, "cand": cand}


def deep_path(dev):
    """Phase 10: the deep-like-10m / raft_ivf_pq.dim48 index at full width,
    every compact-code scan mode through ``ivf_pq.search``, then every
    kernel of the path against its plain version at the shapes the path
    gives it.  Returns the kernel rows of C, D and E with the launches of
    their modes' runs, and the deep-shape checks of Kernels A, B, G and H
    (``at_shape`` entries)."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    db, queries = sift_like(DEEP_DB, N_QUERIES, DEEP_DIM, LATENT, NOISE, dev)
    torch.cuda.synchronize()
    print(f"deep data: {DEEP_DB} x {DEEP_DIM} + {N_QUERIES} queries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = DeviceResources(seed=0)
    t0 = time.perf_counter()
    _, truth = brute_force.knn(res, db, queries, K)
    torch.cuda.synchronize()
    print(f"deep ground truth (brute_force.knn): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    params = ivf_pq.IndexParams(n_lists=DEEP_LISTS, pq_dim=DEEP_PQ_DIM,
                                kmeans_trainset_fraction=DEEP_TRAIN_FRACTION)
    zero_launches()
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    sizes = index.list_sizes.float()
    print(f"deep build: {build_s:.2f} s; {index.n_lists} lists, capacity "
          f"{index.capacity} (list sizes mean {float(sizes.mean()):.1f}, max "
          f"{int(sizes.max())}, min {int(sizes.min())}), {index.size} rows, "
          f"pq_dim {index.pq_dim}, rot {index.rot_dim}; launches "
          f"{json.dumps(build_launches)}", flush=True)
    # coarse_fit is the hierarchical k-means, ~sqrt(K) mesoclusters looped
    print(f"deep build stages (s): {json.dumps(ivf_pq.build.stage_seconds)}",
          flush=True)
    for name in ("kmeans_assign_update", "fused_l2_nn"):
        assert build_launches[name] > 0, f"deep build: {name} never launched"
    print(f"deep peak device memory through the build: {peak_gb():.2f} GB",
          flush=True)

    # Kernels A and H at the hierarchical fit's three pass shapes, on the
    # build's trainset (the first draw of a seed-0 handle, rotated), and H
    # at the codebook fits' shape
    n_train = int(DEEP_DB * DEEP_TRAIN_FRACTION)
    sel = torch.randperm(DEEP_DB, generator=DeviceResources(seed=0).generator,
                         device=dev)[:n_train]
    train = db[sel] @ index.rotation
    del sel
    a_deep, h_deep = hierarchical_checks(
        train, DEEP_LISTS, "deep", build_launches["kmeans_assign_update"],
        build_launches["fused_l2_nn"])
    del train
    h_deep.append(codebook_h_check(index, db, "deep",
                                   build_launches["fused_l2_nn"]))
    torch.cuda.empty_cache()

    def sp(**kw):
        return ivf_pq.SearchParams(n_probes=N_PROBES, **kw)

    kt4 = dict(per_probe_topk=DEEP_KT)
    runs = {}
    for label, params_, kernel in (
            ("auto", sp(), "ivf_pq_scan_fused"),
            ("fused", sp(scan_mode="fused", **kt4), "ivf_pq_scan_codes_fused"),
            ("codes", sp(scan_mode="codes", **kt4), "ivf_pq_scan_codes"),
            ("recon8", sp(scan_mode="recon8", **kt4),
             "ivf_pq_scan_recon8"),
            ("recon", sp(scan_mode="recon", **kt4), "ivf_pq_scan_recon")):
        runs[label] = search_mode(res, index, db, queries, truth,
                                  f"deep {label}", params_, kernel)
        runs[label]["params"] = params_
    agree = float((runs["fused"]["cand"] == runs["codes"]["cand"]).float()
                  .mean())
    print(f"deep fused vs codes: candidate ids equal at {agree:.5f} of "
          f"ranks", flush=True)
    assert runs["auto"]["recall"] >= 0.90, (
        f"deep auto recall@10 {runs['auto']['recall']} below 0.90")
    for label in ("fused", "codes", "recon8", "recon"):
        assert runs[label]["recall"] >= 0.80, (
            f"deep {label} recall@10 {runs[label]['recall']} below 0.80")
    assert agree >= 0.99, f"deep fused and codes ids agree at {agree}"
    print(f"deep peak device memory through the searches: {peak_gb():.2f} "
          f"GB", flush=True)

    rows = check_code_kernels(index, queries, DEEP_KT)
    for row, label in zip(rows, ("fused", "codes", "recon8")):
        row["launches"] = runs[label]["launches"][row["name"]]
        row["also_checked"] = []
    b_deep = at_shape(
        check_kernel_b(index, queries),
        f"deep: {N_QUERIES:,} queries x {N_PROBES} probes, k {K_SEARCH}, kt "
        f"{K_SEARCH}, capacity {index.capacity:,}, rot {index.rot_dim}",
        runs["auto"]["launches"]["ivf_pq_scan_fused"])
    g_deep = at_shape(
        check_kernel_g(index, queries, DEEP_KT),
        f"deep recon: {N_QUERIES:,} queries x {N_PROBES} probes, kt "
        f"{DEEP_KT}, capacity {index.capacity:,}, rot {index.rot_dim}",
        runs["recon"]["launches"]["ivf_pq_scan_recon"])

    for label, run in runs.items():
        device_breakdown(f"deep {label} search+refine batch",
                         lambda: refine.refine(res, db, queries, ivf_pq.search(
                             res, run["params"], index, queries,
                             K_SEARCH)[1], K))

    # the memory-lean deployment: no recon cache, so auto -> codes, whose
    # Kernel C runs at kt = k
    index.list_recon = index.list_recon_sq = index.list_code_rsq = None
    torch.cuda.empty_cache()
    lean = search_mode(res, index, db, queries, truth, "deep auto without a "
                       "recon cache", sp(), "ivf_pq_scan_codes_fused")
    assert lean["recall"] >= 0.90, (
        f"deep auto (no recon cache) recall@10 {lean['recall']} below 0.90")
    row_c = check_code_kernels(index, queries, K_SEARCH, ("C",))[0]
    rows[0]["also_checked"].append(at_shape(
        row_c, f"deep, no recon cache: {N_QUERIES:,} queries x {N_PROBES} "
        f"probes, k {K_SEARCH}, kt {K_SEARCH}, capacity {index.capacity:,}",
        lean["launches"]["ivf_pq_scan_codes_fused"]))
    print(f"deep peak device memory, plain versions included: "
          f"{peak_gb():.2f} GB", flush=True)
    return rows, a_deep, b_deep, g_deep, h_deep


# CAGRA (conf/sift-like-1m.json raft_cagra.deg32)
CAGRA_DEGREE, CAGRA_INTERMEDIATE = 32, 64
CAGRA_POINTS = ((24, 1), (32, 1), (64, 2), (128, 2))
CAGRA_BUCKETS, CAGRA_BUCKET_POINTS, BUCKET_REPS = (1, 8, 64), ((32, 1),
                                                                (64, 2)), 20
# the hop call whose inputs are kept for the kernel check, per shape (a
# middle hop: some of the buffer visited, some not)
CAPTURE_CALL = 4


class HopCapture:
    """Stands in for ``neighbors.cagra``'s handle on ``ops.cagra_hop`` while
    a CAGRA run goes on: every hop goes to the real wrapper (which counts
    its launches as always), and the inputs of the ``CAPTURE_CALL``-th hop
    of each (nq, itopk, wd, pdim) shape are kept for the kernel check."""

    def __init__(self):
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import cagra_hop as chop

        self.cagra, self.real = cagra, chop
        self.calls, self.kept = {}, {}

    def cagra_hop(self, *args, ip_metric):
        nq, wd, pdim = args[2].shape
        key = (nq, args[5].shape[1], wd, pdim)
        self.calls[key] = self.calls.get(key, 0) + 1
        if self.calls[key] == CAPTURE_CALL:
            self.kept[key] = (args, ip_metric)
        return self.real.cagra_hop(*args, ip_metric=ip_metric)

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __enter__(self):
        self.cagra._hop = self
        return self

    def __exit__(self, *exc):
        self.cagra._hop = self.real


def check_kernel_i(args, ip_metric, shape):
    """Kernel I vs plain on one captured hop: the same finite slots, keys
    within 1e-5 relative, ids equal except at key ties, visited flags equal
    where ids are; its device time (profiler; the CUDA-event time of
    back-to-back calls printed beside it), the plain version's, the bound
    (every input read once, the buffer written once; 2·pdim fp32 operations
    per candidate) and ``torch.topk`` over the [buffer | candidate] keys as
    a yardstick (it does no dedupe: no single PyTorch call computes the
    hop)."""
    import torch
    from raft_tpu_torch.ops import cagra_hop as chop

    kd, ki, kv = chop.cagra_hop(*args, ip_metric=ip_metric)
    (pd, pi, pv), plain_ms = timed_once(
        lambda: chop.cagra_hop_plain(*args, ip_metric=ip_metric))
    fin = torch.isfinite(pd)
    assert torch.equal(fin, torch.isfinite(kd)), f"cagra_hop at {shape}: " \
        "finite slots differ"
    err = float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(kd[fin], pd[fin], rtol=1e-5, atol=1e-5), (
        f"cagra_hop at {shape}: keys differ by {err}")
    assert bool((ki[~fin] == -1).all()), f"cagra_hop at {shape}: dead ids"
    assert ties_only(kd, ki, pi, 1e-5), (
        f"cagra_hop at {shape}: ids differ off key ties")
    same = ki == pi
    assert torch.equal(kv[same], pv[same]), (
        f"cagra_hop at {shape}: visited flags differ")
    def hop():
        return chop.cagra_hop(*args, ip_metric=ip_metric)

    ms = device_ms(hop, KERNEL_REPS * 4, "hop_kernel")
    event_ms = cuda_ms(hop, KERNEL_REPS * 4)
    qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, vis = args
    nq, wd, pdim = nb_p.shape
    itopk = buf_d.shape[1]
    nbytes = (nq * (pdim * 2 + 4) + nq * wd * (pdim * 2 + 8)
              + 2 * nq * itopk * 9)
    flops = 2.0 * nq * wd * pdim
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    key, _ = chop.hop_keys(qp_t, q_sq, nb_p, nb_sq, nb_id, ip_metric)
    cat = torch.cat([buf_d, key], 1)
    topk_ms = device_ms(lambda: torch.topk(cat, itopk, dim=1, largest=False),
                        KERNEL_REPS * 4)
    print(f"cagra_hop at {shape}: max |key err| {err}, ids equal at "
          f"{float(same.float().mean()):.6f}; {ms:.4f} ms on the device "
          f"(CUDA events over back-to-back calls {event_ms:.4f}), plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB); torch.topk yardstick {topk_ms:.4f} ms",
          flush=True)
    return {"name": "cagra_hop", "route": "cuda",
            "source": "raft_tpu_torch/csrc/cagra_hop.cu",
            "replaces": "raft_tpu/ops/cagra_hop_pallas.py:257",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "event_ms": event_ms, "yardstick_topk_ms": topk_ms}


def walk_format(index):
    (pdim, quant), = list(index._walk_tables)
    return f"pdim {pdim}, {'int8' if quant else 'bf16'} table"


def cagra_path(db, queries, truth):
    """``raft_cagra.deg32`` on the flagship's rows: ``cagra.build`` (seconds,
    stages, build pdim, Kernel I / H / A launches), the conf's four search
    points at batch 5000, k 10 (first batch, warm ms, QPS, recall@10, walk
    format, Kernel I launches), serving buckets of 1 / 8 / 64 queries, one
    batch under the profiler, and Kernel I vs plain on hops captured from
    the run.  Returns I's kernels row."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra

    res = DeviceResources(seed=0)
    params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                               intermediate_graph_degree=CAGRA_INTERMEDIATE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with HopCapture() as cap:
        t0 = time.perf_counter()
        index = cagra.build(res, params, db)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = read_launches()
        print(f"CAGRA build (graph_degree {CAGRA_DEGREE}, intermediate "
              f"{CAGRA_INTERMEDIATE}): {build_s:.2f} s; stages (s): "
              f"{json.dumps(cagra.build.stage_seconds)}; build pdim "
              f"{cagra.build.build_pdim}; launches: Kernel I "
              f"{build_launches['cagra_hop']}, H "
              f"{build_launches['fused_l2_nn']}, A "
              f"{build_launches['kmeans_assign_update']}; hop shapes "
              f"(nq, itopk, wd, pdim) x calls: "
              f"{ {str(k): v for k, v in cap.calls.items()} }; peak device "
              f"memory {peak_gb():.2f} GB", flush=True)
        for name in ("cagra_hop", "fused_l2_nn"):
            assert build_launches[name] > 0, f"CAGRA build: {name} never " \
                "launched"
        g = index.graph
        assert g.shape == (N_DB, CAGRA_DEGREE) and int(g.min()) >= 0 and \
            int(g.max()) < N_DB, "CAGRA build: bad graph"

        results = {}
        for itopk, width in CAGRA_POINTS:
            sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
            before = read_launches()["cagra_hop"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cagra.search(res, sp, index, queries, K)
            torch.cuda.synchronize()
            first_ms = 1e3 * (time.perf_counter() - t0)
            ms = []
            for _ in range(SEARCH_REPS):
                t0 = time.perf_counter()
                _, found = cagra.search(res, sp, index, queries, K)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
            recall = float(hits) / truth.numel()
            med = sorted(ms)[len(ms) // 2]
            results[(itopk, width)] = recall
            print(f"CAGRA itopk {itopk} width {width}: first batch "
                  f"{first_ms:.2f} ms (walk cache included on the first "
                  f"point); {', '.join(f'{m:.2f}' for m in ms)} ms per batch "
                  f"of {N_QUERIES}; QPS {N_QUERIES / (med / 1e3):.0f} "
                  f"(median); recall@10 {recall:.4f}; {walk_format(index)}; "
                  f"Kernel I launches {read_launches()['cagra_hop'] - before}",
                  flush=True)
        launches = read_launches()
        print(f"CAGRA launches (build + searches): {json.dumps(launches)}; "
              f"peak device memory {peak_gb():.2f} GB", flush=True)
        for point in ((64, 2), (128, 2)):
            assert results[point] >= 0.90, (
                f"CAGRA recall@10 {results[point]} below 0.90 at itopk "
                f"{point[0]}, width {point[1]}")

        bucket_before = read_launches()["cagra_hop"]
        for itopk, width in CAGRA_BUCKET_POINTS:
            sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
            for nq in CAGRA_BUCKETS:
                q = queries[:nq]
                cagra.search(res, sp, index, q, K)
                ms = []
                for _ in range(BUCKET_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cagra.search(res, sp, index, q, K)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                print(f"CAGRA bucket of {nq} at itopk {itopk} width {width}: "
                      f"median {sorted(ms)[len(ms) // 2]:.2f} ms per batch "
                      f"(min {min(ms):.2f}, max {max(ms):.2f})", flush=True)
        bucket_launches = read_launches()["cagra_hop"] - bucket_before

    sp = cagra.SearchParams(itopk_size=64, search_width=2)
    device_breakdown("CAGRA search batch (itopk 64, width 2)",
                     lambda: cagra.search(res, sp, index, queries, K))

    def kept(nq, itopk, wd):
        """The captured hop of the largest batch up to ``nq`` at (itopk,
        wd): the build's self-walk chunks and exact-merge chunks are
        sized by the port, the search batches by this script."""
        keys = [k for k in cap.kept if k[1] == itopk and k[2] == wd
                and k[0] <= nq]
        key = max(keys)
        return key, cap.kept[key]

    key, (args, ipm) = kept(N_QUERIES, 64, 2 * CAGRA_DEGREE)
    row = check_kernel_i(args, ipm, f"search: {key} (nq, itopk, wd, pdim)")
    row["launches"] = launches["cagra_hop"]
    row["also_checked"] = []
    for (nq, itopk, wd), what, n_launch in (
            ((64, 32, CAGRA_DEGREE), "serving bucket", bucket_launches),
            ((8192, 96, CAGRA_INTERMEDIATE), "build self-walk",
             build_launches["cagra_hop"]),
            ((N_DB, CAGRA_INTERMEDIATE + 1, 96), "build exact merge",
             build_launches["cagra_hop"])):
        key, (args, ipm) = kept(nq, itopk, wd)
        shape = f"{what}: {key} (nq, itopk, wd, pdim)"
        row["also_checked"].append(at_shape(check_kernel_i(args, ipm, shape),
                                            shape, n_launch))
    del index, cap
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import _cuda

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = smi()
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)

    phase("build kernels")
    _cuda.library()
    print(f"build: {_cuda.build_seconds:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    db, queries = sift_like(N_DB, N_QUERIES, DIM, LATENT, NOISE, dev)

    phase("kernel A vs plain (first Lloyd pass of the flagship fit)")
    # the build's first draw from a seed-0 handle is this trainset, and
    # the fit starts from these strided centroids
    probe_res = DeviceResources(seed=0)
    n_train = int(N_DB * ivf_pq.IndexParams().kmeans_trainset_fraction)
    sel = torch.randperm(N_DB, generator=probe_res.generator,
                         device=dev)[:n_train]
    train = db[sel]
    c0 = train[::max(n_train // N_LISTS, 1)][:N_LISTS].contiguous()
    row_a = check_kernel_a(train, c0, f"{n_train:,} x {DIM} -> {N_LISTS:,}")
    del train, sel

    phase("main path: IVF-PQ build + search + refine at full width")
    res = DeviceResources(seed=0)
    params = ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM)
    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_stages = dict(ivf_pq.build.stage_seconds)
    batch_ms, search_ms = [], []
    for _ in range(SEARCH_REPS):
        t0 = time.perf_counter()
        _, cand = ivf_pq.search(res, sp, index, queries, K_SEARCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, found = refine.refine(res, db, queries, cand, K)
        torch.cuda.synchronize()
        search_ms.append(1e3 * (t1 - t0))
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, truth = brute_force.knn(res, db, queries, K)
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    med_ms = sorted(batch_ms)[len(batch_ms) // 2]
    print(f"index: {index.n_lists} lists, capacity {index.capacity}, "
          f"{index.size} rows, pq_dim {index.pq_dim}", flush=True)
    print(f"build: {build_s:.2f} s; stages (s): {json.dumps(build_stages)}",
          flush=True)
    print(f"search ms per batch of {N_QUERIES}: "
          f"{', '.join(f'{m:.2f}' for m in search_ms)}", flush=True)
    print(f"search+refine ms per batch of {N_QUERIES}: "
          f"{', '.join(f'{m:.2f}' for m in batch_ms)}; "
          f"QPS {N_QUERIES / (med_ms / 1e3):.0f} (median)", flush=True)
    print(f"recall@10: {recall:.4f}", flush=True)
    print(f"peak device memory: {peak_gb:.2f} GB", flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    for name in ("kmeans_assign_update", "ivf_pq_scan_fused", "fused_l2_nn"):
        assert launches[name] > 0, (
            f"{name} was never launched on the main path")
    assert recall >= 0.90, f"recall@10 {recall} below the 0.90 floor"

    phase("kernel B vs plain (the main path's batch on the built index)")
    row_b = check_kernel_b(index, queries)

    phase("kernel H vs plain at the flagship build's shapes")
    h_more = [h_check(db @ index.rotation, index.centers,
                      f"flagship extend: {N_DB:,} x {DIM} -> {N_LISTS:,}",
                      launches["fused_l2_nn"]),
              codebook_h_check(index, db, "flagship",
                               launches["fused_l2_nn"])]

    phase("IVF-PQ recon mode: scan_mode='recon', n_probes 96, k 20 -> 10")
    recon = search_mode(res, index, db, queries, truth, "flagship recon",
                        ivf_pq.SearchParams(n_probes=N_PROBES,
                                            scan_mode="recon"),
                        "ivf_pq_scan_recon")
    assert recon["recall"] >= 0.90, (
        f"flagship recon recall@10 {recon['recall']} below 0.90")
    row_g = dict(check_kernel_g(index, queries, K_SEARCH),
                 launches=recon["launches"]["ivf_pq_scan_recon"])

    phase("where the time goes (one build, one batch, under the profiler)")
    del index
    device_breakdown("build", lambda: ivf_pq.build(
        DeviceResources(seed=0), params, db))
    index = ivf_pq.build(DeviceResources(seed=0), params, db)
    device_breakdown("search+refine batch", lambda: refine.refine(
        res, db, queries, ivf_pq.search(res, sp, index, queries,
                                        K_SEARCH)[1], K))
    del index, cand, found
    torch.cuda.empty_cache()

    phase("IVF-Flat at full width: sift-like-1m, nlist 4096 and 16384")
    row_f, a_flat, h_flat = ivf_flat_path(db, queries, truth)

    phase("k-means at full width: 1M x 128 -> 1024 (BASELINE config 3)")
    row_h, a_kmeans = kmeans_path(db)

    phase("CAGRA at full width: sift-like-1m, raft_cagra.deg32")
    row_i = cagra_path(db, queries, truth)
    del db, queries, truth
    torch.cuda.empty_cache()

    phase("deep path at full width: 10M x 96, n_lists 8192, pq_dim 48")
    rows_cde, a_deep, b_deep, g_deep, h_deep = deep_path(dev)

    phase("result")
    row_g["also_checked"] = [g_deep]
    row_h["also_checked"] += h_more + h_flat + h_deep
    rows = [dict(row_a, launches=launches["kmeans_assign_update"],
                 also_checked=a_deep + a_flat + [a_kmeans]),
            dict(row_b, launches=launches["ivf_pq_scan_fused"],
                 also_checked=[b_deep])] + rows_cde + [row_f, row_g, row_h,
                                                       row_i]
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive raft_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.  No CUDA device is a failure.
2. Build: compile every kernel under ``raft_tpu_torch/csrc`` with nvcc;
   then the ``raise`` validator's first call and a second one.
3. Kernel A (``kmeans_assign_update``) against its plain PyTorch version on
   the flagship's first Lloyd pass: its 500,000 x 128 training set and its
   4,096 initial centroids, tie-aware (``ops.kmeans_update.
   check_assignment``: the tensor core sums the exact bf16 products in its
   own order), the update held to the plain update of the kernel's own
   labels; its time, the assignment / update device split, and a bf16
   ``torch.matmul`` of the same product as ``library_ms``.
4. Flagship path (BASELINE.md config 4, ``conf/sift-like-1m.json`` entry
   ``raft_ivf_pq.dim64``): a 1,000,000 x 128 SIFT-like database (the
   generator of ``bench.py``, numpy seed 0), ``ivf_pq.build`` at
   ``IndexParams(n_lists=4096, pq_dim=64)``, then batches of 5,000 queries
   searched at n_probes 96, k 20 and refined to k 10, recall@10 against
   ``brute_force.knn``.  Launch counts are zeroed just before and read
   just after; Kernel A, both passes of Kernel B (``list_scan`` and
   ``merge_pairs``, ``csrc/pq_list_scan.cu``) and Kernel H (the build's
   balanced k-means assignments) must each be > 0, and Kernel B's gate
   must refuse no search (``search.fused_fallbacks`` unchanged).  Then
   the ``raise`` validation policy's cost: the batch's median ms under
   ``off`` and under ``raise``, in
   turns, and the difference as a share of the batch (the search alone
   too; and CAGRA's itopk-64 batch in phase 11).
5. Kernel B (``ivf_pq_scan_fused``, list-major) against its plain version
   on the flagship's batch: 5000 queries of the built index at n_probes
   96, k 20, with the batch's group count and the call's device time split
   into grouping, pass 1 and pass 2, and the pair buffer's bytes; its
   query-major route (``scan_query_major``, k = kt = 256) against plain on
   the batch's first 1,000 queries; the batch's recall@10 on the one
   build through each route (the query-major kernel swapped in for the
   search's scan);
   Kernel H (``fused_l2_nn``) against its plain version at the shapes the
   build gave it (the extend's assignment, 1,000,000 x 128 -> 4,096, and a
   codebook fit's, 65,536 x 2 -> 256, its small-dim kernel, a row of its
   own in the kernels line with the small-dim kernel's launches; each H
   check times a call, the kernel's device time and a TF32-off fp32
   ``torch.matmul`` of the same product as ``library_ms``, a TF32-on one
   beside it; above dim 16 also the SIMT tile the tensor-core pass
   replaced, in the same run, and the share of labels equal to its; at
   the extend's shape and at the hierarchical fits' pass shapes the pass
   at two and four warpgroups a block, in turns).
6. IVF-PQ recon mode on the flagship index: ``scan_mode="recon"`` at
   n_probes 96, k 20, refined to k 10 (Kernel G, launches zeroed before,
   read after; pass 1 must be > 0), and Kernel G (``ivf_pq_scan_recon``,
   list-major pass 1) against its plain version on that batch, with its
   split (grouping, pass 1); its query-major route
   (``recon_scan_query_major``, kt 128) against plain on 1,000 queries;
   the recon batch's recall@10 through each route, as for B.  Then
   Kernels C (kt 20 and 4, k 20) and D (kt 4) on the index's codes (rot
   128, 8 bits: the list-major codes pass's tightest shared memory)
   against their plain versions on the batch.
7. Where the flagship's time goes: one more build and one search+refine
   batch under ``torch.profiler`` — device busy time, idle share, heaviest
   kernels.
8. IVF-Flat at full width on the same data (``conf/sift-like-1m.json``
   entries ``raft_ivf_flat.nlist4096`` and ``.nlist16384``):
   ``ivf_flat.build`` at n_lists 4096 (seconds, stages, capacity), search
   at n_probes 32 / 64 / 128, k 10 (ms, QPS, recall@10, the super-tile
   factor F, the launches of Kernel F's two routes: the list-major pass
   must run, the query-major kernel not), the same build's recall@10 at
   each n_probes through each route (within 0.0004), Kernel F
   (``ivf_flat_scan``, list-major, ``csrc/flat_list_scan.cu``) against
   its plain version at n_probes 64 with its device split (grouping, pass
   1), groups and the bytes it streams against the probed live bytes, its
   query-major route (``flat_scan_query_major``, k 100) against plain on
   the first 1,000 queries and on a 200,000 x 25 index (GloVe-25's width:
   one-value row loads), one batch under the profiler; then n_lists
   16384 (the hierarchical fit) at n_probes 128 with Kernel F against
   plain there, and Kernels A and H against plain at its fit's and
   extend's shapes.
9. k-means at full width (BASELINE.md config 3): ``kmeans.fit`` on the
   1,000,000 x 128 rows at ``KMeansParams(n_clusters=1024)`` (k-means++,
   max_iter 300, tol 1e-4) and ``predict`` — seconds, iterations, inertia,
   Kernel A and H launches — then Kernel H (``fused_l2_nn``) against its
   plain version at 1,000,000 x 128 -> 1,024 and at BASELINE.md config 2's
   100,000 x 128 -> 100,000, with ``torch.cdist(x, y).min(1)`` timed as a
   yardstick (no single PyTorch call computes min + first argmin), and
   Kernel A against plain at the Lloyd pass's shape.
10. The round-5 profile decompositions (PERF.md kernel table rows 10-13),
    through the port's profile modules at the JAX scripts' sizes, launch
    counts zeroed before and read after: Kernel F's four (gather, extract)
    variants on phase 8's two indexes at (n_lists, n_probes) (16384, 256)
    and (4096, 128), kt 10, and the pre-gather's time; the raw variant of
    Kernel G's rows on the flagship index (n_probes 96); Kernel J against
    ``torch.index_select`` on 320,000 random rows of a 1,000,000 x 128
    table, f32 and bf16, 1,024 and 2,048 rows a block; Kernel A's cuts
    (mm, mmmin, mmargmin, full; base, uw, mxuonly) at 1,000,000 x 128 ->
    1,024 with a bf16 ``torch.matmul`` of the same product as the
    yardstick, and the JAX script's uw spot check.  Then every variant
    against its plain version: raw distances within 1e-5 of ‖q‖² + max
    ‖x‖² (1e-4 for G's rows), selections as Kernel F's, Kernel J
    bit-equal, the cuts tie-aware as Kernel A (dmin within τ, labels the
    plain ones or at ties), counts exact from their own labels (mxuonly's
    column sums within 1e-4 relative), sums as Kernel A's.
11. Persistence at full width, on the indexes the script built, files
    under a ``tempfile.mkdtemp()`` it deletes: the flagship IVF-PQ
    ``ivf_pq.save`` then ``ivf_pq.load`` on the card (file bytes, save
    and load seconds, the recon cache's re-decode timed apart), the
    phase-4 batch searched and refined on the loaded index against the
    in-memory one (ids equal, distances bit-equal; two searches of the
    in-memory index are compared first, and were they to differ, the
    loaded one would be held to the ids), Kernel B's two passes launched
    on the loaded index; the flagship file with one byte flipped, then
    cut to half, makes ``load`` raise ``CorruptIndexError``; IVF-Flat
    nlist 4096 the same at n_probes 64, k 10, with Kernel F's list-major
    pass launched; then the checkpointed flagship build: ``build(...,
    checkpoint=dir)`` interrupted at its first ``interruptible.
    synchronize`` by ``faults.inject(..., exc=InterruptedException)``
    (the manifest must read ``["kmeans"]``), ``resume=True`` (the
    checkpoint loaded once and saved once, the centers bit-equal to the
    stage file, recall@10 against the flagship's recorded 0.9769-0.9786,
    printed with the gap when outside), then a resume from the complete
    checkpoint, bit-equal in every leaf to the build that wrote it; the
    seconds of each build.  The phase's CAGRA part closes phase 12.
12. CAGRA at full width (``conf/sift-like-1m.json`` entry
    ``raft_cagra.deg32``) on the same rows: ``cagra.build`` at
    ``IndexParams(graph_degree=32, intermediate_graph_degree=64)`` (seconds,
    stage seconds, the build's projected dimension, launches zeroed before
    the build: the walk kernel ``cagra_walk`` (the self-walk, one launch a
    chunk), Kernel I's hop kernel ``cagra_hop`` (the exact merge) and H
    must be > 0), the conf's four search points (itopk 24, 32, 64 width 2,
    128 width 2) at batch 5,000 and k 10 (first batch, warm ms, QPS,
    recall@10 — at least 0.90 at itopk 64 and 128 — walk format; exactly
    one walk launch and no hop launch a search), serving buckets of 1 / 8 /
    64 queries at itopk 32 and 64; then the yardstick, the per-hop loop the
    walk kernel replaced (``hop_loop``: per hop ``select_parents``,
    ``expand`` and the hop kernel, swapped in for the walk), against the
    walk kernel in turns at each point and bucket (equal results, medians,
    QPS), the build's self-walk chunks through both, one batch under the
    profiler through each route (idle share); the walk kernel against the
    plain walk (``torch.equal`` on keys, ids, visited flags and hop counts)
    on walks captured from the run: the search's 5,000 / itopk 64 / width
    2, a bucket's 64 / 32 / 1 and a build self-walk chunk's 8,192 / 96 / 1
    (CUDA-event and device ms, plain ms, the byte bound over the hops run,
    the yardstick's ms); and the hop kernel against its plain version at
    the build's exact merge and on the plain walk's fourth search hop,
    with ``torch.topk`` over the [buffer | candidate] keys timed as a
    yardstick (it does no dedupe).  Then the persistence phase's CAGRA
    part: ``cagra.save`` / ``cagra.load`` (bytes, seconds), the loaded
    index and a fresh index object of the same dataset and graph each
    searched first on a handle of one seed (the entry set is drawn there)
    at itopk 64 width 2: equal results and exactly one walk launch; a
    checkpointed build and a resume from its complete checkpoint, the
    graph bit-equal; the phase's seconds and numbers on one line with the
    card's name and power limit.
13. Deep path at full width (``conf/deep-like-10m.json`` entry
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
    it and read after (``auto`` must launch both passes of Kernel B with
    no fallback; ``fused``, ``codes`` and the lean ``auto`` the
    list-major codes pass ``code_list_scan``, C with pass 2, and no
    query-major codes kernel; ``recon8`` E's list-major pass
    ``recon8_list_scan`` and never its query-major kernel), ``auto``,
    ``recon`` kt 4 and ``recon8`` kt 4 also through each route of B, G
    and E on the one build (within 0.0004), ``fused`` and ``codes``
    through each route of C and D (printed only).  Kernels B, C, D, E and
    G against their plain versions on the full batch at each mode's shape
    (with their device splits; E's time beside G's); the codes pass
    against Kernel G's pass 1 over the recon cache on the codes' norms,
    and E's pass with every scale 1 against G's pass 1 over the int8
    rows as bf16, each bit for bit; C, D and E's query-major routes at k
    = kt = 128 on 1,000 queries; and each mode's batch under the
    profiler.
14. A JSON line with each kernel's route, source, launches, error, time
    (CUDA events), plain-version time, bound and yardstick library call
    (null where none computes the product) on its main path, and
    under ``also_checked`` the same measurements at the other shapes its
    paths give it; the ``nvidia-smi`` line; the result line ``{"ok":
    true, "device": {...}}`` last.

Bounds use the H100 SXM peaks: 3.35 TB/s of device memory, 989 TFLOP/s
for bf16 products (Kernels A-E and G multiply bf16 values, the int8 scan
by way of bf16; C and D's bytes are each probed list's live rows once at
their packed width + 8), 495 TFLOP/s of TF32 for Kernel F's list-major
pass and Kernel H above dim 16 (their fp32 products as 3xTF32: three TF32
products of the hi / lo split, so three times the operations; the fp32
FFMA time of one product is printed beside it, the yardstick of the
earlier SIMT and query-major times) and 67 TFLOP/s of fp32 FFMA for F's
query-major route, H's small-dim kernel and I (I: its bf16 products are
summed one by one in dimension order, as its plain version sums them; the
walk's bytes are each run hop's fat rows once, over the hops its queries
ran).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12

N_DB, N_QUERIES, DIM, LATENT, NOISE = 1_000_000, 5_000, 128, 16, 0.05
N_LISTS, PQ_DIM, N_PROBES, K_SEARCH, K = 4096, 64, 96, 20, 10
DEEP_DB, DEEP_DIM, DEEP_LISTS, DEEP_PQ_DIM = 10_000_000, 96, 8192, 48
DEEP_TRAIN_FRACTION, DEEP_KT = 0.1, 4
SEARCH_REPS = 3
KERNEL_REPS = 5
# queries of the flagship batch at which the large-kt (query-major) routes
# of Kernels B and G are held to their plain versions
LARGE_KT_QUERIES = 1_000
# IVF-Flat (conf/sift-like-1m.json raft_ivf_flat.nlist4096 / .nlist16384)
FLAT_LISTS, FLAT_PROBES, FLAT_CHECK_PROBES = 4096, (32, 64, 128), 64
FLAT_FINE_LISTS, FLAT_FINE_PROBES = 16384, 128
# k of the check of Kernel F's query-major route (kt past KT_LIST_MAX) on
# the first LARGE_KT_QUERIES queries
FLAT_LARGE_K = 100
# that route on a row width off a multiple of 4 (GloVe-25's): an IVF-Flat
# index of the generator's rows at this width
FLAT_ODD_ROWS, FLAT_ODD_DIM, FLAT_ODD_LISTS = 200_000, 25, 1024
# the most two routes' recall@10 may differ by on one build
ROUTE_RECALL_GAP = 0.0004
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
    from raft_tpu_torch.ops import cagra_walk as cw
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs
    from raft_tpu_torch.ops import row_gather as rg

    return {"kmeans_assign_update": ku.kmeans_assign_update,
            "list_scan": pgs.list_scan,
            "merge_pairs": pgs.merge_pairs,
            "scan_query_major": pgs.scan_query_major,
            "recon_scan_query_major": ps.recon_scan_query_major,
            "code_list_scan": pcs.code_list_scan,
            "codes_fused_query_major": pcs.codes_fused_query_major,
            "codes_scan_query_major": pcs.codes_scan_query_major,
            "recon8_list_scan": pcs.recon8_list_scan,
            "recon8_scan_query_major": pcs.recon8_scan_query_major,
            "flat_list_scan": ps.flat_list_scan,
            "flat_scan_query_major": ps.flat_scan_query_major,
            "fused_l2_nn": fnn.fused_l2_nn,
            "cagra_hop": chop.cagra_hop,
            "cagra_walk": cw.cagra_walk,
            "pair_scan_variant": ps.pair_scan_variant,
            "row_gather": rg.row_gather,
            "kmeans_pass_cut": ku.kmeans_pass_cut}


def zero_launches():
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    for fn in counters().values():
        fn.launches = 0
    fnn.fused_l2_nn.small_dim_launches = 0


def read_launches():
    """Each wrapper's launches; ``fused_l2_nn`` counts both of Kernel H's
    kernels, ``fused_l2_nn_small_dim`` the small-dim kernel's share."""
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    out = {name: fn.launches for name, fn in counters().items()}
    out["fused_l2_nn_small_dim"] = fnn.fused_l2_nn.small_dim_launches
    return out


def h_tf32_launches(launches):
    """Kernel H's tensor-core launches in a run: its launches less the
    small-dim kernel's."""
    return launches["fused_l2_nn"] - launches["fused_l2_nn_small_dim"]


def bound(nbytes, flops, peak=BF16_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their peak (bf16 products by
    default; TF32 for Kernel F's list-major pass and H's tensor-core pass,
    fp32 FFMA for F's query-major route and H's small-dim kernel)."""
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
    return device_split(fn, reps, (kernel,))[1][kernel]


def device_split(fn, reps, names):
    """``(total, {name: ms})``: mean device ms per call of all of a call's
    CUDA kernels, and of those whose name contains each of ``names``, over
    ``reps`` calls after one warm-up, from one torch.profiler window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3 / reps
    return total, {name: sum(e.self_device_time_total for e in events
                             if name in e.key) / 1e3 / reps
                   for name in names}


def list_major_split(label, run, probes, n_lists, pair_bytes, merged,
                     pass1="list_scan_kernel"):
    """The list-major route's device time over one call of ``run``, split
    into the grouping (every kernel but the two passes), pass 1 (the
    kernels whose name holds ``pass1``) and pass 2 (``merged``: Kernel B;
    else Kernel F or G, no pass 2); the batch's groups and touched lists,
    and the pair buffer's bytes (not in the bound)."""
    from raft_tpu_torch.neighbors import grouped

    total, split = device_split(run, KERNEL_REPS, (pass1, "merge_kernel"))
    p1, p2 = split[pass1], split["merge_kernel"]
    n_groups = int(grouped.num_groups(probes, n_lists))
    touched = int(grouped.touched_lists(probes, n_lists))
    print(f"{label}: {n_groups:,} groups over {touched:,} touched lists "
          f"({probes.numel() / max(n_groups, 1):.1f} pairs a group); device "
          f"{total:.3f} ms = grouping {total - p1 - p2:.3f} + pass 1 "
          f"{p1:.3f}" + (f" + pass 2 {p2:.3f}" if merged else "")
          + f"; pair buffer {pair_bytes / 1e6:.1f} MB", flush=True)
    assert p1 > 0 and (p2 > 0) == merged, f"{label}: pass split {split}"
    return {"device_ms": total, "grouping_device_ms": total - p1 - p2,
            "pass1_device_ms": p1, "pass2_device_ms": p2,
            "n_groups": n_groups, "touched_lists": touched,
            "pair_buffer_bytes": pair_bytes}


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
# measured too where a kernel's check has them
EXTRA = ("library_tf32_ms", "yardstick_simt_ms", "yardstick_simt_device_ms",
         "simt_label_agreement", "block_size_device_ms",
         "tau", "label_flips", "device_ms", "assign_device_ms",
         "update_device_ms", "grouping_device_ms", "pass1_device_ms",
         "pass2_device_ms", "n_groups", "touched_lists", "pair_buffer_bytes",
         "source", "check_launches", "yardstick_loop_ms", "walk_hops")


def at_shape(row, shape, launches):
    """A kernel's check at one more shape its paths give it: the shape,
    the kernel's launches in the run of that path, and the row's
    measurements; listed under ``also_checked`` in the kernels line."""
    return {"shape": shape, "launches": launches,
            **{key: row[key] for key in MEASURED + EXTRA if key in row}}


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


LIBRARY_OUT_BYTES = 8e9     # largest product a yardstick matmul may write


def matmul_ms(a, b, tf32=False):
    """CUDA-event ms of ``torch.matmul(a, b.T)`` (for fp32: TF32 off, or on
    with ``tf32``), the yardstick of a kernel whose product it computes;
    None when its output would pass ``LIBRARY_OUT_BYTES``."""
    import torch
    from raft_tpu_torch.utils import precision

    if a.shape[0] * b.shape[0] * a.element_size() > LIBRARY_OUT_BYTES:
        return None
    with precision.highest():         # which restores the flag after
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ms = cuda_ms(lambda: torch.matmul(a, b.T), KERNEL_REPS)
    torch.cuda.empty_cache()
    return ms


def check_kernel_a(train, centroids, shape):
    """Kernel A vs plain on one Lloyd pass with unit weights (``shape``
    names it in the print), tie-aware (``ops.kmeans_update.
    check_assignment``): the tensor core sums the exact bf16 products in
    its own order, so dmin is held within τ and each label to the plain
    label or a tie (within 2τ); the count of labels that differ is
    printed.  The update is held to the plain update from the kernel's own
    labels: counts of unit weights equal, sums within 1e-5 · count ·
    max|x| (fp32 atomic order).  Then its time, the device split between
    the assignment and the update kernels, and a bf16 ``torch.matmul`` of
    the same product as ``library_ms`` (a yardstick: no single call
    computes argmin + update)."""
    import torch
    from raft_tpu_torch.ops import kmeans_update as ku

    xb = train.to(torch.bfloat16)
    w = torch.ones(train.shape[0], dtype=torch.float32, device=train.device)
    sums, counts, dmin, labels = ku.kmeans_assign_update_labelled(
        xb, w, centroids)
    (_, _, p_dmin, p_labels), plain_ms = timed_once(
        lambda: ku.kmeans_assign_update_labelled_plain(xb, w, centroids))
    check = ku.check_assignment(xb, centroids, dmin, labels, p_dmin,
                                p_labels)
    assert check.ok, f"kernel A at {shape}: {check}"
    u_sums, u_counts = ku.update_plain(xb, w, labels, centroids.shape[0])
    assert torch.equal(counts, u_counts), (
        f"kernel A at {shape}: counts differ from the update of its labels "
        f"in {int((counts != u_counts).sum())} clusters")
    tol = 1e-5 * u_counts[:, None] * float(xb.float().abs().max()) + 1e-6
    sums_err = (sums - u_sums).abs()
    assert bool((sums_err <= tol).all()), (
        f"kernel A at {shape}: sums differ by up to {float(sums_err.max())}")
    err = max(check.dmin_err, float(sums_err.max()))
    print(f"kernel A vs plain at {shape}: max |dmin err| {check.dmin_err} "
          f"(tau {check.tau:.3e}), labels differing {check.flips} of "
          f"{labels.numel():,} (all at ties), counts equal to the update "
          f"of its labels, max |sums err| {float(sums_err.max())}",
          flush=True)
    del sums, counts, dmin, labels, p_dmin, p_labels, u_sums, u_counts

    def run():
        ku.kmeans_assign_update(xb, w, centroids)

    ms = cuda_ms(run, KERNEL_REPS)
    assign_ms = device_ms(run, KERNEL_REPS, "assign_kernel")
    update_ms = device_ms(run, KERNEL_REPS, "update_kernel")
    lib_ms = matmul_ms(xb, centroids.to(torch.bfloat16))
    n, dim = train.shape
    k = centroids.shape[0]
    flops = 2.0 * n * k * dim
    nbytes = (n * dim * 2 + n * 4 + k * dim * 2 + k * 4      # inputs
              + k * dim * 4 + k * 4 + n * 4)                 # outputs
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel A at {shape}: {ms:.3f} ms/pass "
          f"({flops / ms / 1e9:.1f} TFLOP/s), device: assignment "
          f"{assign_ms:.3f} ms + update {update_ms:.3f} ms (update "
          f"{update_ms / max(assign_ms + update_ms, 1e-9):.1%}), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), bf16 "
          f"matmul {'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}",
          flush=True)
    return {"name": "kmeans_assign_update", "route": "cuda",
            "source": "raft_tpu_torch/csrc/kmeans_update.cu",
            "replaces": "raft_tpu/ops/kmeans_update_pallas.py:78",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "tau": check.tau, "label_flips": check.flips,
            "assign_device_ms": assign_ms, "update_device_ms": update_ms}


def ties_only(v, i, ref_i, atol=1e-4):
    """True when every id that differs from the reference sits at a
    distance tie (within ``atol`` + 1e-4 relative): next to an equal
    distance in its sorted row, or on the row's last finite rank (whose tie
    partner may lie past the row; ``profiles.pair_cut_ties.tie_mask``)."""
    from raft_tpu_torch.profiles.pair_cut_ties import tie_mask

    return bool(((i == ref_i) | tie_mask(v, atol)).all())


def compare_with_plain(name, vk, ik, vp, ip, atol=1e-4, dist_of=None):
    """Distances within 1e-4 relative + ``atol`` at every rank, the same
    exhausted ranks, -1 exactly there, ids equal except at distance ties.

    A tie is one of ``ties_only``'s, or, where ``dist_of(q, ids)`` recomputes
    the distance of each (query, id) from the index in one arithmetic, a
    rank whose two ids recompute to distances within the same tolerance of
    each other.  A row merged from each pair's top kt needs the second
    kind: when two rows of one list tie at the pair's cut, the kernel and
    the plain version may keep different ones, and each then stands in its
    merged row with its partner nowhere beside it.  Ranks that are neither
    are printed, both ids with their recomputed distances, before the
    check fails."""
    import torch
    from raft_tpu_torch.profiles.pair_cut_ties import tie_mask

    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)), f"{name}: exhausted ranks"
    assert torch.equal(ik < 0, ~fin), f"{name}: -1 ids off exhausted ranks"
    err = float((vk[fin] - vp[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(vk[fin], vp[fin], rtol=1e-4, atol=atol), (
        f"{name} distances differ by {err}")
    off = (ik != ip) & ~tie_mask(vk, atol)
    at = torch.nonzero(off, as_tuple=True)
    cut = 0
    if dist_of is not None and bool(off.any()):
        dk, dp = dist_of(at[0], ik[at]), dist_of(at[0], ip[at])
        partner = (dk - dp).abs() <= atol + 1e-4 * vk[at].abs()
        cut = int(partner.sum())
        off[tuple(a[partner] for a in at)] = False
        at = torch.nonzero(off, as_tuple=True)
    for j in range(min(int(off.sum()), 8)):
        pos = tuple(int(a[j]) for a in at)
        line = (f"{name}: rank {pos}: kernel id {int(ik[pos])} at "
                f"{float(vk[pos])!r}, plain id {int(ip[pos])} at "
                f"{float(vp[pos])!r}")
        if dist_of is not None:
            q = at[0][j:j + 1]
            dk = float(dist_of(q, ik[pos].reshape(1))[0])
            dp = float(dist_of(q, ip[pos].reshape(1))[0])
            line += f"; recomputed {dk!r} / {dp!r}"
        print(line, flush=True)
    assert not bool(off.any()), (
        f"{name}: ids differ off distance ties at {int(off.sum())} ranks")
    same = float((ik == ip).float().mean())
    print(f"{name} vs plain: max |dist err| {err}, ids equal at {same:.5f} "
          f"of ranks (others are distance ties"
          + (f"; {cut} at a tie cut by a pair's top kt" if cut else "")
          + ")", flush=True)
    return err


def id_distances(index, qrot, q_of, ids, rows_of, rsq, scales=None):
    """Each (query ``q_of``, id ``ids``) distance recomputed from the index
    as the kernels compute it (the bf16 residual times the stored row,
    summed in fp32), and the list that holds each id."""
    import torch

    flat = index.list_indices.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    live = flat >= 0
    slot_of[flat[live].long()] = torch.nonzero(live)[:, 0]
    slot = slot_of[ids.long()]
    lst = slot // index.capacity
    rows = rows_of(slot)
    sub = qrot[q_of] - index.centers[lst]
    sub = torch.nn.functional.pad(sub, (0, rows.shape[1] - sub.shape[1]))
    ip = (sub.to(torch.bfloat16).float() * rows).sum(1)
    if scales is not None:
        ip = scales[lst] * ip
    d = torch.clamp_min((sub * sub).sum(1) + rsq.reshape(-1)[slot]
                        - 2.0 * ip, 0.0)
    return d, lst


def recompute(index, qrot, q_of, lists_of, vals, ids, rows_of, rsq,
              scales=None):
    """Every returned (query, id) distance recomputed from the index
    (``id_distances``): the id's slot must lie in the list its query
    probed (``lists_of``: the lists allowed for each entry, (m, n)), and
    the distance must match."""
    import torch

    d, lst = id_distances(index, qrot, q_of, ids, rows_of, rsq, scales)
    assert bool((lists_of == lst[:, None]).any(1).all()), (
        "an id outside the lists its query probed")
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
        err = compare_with_plain(
            name, vk, ik, vp, ip,
            dist_of=lambda q, ids: id_distances(
                index, qrot, q, ids, rows_of, rsq, scales)[0])
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


def recon_rows_of(index):
    """The bf16 recon row of each flat slot, as fp32 (``recompute``)."""
    rot = index.rot_dim

    def rows(slot):
        return index.list_recon.reshape(-1, rot)[slot].float()
    return rows


def check_kernel_b(index, queries):
    """Kernel B vs plain on a path's batch of its built index (5000
    queries, n_probes 96, k 20, kt 20, as ``auto`` runs it): the
    list-major route, with its device time split and group count."""
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    nq, rot = qrot.shape
    kt = min(K_SEARCH, index.capacity)
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, K_SEARCH, kt)
    row = check_scans(index, qrot, probes, [
        ("ivf_pq_scan_fused", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:410", pgs.ivf_pq_scan_fused,
         pgs.ivf_pq_scan_fused_plain, args, recon_rows_of(index),
         index.list_recon_sq, None, rot * 2 + 8, 0, nq * K_SEARCH * 8,
         rot)])[0]
    row.update(list_major_split(
        "kernel B", lambda: pgs.ivf_pq_scan_fused(*args), probes,
        index.n_lists, probes.numel() * min(kt, K_SEARCH) * 8, True))
    return row


def check_query_major(index, queries, nq, fused):
    """The large-kt route of Kernel B (``fused``: k = kt = 256, the
    query-major ``scan_query_major``) or G (kt 128,
    ``recon_scan_query_major``) against its plain version on the first
    ``nq`` queries of a path's batch, its launch counted; an
    ``also_checked`` entry of its kernel's row."""
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries[:nq])
    rot = qrot.shape[1]
    if fused:
        k = kt = min(pgs.K_MAX, index.capacity)
        wrapper, src = pgs.scan_query_major, "pq_group_scan.cu"
        spec = ("scan_query_major (B, query-major)", src,
                "raft_tpu/ops/pq_group_scan_pallas.py:410", wrapper,
                pgs.ivf_pq_scan_fused_plain,
                (qrot, index.centers, probes, index.list_recon,
                 index.list_recon_sq, index.list_indices, k, kt),
                recon_rows_of(index), index.list_recon_sq, None,
                rot * 2 + 8, 0, nq * k * 8, rot)
    else:
        k = kt = min(2 * pgs.KT_LIST_MAX, index.capacity)
        wrapper, src = ps.recon_scan_query_major, "pair_scan.cu"
        spec = ("recon_scan_query_major (G, query-major)", src,
                "raft_tpu/ops/pq_group_scan_pallas.py:566", wrapper,
                ps.ivf_pq_scan_recon_plain,
                (qrot, index.centers, probes, index.list_recon,
                 index.list_recon_sq, index.list_indices, kt),
                recon_rows_of(index), index.list_recon_sq, None,
                rot * 2 + 8, 0, probes.numel() * kt * 8, rot)
    assert kt > pgs.KT_LIST_MAX, "the large-kt route needs kt past 64"
    before = wrapper.launches
    row = check_scans(index, qrot, probes, [spec])[0]
    launched = wrapper.launches - before
    assert launched > 0, f"{spec[0]} never launched"
    return at_shape(dict(row, source=f"raft_tpu_torch/csrc/{src}",
                         check_launches=launched),
                    f"{nq:,} queries x {probes.shape[1]} probes, k {k}, kt "
                    f"{kt}, capacity {index.capacity:,}, rot {rot}", 0)


def check_code_kernels(index, queries, kt, kernels=("C", "D", "E"),
                       k=K_SEARCH):
    """Kernels C, D and E (those named in ``kernels``) against their plain
    versions on a path's batch (n_probes 96) at per-pair ``kt`` and C's
    ``k``.  Each runs the route its gate picks (list-major where a pair
    keeps at most 64 candidates: ``csrc/pq_code_list_scan.cu``, over the
    codes or, for E, the int8 rows, with the device split and the group
    count; else the query-major ``pq_code_scan.cu`` / ``pq_recon8_scan.
    cu``); each route's launch counter must move."""
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

    def listed(pair_kt):
        return not pcs.code_list_scan_reject_reason(
            rot, index.pq_dim, index.pq_bits, min(pair_kt, index.capacity))

    pair_out = nq * n_probes * kt * 8
    codes_src = "raft_tpu/ops/pq_code_scan_pallas.py:"
    specs, routes = [], []
    if "C" in kernels:
        on_list = listed(min(kt, k))
        specs.append((
            "ivf_pq_scan_codes_fused",
            "pq_code_list_scan.cu" if on_list else "pq_code_scan.cu",
            codes_src + "282", pcs.ivf_pq_scan_codes_fused,
            pcs.ivf_pq_scan_codes_fused_plain, codes_args + (k, kt), decoded,
            index.list_code_rsq, None, W + 8, 2 * books.numel(), nq * k * 8,
            rot))
        routes.append(pcs.code_list_scan if on_list
                      else pcs.codes_fused_query_major)
    if "D" in kernels:
        on_list = listed(kt)
        specs.append((
            "ivf_pq_scan_codes",
            "pq_code_list_scan.cu" if on_list else "pq_code_scan.cu",
            codes_src + "367", pcs.ivf_pq_scan_codes,
            pcs.ivf_pq_scan_codes_plain, codes_args + (kt,), decoded,
            index.list_code_rsq, None, W + 8, 2 * books.numel(), pair_out,
            rot))
        routes.append(pcs.code_list_scan if on_list
                      else pcs.codes_scan_query_major)
    if "E" in kernels:
        i8 = index.list_recon_i8
        rot_pad = i8.shape[2]
        on_list = not pcs.recon8_list_scan_reject_reason(
            rot_pad, min(kt, index.capacity))
        specs.append((
            "ivf_pq_scan_recon8",
            "pq_code_list_scan.cu" if on_list else "pq_recon8_scan.cu",
            codes_src + "441", pcs.ivf_pq_scan_recon8,
            pcs.ivf_pq_scan_recon8_plain,
            (qrot, index.centers, probes, i8, index.list_recon_scale,
             index.list_recon_i8_sq, index.list_indices, kt),
            lambda slot: i8.reshape(-1, rot_pad)[slot].float(),
            index.list_recon_i8_sq, index.list_recon_scale, rot_pad + 8,
            4 * index.n_lists, pair_out, rot_pad))
        routes.append(pcs.recon8_list_scan if on_list
                      else pcs.recon8_scan_query_major)
    before = [r.launches for r in routes]
    rows = check_scans(index, qrot, probes, specs)
    for row, spec, route, b in zip(rows, specs, routes, before):
        assert route.launches > b, f"{row['name']}: its route never ran"
        if route in (pcs.code_list_scan, pcs.recon8_list_scan):
            merged = row["name"] == "ivf_pq_scan_codes_fused"
            pair_kt = min(kt, k) if merged else kt
            row.update(list_major_split(
                f"{row['name']} (list-major, kt {kt})",
                lambda spec=spec: spec[3](*spec[5]), probes, index.n_lists,
                nq * n_probes * pair_kt * 8, merged,
                "code_list_scan_kernel"))
    return rows


def check_codes_query_major(index, queries, nq):
    """Kernels C, D and E's query-major routes (``csrc/pq_code_scan.cu``,
    ``csrc/pq_recon8_scan.cu``) at a pair kt past 64 (k = kt = 128) on
    the first ``nq`` queries of the batch, each against its plain version,
    its launch counted; three ``also_checked`` entries."""
    from raft_tpu_torch.ops import pq_code_scan as pcs

    kt = min(2 * 64, index.capacity)
    walked = (pcs.codes_fused_query_major, pcs.codes_scan_query_major,
              pcs.recon8_scan_query_major)
    before = [w.launches for w in walked]
    rows = check_code_kernels(index, queries[:nq], kt, ("C", "D", "E"), kt)
    ran = [w.launches - b for w, b in zip(walked, before)]
    assert min(ran) > 0, f"query-major routes launched {ran}"
    return [at_shape(dict(row, check_launches=n),
                     f"query-major (csrc/{row['source'].split('/')[-1]}): "
                     f"{nq:,} queries x {N_PROBES} probes, k {kt}, kt {kt}, "
                     f"capacity {index.capacity:,}, rot {index.rot_dim}", 0)
            for row, n in zip(rows, ran)]


def codes_bit_equal(index, queries, kt):
    """The list-major codes pass against Kernel G's pass 1 over the
    index's recon cache, both on the codes' norms (``list_code_rsq``), at
    per-pair ``kt`` on the batch: the decoded rows are the cache's bits
    and the tiling is the same, so values and ids must be equal."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    groups = grouped.build_groups(probes, index.n_lists)
    cv, ci = pcs.code_list_scan(qrot, index.centers, probes, *groups,
                                index.list_codes, index.codebooks,
                                index.list_code_rsq, index.list_indices,
                                index.pq_bits, kt)
    rv, ri = pgs.list_scan(qrot, index.centers, probes, *groups,
                           index.list_recon, index.list_code_rsq,
                           index.list_indices, kt)
    torch.cuda.synchronize()
    same = torch.equal(cv, rv) and torch.equal(ci, ri)
    print(f"code_list_scan vs list_scan over the recon cache (kt {kt}, "
          f"{probes.numel():,} pairs): bit-equal {same}", flush=True)
    assert same, "the codes pass differs from pass 1 over the recon cache"


def recon8_bit_equal(index, queries, kt):
    """Kernel E's list-major pass with every scale 1 against Kernel G's
    pass 1 over the int8 rows as bf16 (``q8[..., :rot]``, exact), both on
    the int8 norms, at per-pair ``kt`` on the batch: the same tiles, exact
    products, summation order and fold, so values and ids must be
    equal."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    groups = grouped.build_groups(probes, index.n_lists)
    i8, rsq8 = index.list_recon_i8, index.list_recon_i8_sq
    ones = torch.ones_like(index.list_recon_scale)
    ev, ei = pcs.recon8_list_scan(qrot, index.centers, probes, *groups, i8,
                                  ones, rsq8, index.list_indices, kt)
    rows = i8[..., :index.rot_dim].to(torch.bfloat16)
    gv, gi = pgs.list_scan(qrot, index.centers, probes, *groups, rows, rsq8,
                           index.list_indices, kt)
    torch.cuda.synchronize()
    same = torch.equal(ev, gv) and torch.equal(ei, gi)
    del rows
    torch.cuda.empty_cache()
    print(f"recon8_list_scan at scale 1 vs list_scan over the int8 rows as "
          f"bf16 (kt {kt}, {probes.numel():,} pairs): bit-equal {same}",
          flush=True)
    assert same, "the int8 pass differs from pass 1 over its rows as bf16"


def check_kernel_g(index, queries, kt):
    """Kernel G vs plain on a path's batch (5000 queries, n_probes 96) at
    per-pair ``kt``, as ``scan_mode="recon"`` runs it: list-major pass 1,
    with its device time split and group count."""
    from raft_tpu_torch.ops import pair_scan as ps

    qrot, probes = probe(index, queries)
    nq, n_probes = probes.shape
    rot = index.rot_dim
    kt = min(kt, index.capacity)
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, kt)
    row = check_scans(index, qrot, probes, [
        ("ivf_pq_scan_recon", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:566", ps.ivf_pq_scan_recon,
         ps.ivf_pq_scan_recon_plain, args, recon_rows_of(index),
         index.list_recon_sq, None, rot * 2 + 8, 0, nq * n_probes * kt * 8,
         rot)])[0]
    row.update(list_major_split(
        "kernel G", lambda: ps.ivf_pq_scan_recon(*args), probes,
        index.n_lists, nq * n_probes * kt * 8, False))
    return row


def flat_scan_args(index, queries, n_probes, k):
    """What ``ivf_flat.search`` hands Kernel F: the queries, the
    (super-tile) probes, the (L/F, F·cap) views of the lists, kt; and F
    (passed as ``sub_lists``)."""
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


def flat_stream_bytes(probes, ids, F, row_bytes):
    """``(read, multiplied, live)``, a model of Kernel F's list-major
    schedule worked out from the batch's groups, not a counter: the bytes
    of rows the schedule streams (each group its tile's sub-lists, each up
    to its last live row), the bytes of the rows it multiplies (those rows
    padded to 128-row windows with zeros it does not read), and the probed
    tiles' live rows read once."""
    import torch
    from raft_tpu_torch.neighbors import grouped

    n_tiles, rows = ids.shape
    live = ids.reshape(n_tiles, F, rows // F) >= 0
    slot = torch.arange(1, rows // F + 1, device=live.device)
    end = (live * slot).amax(-1)                      # (n_tiles, F)
    gl = grouped.build_groups(probes, n_tiles)[0].long()
    read = int(end.sum(1)[gl].sum()) * row_bytes
    multiplied = int(((end + 127) // 128).sum(1)[gl].sum()) * 128 * row_bytes
    return read, multiplied, int(live[torch.unique(gl)].sum()) * row_bytes


def check_kernel_f(index, queries, n_probes, k, label):
    """Kernel F vs plain on an IVF-Flat batch at ``n_probes`` and ``k``
    through ``ivf_flat_scan`` (k <= 64: the list-major pass; else the
    query-major kernel; the route's launch counter must move): values
    within 1e-5 of the scale ‖q‖² + max ‖x‖² that fp32 cancellation
    moves them by, ids equal but at ties, every returned id found in its
    pair's tile with its distance recomputed; then its CUDA-event time,
    the plain version's and the bound.  The list-major bound is the larger
    of the bytes (each probed tile's live rows read once) and 3xTF32's
    three TF32 products of 2·dim operations per (query, probed live row)
    at the TF32 peak, the fp32 FFMA time of one product beside it (the
    yardstick of the earlier query-major times, printed only); the
    query-major route's is bytes against fp32 FFMA.  The list-major route
    adds its device split and groups to the row, and prints the bytes its
    schedule streams by flat_stream_bytes' model."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps

    args, F = flat_scan_args(index, queries, n_probes, k)
    q, probes, data, dsq, ids, kt = args
    listed = not ps.flat_list_scan_reject_reason(data.shape[1], index.dim,
                                                 kt, F)
    wrapper = ps.flat_list_scan if listed else ps.flat_scan_query_major
    before = wrapper.launches
    vk, ik = ps.ivf_flat_scan(*args, sub_lists=F)
    assert wrapper.launches == before + 1, f"{label}: route not taken"
    (vp, ip), plain_ms = timed_once(lambda: ps.ivf_flat_scan_plain(*args))
    q_sq = (q * q).sum(1)
    scale = float(q_sq.max() + dsq.max())
    err = compare_with_plain(label, vk, ik, vp, ip, atol=1e-5 * scale)
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
        f"{label}: an id outside its pair's tile")
    rows = data.reshape(-1, index.dim)[slot]
    d = torch.clamp_min(q_sq[pair_q] + dsq.reshape(-1)[slot]
                        - 2.0 * (q[pair_q] * rows).sum(1), 0.0)
    assert torch.allclose(d, vk[fin], rtol=0, atol=1e-5 * scale), (
        f"{label}: returned ids do not match their distances")
    del rows, d
    ms = cuda_ms(lambda: ps.ivf_flat_scan(*args, sub_lists=F), KERNEL_REPS)
    live = (ids >= 0).sum(1)
    pr = probes.long()
    pr = pr[pr < data.shape[0]]
    row_bytes = index.dim * 4 + 8
    nbytes = (int(live[torch.unique(pr)].sum()) * row_bytes
              + q.numel() * 4 + probes.numel() * 4 + vk.numel() * 8)
    flops = 2.0 * index.dim * int(live[pr].sum())
    ffma_ms = 1e3 * flops / FP32_FLOP_PER_S
    row = {"name": "ivf_flat_scan", "route": "cuda",
           "source": "raft_tpu_torch/csrc/" + (
               "flat_list_scan.cu" if listed else "pair_scan.cu"),
           "replaces": "raft_tpu/ops/pq_group_scan_pallas.py:637",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "F": F}
    ops_ms = 1e3 * (3 * flops / TF32_FLOP_PER_S if listed
                    else flops / FP32_FLOP_PER_S)
    if listed:
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        streamed, multiplied, live_bytes = flat_stream_bytes(
            probes, ids, F, row_bytes)
        row.update(list_major_split(
            f"{label} split", lambda: ps.ivf_flat_scan(*args, sub_lists=F),
            probes, data.shape[0], vk.numel() * 8, False,
            "flat_list_scan_kernel"))
        print(f"{label}, schedule model (flat_stream_bytes, not measured): "
              f"streams {streamed / 1e6:.1f} MB for {live_bytes / 1e6:.1f} "
              f"MB of probed live rows ({streamed / max(live_bytes, 1):.3f} "
              f"per live byte); rows multiplied, padded to 128-row "
              f"windows: {multiplied / max(live_bytes, 1):.3f} per live "
              f"byte", flush=True)
    else:
        bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    row.update(bound_ms=bound_ms, bound_by=bound_by)
    print(f"{label} ({'list-major' if listed else 'query-major'}, n_probes "
          f"{n_probes}, k {k}, F {F}, tile {data.shape[1]} slots): {ms:.3f} "
          f"ms/batch of {nq}, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB = "
          f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms of bytes, "
          f"{flops / 1e9:.1f} GFLOP = "
          f"{'3xTF32' if listed else 'fp32 FFMA'} {ops_ms:.4f} ms"
          + (f"; fp32 FFMA yardstick {ffma_ms:.4f} ms" if listed else "")
          + ")", flush=True)
    return row


def flat_searches(res, index, queries, truth, probes_list, label):
    """ivf_flat.search at each n_probes, k 10: a first search, then
    SEARCH_REPS timed batches; ms, QPS, recall@10, F and the launches of
    Kernel F's two routes per setting."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

    out = {}
    for n_probes in probes_list:
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        F, _ = ivf_flat.super_tile_factor(index.capacity, index.n_lists,
                                          n_probes)
        before = (ps.flat_list_scan.launches,
                  ps.flat_scan_query_major.launches)
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
              f"(median); recall@10 {recall:.4f}; Kernel F launches: "
              f"list-major {ps.flat_list_scan.launches - before[0]}, "
              f"query-major {ps.flat_scan_query_major.launches - before[1]}",
              flush=True)
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


def odd_width_check(res, dev):
    """Kernel F's query-major route at a row width off a multiple of 4
    (its one-value row loads): an IVF-Flat index of FLAT_ODD_ROWS x 25
    rows (GloVe-25's width; the generator, numpy seed 25) at
    FLAT_ODD_LISTS lists, its first LARGE_KT_QUERIES queries at n_probes
    FLAT_CHECK_PROBES and k FLAT_LARGE_K against the plain version; an
    ``also_checked`` entry of F's row (0 launches on the main path)."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

    db, queries = sift_like(FLAT_ODD_ROWS, LARGE_KT_QUERIES, FLAT_ODD_DIM,
                            LATENT, NOISE, dev, seed=FLAT_ODD_DIM)
    index = ivf_flat.build(res, ivf_flat.IndexParams(
        n_lists=FLAT_ODD_LISTS), db)
    # the public search at k 100, which refused this width before (its
    # first search also attaches the rows' norms)
    before = ps.flat_scan_query_major.launches
    dist, _ = ivf_flat.search(res, ivf_flat.SearchParams(
        n_probes=FLAT_CHECK_PROBES), index, queries, FLAT_LARGE_K)
    assert ps.flat_scan_query_major.launches > before and bool(
        torch.isfinite(dist[:, 0]).all()), "dim-25 search at k 100"
    row = check_kernel_f(index, queries, FLAT_CHECK_PROBES, FLAT_LARGE_K,
                         f"flat_scan_query_major (F, dim {FLAT_ODD_DIM})")
    entry = at_shape(
        row, f"query-major, one-value row loads (csrc/pair_scan.cu "
        f"Fp32Rows): {FLAT_ODD_ROWS:,} x {FLAT_ODD_DIM}, nlist "
        f"{FLAT_ODD_LISTS}, {LARGE_KT_QUERIES:,} queries x "
        f"{FLAT_CHECK_PROBES} probes, k {FLAT_LARGE_K}, F {row['F']}, "
        f"capacity {index.capacity} (1 launch in the check)", 0)
    del db, queries, index
    torch.cuda.empty_cache()
    return entry


def ivf_flat_path(db, queries, truth):
    """The IVF-Flat phases: ``raft_ivf_flat.nlist4096`` built and searched
    at n_probes 32 / 64 / 128 (launches zeroed before the build, read
    after the searches; Kernel F's list-major pass must run and its
    query-major kernel not), the same build through each route of Kernel
    F, Kernel F vs plain at n_probes 64 (list-major, and query-major at k
    100 on the first LARGE_KT_QUERIES queries), one batch under the
    profiler; then ``raft_ivf_flat.nlist16384`` (the hierarchical fit) at
    n_probes 128 with Kernel F vs plain there, and Kernels A and H vs plain
    at the shapes its hierarchical fit and its extend give them, on a
    trainset of the build's size (``also_checked``).  Returns F's kernels
    row, the A and H ``also_checked`` entries and the two indexes (nlist
    16384, then 4096) for the profile phase."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

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
    for name in ("flat_list_scan", "fused_l2_nn", "kmeans_assign_update"):
        assert launches[name] > 0, f"IVF-Flat: {name} never launched"
    assert launches["flat_scan_query_major"] == 0, (
        "IVF-Flat: the k-10 searches left the list-major route")
    assert results[FLAT_PROBES[-1]]["recall"] >= 0.90, (
        f"IVF-Flat recall@10 {results[FLAT_PROBES[-1]]['recall']} below "
        f"0.90 at n_probes {FLAT_PROBES[-1]}")
    for n_probes in FLAT_PROBES:
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        same_build_routes(
            f"IVF-Flat nlist 4096 n_probes {n_probes}", ivf_flat,
            "ivf_flat_scan",
            lambda *a, sub_lists=1: ps.flat_scan_query_major(*a),
            (ps.flat_list_scan, ps.flat_scan_query_major),
            lambda: ivf_flat.search(res, sp, index, queries, K)[1], truth)
    row = check_kernel_f(index, queries, FLAT_CHECK_PROBES, K,
                         "ivf_flat_scan")
    row["launches"] = launches["flat_list_scan"]
    query_major = check_kernel_f(
        index, queries[:LARGE_KT_QUERIES], FLAT_CHECK_PROBES, FLAT_LARGE_K,
        "flat_scan_query_major (F, query-major)")
    odd = odd_width_check(res, db.device)
    sp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
    device_breakdown(f"IVF-Flat search batch (n_probes {FLAT_CHECK_PROBES})",
                     lambda: ivf_flat.search(res, sp, index, queries, K))

    zero_launches()
    fine = build_flat(res, db, FLAT_FINE_LISTS, "IVF-Flat nlist 16384")
    flat_searches(res, fine, queries, truth, (FLAT_FINE_PROBES,),
                  "IVF-Flat nlist 16384")
    fine_launches = read_launches()
    for name in ("flat_list_scan", "fused_l2_nn", "kmeans_assign_update"):
        assert fine_launches[name] > 0, f"IVF-Flat 16384: {name} never launched"
    row_fine = check_kernel_f(fine, queries, FLAT_FINE_PROBES, K,
                              "ivf_flat_scan nlist 16384")
    row["also_checked"] = [
        at_shape(row_fine, f"nlist 16384: {N_QUERIES:,} queries x "
                 f"{FLAT_FINE_PROBES} probes, k {K}, F {row_fine['F']}, "
                 f"capacity {fine.capacity}",
                 fine_launches["flat_list_scan"]),
        at_shape(query_major, f"query-major (csrc/pair_scan.cu Fp32Rows): "
                 f"nlist 4096, {LARGE_KT_QUERIES:,} queries x "
                 f"{FLAT_CHECK_PROBES} probes, k {FLAT_LARGE_K}, F "
                 f"{query_major['F']}, capacity {index.capacity} (1 launch "
                 f"in the check)", launches["flat_scan_query_major"]), odd]
    n_train = int(N_DB * ivf_flat.IndexParams().kmeans_trainset_fraction)
    sel = torch.randperm(N_DB, generator=DeviceResources(seed=0).generator,
                         device=db.device)[:n_train]
    a_rows, h_rows = hierarchical_checks(
        db[sel], FLAT_FINE_LISTS, "IVF-Flat nlist 16384",
        fine_launches["kmeans_assign_update"], h_tf32_launches(fine_launches))
    h_rows.append(h_check(db, fine.centers, f"IVF-Flat nlist 16384 extend: "
                          f"{N_DB:,} x {DIM} -> {FLAT_FINE_LISTS:,}",
                          h_tf32_launches(fine_launches)))
    del sel
    torch.cuda.empty_cache()
    return row, a_rows, h_rows, (fine, index)


def check_kernel_h(x, y, shape, yardstick, block_sizes=False):
    """Kernel H vs plain at one shape: dmin within 1e-5 of the scale ‖x‖²
    + max ‖y‖², each index equal to the plain version's or at a distance
    tie with it (both recomputed directly); its CUDA-event time (wrapper
    included), the device time of the kernel it launched, the plain
    version's time, the bound (x and y read once; at k > SMALL_DIM the
    tensor-core pass's 3 · 2·m·n·k TF32 operations, the fp32 FFMA time of
    one product and the byte time printed beside it; at k <= SMALL_DIM
    2·m·n·k fp32 operations), a TF32-off fp32 ``torch.matmul`` of the same
    product as ``library_ms`` (a yardstick: no single call computes min +
    first argmin) with a TF32-on one (one TF32 product) beside it and,
    with ``yardstick``, the two-call ``torch.cdist(x, y).min(1)``.  At k >
    SMALL_DIM the SIMT tile (the k > 16 kernel before the tensor-core
    pass, ``fused_l2_nn_variant(..., "simt")``) is timed in the same run,
    and the share of the pass's labels equal to the SIMT tile's printed
    with the distance gap of the others; with ``block_sizes``, the pass at
    two and at four warpgroups a block, in turns.  At k <= SMALL_DIM the
    row is the small-dim kernel's."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.utils import precision

    dk, ik = fnn.fused_l2_nn(x, y)
    (dp, ip), plain_ms = timed_once(lambda: fnn.fused_l2_nn_plain(x, y))
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    err = float((dk - dp).abs().max())
    assert err <= 1e-5 * scale, f"fused_l2_nn at {shape}: dmin off by {err}"

    def dist(i):
        return ((x - y[i.long()]) ** 2).sum(1)

    gap = (dist(ik) - dist(ip)).abs()
    assert bool(((ik == ip) | (gap <= 1e-5 * scale)).all()), (
        f"fused_l2_nn at {shape}: an index off a distance tie")
    same = float((ik == ip).float().mean())
    (m, k), n = x.shape, y.shape[0]
    small = k <= fnn.SMALL_DIM
    kernel = "small_dim_kernel" if small else "nn_tf32_kernel"
    ms = cuda_ms(lambda: fnn.fused_l2_nn(x, y), KERNEL_REPS)
    dev_ms = device_ms(lambda: fnn.fused_l2_nn(x, y), KERNEL_REPS, kernel)
    flops = 2.0 * m * n * k
    nbytes = (m + n) * k * 4 + m * 8
    if small:
        bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    else:
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    lib_ms = matmul_ms(x, y)
    lib_tf32_ms = matmul_ms(x, y, tf32=True)
    yard_ms = None
    if yardstick:
        with precision.highest():
            yard_ms = cuda_ms(lambda: torch.cdist(x, y).min(1), KERNEL_REPS)
    row = {"name": "fused_l2_nn_small_dim" if small else "fused_l2_nn",
           "route": "cuda", "source": "raft_tpu_torch/csrc/fused_l2_nn.cu",
           "replaces": "raft_tpu/ops/fused_l2_nn_pallas.py:65",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
           "library_tf32_ms": lib_tf32_ms, "device_ms": dev_ms,
           "yardstick_cdist_min_ms": yard_ms, "shape": shape}
    print(f"fused_l2_nn{' small-dim' if small else ''} at {shape}: max "
          f"|dmin err| {err} (scale {scale:.1f}), indices equal at "
          f"{same:.6f} (others at ties); {ms:.3f} ms a call, kernel "
          f"{dev_ms:.4f} ms on the device ({flops / dev_ms / 1e9:.1f} "
          f"TFLOP/s of one product), plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}"
          + ("" if small else
             f"; 3xTF32 {3e3 * flops / TF32_FLOP_PER_S:.4f} ms, fp32 FFMA "
             f"{1e3 * flops / FP32_FLOP_PER_S:.4f} ms, bytes "
             f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms")
          + f"); fp32 matmul "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'} (TF32 on: "
          f"{'n/a' if lib_tf32_ms is None else f'{lib_tf32_ms:.3f} ms'}); "
          f"cdist+min yardstick "
          f"{yard_ms if yard_ms is None else round(yard_ms, 3)} ms",
          flush=True)
    if small:
        return row
    # the same-run yardstick: the SIMT tile the tensor-core pass replaced
    _, i_simt = fnn.fused_l2_nn_variant(x, y, "simt")
    simt_ms = cuda_ms(lambda: fnn.fused_l2_nn_variant(x, y, "simt"),
                      KERNEL_REPS)
    simt_dev = device_ms(lambda: fnn.fused_l2_nn_variant(x, y, "simt"),
                         KERNEL_REPS, "nn_kernel")
    differ = ik != i_simt
    gaps = ((dist(ik) - dist(i_simt)).abs() / scale)[differ]
    agree = 1.0 - float(differ.double().mean())
    row.update(yardstick_simt_ms=simt_ms, yardstick_simt_device_ms=simt_dev,
               simt_label_agreement=agree)
    listed = sorted(gaps.tolist(), reverse=True)[:20]
    print(f"  SIMT tile yardstick: {simt_ms:.3f} ms a call, "
          f"{simt_dev:.4f} ms on the device (the pass {simt_dev / dev_ms:.2f}x"
          f" faster); labels equal to the SIMT tile's at {agree:.7f} "
          f"({int(differ.sum())} differ; their distance gap / scale, "
          f"largest first: {', '.join(f'{g:.2e}' for g in listed) or '-'})",
          flush=True)
    if block_sizes:
        times = {}
        for variant in ("tf32 2 warpgroups", "tf32 4 warpgroups",
                        "tf32 4 warpgroups", "tf32 2 warpgroups"):
            times.setdefault(variant, []).append(device_ms(
                lambda: fnn.fused_l2_nn_variant(x, y, variant), KERNEL_REPS,
                kernel))
        row["block_size_device_ms"] = times
        print(f"  block sizes in turns (device ms): {json.dumps(times)}",
              flush=True)
    return row


def h_check(x, y, shape, launches, block_sizes=False):
    """Kernel H vs plain at one more shape a path gives it, as an
    ``also_checked`` entry."""
    return at_shape(check_kernel_h(x, y, shape, False, block_sizes), shape,
                    launches)


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
        h_rows.append(h_check(rows, c0, shape, h_launches,
                              block_sizes=True))
    return a_rows, h_rows


def codebook_h_check(index, rows, label):
    """Kernel H vs plain at the shape an IVF-PQ build's codebook fits give
    it, its small-dim kernel's: the first subspace of ``_BOOK_TRAIN_ROWS``
    rotated residuals against its codebook (256 x pq_len).  Returns the
    check's row."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    rot = rows[:ivf_pq._BOOK_TRAIN_ROWS].float() @ index.rotation
    lab = fnn.fused_l2_nn_plain(rot, index.centers)[1].long()
    pq_len = index.rot_dim // index.pq_dim
    sub = (rot - index.centers[lab])[:, :pq_len].contiguous()
    book = index.codebooks[0].contiguous()
    return check_kernel_h(sub, book, f"{label} codebook fit: "
                          f"{sub.shape[0]:,} x {pq_len} -> {book.shape[0]}",
                          False)


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
    row["launches"] = h_tf32_launches(launches)
    row["also_checked"] = [h_check(
        db[:NN_ROWS], db[NN_ROWS:2 * NN_ROWS],
        f"{NN_ROWS:,} x 128 -> {NN_ROWS:,} (BASELINE config 2)", 0)]
    shape = f"k-means Lloyd pass: 1,000,000 x 128 -> {KMEANS_CLUSTERS:,}"
    a_row = at_shape(check_kernel_a(db, centroids, shape), shape,
                     launches["kmeans_assign_update"])
    return row, a_row


# the profile decompositions (PERF.md kernel table rows 10-13): the JAX
# scripts' (n_lists, n_probes), the gather's rows a block, the A cuts
PROFILE_FLAT = ((FLAT_FINE_LISTS, 256), (FLAT_LISTS, 128))
PROFILE_KT = 10
GATHER_ROWS = (1024, 2048)
POLICY_REPS = 5


def policy_cost(label, fn):
    """The ``raise`` validation policy's cost on one batch of a path:
    ``fn`` under ``off`` and under ``raise``, in turns, POLICY_REPS times
    each; the medians and their difference as a share of the batch."""
    import torch
    from raft_tpu_torch import config

    ms = {"off": [], "raise": []}
    for _ in range(POLICY_REPS):
        for policy in ("off", "raise"):
            with config.validation_policy(policy):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[policy].append(1e3 * (time.perf_counter() - t0))
    med = {p: sorted(v)[len(v) // 2] for p, v in ms.items()}
    share = (med["raise"] - med["off"]) / med["off"]
    print(f"validation policy cost, {label}: off "
          f"{', '.join(f'{m:.3f}' for m in ms['off'])} ms; raise "
          f"{', '.join(f'{m:.3f}' for m in ms['raise'])} ms; medians "
          f"{med['off']:.3f} / {med['raise']:.3f} ms; raise costs "
          f"{med['raise'] - med['off']:.3f} ms = {100 * share:.2f}% of the "
          f"batch", flush=True)
    return med, share


def validator_first_call(dev):
    """The ``raise`` validator's first call in the process (its CUDA
    kernels load on first use) and a second one, on 5,000 x 128 queries;
    the main path's first batch would pay the first."""
    import torch
    from raft_tpu_torch.integrity import boundary

    q = torch.zeros(N_QUERIES, DIM, device=dev)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boundary.check_matrix(q, "queries", site="chip_smoke", dim=DIM,
                              policy="raise")
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"validator (raise) on {N_QUERIES:,} x {DIM}: first call "
          f"{ms[0]:.3f} ms, second {ms[1]:.3f} ms", flush=True)


def variant_row(name, src, replaces, launches, checks):
    """A kernels-line row from its checks, the first the row's own shape
    and the rest under ``also_checked``."""
    first = checks[0]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches,
           **{key: first[key] for key in MEASURED}}
    row["shape"] = first["shape"]
    row["also_checked"] = [at_shape(c, c["shape"], launches)
                           for c in checks[1:]]
    return row


def check_scan_variant(label, args, kw, ms, scale, row_bytes, n_rows,
                       flops):
    """One F / G variant against its plain version: raw blocks within
    1e-5 · ``scale`` (F) or 1e-4 (G) at every slot with the same +inf,
    selections as ``compare_with_plain`` holds Kernels F and G; the bound
    from ``n_rows`` rows of ``row_bytes`` read once, the queries, the
    probes and the output."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps

    out = ps.pair_scan_variant(*args, **kw)
    ref, plain_ms = timed_once(lambda: ps.pair_scan_variant_plain(*args,
                                                                  **kw))
    atol = 1e-5 * scale if kw.get("centers") is None else 1e-4 * max(
        scale, 1.0)
    if kw["extract"]:
        err = compare_with_plain(label, *out, *ref, atol=atol)
        out_bytes = out[0].numel() * 8
    else:
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(out)), f"{label}: +inf slots"
        err = float((out[fin] - ref[fin]).abs().max())
        assert err <= atol, f"{label}: raw distances differ by {err}"
        out_bytes = out.numel() * 4
    q, probes = args[0], args[1]
    nbytes = n_rows * row_bytes + q.numel() * 4 + probes.numel() * 4 \
        + out_bytes
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S
                               if kw.get("centers") is None
                               else BF16_FLOP_PER_S)
    print(f"{label}: {ms:.3f} ms, plain {plain_ms:.1f} ms, max |err| {err} "
          f"(tol {atol:.3g}), bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)", flush=True)
    del out, ref
    return {"shape": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def flat_variant_checks(index, queries, n_probes, lines):
    """Row 10 at one IVF-Flat shape: each (gather, extract) variant line
    of the profile's run (``lines``) held to its plain version."""
    import torch
    from raft_tpu_torch.profiles import group_kernel_decomp_r5 as gkd

    probes, data, dsq, ids = gkd.scan_inputs(index, queries, n_probes)
    qg = gkd.pregather(queries, n_probes)
    scale = float((queries * queries).sum(1).max() + dsq.max())
    cap, dim = index.capacity, index.dim
    pr = probes.long()
    probed = torch.unique(pr)
    live = (ids >= 0).sum(1)
    checks = []
    for line in lines:
        gather, extract = line["gather"], line["extract"]
        q_in = queries if gather else qg
        if extract:     # live rows, their ids and norms; live products
            n_rows = int(live[probed].sum())
            row_bytes = dim * 4 + 8
            flops = 2.0 * dim * int(live[pr].sum())
        else:           # every slot, its norm; every product
            n_rows = probed.numel() * cap
            row_bytes = dim * 4 + 4
            flops = 2.0 * dim * pr.numel() * cap
        checks.append(check_scan_variant(
            f"pair_scan_variant F nlist {index.n_lists}, n_probes "
            f"{n_probes}, capacity {cap}, gather {gather}, extract "
            f"{extract}", (q_in, probes, data, dsq, ids, PROFILE_KT),
            dict(gather=gather, extract=extract), line["ms"], scale,
            row_bytes, n_rows, flops))
    return checks


def recon_raw_inputs(index, queries):
    """Row 10's raw variant on Kernel G's rows (``Bf16Rows``) at the
    flagship ``recon`` shape: the scan's arguments and switches."""
    qrot, probes = probe(index, queries)
    return ((qrot, probes, index.list_recon, index.list_recon_sq,
             index.list_indices, K_SEARCH),
            dict(gather=True, extract=False, centers=index.centers))


def recon_raw_check(index, args, kw, ms):
    """G's raw scan (timed at ``ms`` on the profile path) against its
    plain version, with its bound: every slot of every probed list."""
    import torch

    qrot, probes = args[0], args[1]
    cap, rot = index.capacity, index.rot_dim
    pr = probes.long()
    n_rows = torch.unique(pr).numel() * cap
    scale = float((qrot * qrot).sum(1).max() + index.list_recon_sq.max())
    return check_scan_variant(
        f"pair_scan_variant G raw, flagship recon: {N_QUERIES:,} queries x "
        f"{N_PROBES} probes, capacity {cap}, rot {rot}", args, kw, ms, scale,
        rot * 2 + 4, n_rows, 2.0 * rot * pr.numel() * cap)


def gather_checks(table, ids, lines):
    """Row 11: Kernel J bit-equal to ``index_select`` at each dtype and
    block height the profile ran; bound = the gathered rows read once and
    written once, and the ids."""
    import torch
    from raft_tpu_torch.ops import row_gather as rg

    lib = {ln["dtype"]: ln["ms"] for ln in lines
           if ln["impl"] == "index_select"}
    checks = []
    for dtype in ("bf16", "f32"):
        t = table.to(torch.bfloat16) if dtype == "bf16" else table
        for line in lines:
            if line["impl"] != "row_gather" or line["dtype"] != dtype:
                continue
            out = rg.row_gather(t, ids, line["rows"])
            ref, plain_ms = timed_once(lambda: rg.row_gather_plain(t, ids))
            assert torch.equal(out, ref), f"row_gather {dtype} differs"
            nbytes = 2 * out.numel() * out.element_size() + ids.numel() * 4
            bound_ms, bound_by = bound(nbytes, 0.0)
            label = (f"row_gather {dtype}: {ids.numel():,} of "
                     f"{t.shape[0]:,} x {t.shape[1]} rows, {line['rows']} "
                     f"rows a block")
            print(f"{label}: {line['ms']:.4f} ms ({line['gb_per_s']:.1f} "
                  f"GB/s gathered), index_select {lib[dtype]:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bit-equal, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
            checks.append({"shape": label, "max_abs_err": 0.0,
                           "ms": line["ms"], "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": lib[dtype]})
            del out, ref
    return checks


def cut_checks(x, c, timed):
    """Rows 12-13: each Kernel A cut against its plain version, tie-aware
    as Kernel A (``check_assignment``: dmin within τ, each label the plain
    one or at a tie; the count that differs is printed); mmargmin's label
    sum and uw's counts exact and uw's sums within 1e-5 · count · max|x|
    against the plain update from the cut's own labels, mxuonly's column
    sums within 1e-4 of the largest — with its time from the profiles'
    run (``timed``: cut -> (ms, source line, library ms)); bound: the
    product's bf16 operations, or x, the centroids and the outputs
    once."""
    import torch
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.profiles.kmeans_decomp_r5 import TILE

    xb = x.to(torch.bfloat16)
    n, dim = x.shape
    k = c.shape[0]
    flops = 2.0 * n * k * dim
    checks = []
    for cut, (ms, src, lib_ms) in timed.items():
        sums, counts, dmin, labels = ku.kmeans_pass_cut(xb, c, cut)
        (p_sums, p_counts, p_dmin, p_labels), plain_ms = timed_once(
            lambda: ku.kmeans_pass_cut_plain(xb, c, cut))
        assert (labels is None) == (p_labels is None)
        check = ku.check_assignment(xb, c, dmin, labels, p_dmin, p_labels)
        assert check.ok, f"kmeans_pass_cut {cut}: {check}"
        if labels is not None:
            p_sums, p_counts = ku.pass_cut_update_plain(xb, cut, labels, k)
        cerr = float((counts - p_counts).abs().max())
        if cut == "mxuonly":
            assert cerr <= 1e-4 * float(p_counts.abs().max()), (
                f"kmeans_pass_cut mxuonly: column sums differ by {cerr}")
        else:
            assert cerr == 0.0, f"kmeans_pass_cut {cut}: counts"
        serr = (sums - p_sums).abs()
        tol = 1e-5 * p_counts.clamp_min(0)[:, None] * float(
            xb.float().abs().max()) + 1e-6
        if cut in ("uw", "full"):
            assert bool((serr <= tol).all()), (
                f"kmeans_pass_cut {cut}: sums differ by {float(serr.max())}")
        err = max(float(serr.max()), cerr, check.dmin_err)
        nbytes = n * dim * 2 + k * dim * 2 + k * 4 + n * 4 + k * 4 + (
            k * dim * 4 + n * 4 if cut in ("uw", "full") else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        label = (f"kmeans_pass_cut {cut} ({src}): {n:,} x {dim} -> {k:,}, "
                 f"tile {TILE}")
        print(f"{label}: {ms:.3f} ms, plain {plain_ms:.1f} ms, max |dmin "
              f"err| {check.dmin_err} (tau {check.tau:.3e}), labels "
              f"differing {check.flips} (at ties), max |err| {err}, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it "
              f"reached), library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}",
              flush=True)
        checks.append({"shape": label, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms,
                       "tau": check.tau, "label_flips": check.flips})
        del sums, counts, dmin, labels, p_sums, p_counts, p_dmin, p_labels
    return checks


def profiles_path(dev, flagship, queries, flat_indexes):
    """The four profile entry points of the port at the JAX scripts' sizes
    (rows 10-13), launches zeroed before and read after: the F variants on
    the IVF-Flat phase's two indexes and G's raw scan on the flagship
    index; the row gather; the k-means cuts, base, uw and mxuonly.  Then
    each kernel variant against its plain version; returns the three
    kernels-line rows."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.profiles import gather_bench as gb
    from raft_tpu_torch.profiles import group_kernel_decomp_r5 as gkd
    from raft_tpu_torch.profiles import kmeans_decomp_r5 as kd
    from raft_tpu_torch.profiles import kmeans_kernel_r5 as kk

    def show(lines):
        for line in lines:
            print(json.dumps(line), flush=True)

    torch.cuda.synchronize()
    zero_launches()
    flat_lines = {}
    for (n_lists, n_probes), index in zip(PROFILE_FLAT, flat_indexes):
        flat_lines[n_lists] = gkd.run_on_index(index, queries, n_probes,
                                               PROFILE_KT, KERNEL_REPS)
        show(flat_lines[n_lists])
    g_args, g_kw = recon_raw_inputs(flagship, queries)
    g_ms = cuda_ms(lambda: ps.pair_scan_variant(*g_args, **g_kw),
                   KERNEL_REPS)
    table, ids = gb.inputs(device=dev)
    g_lines, match = gb.run(table, ids, GATHER_ROWS)
    show(g_lines)
    print("match:", match, flush=True)
    assert match, "row_gather: not bit-equal to index_select"
    x, c = kd.inputs(device=dev)
    kd_lines = kd.run(x, c)
    show(kd_lines)
    kk_lines, spot = kk.run(x, c)
    show(kk_lines + [spot])
    assert all(spot.values()), f"kmeans_kernel_r5 spot check: {spot}"
    launches = read_launches()
    print(f"profile launches: {json.dumps(launches)}", flush=True)
    for name in ("pair_scan_variant", "row_gather", "kmeans_pass_cut"):
        assert launches[name] > 0, f"profiles: {name} never launched"

    # F's own shape (nlist 4096) first, its raw gathering scan first of
    # all: the row's main entry is the split of Kernel F's time
    f_checks = []
    for (n_lists, n_probes), index in reversed(list(zip(PROFILE_FLAT,
                                                        flat_indexes))):
        lines = sorted((ln for ln in flat_lines[n_lists] if "gather" in ln),
                       key=lambda ln: (ln["extract"], not ln["gather"]))
        f_checks += flat_variant_checks(index, queries, n_probes, lines)
    g_check = recon_raw_check(flagship, g_args, g_kw, g_ms)
    j_checks = gather_checks(table, ids, g_lines)
    del table, ids
    yard = kd_lines[-1]["ms"]
    timed = {ln["variant"]: (ln["ms"], "profiles/kmeans_decomp_r5.py:67",
                             yard if ln["variant"] == "mm" else None)
             for ln in kd_lines if "variant" in ln}
    timed.update({ln["variant"]: (ln["ms"], "profiles/kmeans_kernel_r5.py:77",
                                  None)
                  for ln in kk_lines if ln["variant"] != "base"})
    a_checks = cut_checks(x, c, timed)
    del x, c
    torch.cuda.empty_cache()
    return [
        variant_row("pair_scan_variant", "raft_tpu_torch/csrc/pair_scan.cu",
                    "profiles/group_kernel_decomp_r5.py:50",
                    launches["pair_scan_variant"], f_checks + [g_check]),
        variant_row("row_gather", "raft_tpu_torch/csrc/row_gather.cu",
                    "profiles/gather_bench.py:70", launches["row_gather"],
                    j_checks),
        variant_row("kmeans_pass_cut", "raft_tpu_torch/csrc/kmeans_update.cu",
                    "profiles/kmeans_decomp_r5.py:67",
                    launches["kmeans_pass_cut"], a_checks)]


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
        _, found = refine(res, db, queries, cand, K)
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
          f"{recall:.4f}; launches {json.dumps(launches)}; fused "
          f"fallbacks {fallbacks}", flush=True)
    assert launches[kernel] > 0, f"{label}: {kernel} never launched"
    return {"label": label, "recall": recall, "launches": launches,
            "batch_ms": med, "cand": cand, "fallbacks": fallbacks}


def same_build_routes(label, module, name, walked, kernels, search,
                      truth, gate=True):
    """Recall@10 of one batch on one build (``search()`` gives its found
    ids) through the list-major route and through the query-major scan
    ``walked`` swapped in for ``module.name``, the search's scan: what
    the routes' own rounding does to recall, with the build held fixed.
    ``kernels`` (list-major wrapper, query-major wrapper): their launches
    say that each route ran alone.  Where ``gate``, the two must agree
    within ROUTE_RECALL_GAP; else the comparison is printed only."""
    listed = getattr(module, name)
    recall = {}
    for route in ("list-major", "query-major"):
        before = [k.launches for k in kernels]
        if route == "query-major":
            setattr(module, name, walked)
        try:
            found = search()
        finally:
            setattr(module, name, listed)
        ran = tuple(k.launches > b for k, b in zip(kernels, before))
        assert ran == (route == "list-major", route == "query-major"), (
            f"{label}: the {route} route did not run alone")
        hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
        recall[route] = float(hits) / truth.numel()
    print(f"{label}, one build, recall@10 by route: "
          f"{json.dumps(recall)}", flush=True)
    gap = abs(recall["list-major"] - recall["query-major"])
    assert gap <= ROUTE_RECALL_GAP or not gate, (
        f"{label}: the routes' recall@10 differ by {gap}")
    return recall


def pq_same_build_routes(res, index, db, queries, truth, label, sp, fused):
    """:func:`same_build_routes` for one IVF-PQ search + refine batch:
    Kernel B's ``scan_query_major`` swapped in for the search's fused scan
    when ``fused``, else G's ``recon_scan_query_major`` for its recon
    scan; pass 1 (``list_scan``) is the list-major route of both."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    name, walked = (("ivf_pq_scan_fused", pgs.scan_query_major) if fused
                    else ("ivf_pq_scan_recon", ps.recon_scan_query_major))
    return same_build_routes(
        label, ivf_pq, name, walked, (pgs.list_scan, walked),
        lambda: refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)[1], truth)


def codes_same_build_routes(res, index, db, queries, truth, label, sp,
                            fused):
    """:func:`same_build_routes` for one IVF-PQ search + refine batch over
    the codes: Kernel C's ``codes_fused_query_major`` swapped in for the
    search's fused codes scan when ``fused``, else D's
    ``codes_scan_query_major``; ``code_list_scan`` is the list-major route
    of both.  Printed only, gated on nothing."""
    from raft_tpu_torch.neighbors import refine
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_code_scan as pcs

    name, walked = (("ivf_pq_scan_codes_fused", pcs.codes_fused_query_major)
                    if fused else ("ivf_pq_scan_codes",
                                   pcs.codes_scan_query_major))
    return same_build_routes(
        label, pcs, name, walked, (pcs.code_list_scan, walked),
        lambda: refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)[1], truth, gate=False)


def recon8_same_build_routes(res, index, db, queries, truth, label, sp):
    """:func:`same_build_routes` for one IVF-PQ recon8 search + refine
    batch: Kernel E's ``recon8_scan_query_major`` swapped in for the
    search's int8 scan, ``recon8_list_scan`` its list-major route; the
    two must agree within ROUTE_RECALL_GAP."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pq_code_scan as pcs

    walked = pcs.recon8_scan_query_major
    return same_build_routes(
        label, pcs, "ivf_pq_scan_recon8", walked,
        (pcs.recon8_list_scan, walked),
        lambda: refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)[1], truth)


def flagship_code_checks(index, queries):
    """Kernels C (kt 20 and kt 4, k 20) and D (kt 4) on the flagship
    index's codes (rot 128, pq_dim 64, 8 bits: the list-major codes
    pass's tightest shared-memory shape) against their plain versions on
    its batch (5000 queries x 96 probes).  Returns C's and D's
    ``also_checked`` entries (the main path runs neither: 0 launches)."""
    from raft_tpu_torch.neighbors import ivf_pq

    ivf_pq._with_code_rsq(index)
    c20 = check_code_kernels(index, queries, K_SEARCH, ("C",))[0]
    c4, d4 = check_code_kernels(index, queries, DEEP_KT, ("C", "D"))
    shape = (f"flagship codes (list-major): {N_QUERIES:,} queries x "
             f"{N_PROBES} probes, capacity {index.capacity:,}, rot "
             f"{index.rot_dim}, pq_dim {index.pq_dim}, {index.pq_bits} bits")
    return ([at_shape(c20, f"{shape}, k {K_SEARCH}, kt {K_SEARCH}", 0),
             at_shape(c4, f"{shape}, k {K_SEARCH}, kt {DEEP_KT}", 0)],
            [at_shape(d4, f"{shape}, kt {DEEP_KT}", 0)])


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
        h_tf32_launches(build_launches))
    del train
    book = codebook_h_check(index, db, "deep")
    hs_deep = at_shape(book, book["shape"],
                       build_launches["fused_l2_nn_small_dim"])
    torch.cuda.empty_cache()

    def sp(**kw):
        return ivf_pq.SearchParams(n_probes=N_PROBES, **kw)

    kt4 = dict(per_probe_topk=DEEP_KT)
    runs = {}
    for label, params_, kernel in (
            ("auto", sp(), "merge_pairs"),
            ("fused", sp(scan_mode="fused", **kt4), "code_list_scan"),
            ("codes", sp(scan_mode="codes", **kt4), "code_list_scan"),
            ("recon8", sp(scan_mode="recon8", **kt4), "recon8_list_scan"),
            ("recon", sp(scan_mode="recon", **kt4), "list_scan")):
        runs[label] = search_mode(res, index, db, queries, truth,
                                  f"deep {label}", params_, kernel)
        runs[label]["params"] = params_
    # C and D at kt 4 run the list-major codes pass (C with pass 2), never
    # the query-major kernels
    assert runs["fused"]["launches"]["merge_pairs"] > 0, (
        "deep fused: pass 2 never launched")
    for label in ("fused", "codes"):
        got = runs[label]["launches"]
        assert got["codes_fused_query_major"] == got[
            "codes_scan_query_major"] == 0, (
            f"deep {label}: a query-major codes kernel ran")
        assert runs[label]["fallbacks"] == 0, f"deep {label}: C refused"
    # E at kt 4 runs its list-major pass, never the query-major kernel
    assert runs["recon8"]["launches"]["recon8_scan_query_major"] == 0, (
        "deep recon8: the query-major kernel ran")
    agree = float((runs["fused"]["cand"] == runs["codes"]["cand"]).float()
                  .mean())
    print(f"deep fused vs codes: candidate ids equal at {agree:.5f} of "
          f"ranks", flush=True)
    assert runs["auto"]["recall"] >= 0.90, (
        f"deep auto recall@10 {runs['auto']['recall']} below 0.90")
    assert runs["auto"]["fallbacks"] == 0, "deep auto: Kernel B refused"
    assert runs["auto"]["launches"]["list_scan"] > 0, (
        "deep auto: pass 1 never launched")
    pq_same_build_routes(res, index, db, queries, truth, "deep auto", sp(),
                         True)
    pq_same_build_routes(res, index, db, queries, truth, "deep recon kt 4",
                         runs["recon"]["params"], False)
    for label in ("fused", "codes"):
        codes_same_build_routes(res, index, db, queries, truth,
                                f"deep {label} kt 4", runs[label]["params"],
                                label == "fused")
    recon8_same_build_routes(res, index, db, queries, truth,
                             "deep recon8 kt 4", runs["recon8"]["params"])
    for label in ("fused", "codes", "recon8", "recon"):
        assert runs[label]["recall"] >= 0.80, (
            f"deep {label} recall@10 {runs[label]['recall']} below 0.80")
    assert agree >= 0.99, f"deep fused and codes ids agree at {agree}"
    print(f"deep peak device memory through the searches: {peak_gb():.2f} "
          f"GB", flush=True)

    rows = check_code_kernels(index, queries, DEEP_KT)
    rows[0]["launches"] = runs["fused"]["launches"]["merge_pairs"]
    rows[0]["pass1_launches"] = runs["fused"]["launches"]["code_list_scan"]
    rows[1]["launches"] = runs["codes"]["launches"]["code_list_scan"]
    rows[2]["launches"] = runs["recon8"]["launches"]["recon8_list_scan"]
    for row in rows:
        row["also_checked"] = []
    codes_bit_equal(index, queries, DEEP_KT)
    recon8_bit_equal(index, queries, DEEP_KT)
    walked = check_codes_query_major(index, queries, LARGE_KT_QUERIES)
    for row, entry in zip(rows, walked):
        row["also_checked"].append(entry)
    b_deep = at_shape(
        check_kernel_b(index, queries),
        f"deep: {N_QUERIES:,} queries x {N_PROBES} probes, k {K_SEARCH}, kt "
        f"{K_SEARCH}, capacity {index.capacity:,}, rot {index.rot_dim}",
        runs["auto"]["launches"]["merge_pairs"])
    g_deep = at_shape(
        check_kernel_g(index, queries, DEEP_KT),
        f"deep recon: {N_QUERIES:,} queries x {N_PROBES} probes, kt "
        f"{DEEP_KT}, capacity {index.capacity:,}, rot {index.rot_dim}",
        runs["recon"]["launches"]["list_scan"])
    ratio = rows[2]["ms"] / g_deep["ms"]
    print(f"deep kt {DEEP_KT}: E {rows[2]['ms']:.3f} ms against G "
          f"{g_deep['ms']:.3f} ms in this run ({ratio:.2f}x)", flush=True)

    for label, run in runs.items():
        device_breakdown(f"deep {label} search+refine batch",
                         lambda: refine(res, db, queries, ivf_pq.search(
                             res, run["params"], index, queries,
                             K_SEARCH)[1], K))

    # the memory-lean deployment: no recon cache, so auto -> codes, whose
    # Kernel C runs at kt = k
    index.list_recon = index.list_recon_sq = index.list_code_rsq = None
    torch.cuda.empty_cache()
    lean = search_mode(res, index, db, queries, truth, "deep auto without a "
                       "recon cache", sp(), "code_list_scan")
    assert lean["recall"] >= 0.90, (
        f"deep auto (no recon cache) recall@10 {lean['recall']} below 0.90")
    assert lean["launches"]["merge_pairs"] > 0 and lean["fallbacks"] == 0, (
        "deep auto without a recon cache: not the list-major C")
    row_c = check_code_kernels(index, queries, K_SEARCH, ("C",))[0]
    rows[0]["also_checked"].append(at_shape(
        row_c, f"deep, no recon cache: {N_QUERIES:,} queries x {N_PROBES} "
        f"probes, k {K_SEARCH}, kt {K_SEARCH}, capacity {index.capacity:,}",
        lean["launches"]["merge_pairs"]))
    print(f"deep peak device memory, plain versions included: "
          f"{peak_gb():.2f} GB", flush=True)
    return rows, a_deep, b_deep, g_deep, h_deep, hs_deep


# CAGRA (conf/sift-like-1m.json raft_cagra.deg32)
CAGRA_DEGREE, CAGRA_INTERMEDIATE = 32, 64
CAGRA_POINTS = ((24, 1), (32, 1), (64, 2), (128, 2))
CAGRA_BUCKETS, CAGRA_BUCKET_POINTS, BUCKET_REPS = (1, 8, 64), ((32, 1),
                                                                (64, 2)), 20
# the exact-merge hop call whose inputs are kept for Kernel I's hop check
# (a middle chunk)
CAPTURE_CALL = 4
# the hop of the plain walk whose inputs hold Kernel I's hop kernel at the
# search shape (a middle hop: some of the buffer visited, some not)
CHECK_HOP = 4
# the walk's shapes held to the plain walk, (nq, itopk, search_width, deg)
# at most: the search batch, a serving bucket, a build self-walk chunk
WALK_CHECKS = (((N_QUERIES, 64, 2, CAGRA_DEGREE), "search"),
               ((64, 32, 1, CAGRA_DEGREE), "serving bucket"),
               ((8192, 96, 1, CAGRA_INTERMEDIATE), "build self-walk"))


class _Swap:
    """Stands in for one of ``neighbors.cagra``'s handles on an ops module
    (``attr``) inside a ``with`` block; other names pass through."""

    attr = ""

    def __init__(self, real):
        from raft_tpu_torch.neighbors import cagra

        self.cagra, self.real = cagra, real
        self.calls, self.kept = {}, {}

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __enter__(self):
        setattr(self.cagra, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.cagra, self.attr, self.real)


class HopCapture(_Swap):
    """``neighbors.cagra``'s hop handle while a CAGRA run goes on (only the
    build's exact merge calls it): every hop goes to the real wrapper
    (which counts its launches as always), and the inputs of the
    ``CAPTURE_CALL``-th hop of each (nq, itopk, wd, pdim) shape are kept
    for the kernel check."""

    attr = "_hop"

    def __init__(self):
        from raft_tpu_torch.ops import cagra_hop as chop

        super().__init__(chop)

    def cagra_hop(self, *args, ip_metric):
        nq, wd, pdim = args[2].shape
        key = (nq, args[5].shape[1], wd, pdim)
        self.calls[key] = self.calls.get(key, 0) + 1
        if self.calls[key] == CAPTURE_CALL:
            self.kept[key] = (args, ip_metric)
        return self.real.cagra_hop(*args, ip_metric=ip_metric)


class WalkCapture(_Swap):
    """``neighbors.cagra``'s walk handle while a CAGRA run goes on: every
    walk goes to the real wrapper (one launch each, counted as always), and
    the first walk's inputs of each (nq, itopk, search_width, deg) shape
    are kept for the walk check."""

    attr = "_walk"

    def __init__(self):
        from raft_tpu_torch.ops import cagra_walk as cw

        super().__init__(cw)

    def cagra_walk(self, *args, **kw):
        key = (args[3].shape[0], args[3].shape[1], kw["search_width"],
               kw["deg"])
        self.calls[key] = self.calls.get(key, 0) + 1
        self.kept.setdefault(key, (args, dict(kw)))
        return self.real.cagra_walk(*args, **kw)


def hop_loop(qp_t, q_sq, table, buf_d, buf_i, visited, *, deg,
             search_width, max_iterations, ip_metric, quant=False,
             scales=None, exit_every=8, return_hops=False):
    """The yardstick: the per-hop loop the walk kernel replaced, kept here
    only — per hop ``select_parents`` → ``expand`` → Kernel I's hop kernel
    (``cagra_hop``), the all(visited) exit checked every ``exit_every``
    hops (a host sync).  It returns what the walk returns."""
    from raft_tpu_torch.ops import cagra_hop as chop
    from raft_tpu_torch.ops import cagra_walk as cw

    assert not return_hops
    pdim = qp_t.shape[1]
    for it in range(max_iterations):
        if exit_every and it % exit_every == 0 and it and bool(visited.all()):
            break
        sel, ok, visited = cw.select_parents(buf_d, buf_i, visited,
                                             search_width)
        nb_p, nb_sq, nb_id = cw.expand(table, sel, ok, deg, pdim, quant,
                                       scales)
        buf_d, buf_i, visited = chop.cagra_hop(
            qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited,
            ip_metric=ip_metric)
    return buf_d, buf_i, visited


class LoopWalk(_Swap):
    """``neighbors.cagra``'s walk handle routed to :func:`hop_loop`, so
    ``cagra.search`` runs as it did before the walk kernel (the yardstick
    of the search points and the serving buckets)."""

    attr = "_walk"

    def __init__(self):
        from raft_tpu_torch.ops import cagra_walk as cw

        super().__init__(cw)

    def cagra_walk(self, *args, **kw):
        return hop_loop(*args, **kw)


def walk_bound(args, kw, hops):
    """(ms, by, bytes) of a walk: the query side and the buffer read once,
    the buffer written once, each run hop's fat rows read once (``hops``:
    the hops the queries ran); 2·pdim fp32 operations per candidate."""
    from raft_tpu_torch.ops import cagra_walk as cw

    qp_t, buf_d = args[0], args[3]
    nq, itopk = buf_d.shape
    pdim = qp_t.shape[1]
    rows = kw["search_width"] * kw["deg"]
    nbytes = (nq * (pdim * 2 + 4) + 2 * nq * itopk * 9
              + hops * rows * cw.walk_unit(pdim, kw["quant"]) * 2)
    ms, by = bound(nbytes, 2.0 * hops * rows * pdim, FP32_FLOP_PER_S)
    return ms, by, nbytes


def check_kernel_walk(args, kw, shape):
    """The walk kernel vs the plain walk on one captured walk: keys, ids,
    visited flags and each query's hop count equal (``torch.equal``); its
    CUDA-event ms and device ms (profiler), the plain walk's ms, the bound
    (walk_bound over the hops the queries ran) and the yardstick, the
    per-hop loop of Kernel I's hop kernel (:func:`hop_loop`) on the same
    inputs.  No single PyTorch call walks a graph."""
    import torch
    from raft_tpu_torch.ops import cagra_walk as cw

    kd, ki, kv, kh = cw.cagra_walk(*args, return_hops=True, **kw)
    (pd, pi, pv, ph), plain_ms = timed_once(
        lambda: cw.cagra_walk_plain(*args, return_hops=True, **kw))
    for what, a, b in (("keys", kd, pd), ("ids", ki, pi),
                       ("visited flags", kv, pv), ("hop counts", kh, ph)):
        assert torch.equal(a, b), f"cagra_walk at {shape}: {what} differ"
    fin = torch.isfinite(pd)
    err = float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0

    def walk():
        return cw.cagra_walk(*args, **kw)

    ms = cuda_ms(walk, KERNEL_REPS * 4)
    dev_ms = device_ms(walk, KERNEL_REPS * 4, "walk_kernel")
    loop_ms = cuda_ms(lambda: hop_loop(*args, **kw), KERNEL_REPS)
    hops = int(kh.sum())
    bound_ms, bound_by, nbytes = walk_bound(args, kw, hops)
    print(f"cagra_walk at {shape}: keys, ids, visited flags and hop counts "
          f"equal to the plain walk; {hops:,} hops run "
          f"({hops / kh.numel():.2f} a query, at most {int(kh.max())} of "
          f"{kw['max_iterations']}); "
          f"{ms:.4f} ms (CUDA events; device {dev_ms:.4f}), plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.2f} MB); yardstick (per-hop loop on Kernel I's "
          f"hop kernel) {loop_ms:.3f} ms = {loop_ms / ms:.1f}x the walk",
          flush=True)
    return {"name": "cagra_walk", "route": "cuda",
            "source": "raft_tpu_torch/csrc/cagra_walk.cu",
            "replaces": "raft_tpu/ops/cagra_hop_pallas.py:257",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "yardstick_loop_ms": loop_ms,
            "walk_hops": hops}


def check_kernel_i(args, ip_metric, shape):
    """Kernel I's hop kernel vs plain on one hop: the same finite slots,
    keys within 1e-5 relative, ids equal except at key ties, visited flags
    equal where ids are; its device time (profiler; the CUDA-event time of
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


def plain_hop_inputs(args, kw, hop):
    """The inputs of the plain walk's ``hop``-th hop on a captured walk:
    ``hop`` - 1 hops of the plain walk, then that hop's parents and their
    decoded rows (so the hop check's buffer keeps the walk's history)."""
    from raft_tpu_torch.ops import cagra_walk as cw

    kw = dict(kw, max_iterations=hop - 1, exit_every=0)
    buf_d, buf_i, vis = cw.cagra_walk_plain(*args, **kw)
    sel, ok, vis = cw.select_parents(buf_d, buf_i, vis, kw["search_width"])
    nb_p, nb_sq, nb_id = cw.expand(args[2], sel, ok, kw["deg"],
                                   args[0].shape[1], kw["quant"],
                                   kw["scales"])
    return (args[0], args[1], nb_p, nb_sq, nb_id, buf_d, buf_i, vis)


def walk_format(index):
    (pdim, quant), = list(index._walk_tables)
    return f"pdim {pdim}, {'int8' if quant else 'bf16'} table"


def timed_searches(fn, reps):
    """``reps`` calls of ``fn``, each ending in a synchronise: their wall
    ms and the last result."""
    import torch

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, out


def median(ms):
    return sorted(ms)[len(ms) // 2]


def walk_against_loop(label, fn, reps):
    """``fn`` (a search) with the walk kernel and with the yardstick loop
    (:class:`LoopWalk`), in turns, ``reps`` times each: both routes give
    the same ids and distances bit for bit; returns the medians."""
    import torch

    ms = {"walk": [], "loop": []}
    outs = {}
    for _ in range(reps):
        for route in ("walk", "loop"):
            if route == "loop":
                with LoopWalk():
                    t, outs[route] = timed_searches(fn, 1)
            else:
                t, outs[route] = timed_searches(fn, 1)
            ms[route] += t
    for a, b in zip(outs["walk"], outs["loop"]):
        assert torch.equal(a, b), f"{label}: walk kernel and loop differ"
    med = {route: median(v) for route, v in ms.items()}
    print(f"{label}: walk kernel {', '.join(f'{m:.2f}' for m in ms['walk'])}"
          f" ms, yardstick loop {', '.join(f'{m:.2f}' for m in ms['loop'])}"
          f" ms; medians {med['walk']:.3f} / {med['loop']:.3f} ms = "
          f"{med['loop'] / med['walk']:.2f}x; results equal", flush=True)
    return med


def cagra_path(db, queries, truth):
    """``raft_cagra.deg32`` on the flagship's rows: ``cagra.build``
    (seconds, stages, build pdim, walk / hop / H / A launches), the conf's
    four search points at batch 5000, k 10 (first batch, warm ms, QPS,
    recall@10, walk format, walk launches: one per search), serving
    buckets of 1 / 8 / 64 queries; then each point and bucket against the
    yardstick loop in turns, the build's self-walk against the loop's
    prediction, one batch under the profiler through each route, the walk
    kernel vs the plain walk on walks captured from the run, and Kernel
    I's hop kernel vs plain at the exact merge and at the search's fourth
    hop.  Returns the walk's and the hop kernel's kernels rows, and the
    index (for the persistence checks)."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra

    res = DeviceResources(seed=0)
    params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                               intermediate_graph_degree=CAGRA_INTERMEDIATE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with HopCapture() as cap, WalkCapture() as wcap:
        t0 = time.perf_counter()
        index = cagra.build(res, params, db)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = read_launches()
        stages = dict(cagra.build.stage_seconds)
        print(f"CAGRA build (graph_degree {CAGRA_DEGREE}, intermediate "
              f"{CAGRA_INTERMEDIATE}): {build_s:.2f} s; stages (s): "
              f"{json.dumps(stages)}; build pdim "
              f"{cagra.build.build_pdim}; launches: walk "
              f"{build_launches['cagra_walk']}, hop "
              f"{build_launches['cagra_hop']}, H "
              f"{build_launches['fused_l2_nn']}, A "
              f"{build_launches['kmeans_assign_update']}; walk shapes (nq, "
              f"itopk, width, deg) x calls: "
              f"{ {str(k): v for k, v in wcap.calls.items()} }; hop shapes "
              f"(nq, itopk, wd, pdim) x calls: "
              f"{ {str(k): v for k, v in cap.calls.items()} }; peak device "
              f"memory {peak_gb():.2f} GB", flush=True)
        for name in ("cagra_walk", "cagra_hop", "fused_l2_nn"):
            assert build_launches[name] > 0, f"CAGRA build: {name} never " \
                "launched"
        g = index.graph
        assert g.shape == (N_DB, CAGRA_DEGREE) and int(g.min()) >= 0 and \
            int(g.max()) < N_DB, "CAGRA build: bad graph"

        results = {}
        for itopk, width in CAGRA_POINTS:
            sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cagra.search(res, sp, index, queries, K)
            torch.cuda.synchronize()
            first_ms = 1e3 * (time.perf_counter() - t0)
            ms, (_, found) = timed_searches(
                lambda: cagra.search(res, sp, index, queries, K),
                SEARCH_REPS)
            after = read_launches()
            walks = after["cagra_walk"] - before["cagra_walk"]
            assert walks == 1 + SEARCH_REPS and \
                after["cagra_hop"] == before["cagra_hop"], (
                    f"CAGRA itopk {itopk}: {walks} walk launches, "
                    f"{after['cagra_hop'] - before['cagra_hop']} hop "
                    f"launches in {1 + SEARCH_REPS} searches")
            hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
            recall = float(hits) / truth.numel()
            results[(itopk, width)] = recall
            print(f"CAGRA itopk {itopk} width {width}: first batch "
                  f"{first_ms:.2f} ms (walk cache included on the first "
                  f"point); {', '.join(f'{m:.2f}' for m in ms)} ms per batch "
                  f"of {N_QUERIES}; QPS {N_QUERIES / (median(ms) / 1e3):.0f} "
                  f"(median); recall@10 {recall:.4f}; {walk_format(index)}; "
                  f"walk launches {walks / (1 + SEARCH_REPS):.0f} a search, "
                  f"hop launches 0", flush=True)
        for point in ((64, 2), (128, 2)):
            assert results[point] >= 0.90, (
                f"CAGRA recall@10 {results[point]} below 0.90 at itopk "
                f"{point[0]}, width {point[1]}")

        bucket_before = read_launches()["cagra_walk"]
        for itopk, width in CAGRA_BUCKET_POINTS:
            sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
            for nq in CAGRA_BUCKETS:
                q = queries[:nq]
                cagra.search(res, sp, index, q, K)
                ms, _ = timed_searches(
                    lambda: cagra.search(res, sp, index, q, K), BUCKET_REPS)
                print(f"CAGRA bucket of {nq} at itopk {itopk} width {width}: "
                      f"median {median(ms):.3f} ms per batch (min "
                      f"{min(ms):.3f}, max {max(ms):.3f})", flush=True)
        bucket_launches = read_launches()["cagra_walk"] - bucket_before
    launches = read_launches()
    print(f"CAGRA launches (build + searches + buckets): "
          f"{json.dumps(launches)}; peak device memory {peak_gb():.2f} GB",
          flush=True)

    # the yardstick: the per-hop loop on Kernel I's hop kernel, in turns
    for itopk, width in CAGRA_POINTS:
        sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
        med = walk_against_loop(
            f"CAGRA itopk {itopk} width {width}, batch of {N_QUERIES}",
            lambda: cagra.search(res, sp, index, queries, K), SEARCH_REPS)
        print(f"CAGRA itopk {itopk} width {width}: QPS walk kernel "
              f"{N_QUERIES / (med['walk'] / 1e3):.0f}, yardstick loop "
              f"{N_QUERIES / (med['loop'] / 1e3):.0f}", flush=True)
    for itopk, width in CAGRA_BUCKET_POINTS:
        sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
        for nq in CAGRA_BUCKETS:
            q = queries[:nq]
            walk_against_loop(f"CAGRA bucket of {nq} at itopk {itopk} width "
                              f"{width}",
                              lambda: cagra.search(res, sp, index, q, K),
                              BUCKET_REPS)

    # the build's self-walk: its chunks' walks against the loop's time
    sw = [k for k in wcap.calls if k[1:] == WALK_CHECKS[2][0][1:]]
    n_walks = sum(wcap.calls[k] for k in sw)
    sw_args, sw_kw = wcap.kept[max(sw)]
    walk_ms = cuda_ms(lambda: cagra._walk.cagra_walk(*sw_args, **sw_kw),
                      KERNEL_REPS)
    loop_ms = cuda_ms(lambda: hop_loop(*sw_args, **sw_kw), KERNEL_REPS)
    walk_stage_s = sum(v for k, v in stages.items()
                       if k.startswith("walk_refine"))
    print(f"CAGRA build self-walk: {n_walks} chunk walks (chunk "
          f"{max(sw)[0]:,}); a chunk {walk_ms:.3f} ms through the walk "
          f"kernel, {loop_ms:.3f} ms through the yardstick loop; predicted "
          f"self-walk seconds {n_walks * walk_ms / 1e3:.3f} (kernel) / "
          f"{n_walks * loop_ms / 1e3:.3f} (loop); the walk_refine stages "
          f"took {walk_stage_s:.3f} s", flush=True)

    sp = cagra.SearchParams(itopk_size=64, search_width=2)
    device_breakdown("CAGRA search batch (itopk 64, width 2)",
                     lambda: cagra.search(res, sp, index, queries, K))
    with LoopWalk():
        device_breakdown("CAGRA search batch (itopk 64, width 2) through "
                         "the yardstick loop",
                         lambda: cagra.search(res, sp, index, queries, K))
    policy_cost(f"CAGRA search, itopk 64 width 2 (batch of {N_QUERIES})",
                lambda: cagra.search(res, sp, index, queries, K))

    rows = []
    for (nq, itopk, width, deg), what in WALK_CHECKS:
        keys = [k for k in wcap.kept if k[1:] == (itopk, width, deg)
                and k[0] <= nq]
        key = max(keys)
        args, kw = wcap.kept[key]
        rows.append(check_kernel_walk(
            args, kw, f"{what}: {key} (nq, itopk, width, deg)"))
    row_walk = dict(rows[0], launches=launches["cagra_walk"])
    row_walk["also_checked"] = [
        at_shape(rows[1], "serving bucket: 64 queries, itopk 32, width 1",
                 bucket_launches),
        at_shape(rows[2], "build self-walk chunk: 8,192 nodes, itopk 96, "
                 "width 1, deg 64", build_launches["cagra_walk"])]

    merge = [k for k in cap.kept if k[1] == CAGRA_INTERMEDIATE + 1]
    key = max(merge)
    args, ipm = cap.kept[key]
    row_i = check_kernel_i(args, ipm, f"build exact merge: {key} (nq, "
                           f"itopk, wd, pdim)")
    row_i["launches"] = launches["cagra_hop"]
    s_args, s_kw = wcap.kept[WALK_CHECKS[0][0]]
    shape = (f"search hop {CHECK_HOP} of the plain walk: {N_QUERIES:,} "
             f"queries, itopk 64, wd {2 * CAGRA_DEGREE}")
    row_i["also_checked"] = [at_shape(check_kernel_i(
        plain_hop_inputs(s_args, s_kw, CHECK_HOP), s_kw["ip_metric"], shape),
        shape, 0)]
    del cap, wcap
    torch.cuda.empty_cache()
    return row_walk, row_i, index


# ---------------------------------------------------------------------------
# persistence at full width
# ---------------------------------------------------------------------------

# the flagship's recall@10 over the recorded builds (PERF.md §7)
FLAGSHIP_RECALL = (0.9769, 0.9786)
CAGRA_PERSIST_POINT = (64, 2)
# the seed of the fresh handles whose first search draws a CAGRA entry set
CAGRA_ENTRY_SEED = 11


class CheckpointCalls:
    """Counts ``CheckpointManager.load`` / ``.save`` calls while active
    (the port has no observability registry to count them)."""

    def __enter__(self):
        from raft_tpu_torch.resilience import CheckpointManager

        self.calls = {"load": 0, "save": 0}
        self._orig = {n: getattr(CheckpointManager, n) for n in self.calls}
        for name, orig in self._orig.items():
            def spy(mgr, *a, _orig=orig, _name=name, **kw):
                self.calls[_name] += 1
                return _orig(mgr, *a, **kw)
            setattr(CheckpointManager, name, spy)
        return self

    def __exit__(self, *exc):
        from raft_tpu_torch.resilience import CheckpointManager

        for name, orig in self._orig.items():
            setattr(CheckpointManager, name, orig)


def timed_s(fn):
    """``(fn(), s)``: one call's wall seconds, its CUDA work included."""
    (ms,), out = timed_searches(fn, 1)
    return out, ms / 1e3


def save_and_load(module, res, index, path, label, **load_kw):
    """``module.save`` then ``module.load`` of ``index`` through ``path``:
    prints the file's bytes and both times; returns the loaded index and
    the numbers."""
    import os

    _, save_s = timed_s(lambda: module.save(res, path, index))
    loaded, load_s = timed_s(lambda: module.load(res, path, **load_kw))
    nbytes = os.path.getsize(path)
    print(f"{label}: file {nbytes:,} bytes; save {save_s:.3f} s "
          f"({nbytes / save_s / 1e9:.2f} GB/s); load {load_s:.3f} s "
          f"({nbytes / load_s / 1e9:.2f} GB/s)", flush=True)
    return loaded, {"bytes": nbytes, "save_s": save_s, "load_s": load_s}


def same_results(label, ref, ours, ref_again=None):
    """Ids equal and distances bit-equal; where two searches of the
    in-memory index already differ (``ref_again``), print that and hold
    the loaded index's result to the ids only."""
    import torch

    stable = ref_again is None or (torch.equal(ref[0], ref_again[0])
                                   and torch.equal(ref[1], ref_again[1]))
    ids = torch.equal(ours[1], ref[1])
    dist = torch.equal(ours[0], ref[0])
    repeat = ("" if ref_again is None else "two searches of the in-memory "
              f"index {'agree bit for bit' if stable else 'DIFFER'}; ")
    print(f"{label}: {repeat}loaded index against the in-memory one: ids "
          f"{'equal' if ids else 'DIFFER'}, distances "
          f"{'bit-equal' if dist else 'differ'}", flush=True)
    assert ids and (dist or not stable), f"{label}: loaded index differs"


def recall_at(found, truth):
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    return float(hits) / truth.numel()


def persistence_path(res, index, flat, db, queries, truth, params, sp):
    """Phase 11 on the indexes the script built: the flagship IVF-PQ and
    IVF-Flat 4096 saved, loaded on the card and searched against the
    in-memory index (Kernel B's passes / Kernel F's list-major pass
    launched on the loaded index), a flipped byte and a truncated copy of
    the flagship file refused, and the checkpointed flagship build
    (interrupted at its first sync point, resumed from ``kmeans``, then
    from the complete checkpoint).  Returns the numbers."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.core.interruptible import InterruptedException
    from raft_tpu_torch.core.serialize import CorruptIndexError
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, refine
    from raft_tpu_torch.resilience import CheckpointManager, faults

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        # flagship: save -> load -> the phase-4 batch
        path = os.path.join(tmp, "flagship.ivf_pq")
        loaded, out["flagship"] = save_and_load(
            ivf_pq, res, index, path, "flagship IVF-PQ")
        _, recon_s = timed_s(lambda: ivf_pq._with_recon(dataclasses.replace(
            loaded, list_recon=None, list_recon_sq=None)))
        out["flagship"]["recon_s"] = recon_s
        print(f"flagship IVF-PQ: of the load, the recon cache's re-decode "
              f"takes {recon_s:.3f} s (timed apart)", flush=True)
        batch = lambda ix: refine(res, db, queries, ivf_pq.search(  # noqa
            res, sp, ix, queries, K_SEARCH)[1], K)
        ref, ref_again = batch(index), batch(index)
        zero_launches()
        ours = batch(loaded)
        launches = read_launches()
        same_results("flagship IVF-PQ search+refine", ref, ours, ref_again)
        print(f"flagship IVF-PQ loaded-index launches: list_scan "
              f"{launches['list_scan']}, merge_pairs "
              f"{launches['merge_pairs']}", flush=True)
        assert launches["list_scan"] > 0 and launches["merge_pairs"] > 0, \
            "Kernel B never launched on the loaded flagship index"
        del loaded

        # corruption: one flipped byte, then a truncated copy
        with open(path, "rb") as f:
            raw = f.read()
        flipped = bytearray(raw)
        flipped[len(raw) // 2] ^= 0x5A
        for label, data in (("one byte flipped", bytes(flipped)),
                            ("truncated to half", raw[:len(raw) // 2])):
            bad = os.path.join(tmp, "bad.ivf_pq")
            with open(bad, "wb") as f:
                f.write(data)
            try:
                ivf_pq.load(res, bad)
            except CorruptIndexError as e:
                print(f"corruption ({label}): load raised "
                      f"CorruptIndexError: {str(e)[:100]}", flush=True)
            else:
                raise AssertionError(f"corruption ({label}) loaded")
        del raw, flipped, data
        os.remove(path)

        # IVF-Flat nlist 4096: save -> load -> n_probes 64, k 10
        path = os.path.join(tmp, "flat4096.ivf_flat")
        loaded, out["ivf_flat"] = save_and_load(
            ivf_flat, res, flat, path, "IVF-Flat nlist 4096")
        fsp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
        fsearch = lambda ix: ivf_flat.search(res, fsp, ix, queries, K)  # noqa
        ref, ref_again = fsearch(flat), fsearch(flat)
        zero_launches()
        ours = fsearch(loaded)
        launches = read_launches()
        same_results(f"IVF-Flat nlist 4096 n_probes {FLAT_CHECK_PROBES}",
                     ref, ours, ref_again)
        print(f"IVF-Flat loaded-index launches: flat_list_scan "
              f"{launches['flat_list_scan']}", flush=True)
        assert launches["flat_list_scan"] > 0, \
            "Kernel F never launched on the loaded IVF-Flat index"
        del loaded
        os.remove(path)

        # the checkpointed flagship build
        ck = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with faults.inject("interruptible.synchronize", times=1,
                           exc=InterruptedException):
            try:
                ivf_pq.build(DeviceResources(seed=0), params, db,
                             checkpoint=ck)
            except InterruptedException:
                torch.cuda.synchronize()
                cut_s = time.perf_counter() - t0
            else:
                raise AssertionError("the injected interruption never came")
        stages = CheckpointManager(ck).completed
        assert stages == ["kmeans"], f"manifest after the cut: {stages}"
        with CheckpointCalls() as calls:
            resumed, resume_s = timed_s(lambda: ivf_pq.build(
                DeviceResources(seed=0), params, db, checkpoint=ck,
                resume=True))
        assert calls.calls == {"load": 1, "save": 1}, calls.calls
        saved = CheckpointManager(ck).load("kmeans")["centers"]
        assert np.array_equal(resumed.centers.cpu().numpy(), saved), \
            "resumed centers differ from the kmeans stage file"
        recall = recall_at(batch(resumed)[1], truth)
        lo, hi = FLAGSHIP_RECALL
        gap = 0.0 if lo <= recall <= hi else min(abs(recall - lo),
                                                 abs(recall - hi))
        print(f"checkpointed flagship build: interrupted at its first "
              f"synchronize after {cut_s:.2f} s (manifest {stages}); "
              f"resumed from kmeans in "
              f"{resume_s:.2f} s (checkpoint loads {calls.calls['load']}, "
              f"saves {calls.calls['save']}; stages (s) "
              f"{json.dumps(ivf_pq.build.stage_seconds)}); centers "
              f"bit-equal to the stage file; recall@10 {recall:.4f} "
              + ("within" if gap == 0.0 else f"off by {gap:.4f} from")
              + f" the recorded {lo}-{hi}", flush=True)
        with CheckpointCalls() as calls:
            again, full_s = timed_s(lambda: ivf_pq.build(
                DeviceResources(seed=0), params, db, checkpoint=ck,
                resume=True))
        assert calls.calls == {"load": 2, "save": 0}, calls.calls
        equal = {leaf: torch.equal(getattr(again, leaf),
                                   getattr(resumed, leaf))
                 for leaf in ("centers", "codebooks", "list_codes",
                              "list_indices", "list_sizes", "list_recon",
                              "list_recon_sq")}
        print(f"resume from the complete checkpoint: {full_s:.2f} s (loads "
              f"{calls.calls['load']}); against the build that wrote it, "
              f"bit-equal: {json.dumps(equal)}", flush=True)
        assert all(equal.values()), f"complete resume differs: {equal}"
        out["checkpointed_build"] = {
            "interrupted_s": cut_s, "resume_s": resume_s,
            "full_resume_s": full_s,
            "recall": recall, "recall_gap": gap}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def cagra_persistence(db, queries, index):
    """The CAGRA part of the persistence phase on the ``deg32`` index:
    save -> load -> itopk 64 width 2 on fresh seeded handles (the loaded
    index and a fresh index object of the same dataset and graph: equal
    results, exactly one walk launch a search), then a checkpointed build
    and a resume from its complete checkpoint (the graph bit-equal)."""
    import os
    import shutil
    import tempfile

    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_walk as cw

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        res = DeviceResources(seed=0)
        path = os.path.join(tmp, "deg32.cagra")
        loaded, out["cagra"] = save_and_load(cagra, res, index, path,
                                             "CAGRA deg32")
        os.remove(path)
        itopk, width = CAGRA_PERSIST_POINT
        sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
        fresh = cagra.Index(dataset=index.dataset, graph=index.graph,
                            metric=index.metric)
        ref = cagra.search(DeviceResources(seed=CAGRA_ENTRY_SEED), sp,
                           fresh, queries, K)
        before = cw.cagra_walk.launches
        ours = cagra.search(DeviceResources(seed=CAGRA_ENTRY_SEED), sp,
                            loaded, queries, K)
        walks = cw.cagra_walk.launches - before
        same_results(f"CAGRA itopk {itopk} width {width}, fresh handles of "
                     f"seed {CAGRA_ENTRY_SEED}", ref, ours)
        print(f"CAGRA loaded-index search: {walks} cagra_walk launch(es)",
              flush=True)
        assert walks == 1, f"CAGRA: {walks} walk launches in one search"
        del loaded, fresh

        params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                                   intermediate_graph_degree=CAGRA_INTERMEDIATE)
        ck = os.path.join(tmp, "ckpt")
        built, build_s = timed_s(lambda: cagra.build(
            DeviceResources(seed=0), params, db, checkpoint=ck))
        resumed, resume_s = timed_s(lambda: cagra.build(
            DeviceResources(seed=0), params, db, checkpoint=ck,
            resume=True))
        equal = torch.equal(built.graph, resumed.graph)
        print(f"CAGRA checkpointed build {build_s:.2f} s; resume from the "
              f"complete checkpoint {resume_s:.2f} s; graph "
              f"{'bit-equal' if equal else 'DIFFERS'}", flush=True)
        assert equal, "CAGRA resume: graph differs"
        out["cagra_resume"] = {"build_s": build_s, "resume_s": resume_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
    for kernel, regs, stores, loads in _cuda.ptxas_usage(
            "fused_l2_nn.cu", "nn_tf32_kernel"):
        print(f"ptxas: {kernel}: {regs} registers, spill stores {stores} "
              f"B, spill loads {loads} B", flush=True)
    # C7519: ptxas fenced a wgmma's accumulators to let other code use
    # their registers (it serializes the products)
    print("ptxas C7519 remarks: " + ", ".join(
        f"{src} {_cuda.build_logs.get(src, '').count('C7519')}"
        for src in ("fused_l2_nn.cu", "kmeans_update.cu",
                    "flat_list_scan.cu")), flush=True)
    validator_first_call(torch.device("cuda", 0))

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
    fallbacks = ivf_pq.search.fused_fallbacks
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
        _, found = refine(res, db, queries, cand, K)
        torch.cuda.synchronize()
        search_ms.append(1e3 * (t1 - t0))
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    fallbacks = ivf_pq.search.fused_fallbacks - fallbacks
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
    for name in ("kmeans_assign_update", "list_scan", "merge_pairs",
                 "fused_l2_nn"):
        assert launches[name] > 0, (
            f"{name} was never launched on the main path")
    assert fallbacks == 0, "Kernel B's gate refused the main path's search"
    assert recall >= 0.90, f"recall@10 {recall} below the 0.90 floor"
    # the search alone tells its validation from refine's, whose host
    # sync waits for the search's kernels before refine's work is queued
    policy_cost(f"search + refine (batch of {N_QUERIES})", lambda:
                refine(res, db, queries, ivf_pq.search(
                    res, sp, index, queries, K_SEARCH)[1], K))
    policy_cost(f"search alone (batch of {N_QUERIES})", lambda:
                ivf_pq.search(res, sp, index, queries, K_SEARCH))

    phase("kernel B vs plain (the main path's batch on the built index)")
    row_b = check_kernel_b(index, queries)
    pq_same_build_routes(res, index, db, queries, truth, "flagship auto",
                         sp, True)
    b_query_major = check_query_major(index, queries, LARGE_KT_QUERIES, True)

    phase("kernel H vs plain at the flagship build's shapes")
    h_more = [h_check(db @ index.rotation, index.centers,
                      f"flagship extend: {N_DB:,} x {DIM} -> {N_LISTS:,}",
                      h_tf32_launches(launches), block_sizes=True)]
    row_hs = dict(codebook_h_check(index, db, "flagship"),
                  launches=launches["fused_l2_nn_small_dim"])
    assert row_hs["launches"] > 0, (
        "the small-dim kernel was never launched on the main path")

    phase("IVF-PQ recon mode: scan_mode='recon', n_probes 96, k 20 -> 10")
    sp_recon = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="recon")
    recon = search_mode(res, index, db, queries, truth, "flagship recon",
                        sp_recon, "list_scan")
    pq_same_build_routes(res, index, db, queries, truth, "flagship recon",
                         sp_recon, False)
    assert recon["recall"] >= 0.90, (
        f"flagship recon recall@10 {recon['recall']} below 0.90")
    row_g = dict(check_kernel_g(index, queries, K_SEARCH),
                 launches=recon["launches"]["list_scan"])
    g_query_major = check_query_major(index, queries, LARGE_KT_QUERIES,
                                      False)

    phase("kernels C and D on the flagship's codes (rot 128, 8 bits)")
    c_flag, d_flag = flagship_code_checks(index, queries)

    phase("where the time goes (one build, one batch, under the profiler)")
    del index
    device_breakdown("build", lambda: ivf_pq.build(
        DeviceResources(seed=0), params, db))
    index = ivf_pq.build(DeviceResources(seed=0), params, db)
    device_breakdown("search+refine batch", lambda: refine(
        res, db, queries, ivf_pq.search(res, sp, index, queries,
                                        K_SEARCH)[1], K))
    del cand, found
    torch.cuda.empty_cache()

    phase("IVF-Flat at full width: sift-like-1m, nlist 4096 and 16384")
    row_f, a_flat, h_flat, flat_indexes = ivf_flat_path(db, queries, truth)

    phase("k-means at full width: 1M x 128 -> 1024 (BASELINE config 3)")
    row_h, a_kmeans = kmeans_path(db)

    phase("profiles: the round-5 decompositions (kernel table rows 10-13)")
    rows_profiles = profiles_path(dev, index, queries, flat_indexes)

    phase("persistence at full width: save / load / search, corruption, "
          "checkpointed flagship build")
    t0 = time.perf_counter()
    persisted = persistence_path(res, index, flat_indexes[1], db, queries,
                                 truth, params, sp)
    persist_s = time.perf_counter() - t0
    del index, flat_indexes
    torch.cuda.empty_cache()

    phase("CAGRA at full width: sift-like-1m, raft_cagra.deg32")
    row_walk, row_i, cagra_index = cagra_path(db, queries, truth)

    phase("persistence at full width: CAGRA deg32")
    t0 = time.perf_counter()
    persisted.update(cagra_persistence(db, queries, cagra_index))
    persist_s += time.perf_counter() - t0
    print(f"persistence phase: {persist_s:.1f} s; {json.dumps(persisted)}; "
          f"nvidia-smi: {smi_line}", flush=True)
    del cagra_index, db, queries, truth
    torch.cuda.empty_cache()

    phase("deep path at full width: 10M x 96, n_lists 8192, pq_dim 48")
    rows_cde, a_deep, b_deep, g_deep, h_deep, hs_deep = deep_path(dev)

    phase("result")
    rows_cde[0]["also_checked"] += c_flag
    rows_cde[1]["also_checked"] += d_flag
    row_g["also_checked"] = [g_deep, g_query_major]
    row_h["also_checked"] += h_more + h_flat + h_deep
    row_hs["also_checked"] = [hs_deep]
    rows = [dict(row_a, launches=launches["kmeans_assign_update"],
                 also_checked=a_deep + a_flat + [a_kmeans]),
            dict(row_b, launches=launches["merge_pairs"],
                 pass1_launches=launches["list_scan"],
                 also_checked=[b_deep, b_query_major])] + rows_cde + [
                     row_f, row_g, row_h, row_hs, row_i, row_walk] + \
        rows_profiles
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

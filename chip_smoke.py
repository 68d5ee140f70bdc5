#!/usr/bin/env python3
"""Drive raft_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.  No CUDA device is a failure.
2. Build: compile every kernel under ``raft_tpu_torch/csrc`` with nvcc.
3. Kernel A (``kmeans_assign_update``) against its plain PyTorch version on
   the main path's first Lloyd pass: the flagship's 500,000 x 128 training
   set and its 4,096 initial centroids.
4. Main path at the flagship configuration (BASELINE.md config 4,
   ``conf/sift-like-1m.json`` entry ``raft_ivf_pq.dim64``): a 1,000,000 x
   128 SIFT-like database (the generator of ``bench.py``, numpy seed 0),
   ``ivf_pq.build`` at ``IndexParams(n_lists=4096, pq_dim=64)``, then
   batches of 5,000 queries searched at n_probes 96, k 20 and refined to
   k 10, recall@10 against ``brute_force.knn``.  Both kernels' launch
   counts are zeroed just before and read just after; each must be > 0.
5. Kernel B (``ivf_pq_scan_fused``) against its plain version on the
   main path's batch: 5000 queries of the built index at n_probes 96,
   k 20.
6. Where the time goes: one more build and one search+refine batch under
   ``torch.profiler`` — device busy time, idle share, heaviest kernels.
7. A JSON line with each kernel's route, source, launches, error, time
   (CUDA events), plain-version time and bound; the ``nvidia-smi`` line;
   the result line ``{"ok": true, "device": {...}}`` last.

Bounds use the H100 SXM peaks: 3.35 TB/s of device memory and 989
TFLOP/s for bf16 products (both kernels multiply bf16 values).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

N_DB, N_QUERIES, DIM, LATENT, NOISE = 1_000_000, 5_000, 128, 16, 0.05
N_LISTS, PQ_DIM, N_PROBES, K_SEARCH, K = 4096, 64, 96, 20, 10
SEARCH_REPS = 3
KERNEL_REPS = 5


def sift_like(n, n_queries, dim, latent, noise, seed=0):
    """bench.py's SIFT-like generator: a 16-d latent mapped to ``dim`` plus
    5% noise, numpy seed 0 (database rows first, then the queries)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n + n_queries, latent)).astype(np.float32)
    A = rng.normal(size=(latent, dim)).astype(np.float32) / np.sqrt(latent)
    X = (Z @ A).astype(np.float32)
    X += noise * rng.normal(size=X.shape).astype(np.float32)
    return X[:n], X[n:]


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


def phase(name):
    print(f"== {name}", flush=True)


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


def check_kernel_a(res, train, centroids):
    """Kernel A vs plain on the first Lloyd pass of the flagship fit.
    dmin and the labels are the same arithmetic in the same order (exact
    bf16 products summed in dimension order), so counts of unit weights
    must be equal; sums differ by the order of fp32 atomic additions:
    |err| <= 1e-5 * count * max|x| per element."""
    import torch
    from raft_tpu_torch.ops import kmeans_update as ku

    xb = train.to(torch.bfloat16)
    w = torch.ones(train.shape[0], dtype=torch.float32, device=res.device)
    sums, counts, dmin = ku.kmeans_assign_update(xb, w, centroids)
    p_sums, p_counts, p_dmin = ku.kmeans_assign_update_plain(xb, w,
                                                            centroids)
    torch.cuda.synchronize()
    assert torch.equal(counts, p_counts), (
        "kernel A counts differ from the plain version: "
        f"{int((counts != p_counts).sum())} clusters")
    dmin_err = float((dmin - p_dmin).abs().max())
    assert dmin_err <= 1e-5, f"kernel A dmin differs by {dmin_err}"
    tol = 1e-5 * p_counts[:, None] * float(xb.float().abs().max()) + 1e-6
    sums_err = (sums - p_sums).abs()
    assert bool((sums_err <= tol).all()), (
        f"kernel A sums differ by up to {float(sums_err.max())}")
    err = max(dmin_err, float(sums_err.max()))
    print(f"kernel A vs plain: counts equal, max |dmin err| {dmin_err}, "
          f"max |sums err| {float(sums_err.max())}", flush=True)

    ms = cuda_ms(lambda: ku.kmeans_assign_update(xb, w, centroids),
                 KERNEL_REPS)
    plain_ms = cuda_ms(lambda: ku.kmeans_assign_update_plain(xb, w,
                                                             centroids), 1)
    n, dim = train.shape
    k = centroids.shape[0]
    flops = 2.0 * n * k * dim
    nbytes = (n * dim * 2 + n * 4 + k * dim * 2 + k * 4      # inputs
              + k * dim * 4 + k * 4 + n * 4)                 # outputs
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                > flops / BF16_FLOP_PER_S else "operations")
    print(f"kernel A: {ms:.3f} ms/pass ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return {"name": "kmeans_assign_update", "route": "cuda",
            "source": "raft_tpu_torch/csrc/kmeans_update.cu",
            "replaces": "raft_tpu/ops/kmeans_update_pallas.py:78",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_kernel_b(res, index, queries):
    """Kernel B vs plain on the main path's batch of the built index
    (5000 queries, n_probes 96, k 20).  Distances
    agree within 1e-4 rel/abs at every rank (only fp32 summation order
    differs); where an id differs the two distances at that rank agree,
    i.e. a tie; every (id, distance) the kernel returns is recomputed from
    the index and must match."""
    import torch
    from raft_tpu_torch.neighbors.ivf_flat import _select_clusters
    from raft_tpu_torch.ops import pq_group_scan as pgs

    def inputs(q):
        qrot = q.float() @ index.rotation
        probes = _select_clusters(index.centers, qrot, N_PROBES,
                                  index.metric)
        return (qrot, index.centers, probes, index.list_recon,
                index.list_recon_sq, index.list_indices)

    kt = min(K_SEARCH, index.capacity)
    args = inputs(queries)
    vk, ik = pgs.ivf_pq_scan_fused(*args, K_SEARCH, kt)
    vp, ip = pgs.ivf_pq_scan_fused_plain(*args, K_SEARCH, kt)
    torch.cuda.synchronize()
    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)), "kernel B: exhausted ranks"
    assert torch.equal(ik < 0, ~fin), "kernel B: -1 ids off exhausted ranks"
    err = float((vk[fin] - vp[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(vk[fin], vp[fin], rtol=1e-4, atol=1e-4), (
        f"kernel B distances differ by {err}")
    # recompute each returned (query, id) distance from the index
    qrot, _, probes = args[:3]
    flat = index.list_indices.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    live = flat >= 0
    slot_of[flat[live].long()] = torch.nonzero(live)[:, 0]
    ids = ik[fin].long()
    rows = torch.nonzero(fin)[:, 0]
    slot = slot_of[ids]
    lst = slot // index.capacity
    assert bool((probes[rows].long() == lst[:, None]).any(1).all()), (
        "kernel B returned an id outside the query's probed lists")
    sub = qrot[rows] - index.centers[lst]
    rec = index.list_recon.reshape(-1, index.rot_dim)[slot].float()
    d = torch.clamp_min((sub * sub).sum(1) + index.list_recon_sq.reshape(-1)[
        slot] - 2.0 * (sub.to(torch.bfloat16).float() * rec).sum(1), 0.0)
    assert torch.allclose(d, vk[fin], rtol=1e-4, atol=1e-4), (
        "kernel B ids do not match their distances")
    same = float((ik == ip).float().mean())
    print(f"kernel B vs plain: max |dist err| {err}, ids equal at "
          f"{same:.5f} of ranks (others are distance ties)", flush=True)

    ms = cuda_ms(lambda: pgs.ivf_pq_scan_fused(*args, K_SEARCH, kt),
                 KERNEL_REPS)
    plain_ms = cuda_ms(lambda: pgs.ivf_pq_scan_fused_plain(*args, K_SEARCH,
                                                           kt), 1)
    # the least work: each distinct probed list's live rows read once,
    # 2*rot bf16 operations per (query, probed live row)
    nq, rot = args[0].shape
    probes = args[2].long()
    sizes = index.list_sizes.long()
    probed = torch.unique(probes)
    nbytes = (nq * rot * 4 + probes.numel() * 4 + probed.numel() * rot * 4
              + int(sizes[probed].sum()) * (rot * 2 + 4 + 4)
              + nq * K_SEARCH * 8)
    flops = 2.0 * rot * int(sizes[probes].sum())
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                > flops / BF16_FLOP_PER_S else "operations")
    print(f"kernel B: {ms:.3f} ms/batch of {nq}, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.1f} GFLOP)", flush=True)
    return {"name": "ivf_pq_scan_fused", "route": "cuda",
            "source": "raft_tpu_torch/csrc/pq_group_scan.cu",
            "replaces": "raft_tpu/ops/pq_group_scan_pallas.py:410",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main() -> int:
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import _cuda
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.ops import pq_group_scan as pgs

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    phase("build kernels")
    _cuda.library()
    print(f"build: {_cuda.build_seconds:.1f} s", flush=True)

    db_np, q_np = sift_like(N_DB, N_QUERIES, DIM, LATENT, NOISE)
    dev = torch.device("cuda", 0)
    db = torch.from_numpy(db_np).to(dev)
    queries = torch.from_numpy(q_np).to(dev)

    phase("kernel A vs plain (first Lloyd pass of the flagship fit)")
    # the build's first draw from a seed-0 handle is this trainset, and
    # the fit starts from these strided centroids
    probe_res = DeviceResources(seed=0)
    n_train = int(N_DB * ivf_pq.IndexParams().kmeans_trainset_fraction)
    sel = torch.randperm(N_DB, generator=probe_res.generator,
                         device=dev)[:n_train]
    train = db[sel]
    c0 = train[::max(n_train // N_LISTS, 1)][:N_LISTS].contiguous()
    row_a = check_kernel_a(probe_res, train, c0)
    del train, sel

    phase("main path: IVF-PQ build + search + refine at full width")
    res = DeviceResources(seed=0)
    params = ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM)
    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ku.kmeans_assign_update.launches = 0
    pgs.ivf_pq_scan_fused.launches = 0
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch_ms, search_ms = [], []
    for _ in range(SEARCH_REPS):
        found = []
        for s in range(0, N_QUERIES, 5000):
            qb = queries[s:s + 5000]
            t0 = time.perf_counter()
            _, cand = ivf_pq.search(res, sp, index, qb, K_SEARCH)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, ids = refine.refine(res, db, qb, cand, K)
            torch.cuda.synchronize()
            search_ms.append(1e3 * (t1 - t0))
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            found.append(ids)
    launches = {"kmeans_assign_update": ku.kmeans_assign_update.launches,
                "ivf_pq_scan_fused": pgs.ivf_pq_scan_fused.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    found = torch.cat(found)
    _, truth = brute_force.knn(res, db, queries, K)
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    med_ms = sorted(batch_ms)[len(batch_ms) // 2]
    print(f"index: {index.n_lists} lists, capacity {index.capacity}, "
          f"{index.size} rows, pq_dim {index.pq_dim}", flush=True)
    print(f"build: {build_s:.2f} s", flush=True)
    print(f"search ms per batch of 5000: "
          f"{', '.join(f'{m:.2f}' for m in search_ms)}", flush=True)
    print(f"search+refine ms per batch of 5000: "
          f"{', '.join(f'{m:.2f}' for m in batch_ms)}; "
          f"QPS {5000 / (med_ms / 1e3):.0f} (median)", flush=True)
    print(f"recall@10: {recall:.4f}", flush=True)
    print(f"peak device memory: {peak_gb:.2f} GB", flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    assert recall >= 0.90, f"recall@10 {recall} below the 0.90 floor"

    phase("kernel B vs plain (the main path's batch on the built index)")
    row_b = check_kernel_b(res, index, queries)

    phase("where the time goes (one build, one batch, under the profiler)")
    del index
    device_breakdown("build", lambda: ivf_pq.build(
        DeviceResources(seed=0), params, db))
    index = ivf_pq.build(DeviceResources(seed=0), params, db)
    qb = queries[:5000]
    device_breakdown("search+refine batch", lambda: refine.refine(
        res, db, qb, ivf_pq.search(res, sp, index, qb, K_SEARCH)[1], K))

    rows = [dict(row_a, launches=launches["kmeans_assign_update"]),
            dict(row_b, launches=launches["ivf_pq_scan_fused"])]
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   just after; Kernels A and B must each be > 0.
5. Kernel B (``ivf_pq_scan_fused``) against its plain version on the
   flagship's batch: 5000 queries of the built index at n_probes 96, k 20.
6. Where the flagship's time goes: one more build and one search+refine
   batch under ``torch.profiler`` — device busy time, idle share, heaviest
   kernels.
7. Deep path at full width (``conf/deep-like-10m.json`` entry
   ``raft_ivf_pq.dim48``): a 10,000,000 x 96 database + 5,000 queries from
   the same generator, ``ivf_pq.build`` at ``IndexParams(n_lists=8192,
   pq_dim=48, kmeans_trainset_fraction=0.1)`` (the hierarchical k-means
   build, Kernel A; its stages' wall seconds), Kernel A against its plain
   version at the fit's three pass shapes, then per scan mode — ``auto``
   (Kernel B), ``fused`` kt 4 (Kernel C), ``codes`` kt 4 (Kernel D),
   ``recon8`` kt 4 (Kernel E), and ``auto`` on the index with its recon
   cache dropped (Kernel C at kt 20) — search at n_probes 96, k 20,
   refine to k 10: ms per batch, QPS and recall@10, each mode's launch
   counts zeroed before it and read after.  Kernels B, C, D and E against
   their plain versions on the full batch at each mode's shape, and each
   mode's batch under the profiler.
8. A JSON line with each kernel's route, source, launches, error, time
   (CUDA events), plain-version time and bound on its main path, and
   under ``also_checked`` the same measurements at the deep path's
   shapes; the ``nvidia-smi`` line; the result line ``{"ok": true,
   "device": {...}}`` last.

Bounds use the H100 SXM peaks: 3.35 TB/s of device memory and 989
TFLOP/s for bf16 products (every kernel multiplies bf16 values, the int8
scan by way of bf16).
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
DEEP_DB, DEEP_DIM, DEEP_LISTS, DEEP_PQ_DIM = 10_000_000, 96, 8192, 48
DEEP_TRAIN_FRACTION, DEEP_KT = 0.1, 4
SEARCH_REPS = 3
KERNEL_REPS = 5


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
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    return {"kmeans_assign_update": ku.kmeans_assign_update,
            "ivf_pq_scan_fused": pgs.ivf_pq_scan_fused,
            "ivf_pq_scan_codes_fused": pcs.ivf_pq_scan_codes_fused,
            "ivf_pq_scan_codes": pcs.ivf_pq_scan_codes,
            "ivf_pq_scan_recon8": pcs.ivf_pq_scan_recon8}


def zero_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in counters().items()}


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the bf16 operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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


def ties_only(v, i, ref_i):
    """True when every id that differs from the reference sits at a
    distance tie: next to an equal distance in its sorted row, or on the
    row's last finite rank (whose tie partner may lie past the row)."""
    import torch

    tol = 1e-4 * (1.0 + v.abs())
    tie = torch.zeros_like(v, dtype=torch.bool)
    near = (v[..., 1:] - v[..., :-1]).abs() <= tol[..., 1:]
    tie[..., 1:] |= near
    tie[..., :-1] |= near
    last = torch.isfinite(v) & ~torch.isfinite(
        torch.cat([v[..., 1:], torch.full_like(v[..., :1], float("inf"))],
                  -1))
    return bool(((i == ref_i) | tie | last).all())


def compare_with_plain(name, vk, ik, vp, ip):
    """Distances within 1e-4 rel/abs at every rank, the same exhausted
    ranks, -1 exactly there, ids equal except at distance ties."""
    import torch

    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)), f"{name}: exhausted ranks"
    assert torch.equal(ik < 0, ~fin), f"{name}: -1 ids off exhausted ranks"
    err = float((vk[fin] - vp[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(vk[fin], vp[fin], rtol=1e-4, atol=1e-4), (
        f"{name} distances differ by {err}")
    assert ties_only(vk, ik, ip), f"{name}: ids differ off distance ties"
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


def deep_mode(res, index, db, queries, truth, label, sp, kernel):
    """One scan mode on the deep index: launch counts zeroed before and
    read after; a first search (which attaches the mode's lazy cache),
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
    print(f"deep {label}: first search {first_ms:.2f} ms (lazy caches "
          f"included); search {', '.join(f'{m:.2f}' for m in search_ms)} "
          f"ms; search+refine {', '.join(f'{m:.2f}' for m in batch_ms)} ms "
          f"per batch of {queries.shape[0]}; QPS "
          f"{queries.shape[0] / (med / 1e3):.0f} (median); recall@10 "
          f"{recall:.4f}; launches {json.dumps(launches)}; fused codes "
          f"fallbacks {fallbacks}", flush=True)
    assert launches[kernel] > 0, f"deep {label}: {kernel} never launched"
    return {"label": label, "recall": recall, "launches": launches,
            "batch_ms": med, "cand": cand}


def deep_path(dev):
    """Phase 7: the deep-like-10m / raft_ivf_pq.dim48 index at full width,
    every compact-code scan mode through ``ivf_pq.search``, then every
    kernel of the path against its plain version at the shapes the path
    gives it.  Returns the kernel rows of C, D and E with the launches of
    their modes' runs, and the deep-shape checks of Kernels A and B
    (``at_shape`` entries)."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.cluster.kmeans_balanced import _strided_init
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
    assert build_launches["kmeans_assign_update"] > 0, (
        "deep build: Kernel A never launched")
    print(f"deep peak device memory through the build: {peak_gb():.2f} GB",
          flush=True)

    # Kernel A at the hierarchical fit's three pass shapes, on the build's
    # trainset (the first draw of a seed-0 handle, rotated): the
    # mesocluster stage's first pass (all rows, its strided init), a
    # per-mesocluster pass (a sample of the fit's size) and a pass of the
    # full-K refinement
    n_train = int(DEEP_DB * DEEP_TRAIN_FRACTION)
    sel = torch.randperm(DEEP_DB, generator=DeviceResources(seed=0).generator,
                         device=dev)[:n_train]
    train = db[sel] @ index.rotation
    del sel
    n_meso = round(DEEP_LISTS ** 0.5)
    k_max = -(-DEEP_LISTS // n_meso)
    per = max(2048, 32 * k_max)
    a_deep = []
    for what, rows, k in (("mesocluster", train, n_meso),
                          ("per-mesocluster", train[:per], k_max),
                          ("full-K", train, DEEP_LISTS)):
        shape = f"deep {what} pass: {rows.shape[0]:,} x {DEEP_DIM} -> {k:,}"
        a_deep.append(at_shape(
            check_kernel_a(rows, _strided_init(rows, k), shape), shape,
            build_launches["kmeans_assign_update"]))
    del train
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
             "ivf_pq_scan_recon8")):
        runs[label] = deep_mode(res, index, db, queries, truth, label,
                                params_, kernel)
        runs[label]["params"] = params_
    agree = float((runs["fused"]["cand"] == runs["codes"]["cand"]).float()
                  .mean())
    print(f"deep fused vs codes: candidate ids equal at {agree:.5f} of "
          f"ranks", flush=True)
    assert runs["auto"]["recall"] >= 0.90, (
        f"deep auto recall@10 {runs['auto']['recall']} below 0.90")
    for label in ("fused", "codes", "recon8"):
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

    for label, run in runs.items():
        device_breakdown(f"deep {label} search+refine batch",
                         lambda: refine.refine(res, db, queries, ivf_pq.search(
                             res, run["params"], index, queries,
                             K_SEARCH)[1], K))

    # the memory-lean deployment: no recon cache, so auto -> codes, whose
    # Kernel C runs at kt = k
    index.list_recon = index.list_recon_sq = index.list_code_rsq = None
    torch.cuda.empty_cache()
    lean = deep_mode(res, index, db, queries, truth, "auto without a recon "
                     "cache", sp(), "ivf_pq_scan_codes_fused")
    assert lean["recall"] >= 0.90, (
        f"deep auto (no recon cache) recall@10 {lean['recall']} below 0.90")
    row_c = check_code_kernels(index, queries, K_SEARCH, ("C",))[0]
    rows[0]["also_checked"].append(at_shape(
        row_c, f"deep, no recon cache: {N_QUERIES:,} queries x {N_PROBES} "
        f"probes, k {K_SEARCH}, kt {K_SEARCH}, capacity {index.capacity:,}",
        lean["launches"]["ivf_pq_scan_codes_fused"]))
    print(f"deep peak device memory, plain versions included: "
          f"{peak_gb():.2f} GB", flush=True)
    return rows, a_deep, b_deep


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
    for name in ("kmeans_assign_update", "ivf_pq_scan_fused"):
        assert launches[name] > 0, (
            f"{name} was never launched on the main path")
    assert recall >= 0.90, f"recall@10 {recall} below the 0.90 floor"

    phase("kernel B vs plain (the main path's batch on the built index)")
    row_b = check_kernel_b(index, queries)

    phase("where the time goes (one build, one batch, under the profiler)")
    del index
    device_breakdown("build", lambda: ivf_pq.build(
        DeviceResources(seed=0), params, db))
    index = ivf_pq.build(DeviceResources(seed=0), params, db)
    device_breakdown("search+refine batch", lambda: refine.refine(
        res, db, queries, ivf_pq.search(res, sp, index, queries,
                                        K_SEARCH)[1], K))
    del index, db, queries, truth, cand, found
    torch.cuda.empty_cache()

    phase("deep path at full width: 10M x 96, n_lists 8192, pq_dim 48")
    rows_cde, a_deep, b_deep = deep_path(dev)

    phase("result")
    rows = [dict(row_a, launches=launches["kmeans_assign_update"],
                 also_checked=a_deep),
            dict(row_b, launches=launches["ivf_pq_scan_fused"],
                 also_checked=[b_deep])] + rows_cde
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

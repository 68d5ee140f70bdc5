"""Kernels B-G's query-major routes, unfiltered, and Kernel B's filtered
list-major pass 1, of one checkout, for comparing two commits in turns on
one card (parent, change, change, parent).

Run by path, with the root of the checkout to measure (an unpacked ``git
archive`` of the parent, or this checkout's root)::

    for t in parent . . parent; do
        python3 raft_tpu_torch/profiles/query_major_turns.py $t
    done

Each run imports that checkout's ``raft_tpu_torch`` and ``chip_smoke``
(whose timer it uses), draws random lists on the card from a fixed seed
at the shapes chip_smoke holds the query-major routes at — the flagship's
4,096 lists of up to 416 bf16 rows of rot 128 (B at k = kt = 256, G at kt
128, and B's list-major pass 1 at kt 20 with a 50% per-query filter),
IVF-Flat's 2,048 super-tiles of up to 832 fp32 rows of dim 128 (F at kt
100, 64 probes), the deep index's 8,192 lists of up to 2,112 rows of rot
96 as 48 8-bit codes and as int8 (C at k = kt = 128, D and E at kt 128,
96 probes) — with 1,000 queries, and prints one JSON line of each
kernel's CUDA-event ms.  It runs on the card only: by path, not as a
module, so that the checkout named comes first on ``sys.path``.
"""

import json
import os
import sys

NQ = 1_000


def lists(g, n_lists, cap, dev):
    """ids (n_lists, cap) int32: each list's first size slots hold fresh
    ids, size uniform in [cap / 3, cap], the rest -1."""
    import torch

    sizes = torch.randint(cap // 3, cap + 1, (n_lists, 1), generator=g,
                          device=dev)
    slot = torch.arange(cap, device=dev)[None, :]
    live = slot < sizes
    ids = torch.cumsum(live.reshape(-1).int(), 0).reshape(n_lists, cap) - 1
    return torch.where(live, ids, torch.full_like(ids, -1)).int()


def probes_of(g, n_lists, n_probes, dev):
    """(NQ, n_probes) int32: distinct lists for each query."""
    import torch

    keys = torch.rand(NQ, n_lists, generator=g, device=dev)
    return keys.topk(n_probes, dim=1).indices.int()


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.filters import bitset
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    reps = cs.KERNEL_REPS
    out = {"tree": tree}

    # the flagship's lists: B, G and B's filtered pass 1
    n_lists, cap, rot = 4096, 416, 128
    recon = torch.randn(n_lists, cap, rot, generator=g,
                        device=dev).to(torch.bfloat16)
    rsq = (recon.float() ** 2).sum(-1)
    ids = lists(g, n_lists, cap, dev)
    centers = torch.randn(n_lists, rot, generator=g, device=dev)
    qrot = torch.randn(NQ, rot, generator=g, device=dev)
    probes = probes_of(g, n_lists, 96, dev)
    common = (qrot, centers, probes, recon, rsq, ids)
    out["B_ms"] = cs.cuda_ms(
        lambda: pgs.scan_query_major(*common, 256, 256), reps)
    out["G_ms"] = cs.cuda_ms(
        lambda: ps.recon_scan_query_major(*common, 128), reps)
    mask = torch.rand(NQ, int(ids.max()) + 1, generator=g, device=dev) < 0.5
    words = bitset.pack_mask(mask)
    groups = grouped.build_groups(probes, n_lists)
    out["B_filtered_pass1_ms"] = cs.cuda_ms(
        lambda: pgs.list_scan(qrot, centers, probes, *groups, recon, rsq,
                              ids, 20, filter_words=words), reps)
    del recon, rsq, mask, words

    # IVF-Flat's super-tiles: F
    n_tiles, rows, dim = 2048, 832, 128
    data = torch.randn(n_tiles, rows, dim, generator=g, device=dev)
    ids = lists(g, n_tiles, rows, dev)
    q = torch.randn(NQ, dim, generator=g, device=dev)
    probes = probes_of(g, n_tiles, 64, dev)
    dsq = (data * data).sum(-1)
    out["F_ms"] = cs.cuda_ms(
        lambda: ps.flat_scan_query_major(q, probes, data, dsq, ids, 100),
        reps)
    del data, dsq

    # the deep index's lists: C, D (8-bit codes) and E (int8 rows)
    n_lists, cap, rot, pq_dim = 8192, 2112, 96, 48
    codes = torch.randint(0, 256, (n_lists, cap, pq_dim), generator=g,
                          device=dev, dtype=torch.uint8)
    books = torch.randn(pq_dim, 256, rot // pq_dim, generator=g, device=dev)
    rsq = torch.rand(n_lists, cap, generator=g, device=dev) * rot
    ids = lists(g, n_lists, cap, dev)
    centers = torch.randn(n_lists, rot, generator=g, device=dev)
    qrot = torch.randn(NQ, rot, generator=g, device=dev)
    probes = probes_of(g, n_lists, 96, dev)
    args = (qrot, centers, probes, codes, books, rsq, ids, 8)
    out["C_ms"] = cs.cuda_ms(
        lambda: pcs.codes_fused_query_major(*args, 128, 128), reps)
    out["D_ms"] = cs.cuda_ms(
        lambda: pcs.codes_scan_query_major(*args, 128), reps)
    del codes
    i8 = torch.randint(-127, 128, (n_lists, cap, rot), generator=g,
                       device=dev, dtype=torch.int8)
    scales = torch.rand(n_lists, generator=g, device=dev) * 0.1
    out["E_ms"] = cs.cuda_ms(
        lambda: pcs.recon8_scan_query_major(qrot, centers, probes, i8,
                                            scales, rsq, ids, 128), reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")

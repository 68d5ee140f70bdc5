"""Kernel I's walk and hop kernels of one checkout, at chip_smoke's shapes,
for comparing two commits in turns on one card (parent, change, change,
parent).

Run by path, with the root of the checkout to measure (an unpacked ``git
archive`` of the parent, or this checkout's root)::

    for t in parent . . parent; do
        python3 raft_tpu_torch/profiles/cagra_walk_turns.py $t
    done

Each run imports that checkout's ``raft_tpu_torch`` and ``chip_smoke``
(whose timers it uses) and draws from a fixed seed on the card 1M random
rows of dim 128 and, for each walk, a random graph and its walk table
(bf16 at pdim 16, or int8 at pdim 8).  It times the walk kernel at each of
:data:`WALKS` — the search batch (5,000 queries, itopk 64, width 2), a
serving bucket (64, itopk 32, width 1), the build's self-walk chunks
(8,192 nodes, itopk 96, width 1, 8 hops: degree 64, and degree 32 on an
int8 table as the deep build's) and the walks past 256 (1,000 queries at
itopk 512 width 1 and itopk 256 width 16) — the exact-row source at
:data:`EXACT` (the direct walk on the 1M rows, 5,000 queries at itopk 64
width 2, and on 10M random rows of dim 96, deep-cagra-10m's shape, 3.84 GB
on the card, at itopk 96 width 2), and the hop kernel at the build's
exact merge (5,371 queries, itopk 65, wd 96, pdim 128).  It prints one
JSON line: CUDA-event and device ms, the hops run (sum and most a query)
and, where the checkout reports it, the block size and resident blocks
per SM.  It runs on the card only: by path, not as a module, so that the
checkout named comes first on ``sys.path``.
"""

import json
import os
import sys

N, DIM, PDIM = 1_000_000, 128, 16
DEEP_N, DEEP_DIM = 10_000_000, 96
# label: ((nq, itopk, width, deg), pdim, int8 table, max hops or None)
WALKS = {"search": ((5000, 64, 2, 32), PDIM, False, None),
         "bucket": ((64, 32, 1, 32), PDIM, False, None),
         "self_walk": ((8192, 96, 1, 64), PDIM, False, 8),
         "deep_self_walk": ((8192, 96, 1, 32), 8, True, 8),
         "wide512": ((1000, 512, 1, 32), PDIM, False, None),
         "wide256": ((1000, 256, 16, 32), PDIM, False, None)}
# label: (rows, (nq, itopk, width, deg))
EXACT = {"exact_1m": ("1m", (5000, 64, 2, 32)),
         "exact_10m": ("10m", (5000, 96, 2, 32))}


def walk_args(g, dev, x, nq, itopk, width, deg, pdim=PDIM, quant=False):
    """A walk's operands and keywords over a random degree-``deg`` graph of
    ``x``'s rows, seeded from 4,096 random entries as
    ``cagra._search_impl_walk`` seeds it."""
    import torch
    from raft_tpu_torch.neighbors import cagra

    n, dim = x.shape
    proj = torch.randn(dim, pdim, generator=g, device=dev) / dim ** 0.5
    graph = torch.randint(0, n, (n, deg), generator=g, device=dev).int()
    scales = None
    if quant:
        table, _, scales = cagra._build_walk_table_q(x, graph, pdim,
                                                     proj=proj)
    else:
        table, _ = cagra._build_walk_table(x, graph, pdim, proj=proj)
    del graph
    q = torch.randn(nq, dim, generator=g, device=dev)
    q_sq, qp, qp_t = cagra._query_side(q, proj, quant, scales)
    eids = torch.randperm(n, generator=g, device=dev)[:4096].int()
    eproj, esq, eids = cagra._entry_set_of(x, proj, eids)
    buf = cagra._seed_walk(qp, q_sq, eproj, esq, eids, itopk, False)
    return (qp_t, q_sq, table) + tuple(buf), dict(
        deg=deg, search_width=width, max_iterations=10 + itopk // width,
        ip_metric=False, quant=quant, scales=scales)


def exact_args(g, dev, rows, nq, itopk, width, deg):
    """A direct walk's operands and keywords over a random degree-``deg``
    graph of ``rows``, seeded from 4 x itopk random draws as
    ``cagra._search_impl`` seeds it."""
    import torch
    from raft_tpu_torch.neighbors import cagra

    n, dim = rows.shape
    graph = torch.randint(0, n, (n, deg), generator=g, device=dev).int()
    q = torch.randn(nq, dim, generator=g, device=dev)
    q_sq = (q * q).sum(1)
    rows_sq = (rows * rows).sum(1)
    seeds = torch.randint(0, n, (nq, max(4 * itopk, 128)), generator=g,
                          device=dev).int()
    buf = cagra._seed_direct(q, q_sq, rows, rows_sq, seeds, itopk, False)
    return (q, q_sq, graph, rows, rows_sq) + tuple(buf), dict(
        search_width=width, max_iterations=10 + itopk // width,
        ip_metric=False)


def hop_args(g, dev):
    """The hop kernel's operands at the build's exact merge."""
    import torch

    nq, itopk, wd, pdim = 5371, 65, 96, 128
    qp = torch.randn(nq, pdim, generator=g, device=dev).to(torch.bfloat16)
    nb_id = torch.randint(0, N, (nq, wd), generator=g, device=dev).int()
    nb_p = torch.randn(nq, wd, pdim, generator=g,
                       device=dev).to(torch.bfloat16)
    nb_sq = torch.rand(nq, wd, generator=g, device=dev)
    buf_d = torch.sort(torch.rand(nq, itopk, generator=g, device=dev),
                       dim=1).values
    buf_i = torch.randint(0, N, (nq, itopk), generator=g, device=dev).int()
    vis = torch.zeros(nq, itopk, dtype=torch.bool, device=dev)
    return (qp, torch.zeros(nq, device=dev), nb_p, nb_sq, nb_id, buf_d,
            buf_i, vis)


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.ops import cagra_hop as chop
    from raft_tpu_torch.ops import cagra_walk as cw

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    reps = cs.KERNEL_REPS * 4
    x = torch.randn(N, DIM, generator=g, device=dev)
    out = {"tree": tree}
    resident = getattr(cw, "walk_resident", None)

    def measure(label, fn, args, kw, exact):
        hops = fn(*args, return_hops=True, **kw)[3]
        out[f"walk_{label}_ms"] = cs.cuda_ms(lambda: fn(*args, **kw), reps)
        out[f"walk_{label}_device_ms"] = cs.device_ms(
            lambda: fn(*args, **kw), reps, "walk_kernel")
        out[f"walk_{label}_hops"] = [int(hops.sum()), int(hops.max())]
        if resident is not None:
            nq, itopk = args[-3].shape
            pdim = args[3].shape[1] if exact else args[0].shape[1]
            deg = args[2].shape[1] if exact else kw["deg"]
            out[f"walk_{label}_resident"] = resident(
                itopk, kw["search_width"], deg, pdim,
                kw.get("quant", False), exact)

    for label, (shape, pdim, quant, max_iter) in WALKS.items():
        args, kw = walk_args(g, dev, x, *shape, pdim=pdim, quant=quant)
        if max_iter is not None:
            kw["max_iterations"] = max_iter
        measure(label, cw.cagra_walk, args, kw, False)
        del args
    for label, (rows, shape) in EXACT.items():
        if rows == "10m":
            del x
            x = torch.randn(DEEP_N, DEEP_DIM, generator=g, device=dev)
        args, kw = exact_args(g, dev, x, *shape)
        measure(label, cw.cagra_walk_exact, args, kw, True)
        del args
    del x
    hop = hop_args(g, dev)

    def hop_call():
        return chop.cagra_hop(*hop, ip_metric=False)

    out["hop_merge_ms"] = cs.cuda_ms(hop_call, reps)
    out["hop_merge_device_ms"] = cs.device_ms(hop_call, reps, "hop_kernel")
    if hasattr(chop, "hop_resident"):
        out["hop_merge_resident"] = chop.hop_resident(65, 96, 128)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")

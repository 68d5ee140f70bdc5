"""Kernel I's walk and hop kernels of one checkout, at chip_smoke's shapes,
for comparing two commits in turns on one card (parent, change, change,
parent).

Run by path, with the root of the checkout to measure (an unpacked ``git
archive`` of the parent, or this checkout's root)::

    for t in parent . . parent; do
        python3 raft_tpu_torch/profiles/cagra_walk_turns.py $t
    done

Each run imports that checkout's ``raft_tpu_torch`` and ``chip_smoke``
(whose timers it uses), draws from a fixed seed on the card 1M random rows
of dim 128, a random degree-32 graph (degree 64 for the self-walk) and
its bf16 walk table at pdim 16, and times the walk kernel at the search
batch (5,000 queries, itopk 64, width 2) and at a build self-walk chunk
(8,192 nodes, itopk 96, width 1, degree 64, 8 hops), and the hop kernel
at the build's exact merge (5,371 queries, itopk 65, wd 96, pdim 128),
printing one JSON line of CUDA-event and device ms.  It runs on the card
only: by path, not as a module, so that the checkout named comes first on
``sys.path``.
"""

import json
import os
import sys

N, DIM, PDIM = 1_000_000, 128, 16


def walk_args(g, dev, x, proj, nq, itopk, width, deg):
    """A walk's operands and keywords, seeded from 4,096 random entries as
    ``cagra._search_impl_walk`` seeds it."""
    import torch
    from raft_tpu_torch.neighbors import cagra

    graph = torch.randint(0, N, (N, deg), generator=g, device=dev).int()
    table, _ = cagra._build_walk_table(x, graph, PDIM, proj=proj)
    q = torch.randn(nq, DIM, generator=g, device=dev)
    q_sq, qp, qp_t = cagra._query_side(q, proj, False, None)
    eids = torch.randperm(N, generator=g, device=dev)[:4096].int()
    eproj, esq, eids = cagra._entry_set_of(x, proj, eids)
    buf = cagra._seed_walk(qp, q_sq, eproj, esq, eids, itopk, False)
    return (qp_t, q_sq, table) + tuple(buf), dict(
        deg=deg, search_width=width, max_iterations=10 + itopk // width,
        ip_metric=False, quant=False, scales=None)


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
    proj = torch.randn(DIM, PDIM, generator=g, device=dev) / DIM ** 0.5
    out = {"tree": tree}
    for label, shape in (("search", (5000, 64, 2, 32)),
                         ("self_walk", (8192, 96, 1, 64))):
        args, kw = walk_args(g, dev, x, proj, *shape)
        if label == "self_walk":
            kw["max_iterations"] = 8

        def walk(args=args, kw=kw):
            return cw.cagra_walk(*args, **kw)

        out[f"walk_{label}_ms"] = cs.cuda_ms(walk, reps)
        out[f"walk_{label}_device_ms"] = cs.device_ms(walk, reps,
                                                      "walk_kernel")
        del args
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
    hop_args = (qp, torch.zeros(nq, device=dev), nb_p, nb_sq, nb_id, buf_d,
                buf_i, vis)

    def hop():
        return chop.cagra_hop(*hop_args, ip_metric=False)

    out["hop_merge_ms"] = cs.cuda_ms(hop, reps)
    out["hop_merge_device_ms"] = cs.device_ms(hop, reps, "hop_kernel")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")

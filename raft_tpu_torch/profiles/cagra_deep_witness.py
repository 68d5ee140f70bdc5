"""How good the deep regime's graph is, stage by stage, and what its walk
table's plan does to it: CAGRA builds of ``conf/deep-cagra-10m.json``'s
``raft_cagra.deg32`` (graph degree 32, intermediate degree 64,
``build_n_probes`` 12) on chip_smoke's rows, on the card.

Run from the root of a checkout::

    python3 raft_tpu_torch/profiles/cagra_deep_witness.py

It imports that checkout's ``raft_tpu_torch`` and ``chip_smoke`` (whose
row generator and graph recall it uses) and builds, in this order:

- ``1m_default``: chip_smoke's 1M x 128 flagship rows, the default regime
  (fewer rows than ``_DEEP_SCALE_ROWS``);
- ``1m_deep``: the same rows in the deep regime (``_DEEP_SCALE_ROWS``
  lowered to 1), its walk table planned as at 10M but from 1M rows;
- ``1m_deep_pdim8``: the same, the table cap (``_WALK_TABLE_MAX_BYTES``)
  lowered to 600 MB so the rounds take the 10M plan, (32, 8, int8);
- ``10m_deep``: chip_smoke's 10M x 96 deep rows, as chip_smoke builds them
  (the 6 GiB cap: (32, 8, int8));
- ``10m_deep_pdim16`` and ``10m_deep_deg64``: the cap raised to 8 and 16
  GiB: (32, 16, int8) and (64, 16, int8).

For each it prints one JSON line: build seconds, the rounds' plans, the
intermediate graph's recall@64 on 1,000 strided nodes against
``brute_force.knn`` after the scan, after the reverse merge (deep regime
only), after each walk round and as pruned, and recall@10 of the search at
itopk 96 width 2 on the direct walk (``walk_pdim=0``, the same search
whatever the build's plan) over chip_smoke's 5,000 queries.
"""

import json
import os
import sys
import time

DEEP_CAGRA = dict(graph_degree=32, intermediate_graph_degree=64,
                  build_n_probes=12)
CAPS = {"1m_deep_pdim8": 600_000_000, "10m_deep_pdim16": 8 << 30,
        "10m_deep_deg64": 16 << 30}


def witness(label, db, queries, truth):
    """One build and its search: the JSON line's fields."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra

    import chip_smoke as cs

    res = DeviceResources(seed=0)
    stages = []

    def recall_of(stage, knn):
        torch.cuda.synchronize()
        stages.append((stage, cs.graph_recall(res, db, knn,
                                              cs.GRAPH_RECALL_NODES)))

    real = {name: getattr(cagra, name) for name in (
        "_merge_refine_inplace", "_deep_walk_round", "_graph_refine_round",
        "prune")}

    def merge(dataset, knn, *a, **kw):
        recall_of("scan", knn)
        return real["_merge_refine_inplace"](dataset, knn, *a, **kw)

    def deep_round(dataset, knn, *a, **kw):
        recall_of("reverse_merge" if len(stages) == 1
                  else f"walk_round_{len(stages) - 2}", knn)
        return real["_deep_walk_round"](dataset, knn, *a, **kw)

    def round_(r, dataset, knn, *a, **kw):
        recall_of("scan" if not stages else f"walk_round_{len(stages) - 1}",
                  knn)
        return real["_graph_refine_round"](r, dataset, knn, *a, **kw)

    def prune(r, knn, degree):
        recall_of("pruned_input", knn)
        return real["prune"](r, knn, degree)

    old_rows, old_cap = cagra._DEEP_SCALE_ROWS, cagra._WALK_TABLE_MAX_BYTES
    if "deep" in label:
        cagra._DEEP_SCALE_ROWS = 1
    cagra._WALK_TABLE_MAX_BYTES = CAPS.get(label, old_cap)
    for name, fn in (("_merge_refine_inplace", merge),
                     ("_deep_walk_round", deep_round),
                     ("_graph_refine_round", round_), ("prune", prune)):
        setattr(cagra, name, fn)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = cagra.build(res, cagra.IndexParams(**DEEP_CAGRA), db)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        plans = list(cagra.build.deep_plans) if "deep" in label else None
    finally:
        for name, fn in real.items():
            setattr(cagra, name, fn)
        cagra._DEEP_SCALE_ROWS = old_rows
    try:
        sp = cagra.SearchParams(itopk_size=96, search_width=2, walk_pdim=0)
        _, found = cagra.search(res, sp, index, queries, 10)
    finally:
        cagra._WALK_TABLE_MAX_BYTES = old_cap
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    # the walk rounds' recall was read before each round: the last round's
    # output is the pruned input
    return {"label": label, "rows": db.shape[0], "dim": db.shape[1],
            "build_s": build_s, "build_pdim": cagra.build.build_pdim,
            "deep_plans": plans,
            "stage_seconds": dict(cagra.build.stage_seconds),
            "graph_recall@64": dict(stages),
            "search_recall@10_itopk96_w2_direct": float(hits)
            / truth.numel()}


def main() -> None:
    sys.path.insert(0, os.path.abspath("."))
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import brute_force

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    res = DeviceResources(seed=0)
    for n, dim, labels in (
            (cs.N_DB, cs.DIM, ("1m_default", "1m_deep", "1m_deep_pdim8")),
            (cs.DEEP_DB, cs.DEEP_DIM, ("10m_deep", "10m_deep_pdim16",
                                       "10m_deep_deg64"))):
        db, queries = cs.sift_like(n, cs.N_QUERIES, dim, cs.LATENT, cs.NOISE,
                                   dev)
        _, truth = brute_force.knn(res, db, queries, 10)
        for label in labels:
            print(json.dumps(witness(label, db, queries, truth)), flush=True)
            torch.cuda.empty_cache()
        del db, queries, truth
        torch.cuda.empty_cache()
    print(f"nvidia-smi: {cs.smi()}", flush=True)


if __name__ == "__main__":
    main()

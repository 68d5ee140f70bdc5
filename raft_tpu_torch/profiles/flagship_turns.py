"""The unfiltered flagship batch of one checkout, for comparing two commits
in turns on one card (parent, change, change, parent).

Run by path, with the root of the checkout to measure (an unpacked ``git
archive`` of the parent, or this checkout's root)::

    for t in parent . . parent; do
        python3 raft_tpu_torch/profiles/flagship_turns.py $t
    done

Each run imports that checkout's ``raft_tpu_torch`` and ``chip_smoke``
(whose generator, timers and constants it uses), builds the flagship
IVF-PQ index (1,000,000 x 128, 4,096 lists, pq_dim 64), times five warm
batches of 5,000 queries searched at n_probes 96, k 20 and refined to k
10, and Kernel B's pass-1 device ms on that batch, and prints one JSON
line.  It runs on the card only: by path, not as a module, so that the
checkout named comes first on ``sys.path``.
"""

import json
import os
import sys
import time


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pq_group_scan as pgs

    dev = torch.device("cuda", 0)
    db, queries = cs.sift_like(cs.N_DB, cs.N_QUERIES, cs.DIM, cs.LATENT,
                               cs.NOISE, dev)
    res = DeviceResources(seed=0)
    t0 = time.perf_counter()
    index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=cs.N_LISTS,
                                                 pq_dim=cs.PQ_DIM), db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp = ivf_pq.SearchParams(n_probes=cs.N_PROBES)

    def batch():
        cand = ivf_pq.search(res, sp, index, queries, cs.K_SEARCH)[1]
        return refine(res, db, queries, cand, cs.K)

    batch()
    ms, _ = cs.timed_searches(batch, 5)
    qrot, probes = cs.probe(index, queries)
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, cs.K_SEARCH,
            cs.K_SEARCH)
    _, split = cs.device_split(lambda: pgs.ivf_pq_scan_fused(*args),
                               cs.KERNEL_REPS, ("list_scan_kernel",))
    print(json.dumps({"tree": tree, "build_s": build_s,
                      "search_refine_ms": ms, "median_ms": cs.median(ms),
                      "pass1_device_ms": split["list_scan_kernel"]}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")

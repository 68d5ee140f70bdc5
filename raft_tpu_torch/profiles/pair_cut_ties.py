"""How often Kernel C's merged rows hold an id that the plain version's do
not, with no equal distance beside it in the row.  A profile of the port's
own design, with no JAX script behind it.

Each (query, probe) pair keeps its top kt before a query's pairs are
merged into its top k.  Where two rows of one list tie at that cut (their
distances equal but for the order the products are summed in), Kernel C
and its plain version may keep different ones.  When the kept row then
stands inside its query's merged top k - 1, each version's row holds an id
the other's lacks, with its tie partner nowhere beside it: a tie that only
the two ids' recomputed distances show.

On the deep index of :mod:`.list_scan_decomp` (10,000,000 × 96, n_lists
8192, pq_dim 48, built from a seed-0 handle), ``n_sets`` batches of 5,000
queries at n_probes 96, kt 4, k 20 (chip_smoke's deep batch, then database
rows with 5% noise), one JSON line a batch with the running totals:

- ``pairs``; ``cut_flips``: pairs whose kept rows differ between Kernel D
  and its plain version; ``inside``: those whose last kept row (either
  version's) lies strictly inside its query's merged top k - 1 (Kernel
  C's);
- ``differing_ranks``: ranks where Kernel C's ids differ from the plain
  version's; ``off_adjacent``: those next to no equal distance in the
  kernel's row and not on its last rank; ``off_ties``: those whose two ids
  recompute to distances further apart than the tolerance (a wrong
  result; chip_smoke fails on any).

    python3 -m raft_tpu_torch.profiles.pair_cut_ties [n_sets]
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterator, List

import torch

from raft_tpu_torch.profiles import list_scan_decomp, require_cuda

N_PROBES, KT, K = 96, 4, 20
NOISE = 0.05


def tie_mask(v: torch.Tensor, atol: float = 1e-4) -> torch.Tensor:
    """The ranks of each sorted row within ``atol`` + 1e-4 relative of a
    neighbour in the row, and each row's last finite rank."""
    tol = atol + 1e-4 * v.abs()
    tie = torch.zeros_like(v, dtype=torch.bool)
    near = (v[..., 1:] - v[..., :-1]).abs() <= tol[..., 1:]
    tie[..., 1:] |= near
    tie[..., :-1] |= near
    last = torch.isfinite(v) & ~torch.isfinite(
        torch.cat([v[..., 1:], torch.full_like(v[..., :1], float("inf"))],
                  -1))
    return tie | last


def cut_flips(kv, ki, pv, pi, merged_v) -> Dict[str, int]:
    """Pairs (rows of ``(nq, n_probes, kt)``) whose kept ids differ
    between the kernel (``kv``, ``ki``) and the plain version (``pv``,
    ``pi``), and of them those whose last kept distance lies strictly
    inside the query's merged top k - 1 (``merged_v``, ``(nq, k)``)."""
    flip = (ki.sort(-1)[0] != pi.sort(-1)[0]).any(-1)
    q, p = torch.nonzero(flip, as_tuple=True)
    worst = torch.maximum(kv[q, p, -1], pv[q, p, -1])
    return {"pairs": int(flip.numel()), "cut_flips": int(flip.sum()),
            "inside": int((worst < merged_v[q, -2]).sum())}


def off_ties(vk, ik, ip, dist_of, atol: float = 1e-4) -> Dict[str, int]:
    """Ranks where the kernel's ids ``ik`` differ from the plain version's
    ``ip``; of them those off :func:`tie_mask` of the kernel's sorted
    distances ``vk``; of those the ranks whose two ids recompute
    (``dist_of(q, ids)``) to distances further apart than the
    tolerance."""
    diff = ik != ip
    at = torch.nonzero(diff & ~tie_mask(vk, atol), as_tuple=True)
    gap = (dist_of(at[0], ik[at]) - dist_of(at[0], ip[at])).abs()
    return {"differing_ranks": int(diff.sum()),
            "off_adjacent": int(at[0].numel()),
            "off_ties": int((gap > atol + 1e-4 * vk[at].abs()).sum())}


def code_distances(index, qrot):
    """``dist_of(q, ids)``: each (query, id) distance recomputed from the
    index as Kernels C and D compute it (the bf16 residual times the
    decoded row, summed in fp32)."""
    from raft_tpu_torch.ops import pq_code_scan as pcs

    flat = index.list_indices.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    live = flat >= 0
    slot_of[flat[live].long()] = torch.nonzero(live)[:, 0]

    def dist_of(q, ids):
        slot = slot_of[ids.long()]
        lst = slot // index.capacity
        rows = pcs.decode_codes(
            index.list_codes.reshape(-1, index.code_width)[slot],
            index.codebooks, index.pq_bits).float()
        sub = qrot[q] - index.centers[lst]
        sub = torch.nn.functional.pad(sub, (0, rows.shape[1] - sub.shape[1]))
        ip = (sub.to(torch.bfloat16).float() * rows).sum(-1)
        return ((sub * sub).sum(-1) + index.list_code_rsq.reshape(-1)[slot]
                - 2.0 * ip)
    return dist_of


def run(rows: int, dim: int, n_lists: int, pq_dim: int, fraction: float,
        n_sets: int, device, n_probes: int = N_PROBES, kt: int = KT,
        k: int = K) -> Iterator[Dict]:
    """One IVF-PQ index of ``list_scan_decomp.sift_like`` rows, then the
    counts over ``n_sets`` batches (running totals, one dict a batch).
    On the CPU the wrappers run their plain versions, so every count past
    ``pairs`` is 0."""
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import pq_code_scan as pcs

    db, queries = list_scan_decomp.sift_like(rows, dim, device)
    index = ivf_pq.build(DeviceResources(seed=0, device=device),
                         ivf_pq.IndexParams(n_lists=n_lists, pq_dim=pq_dim,
                                            kmeans_trainset_fraction=fraction),
                         db)
    ivf_pq._with_code_rsq(index)
    gen = torch.Generator(device=device).manual_seed(1)
    totals: Dict[str, int] = {}
    for s in range(n_sets):
        if s:
            pick = torch.randint(0, rows, (queries.shape[0],), device=device,
                                 generator=gen)
            queries = db[pick] + NOISE * torch.randn(
                queries.shape, device=device, generator=gen)
        qrot = queries @ index.rotation
        probes = ivf_flat._select_clusters(index.centers, qrot, n_probes,
                                           index.metric)
        args = (qrot, index.centers, probes, index.list_codes,
                index.codebooks, index.list_code_rsq, index.list_indices,
                index.pq_bits)
        vk, ik = pcs.ivf_pq_scan_codes_fused(*args, k, kt)
        vp, ip = pcs.ivf_pq_scan_codes_fused_plain(*args, k, kt)
        counts = cut_flips(*pcs.ivf_pq_scan_codes(*args, kt),
                           *pcs.ivf_pq_scan_codes_plain(*args, kt), vk)
        counts.update(off_ties(vk, ik, ip, code_distances(index, qrot)))
        for key, n in counts.items():
            totals[key] = totals.get(key, 0) + n
        yield {"batch": s, **totals}


def main(argv: List[str]) -> None:
    device = require_cuda()
    _, rows, dim, n_lists, pq_dim, fraction = list_scan_decomp.INDEXES[1]
    n_sets = int(argv[0]) if argv else 10
    for line in run(rows, dim, n_lists, pq_dim, fraction, n_sets, device):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Candidate refinement — exact re-ranking (port of
``raft_tpu.neighbors.refine``).

Reference: raft/neighbors/refine.cuh:105.  Gather each query's candidate
rows, compute exact fp32 distances, keep the best k; negative candidate
ids are empty slots.  Plain PyTorch, as the JAX version is plain XLA
(``raft_tpu/neighbors/refine.py:32-57``).  The queries pass the boundary
validator (:mod:`raft_tpu_torch.integrity.boundary`): under ``mask`` a
non-finite query row returns the worst distance and id -1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.outputs import auto_convert_output, raw
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.tracing import range as named_range
from raft_tpu_torch.distance.types import DistanceType, L2_METRICS, SQRT_METRICS
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.utils import precision


@auto_convert_output
def refine(res, dataset, queries, candidates, k: int, *,
           metric: int = DistanceType.L2Unexpanded
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of candidate ids: (distances (q, k) f32, indices (q, k)
    int32), best first.  ``candidates`` (q, n_candidates) are row ids of
    ``dataset``.  The re-rank runs under the ``refine`` stage."""
    with named_range("refine"), precision.highest():
        dataset = ensure_tensor(dataset, res, "dataset")
        queries = ensure_tensor(queries, res, "queries")
        candidates = ensure_tensor(candidates, res, "candidates")
        expects(candidates.ndim == 2
                and candidates.shape[0] == queries.shape[0],
                "refine: (q, n_candidates) ids required")
        expects(k <= candidates.shape[1],
                "refine: k exceeds candidate count")
        expects(metric in L2_METRICS or metric == DistanceType.InnerProduct,
                "refine: L2 / InnerProduct metrics only (as the reference)")
        queries, ok_rows = boundary.check_matrix(
            queries, "queries", site="refine", dim=dataset.shape[1])
        with obs.stage("refine") as st:
            valid = candidates >= 0
            cand = dataset[torch.where(valid, candidates, 0).long()].float()
            qf = queries.float()
            ip = torch.einsum("qd,qcd->qc", qf, cand)
            if metric == DistanceType.InnerProduct:
                d = torch.where(valid, ip,
                                torch.full_like(ip, -float("inf")))
                vals, pos = raw(select_k)(d, k, select_min=False)
            else:
                d = torch.clamp_min((cand * cand).sum(-1) - 2.0 * ip
                                    + (qf * qf).sum(-1, keepdim=True), 0.0)
                if metric in SQRT_METRICS:
                    d = torch.sqrt(d)
                d = torch.where(valid, d, torch.full_like(d, float("inf")))
                vals, pos = raw(select_k)(d, k, select_min=True)
            ids = torch.gather(candidates, 1, pos).int()
            st.fence(vals, ids)
        return boundary.mask_search_outputs(
            vals, ids, ok_rows,
            select_min=metric != DistanceType.InnerProduct)

"""Bucket policy — the closed shape set the executors are warmed for (port
of ``raft_tpu.serving.buckets``).

The warm search executables are shape-specialized (core/aot.py): every
distinct (batch, k) pair is a separate captured CUDA graph.  Serving
therefore admits only a *closed* set of batch shapes — powers of two up
to ``max_batch`` — and pads every cut batch up to its bucket.  The
warmup pass at server start captures each bucket once, so steady state
sees zero new captures no matter how request sizes fluctuate.

Padding rows are zeros; their outputs are flagged through the SAME mask
path the integrity boundary uses for non-finite rows
(:func:`raft_tpu_torch.integrity.boundary.mask_search_outputs`): id -1 and the
worst distance for the metric.  A padded row can never be confused with
a real answer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects


def bucket_sizes(max_batch: int, min_bucket: int = 1) -> Tuple[int, ...]:
    """The closed bucket set: powers of two in [min_bucket, max_batch].

    ``max_batch`` itself is always included even when it is not a power
    of two (it is the shape the closed-loop peak runs at).
    """
    expects(max_batch >= 1, "serving: max_batch must be >= 1")
    expects(min_bucket >= 1, "serving: min_bucket must be >= 1")
    out = []
    b = 1
    while b <= max_batch:
        if b >= min_bucket:
            out.append(b)
        b *= 2
    if not out or out[-1] != max_batch:
        out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, max_batch: int, min_bucket: int = 1) -> int:
    """Smallest bucket holding ``n`` rows (n must be <= max_batch)."""
    expects(1 <= n <= max_batch,
            f"serving: batch of {n} rows exceeds max_batch={max_batch}")
    for b in bucket_sizes(max_batch, min_bucket):
        if b >= n:
            return b
    return max_batch


def pad_rows(x, bucket: int):
    """Zero-pad (n, dim) -> (bucket, dim) (a tensor stays a tensor on its
    device, anything else becomes numpy); returns the input unchanged
    when it already fills the bucket."""
    n = x.shape[0]
    if n == bucket:
        return x
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, 0, 0, bucket - n))
    return np.pad(np.asarray(x), ((0, bucket - n), (0, 0)))


def valid_rows_mask(n_valid: int, bucket: int, device="cpu") -> torch.Tensor:
    """Bool (bucket,) tensor on ``device``, True for real rows — the
    ``ok_rows`` contract of
    :func:`raft_tpu_torch.integrity.boundary.mask_search_outputs`; made
    on the device, so it waits on nothing."""
    return torch.arange(bucket, device=device) < n_valid

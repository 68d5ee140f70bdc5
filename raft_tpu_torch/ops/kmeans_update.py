"""Kernel A: the k-means assignment + centroid-update pass.

Replaces ``raft_tpu/ops/kmeans_update_pallas.py:78 fused_assign_update``
(an XLA product + argmin, then the Pallas one-hot epilogue
``_epi_kernel``).  The CUDA kernel is ``csrc/kmeans_update.cu``; its source
note says what bounds it on an H100 (operations: 2·n·k·dim per pass) and
what the design does about it.

:func:`kmeans_assign_update` launches the kernel for CUDA tensors and runs
:func:`kmeans_assign_update_plain` for CPU tensors — nothing else picks
between them, and a failed build or launch raises.
``kmeans_assign_update.launches`` counts kernel launches.

Contract (``fused_assign_update``'s docstring and padding contract): x and
the centroids are rounded to bf16 for the distance; ``c_sq`` comes from the
unrounded fp32 centroids; ``dmin = min_c(c_sq − 2·bf16(x)·bf16(c))`` in
fp32; the label is the first index of the minimum; ``sums`` accumulate
``w·bf16(x)`` and ``counts`` accumulate ``w`` in fp32; rows of weight 0
contribute nothing.  Add a row's own ``‖x‖²`` to ``dmin`` for its squared
distance.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda

# rows per chunk of the plain version's (chunk, k) accumulator
_PLAIN_CHUNK = 8192


def _prepare(x, weights, centroids):
    expects(x.ndim == 2 and centroids.ndim == 2
            and x.shape[1] == centroids.shape[1],
            "kmeans_assign_update: x (n, dim) and centroids (k, dim) "
            "required")
    expects(weights.shape == (x.shape[0],),
            "kmeans_assign_update: weights (n,) required")
    expects(x.device == weights.device == centroids.device,
            "kmeans_assign_update: tensors on different devices")
    cf = centroids.float()
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    return (xb.contiguous(), weights.float().contiguous(),
            cf.to(torch.bfloat16).contiguous(),
            (cf * cf).sum(1).contiguous())


def kmeans_assign_update_plain(x, weights, centroids
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of the kernel, same arithmetic: the products
    of bf16 values are exact in fp32 and are summed in dimension order, as
    each of the kernel's accumulators sums them, so ``dmin`` and the labels
    are the kernel's bit for bit; ``sums`` differ only by the order of
    their fp32 additions."""
    xb, w, cb, c_sq = _prepare(x, weights, centroids)
    n, dim = xb.shape
    k = cb.shape[0]
    cbf = cb.float()
    labels = torch.empty(n, dtype=torch.int64, device=xb.device)
    dmin = torch.empty(n, dtype=torch.float32, device=xb.device)
    for s in range(0, n, _PLAIN_CHUNK):
        xc = xb[s:s + _PLAIN_CHUNK].float()
        acc = torch.zeros(xc.shape[0], k, dtype=torch.float32,
                          device=xb.device)
        for j in range(dim):
            acc += xc[:, j:j + 1] * cbf[:, j][None, :]
        d = c_sq[None, :] - 2.0 * acc
        lab = torch.argmin(d, dim=1)
        labels[s:s + xc.shape[0]] = lab
        dmin[s:s + xc.shape[0]] = torch.gather(d, 1, lab[:, None])[:, 0]
    keep = w != 0
    sums = torch.zeros(k, dim, dtype=torch.float32, device=xb.device)
    counts = torch.zeros(k, dtype=torch.float32, device=xb.device)
    sums.index_add_(0, labels[keep], w[keep, None] * xb[keep].float())
    counts.index_add_(0, labels[keep], w[keep])
    return sums, counts, dmin


def kmeans_assign_update(x, weights, centroids
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One assignment + update pass: ``(sums (k, dim) f32, counts (k,) f32,
    dmin (n,) f32)``.  CUDA tensors launch Kernel A; CPU tensors run the
    plain version."""
    if not x.is_cuda:
        return kmeans_assign_update_plain(x, weights, centroids)
    xb, w, cb, c_sq = _prepare(x, weights, centroids)
    n, dim = xb.shape
    k = cb.shape[0]
    expects(n < 2 ** 31, "kmeans_assign_update: n must fit an int32")
    dev = xb.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(k, dim, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _cuda.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.raft_kmeans_assign_update(
        xb.data_ptr(), w.data_ptr(), cb.data_ptr(), c_sq.data_ptr(), n, k,
        dim, labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        dmin.data_ptr(), stream)
    _cuda.check(status, "kmeans_assign_update")
    kmeans_assign_update.launches += 1
    return sums, counts, dmin


kmeans_assign_update.launches = 0

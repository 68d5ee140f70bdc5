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

:func:`kmeans_pass_cut` runs the pass cut into the parts the k-means
profiles time (``profiles/kmeans_decomp_r5.py:67 run`` and
``profiles/kmeans_kernel_r5.py:77 run_variant``), as Kernel A variants of
the same CUDA source; ``raft_tpu_torch.profiles.kmeans_decomp_r5`` and
``.kmeans_kernel_r5`` time them.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    xb, cb, c_sq = _rows_and_centroids(x, centroids)
    return xb, weights.float().contiguous(), cb, c_sq


def _rows_and_centroids(x, centroids):
    """bf16 rows, bf16 centroids and the unrounded centroids' squared
    norms, contiguous."""
    cf = centroids.float()
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    return (xb.contiguous(), cf.to(torch.bfloat16).contiguous(),
            (cf * cf).sum(1).contiguous())


def _plain_distances(xb, cb, c_sq):
    """``(first row, d)`` per chunk of rows: ``d = c_sq − 2·acc``, each
    accumulator summing the exact bf16 products in dimension order, as the
    kernel's accumulators sum them."""
    cbf = cb.float()
    for s in range(0, xb.shape[0], _PLAIN_CHUNK):
        xc = xb[s:s + _PLAIN_CHUNK].float()
        acc = torch.zeros(xc.shape[0], cb.shape[0], dtype=torch.float32,
                          device=xb.device)
        for j in range(xb.shape[1]):
            acc += xc[:, j:j + 1] * cbf[:, j][None, :]
        yield s, c_sq[None, :] - 2.0 * acc


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
    labels = torch.empty(n, dtype=torch.int64, device=xb.device)
    dmin = torch.empty(n, dtype=torch.float32, device=xb.device)
    for s, d in _plain_distances(xb, cb, c_sq):
        lab = torch.argmin(d, dim=1)
        labels[s:s + d.shape[0]] = lab
        dmin[s:s + d.shape[0]] = torch.gather(d, 1, lab[:, None])[:, 0]
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


# ---------------------------------------------------------------------------
# the pass cut into its parts (the k-means profiles' variants)
# ---------------------------------------------------------------------------

# the cuts, in the C entry point's order; "full" (kmeans_decomp_r5) is "uw"
PASS_CUTS = ("mm", "mmmin", "mmargmin", "uw", "mxuonly")
_CUT_ALIASES = {"full": "uw"}


def _cut_index(cut: str) -> int:
    cut = _CUT_ALIASES.get(cut, cut)
    expects(cut in PASS_CUTS,
            f"kmeans_pass_cut: cut must be one of {PASS_CUTS} or 'full', "
            f"got {cut!r}")
    return PASS_CUTS.index(cut)


def _check_cut(x, centroids):
    expects(x.ndim == 2 and centroids.ndim == 2
            and x.shape[1] == centroids.shape[1]
            and x.device == centroids.device,
            "kmeans_pass_cut: x (n, dim) and centroids (k, dim) on one "
            "device required")


def kmeans_pass_cut_plain(x, centroids, cut: str
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`kmeans_pass_cut`, Kernel A's
    arithmetic: ``dmin`` and the labels bit for bit, the sums of ``uw``
    and the column sums of ``mxuonly`` to the order of their fp32
    additions."""
    c = _cut_index(cut)
    _check_cut(x, centroids)
    xb, cb, c_sq = _rows_and_centroids(x, centroids)
    n, dim = xb.shape
    k = cb.shape[0]
    dev = xb.device
    sums = torch.zeros(k, dim, dtype=torch.float32, device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    labels = (torch.empty(n, dtype=torch.int32, device=dev)
              if PASS_CUTS[c] in ("mmargmin", "uw") else None)
    for s, d in _plain_distances(xb, cb, c_sq):
        rows = slice(s, s + d.shape[0])
        if PASS_CUTS[c] == "mm":
            dmin[rows] = d[:, 0]
        elif labels is None:
            dmin[rows] = d.min(1).values
            if PASS_CUTS[c] == "mxuonly":
                counts += d.sum(0)
        else:
            lab = torch.argmin(d, dim=1)
            labels[rows] = lab
            dmin[rows] = torch.gather(d, 1, lab[:, None])[:, 0]
    if PASS_CUTS[c] == "mmargmin":
        counts[:] = float(labels.sum())
    elif PASS_CUTS[c] == "uw":
        sums.index_add_(0, labels, xb.float())
        counts = torch.bincount(labels, minlength=k).float()
    return sums, counts, dmin, labels


def kmeans_pass_cut(x, centroids, cut: str
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """One k-means pass cut at ``cut``: ``(sums (k, dim), counts (k,), dmin
    (n,), labels (n,) or None)``, f32 but the int32 labels.  Rows and centroids are rounded to bf16 as Kernel A rounds
    them; ``d = c_sq − 2·bf16(x)·bf16(c)``.

    - ``mm``: the product alone, ``dmin = d[:, 0]`` (the kernel also
      writes a checksum of every product to scratch, so none is skipped);
    - ``mmmin``: ``dmin`` the row min;
    - ``mmargmin``: + the labels (first argmin); ``counts[:]`` = the sum
      of the labels, exact and rounded once to fp32;
    - ``uw`` (``full``): + ``sums`` of bf16(x) per label, ``counts`` the
      row counts — Kernel A at unit weights with no weight multiply;
    - ``mxuonly``: the row min, ``counts[c]`` = the sum of ``d[:, c]``
      over the rows.

    Sums and counts are zero where a cut computes none.  The JAX variants
    also count the zero rows they pad ``x`` with (a TPU layout artifact);
    only the real rows count here.  CUDA tensors launch the Kernel A
    variant (``kmeans_pass_cut.launches``); CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return kmeans_pass_cut_plain(x, centroids, cut)
    c = _cut_index(cut)
    _check_cut(x, centroids)
    xb, cb, c_sq = _rows_and_centroids(x, centroids)
    n, dim = xb.shape
    k = cb.shape[0]
    expects(n < 2 ** 31 and k >= 1,
            "kmeans_pass_cut: n must fit an int32, k >= 1")
    dev = xb.device
    sums = torch.empty(k, dim, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    dmin = torch.empty(n, dtype=torch.float32, device=dev)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    # mm's per-warp checksums; mmargmin's 64-bit label sum
    aux = torch.empty(max(1, -(-n // 128) * 8), dtype=torch.float32,
                      device=dev)
    label_sum = torch.empty(1, dtype=torch.int64, device=dev)
    status = _cuda.library().raft_kmeans_pass_cut(
        xb.data_ptr(), cb.data_ptr(), c_sq.data_ptr(), n, k, dim, c,
        labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        dmin.data_ptr(), aux.data_ptr(), label_sum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "kmeans_pass_cut")
    kmeans_pass_cut.launches += 1
    return (sums, counts, dmin,
            labels if PASS_CUTS[c] in ("mmargmin", "uw") else None)


kmeans_pass_cut.launches = 0

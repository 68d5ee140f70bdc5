"""Kernel A: the k-means assignment + centroid-update pass.

Replaces ``raft_tpu/ops/kmeans_update_pallas.py:78 fused_assign_update``
(an XLA product + argmin, then the Pallas one-hot epilogue
``_epi_kernel``).  The CUDA kernel is ``csrc/kmeans_update.cu`` over
``csrc/nn_tile_mma.cuh``; their source notes say what bounds it on an
H100 (operations: 2·n·k·dim bf16 products per pass) and what the design
does about it (the product on the bf16 tensor cores, ``wgmma``, with the
row min folded in where the accumulators lie).

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

Numerics: the bf16 products are exact in fp32 in both versions.  The plain
version sums them in dimension order; the tensor core in its own order.
So the kernel's ``dmin`` is the plain version's within rounding, and at a
near-tie its label may be the other centroid.  :func:`check_assignment`
holds a kernel result to its plain version on those terms:
``|dmin − plain dmin| ≤ τ`` (:func:`tie_tolerance`), and each label that
differs is at a tie, its plain distance within ``2τ`` of the plain min.
The update is then exact to its own labels (:func:`update_plain`).

:func:`kmeans_pass_cut` runs the pass cut into the parts the k-means
profiles time (``profiles/kmeans_decomp_r5.py:67 run`` and
``profiles/kmeans_kernel_r5.py:77 run_variant``), as Kernel A variants of
the same CUDA source; ``raft_tpu_torch.profiles.kmeans_decomp_r5`` and
``.kmeans_kernel_r5`` time them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    accumulator summing the exact bf16 products in dimension order."""
    cbf = cb.float()
    for s in range(0, xb.shape[0], _PLAIN_CHUNK):
        xc = xb[s:s + _PLAIN_CHUNK].float()
        acc = torch.zeros(xc.shape[0], cb.shape[0], dtype=torch.float32,
                          device=xb.device)
        for j in range(xb.shape[1]):
            acc += xc[:, j:j + 1] * cbf[:, j][None, :]
        yield s, c_sq[None, :] - 2.0 * acc


def _assign_plain(xb, cb, c_sq):
    """(labels int32, dmin f32): the first argmin of each row's ``d``."""
    n = xb.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=xb.device)
    dmin = torch.empty(n, dtype=torch.float32, device=xb.device)
    for s, d in _plain_distances(xb, cb, c_sq):
        lab = torch.argmin(d, dim=1)
        labels[s:s + d.shape[0]] = lab.int()
        dmin[s:s + d.shape[0]] = torch.gather(d, 1, lab[:, None])[:, 0]
    return labels, dmin


def update_plain(x, weights, labels, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass's update from given labels: ``(sums (k, dim), counts
    (k,))`` of ``w·bf16(x)`` and ``w`` per label, f32; rows of weight 0
    add nothing."""
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    w = weights.float()
    keep = w != 0
    lab = labels.long()[keep]
    sums = torch.zeros(k, xb.shape[1], dtype=torch.float32, device=xb.device)
    counts = torch.zeros(k, dtype=torch.float32, device=xb.device)
    sums.index_add_(0, lab, w[keep, None] * xb[keep].float())
    counts.index_add_(0, lab, w[keep])
    return sums, counts


def kmeans_assign_update_labelled_plain(x, weights, centroids
                                        ) -> Tuple[torch.Tensor, ...]:
    """:func:`kmeans_assign_update_plain` with the labels: ``(sums,
    counts, dmin, labels int32)``."""
    xb, w, cb, c_sq = _prepare(x, weights, centroids)
    labels, dmin = _assign_plain(xb, cb, c_sq)
    sums, counts = update_plain(xb, w, labels, cb.shape[0])
    return sums, counts, dmin, labels


def kmeans_assign_update_plain(x, weights, centroids
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of the kernel: the same exact bf16 products,
    summed in dimension order (the kernel's tensor core sums them in its
    own order: :func:`check_assignment`); ``sums`` as the kernel's up to
    the order of their fp32 additions."""
    return kmeans_assign_update_labelled_plain(x, weights, centroids)[:3]


def kmeans_assign_update_labelled(x, weights, centroids
                                  ) -> Tuple[torch.Tensor, ...]:
    """:func:`kmeans_assign_update` with the labels: ``(sums, counts,
    dmin, labels int32)``."""
    if not x.is_cuda:
        return kmeans_assign_update_labelled_plain(x, weights, centroids)
    xb, w, cb, c_sq = _prepare(x, weights, centroids)
    n, dim = xb.shape
    k = cb.shape[0]
    expects(n < 2 ** 31 and k >= 1,
            "kmeans_assign_update: n must fit an int32, k >= 1")
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
    return sums, counts, dmin, labels


def kmeans_assign_update(x, weights, centroids
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One assignment + update pass: ``(sums (k, dim) f32, counts (k,) f32,
    dmin (n,) f32)``.  CUDA tensors launch Kernel A; CPU tensors run the
    plain version."""
    return kmeans_assign_update_labelled(x, weights, centroids)[:3]


kmeans_assign_update.launches = 0


# ---------------------------------------------------------------------------
# kernel against plain: tie-aware
# ---------------------------------------------------------------------------

def tie_tolerance(x, centroids) -> float:
    """τ = 4·dim·2⁻²⁴·(max‖bf16 x‖² + max‖bf16 c‖²): how far two fp32 sums
    of the same exact bf16 products, added in different orders, may set
    one ``d = c_sq − 2·x·c`` apart.  Each of a sum's ``dim`` additions
    rounds by at most 2⁻²⁴ of a partial sum no larger than ‖x‖‖c‖ ≤
    (‖x‖² + ‖c‖²)/2; ``d`` doubles it, two sums double it again, and τ
    keeps a factor 2 to spare."""
    xb, cb, _ = _rows_and_centroids(x, centroids)

    def max_sq(a):
        return float((a.float() ** 2).sum(1).max()) if a.shape[0] else 0.0

    return 4.0 * xb.shape[1] * 2.0 ** -24 * (max_sq(xb) + max_sq(cb))


class AssignmentCheck(NamedTuple):
    """A kernel assignment against its plain version
    (:func:`check_assignment`): τ, the largest ``|dmin − plain dmin|``, the
    labels that differ from the plain version's, and those of them off a
    tie (plain distance more than 2τ above the plain min)."""

    tau: float
    dmin_err: float
    flips: int
    off_tie: int

    @property
    def ok(self) -> bool:
        return self.dmin_err <= self.tau and self.off_tie == 0


def _plain_distance_of(xb, cb, c_sq, labels):
    """The plain version's ``d`` of each row to the centroid it is given:
    the exact bf16 products summed in dimension order."""
    xf = xb.float()
    cf = cb[labels].float()
    acc = torch.zeros(xf.shape[0], dtype=torch.float32, device=xf.device)
    for j in range(xf.shape[1]):
        acc += xf[:, j] * cf[:, j]
    return c_sq[labels] - 2.0 * acc


def check_assignment(x, centroids, dmin, labels, plain_dmin, plain_labels
                     ) -> AssignmentCheck:
    """Hold a kernel's ``(dmin, labels)`` to the plain version's on the same
    ``x`` and centroids, tie-aware: ``|dmin − plain dmin| ≤ τ``
    (:func:`tie_tolerance`), and each label equal to the plain label or
    at a tie, its plain distance within ``2τ`` of the plain min.  Either
    pair of labels may be None (``dmin`` alone is held)."""
    xb, cb, c_sq = _rows_and_centroids(x, centroids)
    tau = tie_tolerance(xb, cb)
    dmin_err = (float((dmin.float() - plain_dmin.float()).abs().max())
                if dmin.numel() else 0.0)
    if labels is None or plain_labels is None:
        return AssignmentCheck(tau, dmin_err, 0, 0)
    lk = labels.long()
    diff = torch.nonzero(lk != plain_labels.long())[:, 0]
    off_tie = 0
    if diff.numel():
        gap = (_plain_distance_of(xb[diff], cb, c_sq, lk[diff])
               - plain_dmin.float()[diff])
        off_tie = int((~(gap <= 2.0 * tau)).sum())
    return AssignmentCheck(tau, dmin_err, int(diff.numel()), off_tie)


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
    """Plain PyTorch version of :func:`kmeans_pass_cut`: the exact bf16
    products summed in dimension order, as
    :func:`kmeans_assign_update_plain` sums them.  The kernel's ``dmin``
    and labels agree with it as :func:`check_assignment` states; its sums
    of ``uw`` and column sums of ``mxuonly`` also differ by the order of
    their fp32 additions."""
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
    if labels is not None:
        sums, counts = pass_cut_update_plain(xb, cut, labels, k)
    return sums, counts, dmin, labels


def pass_cut_update_plain(x, cut: str, labels, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums, counts)`` of the cuts with labels, from given labels:
    ``mmargmin`` counts[:] = the labels' exact sum rounded once, no sums;
    ``uw`` the sums of bf16(x) and the row counts per label."""
    cut = _CUT_ALIASES.get(cut, cut)
    expects(cut in ("mmargmin", "uw"),
            "pass_cut_update_plain: only mmargmin and uw have labels")
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    lab = labels.long()
    sums = torch.zeros(k, xb.shape[1], dtype=torch.float32, device=xb.device)
    if cut == "mmargmin":
        return sums, torch.full((k,), float(lab.sum()), dtype=torch.float32,
                                device=xb.device)
    sums.index_add_(0, lab, xb.float())
    return sums, torch.bincount(lab, minlength=k).float()


def kmeans_pass_cut(x, centroids, cut: str
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """One k-means pass cut at ``cut``: ``(sums (k, dim), counts (k,), dmin
    (n,), labels (n,) or None)``, f32 but the int32 labels.  Rows and
    centroids are rounded to bf16 as Kernel A rounds them; ``d = c_sq −
    2·bf16(x)·bf16(c)``.

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
    # mm's per-warp checksums (one a warp at 256-row blocks of 16 warps,
    # as many as 128-row blocks of 8 need); mmargmin's 64-bit label sum
    aux = torch.empty(max(1, -(-n // 256) * 16), dtype=torch.float32,
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

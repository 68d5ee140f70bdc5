"""Kernel H: fused L2 distance + 1-nearest-neighbour argmin.

Replaces ``raft_tpu/ops/fused_l2_nn_pallas.py:65 fused_l2_nn_pallas`` (the
reference's ``fusedL2NN``).  The CUDA kernels are in
``csrc/fused_l2_nn.cu``: at ``k > SMALL_DIM`` the 3xTF32 tensor-core pass
of ``csrc/nn_tile_tf32.cuh`` (the x rows split once into TF32 hi and lo
parts and kept in shared memory, the rows of y streamed and split in
registers, three TF32 ``wgmma`` products per 8 dims, the argmin folded on
the accumulator fragment), whose shared-memory layout
:func:`nn_tf32_layout` computes; at ``k <= SMALL_DIM`` (the IVF-PQ
codebook fits) a kernel that keeps one row of x in registers a thread and
streams whole rows of y through shared memory.  Their source notes say
what bounds them on an H100.

:func:`fused_l2_nn` launches a kernel for CUDA tensors, picked by ``k``
alone (:func:`route`), and runs :func:`fused_l2_nn_plain` for CPU tensors
— nothing else picks between them, and a failed build or launch raises.
``fused_l2_nn.launches`` counts kernel launches, of either kernel;
``fused_l2_nn.small_dim_launches`` the small-dim kernel's among them.
:func:`fused_l2_nn_batched` runs the small-dim kernel over a batch of
independent problems of one shape in one launch (its own count,
``fused_l2_nn_batched.launches``).
:func:`fused_l2_nn_variant` reaches the kernels no entry point takes (the
SIMT tile of ``csrc/nn_tile.cuh``, the k > 16 kernel before the
tensor-core one, and the tensor-core pass at a fixed block size), for
same-run comparisons on the card.

Contract, for x (m, k) and y (n, k), both fp32: ``d = max(‖x‖² + ‖y‖² −
2·x·y, 0)`` with ``‖x‖²``, ``‖y‖²`` fp32 sums and the product fp32-accurate
(the reference's is a dot at ``Precision.HIGHEST``, summed in the MXU's
order); ``(dmin (m,) f32, idx (m,) i32)`` is each row's minimum and the
FIRST index reaching it; ``sqrt=True`` returns ``sqrt(dmin)``.  The (m, n)
matrix is never materialised by the kernel.  The small-dim kernel sums in
dimension order and equals the plain version bit for bit; the tensor-core
pass sums 3xTF32 products in the tensor core's order, within ~1.5·2⁻²⁰
(‖x‖² + ‖y‖²) of it, so an index may differ at a near-tie.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.utils import precision

# elements per chunk of the plain version's (rows, n) distance block
_PLAIN_BLOCK = 1 << 26
# elements of x whose squares the launch sums at once: ||x||² of a larger
# x is summed a block of rows at a time, not through one (m, k) temporary
_NORM_BLOCK = 1 << 28
# k at or below: the small-dim kernel (csrc/fused_l2_nn.cu kSmallDim)
SMALL_DIM = 16
# an H100 block's dynamic shared memory
_SMEM_LIMIT = 232_448
# the tensor-core pass's stage: 128 rows x 32 fp32 dims, in bytes
_OP = 128 * 128


class NnLayout(NamedTuple):
    """The dynamic shared memory of one block of the tensor-core pass, in
    the field order of ``csrc/nn_tile_tf32.cuh``'s ``NnLayout``: the one
    copy of the formula (the launch passes it and the kernel reads it).
    ``resident``: x's every dim stays in shared memory; then byte offsets
    from the 1024-byte aligned base: x's hi parts at 0 and their lo parts
    at ``a_lo`` (atom columns, or stages, ``a_step`` apart), the centroid
    stages at ``b``, the two tiles' ``y_sq`` at ``csq``, and ``total``,
    the bytes a block requests."""
    resident: int
    a_step: int
    a_lo: int
    b: int
    csq: int
    total: int

    def as_c(self):
        """The layout as the C entry point reads it: a ctypes array of
        ints in field order."""
        return (ctypes.c_int * len(self))(*self)


@functools.lru_cache(maxsize=None)
def nn_tf32_layout(dim: int, warpgroups: int) -> NnLayout:
    """:class:`NnLayout` of a ``dim``-wide pass with blocks of
    ``warpgroups`` × 64 rows: x as TF32 hi and lo parts (``warpgroups`` ×
    8 KB each per 32 dims: resident when everything fits the card's
    limit, else two 32-dim stages), two stages of 128 centroids x 32 dims,
    hi and lo, two tiles' ``y_sq``, and 1 KB to align the base for the
    swizzle atoms."""
    expects(dim >= 1 and warpgroups in (2, 4),
            f"nn_tf32_layout: dim {dim} >= 1 and 2 or 4 warpgroups required")
    op_a = warpgroups * 64 * 128
    atoms = -(-dim // 32)
    rest = 2 * 2 * _OP + 2 * 128 * 4 + 1024
    resident = 2 * atoms * op_a + rest <= _SMEM_LIMIT
    b = 2 * atoms * op_a if resident else 2 * 2 * op_a
    csq = b + 2 * 2 * _OP
    return NnLayout(int(resident), op_a if resident else 2 * op_a,
                    atoms * op_a if resident else op_a, b, csq,
                    csq + 2 * 128 * 4 + 1024)


def warpgroups_for(m: int, sms: int) -> int:
    """Warpgroups (64 rows of x each) a block of the tensor-core pass
    takes for ``m`` rows on a card of ``sms`` SMs: four once blocks of 256
    rows fill the SMs (x then streams with the centroids past dim 64),
    else two (128 rows, x resident up to dim 160), so a few thousand rows
    still spread over the card — Kernel A's rule
    (``csrc/nn_tile_mma.cuh`` ``row_warpgroups``)."""
    return 4 if -(-m // 256) >= sms else 2


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def route(k: int) -> str:
    """The kernel :func:`fused_l2_nn` launches at row width ``k``:
    ``"small_dim"`` at ``k <= SMALL_DIM``, else ``"tf32"``."""
    return "small_dim" if k <= SMALL_DIM else "tf32"


def _check(x, y):
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "fused_l2_nn: x (m, k) and y (n, k) required")
    expects(y.shape[0] > 0 and x.shape[1] > 0,
            "fused_l2_nn: y needs at least one row and one column")
    expects(x.device == y.device, "fused_l2_nn: tensors on different devices")
    return x.float(), y.float()


def fused_l2_nn_plain(x, y, sqrt: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: fp32 ``x_sq + y_sq − 2·x @ y.T`` (TF32 off),
    clamped at 0, ``torch.argmin`` (first index of the minimum), over row
    chunks of x."""
    xf, yf = _check(x, y)
    m, n = xf.shape[0], yf.shape[0]
    y_sq = (yf * yf).sum(1)
    dmin = torch.empty(m, dtype=torch.float32, device=xf.device)
    idx = torch.empty(m, dtype=torch.int32, device=xf.device)
    rows = max(1, _PLAIN_BLOCK // n)
    with precision.highest():
        for s in range(0, m, rows):
            xc = xf[s:s + rows]
            d = torch.clamp_min((xc * xc).sum(1, keepdim=True)
                                + y_sq[None, :] - 2.0 * (xc @ yf.T), 0.0)
            lab = torch.argmin(d, dim=1)
            dmin[s:s + xc.shape[0]] = torch.gather(d, 1, lab[:, None])[:, 0]
            idx[s:s + xc.shape[0]] = lab.int()
    return (torch.sqrt(dmin) if sqrt else dmin), idx


def _launch(kernel: str, x, y, sqrt: bool, warpgroups: int = 0):
    """One launch of ``kernel`` ("tf32", "small_dim" or "simt") on CUDA
    tensors, outputs allocated here; raises on a CUDA error.  The
    tensor-core pass takes ``warpgroups`` a block, or
    :func:`warpgroups_for`'s at 0."""
    xf, yf = _check(x, y)
    m, k = xf.shape
    n = yf.shape[0]
    expects(m < 2 ** 31 and n < 2 ** 31, "fused_l2_nn: sizes must fit int32")
    xf, yf = xf.contiguous(), yf.contiguous()
    x_sq = torch.cat([(b * b).sum(1)
                      for b in xf.split(max(1, _NORM_BLOCK // k))])
    y_sq = (yf * yf).sum(1)
    dmin = torch.empty(m, dtype=torch.float32, device=xf.device)
    idx = torch.empty(m, dtype=torch.int32, device=xf.device)
    lib = _cuda.library()
    head = (xf.data_ptr(), yf.data_ptr(), x_sq.data_ptr(), y_sq.data_ptr(),
            m, n, k, int(sqrt))
    tail = (dmin.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(xf.device).cuda_stream)
    if kernel == "tf32":
        warpgroups = warpgroups or warpgroups_for(
            m, _sm_count(xf.device.index))
        status = lib.raft_fused_l2_nn(
            *head, warpgroups, nn_tf32_layout(k, warpgroups).as_c(), *tail)
    elif kernel == "small_dim":
        status = lib.raft_fused_l2_nn_small_dim(*head[:4], 1, *head[4:],
                                                *tail)
    else:
        status = lib.raft_fused_l2_nn_simt(*head, *tail)
    _cuda.check(status, f"fused_l2_nn ({kernel})")
    return dmin, idx


def fused_l2_nn(x, y, sqrt: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dmin (m,) f32, idx (m,) i32)``: each row of x's minimum L2²
    distance (or its sqrt) over the rows of y and the first index reaching
    it.  CUDA tensors launch Kernel H (the tensor-core pass, or the
    small-dim kernel at ``k <= SMALL_DIM``); CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return fused_l2_nn_plain(x, y, sqrt)
    kernel = route(x.shape[-1])
    out = _launch(kernel, x, y, sqrt)
    fused_l2_nn.launches += 1
    fused_l2_nn.small_dim_launches += int(kernel == "small_dim")
    return out


fused_l2_nn.launches = 0
fused_l2_nn.small_dim_launches = 0


def _check_batched(x, y):
    expects(x.ndim == 3 and y.ndim == 3 and x.shape[0] == y.shape[0]
            and x.shape[2] == y.shape[2],
            "fused_l2_nn_batched: x (B, m, k) and y (B, n, k) required")
    expects(y.shape[1] > 0 and 1 <= x.shape[2] <= SMALL_DIM,
            f"fused_l2_nn_batched: y needs a row and 1 <= k <= {SMALL_DIM}")
    expects(x.device == y.device,
            "fused_l2_nn_batched: tensors on different devices")
    return x.float(), y.float()


def fused_l2_nn_batched_plain(x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_l2_nn_batched`: a loop of
    :func:`fused_l2_nn_plain` over the members."""
    xf, yf = _check_batched(x, y)
    B, m = xf.shape[:2]
    dmin = torch.empty(B, m, dtype=torch.float32, device=xf.device)
    idx = torch.empty(B, m, dtype=torch.int32, device=xf.device)
    for b in range(B):
        dmin[b], idx[b] = fused_l2_nn_plain(xf[b], yf[b])
    return dmin, idx


def fused_l2_nn_batched(x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dmin (B, m) f32, idx (B, m) i32)``: :func:`fused_l2_nn` of each
    member ``x[b]`` (m, k) against ``y[b]`` (n, k), ``1 <= k <=
    SMALL_DIM``, member b's rows seeing only member b's centres.  CUDA
    tensors launch the small-dim kernel ONCE for the whole batch (a grid
    of row blocks by members; ``fused_l2_nn_batched.launches`` counts the
    launches); CPU tensors run the plain version.  The IVF-PQ codebook
    loops run every subspace (or every coarse list) through it a turn."""
    if not x.is_cuda:
        return fused_l2_nn_batched_plain(x, y)
    xf, yf = _check_batched(x, y)
    B, m, k = xf.shape
    n = yf.shape[1]
    expects(B <= 65535 and B * max(m, n) < 2 ** 31,
            "fused_l2_nn_batched: at most 65535 members, sizes within int32")
    xf, yf = xf.contiguous(), yf.contiguous()
    x_sq = (xf * xf).sum(2)
    y_sq = (yf * yf).sum(2)
    dmin = torch.empty(B, m, dtype=torch.float32, device=xf.device)
    idx = torch.empty(B, m, dtype=torch.int32, device=xf.device)
    status = _cuda.library().raft_fused_l2_nn_small_dim(
        xf.data_ptr(), yf.data_ptr(), x_sq.data_ptr(), y_sq.data_ptr(), B, m,
        n, k, 0, dmin.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(xf.device).cuda_stream)
    _cuda.check(status, "fused_l2_nn_batched")
    fused_l2_nn_batched.launches += 1
    return dmin, idx


fused_l2_nn_batched.launches = 0

# the kernels no entry point takes: name -> (kernel, warpgroups)
VARIANTS = {"simt": ("simt", 0),
            "tf32 2 warpgroups": ("tf32", 2),
            "tf32 4 warpgroups": ("tf32", 4)}


def fused_l2_nn_variant(x, y, variant: str, sqrt: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel H through one of :data:`VARIANTS` on CUDA tensors, for
    same-run comparisons on the card: ``"simt"`` the SIMT tile
    (``csrc/nn_tile.cuh``; sums in dimension order, so it equals the plain
    version bit for bit where cuBLAS does too), ``"tf32 N warpgroups"``
    the tensor-core pass with blocks of N × 64 rows.  No entry point calls it, and its launches
    count in ``fused_l2_nn_variant.launches`` only."""
    expects(variant in VARIANTS, f"fused_l2_nn_variant: {variant!r} is not "
            f"one of {sorted(VARIANTS)}")
    expects(x.is_cuda, "fused_l2_nn_variant: CUDA tensors required")
    kernel, warpgroups = VARIANTS[variant]
    out = _launch(kernel, x, y, sqrt, warpgroups)
    fused_l2_nn_variant.launches += 1
    return out


fused_l2_nn_variant.launches = 0

"""Kernel H: fused L2 distance + 1-nearest-neighbour argmin.

Replaces ``raft_tpu/ops/fused_l2_nn_pallas.py:65 fused_l2_nn_pallas`` (the
reference's ``fusedL2NN``).  The CUDA kernel is ``csrc/fused_l2_nn.cu``
over ``csrc/nn_tile.cuh``, the register-tiled pass Kernel A's assignment
also runs; its source note says what bounds it on an H100 (fp32
operations) and why it stays off the TF32 tensor cores.

:func:`fused_l2_nn` launches the kernel for CUDA tensors and runs
:func:`fused_l2_nn_plain` for CPU tensors — nothing else picks between
them, and a failed build or launch raises.  ``fused_l2_nn.launches``
counts kernel launches.

Contract, for x (m, k) and y (n, k), both fp32: ``d = max(‖x‖² + ‖y‖² −
2·x·y, 0)`` with fp32 products; ``(dmin (m,) f32, idx (m,) i32)`` is each
row's minimum and the FIRST index reaching it; ``sqrt=True`` returns
``sqrt(dmin)``.  The (m, n) matrix is never materialised by the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.utils import precision

# elements per chunk of the plain version's (rows, n) distance block
_PLAIN_BLOCK = 1 << 26


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


def fused_l2_nn(x, y, sqrt: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dmin (m,) f32, idx (m,) i32)``: each row of x's minimum L2²
    distance (or its sqrt) over the rows of y and the first index reaching
    it.  CUDA tensors launch Kernel H; CPU tensors run the plain version."""
    if not x.is_cuda:
        return fused_l2_nn_plain(x, y, sqrt)
    xf, yf = _check(x, y)
    m, k = xf.shape
    n = yf.shape[0]
    expects(m < 2 ** 31 and n < 2 ** 31, "fused_l2_nn: sizes must fit int32")
    xf, yf = xf.contiguous(), yf.contiguous()
    x_sq = (xf * xf).sum(1)
    y_sq = (yf * yf).sum(1)
    dmin = torch.empty(m, dtype=torch.float32, device=xf.device)
    idx = torch.empty(m, dtype=torch.int32, device=xf.device)
    status = _cuda.library().raft_fused_l2_nn(
        xf.data_ptr(), yf.data_ptr(), x_sq.data_ptr(), y_sq.data_ptr(), m, n,
        k, int(sqrt), dmin.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(xf.device).cuda_stream)
    _cuda.check(status, "fused_l2_nn")
    fused_l2_nn.launches += 1
    return dmin, idx


fused_l2_nn.launches = 0

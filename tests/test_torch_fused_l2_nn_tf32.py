"""Kernel H's tensor-core pass (``csrc/nn_tile_tf32.cuh``) off the card.

The kernel itself runs only on a CUDA device (``tests/test_torch_cuda.py``
holds it to the plain version there).  Here, on the CPU: the shared-memory
layout the launch passes it (``ops.fused_l2_nn.nn_tf32_layout``, the one
copy of the formula), the route by row width and the block size, and a
numpy model of its arithmetic — 3xTF32: each operand split into TF32 hi
and lo parts by ``cvt.rna`` (round to nearest, ties away, of the low 13
mantissa bits), the product hi·hi + hi·lo + lo·hi — held to the plain
version within the bound the kernel's note states, its indices equal to
the plain version's or at a distance tie."""

import re

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops import fused_l2_nn as fnn

SMEM_LIMIT = 232_448       # an H100 block's dynamic shared memory


@pytest.mark.parametrize("warpgroups", [2, 4])
@pytest.mark.parametrize("dim", [17, 25, 32, 50, 64, 65, 96, 128, 129, 160,
                                 161, 1000, 4096])
def test_nn_tf32_layout_fits_the_card(dim, warpgroups):
    """The block's shared memory stays within the H100's 232,448 B at every
    dim: x's hi and lo parts stay resident exactly where everything fits
    (up to dim 160 at two warpgroups, 64 at four), else they stream in two
    32-dim stages; the offsets ascend, the swizzled operands' on
    1024-byte atoms."""
    lay = fnn.nn_tf32_layout(dim, warpgroups)
    op_a = warpgroups * 64 * 128          # 64 rows a warpgroup x 32 dims
    op_b = 128 * 128                      # 128 centroids x 32 dims
    atoms = -(-dim // 32)
    rest = 2 * 2 * op_b + 2 * 128 * 4 + 1024
    resident = 2 * atoms * op_a + rest <= SMEM_LIMIT
    assert bool(lay.resident) == resident
    assert lay.resident == (dim <= (160 if warpgroups == 2 else 64))
    assert lay.total <= SMEM_LIMIT
    assert lay.total == (2 * atoms if resident else 4) * op_a + rest
    offsets = lay[2:]                     # a_lo, b, csq, total
    assert list(offsets) == sorted(offsets) and offsets[0] > 0
    assert lay.a_step % 1024 == lay.a_lo % 1024 == lay.b % 1024 == 0
    # x's hi and lo parts end where the centroid stages start
    assert lay.b == 2 * lay.a_lo if resident else lay.b == 2 * lay.a_step
    assert lay.csq == lay.b + 2 * 2 * op_b
    assert list(lay.as_c()) == list(lay)


def test_nn_tf32_layout_fields_match_the_kernel():
    """The layout's field order is the C struct's, which the kernel reads
    from the ints the launch passes."""
    src = (_cuda.SRC_DIR / "nn_tile_tf32.cuh").read_text()
    fields = re.search(r"struct NnLayout \{\s*int ([^;]*);", src).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == \
        fnn.NnLayout._fields


def test_nn_tf32_layout_rejects_what_the_kernel_does_not_take():
    with pytest.raises(Exception, match="warpgroups"):
        fnn.nn_tf32_layout(128, 3)
    with pytest.raises(Exception, match="dim"):
        fnn.nn_tf32_layout(0, 2)


@pytest.mark.parametrize("k,kernel", [(1, "small_dim"), (16, "small_dim"),
                                      (17, "tf32"), (128, "tf32"),
                                      (4096, "tf32")])
def test_route_by_row_width(k, kernel):
    """k <= 16 goes to the small-dim kernel, 17 and above to the
    tensor-core pass."""
    assert fnn.route(k) == kernel
    assert (kernel == "small_dim") == (k <= fnn.SMALL_DIM)


@pytest.mark.parametrize("m,warpgroups", [(0, 2), (2_912, 2), (33_536, 2),
                                          (33_537, 4), (1_000_000, 4)])
def test_block_size_by_rows(m, warpgroups):
    """Four warpgroups once 256-row blocks fill an H100's 132 SMs, else
    two (Kernel A's rule)."""
    assert fnn.warpgroups_for(m, 132) == warpgroups


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 20)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(9, 20)).astype(np.float32))
    before = (fnn.fused_l2_nn.launches, fnn.fused_l2_nn.small_dim_launches)
    d, i = fnn.fused_l2_nn(x, y)
    dp, ip = fnn.fused_l2_nn_plain(x, y)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert (fnn.fused_l2_nn.launches,
            fnn.fused_l2_nn.small_dim_launches) == before
    with pytest.raises(Exception, match="CUDA"):
        fnn.fused_l2_nn_variant(x, y, "simt")


def tf32(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero, keeping
    10 mantissa bits (the low 13 bits zero)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(v: np.ndarray):
    """3xTF32's split: hi = tf32(v), lo = tf32(v - hi) (v - hi exact)."""
    hi = tf32(v)
    return hi, tf32((v - hi).astype(np.float32))


def model_3xtf32(x: np.ndarray, y: np.ndarray):
    """The tensor-core pass's arithmetic: x . y as hi·hi + hi·lo + lo·hi
    (each TF32 product exact in fp32; summed here in float64, the tensor
    core sums in fp32 in its own order), d = max(x_sq + y_sq − 2·x·y, 0)
    with fp32 norms, the first index of each row's minimum.  Returns (x·y
    in float64, d (m, n), dmin, idx)."""
    xh, xl = split(x)
    yh, yl = split(y)
    xh, xl, yh, yl = (v.astype(np.float64) for v in (xh, xl, yh, yl))
    dot = xh @ yh.T + xh @ yl.T + xl @ yh.T
    x_sq = (x * x).sum(1, dtype=np.float32)
    y_sq = (y * y).sum(1, dtype=np.float32)
    d = np.maximum(x_sq[:, None] + y_sq[None, :]
                   - np.float32(2) * dot.astype(np.float32), np.float32(0))
    idx = d.argmin(1)
    return dot, d, d[np.arange(len(x)), idx], idx.astype(np.int32)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The model's cvt.rna: ten mantissa bits kept; a value halfway
    between two TF32 values goes away from zero; hi + lo is x within
    2^-22 |x|."""
    one_ulp = np.float32(2.0 ** -10)
    half = np.array([1 + one_ulp / 2, -(1 + one_ulp / 2),
                     1 + 1.5 * one_ulp], np.float32)
    np.testing.assert_array_equal(
        tf32(half), np.array([1 + one_ulp, -(1 + one_ulp), 1 + 2 * one_ulp],
                             np.float32))
    v = np.random.default_rng(1).normal(size=100_000).astype(np.float32)
    hi, lo = split(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(v.astype(np.float64) - hi - lo)
                  <= 2.0 ** -22 * np.abs(v))


@pytest.mark.parametrize("m,n,k", [(300, 700, 17), (257, 129, 25),
                                   (100, 37, 50), (64, 1, 129),
                                   (200, 300, 128), (50, 90, 1000)])
def test_3xtf32_model_matches_the_plain_version(m, n, k):
    """The model's product within the note's ~1.5·2⁻²⁰ (‖x‖² + ‖y‖²) of
    x · y, its dmin within 1e-5 of max ‖x‖² + max ‖y‖² of the plain
    version's (the card tests' tolerance), each index the plain one or at
    a distance tie; near-ties: a duplicated y row (the first copy wins), x
    rows 1e-3 from a y row and equal to one (d near 0)."""
    rng = np.random.default_rng(m + n + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    if n > 5:
        y[n - 1] = y[1]
        x[0] = y[1] + np.float32(1e-3)
        x[2] = y[4]
    dot, d, dmin, idx = model_3xtf32(x, y)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    norms = (x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
    assert np.all(np.abs(dot - x64 @ y64.T) <= 1.5 * 2.0 ** -20 * norms)
    dp, ip = fnn.fused_l2_nn_plain(torch.from_numpy(x), torch.from_numpy(y))
    scale = float((x64 * x64).sum(1).max() + (y64 * y64).sum(1).max())
    np.testing.assert_allclose(dmin, dp.numpy(), rtol=0, atol=1e-5 * scale)
    ip = ip.numpy()
    gap = np.abs(((x64 - y64[idx]) ** 2).sum(1)
                 - ((x64 - y64[ip]) ** 2).sum(1))
    assert np.all((idx == ip) | (gap <= 1e-5 * scale))
    if n > 5:
        assert idx[0] == ip[0] == 1
        assert idx[2] == 4 and d[2, 4] <= 1e-5 * scale
    if n == 1:
        assert not idx.any()


def test_ptxas_report_is_read_per_kernel(monkeypatch):
    """chip_smoke prints the pass's registers and spills from nvcc's
    ``-Xptxas -v`` report in the build log: each matching kernel's own
    lines, the others skipped."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z14small_dim_kernelILi1EEv'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _Z14small_dim_kernelILi1EEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN8raft_mma14nn_tf32_kernel"
        "ILi2ELb1ELb1EEEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN8raft_mma14nn_tf32_kernel"
        "ILi2ELb1ELb1EEEv",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 161 registers, used 1 barriers"])
    monkeypatch.setitem(_cuda.build_logs, "fused_l2_nn.cu", log)
    assert _cuda.ptxas_usage("fused_l2_nn.cu", "nn_tf32_kernel") == [
        ("_ZN8raft_mma14nn_tf32_kernelILi2ELb1ELb1EEEv", 161, 12, 16)]
    assert _cuda.ptxas_usage("fused_l2_nn.cu", "small_dim")[0][1:] == (
        40, 0, 0)
    assert _cuda.ptxas_usage("pair_scan.cu", "nn_tf32_kernel") == []

// Kernel H: fused L2 distance + 1-nearest-neighbour argmin.
//
// Replaces raft_tpu/ops/fused_l2_nn_pallas.py:65 fused_l2_nn_pallas (body
// _kernel), the reference's fusedL2NN.  Contract, for x (m, k) and y
// (n, k) fp32:
//   d[i, j] = max(x_sq[i] + y_sq[j] - 2 x[i] . y[j], 0)
//   dmin[i] = min_j d[i, j]   (sqrt(dmin) when asked)
//   idx[i]  = the FIRST j reaching that minimum
// with x_sq and y_sq fp32 sums.  The (m, n) matrix is never written.  The
// TPU kernel pads y to its tile with +3.0e38 norms; here every edge is
// bounds-checked instead.  The TPU kernel's product is a dot at the
// library's precision, Precision.HIGHEST by default: an fp32-accurate
// multi-pass product summed in the MXU's own order, not a sequential fp32
// sum.
//
// What bounds it on an H100: operations — 2*m*n*k fp32-accurate
// multiply-adds (1.05 TFLOP at 1,000,000 x 4,096 x 128) against
// (m + n)*k*4 bytes.  Two kernels, which the wrapper (ops/fused_l2_nn.py,
// SMALL_DIM) picks by k alone:
//   k > kSmallDim: csrc/nn_tile_tf32.cuh's pass on the TF32 tensor cores
//     as 3xTF32 (three TF32 products of a hi / lo split, 495 TFLOP/s
//     each): 128 or 256 rows of x a block split once into hi and lo
//     (kept in shared memory where they fit), y streamed 128 rows x 32
//     dims a step, the (min, first index) folded on the wgmma
//     accumulator fragment.  It agrees with the plain
//     version within ~1.5 2^-20 (|x|^2 + |y|^2), an index at a near-tie;
//   k <= kSmallDim (the IVF-PQ codebook fits: 65,536 x 2 -> 256): a
//     32-dimension stage would be mostly zeros, so one thread holds one
//     x row in registers, y streams through shared memory as whole rows
//     (read by every thread at once, a broadcast), and the thread sweeps
//     the rows of y in increasing order in plain fp32 FMAs.  The bound
//     there is under 2 us; the launch is the floor.  So the kernel takes
//     a batch axis: a grid of (row blocks, members) runs many independent
//     problems of one shape in one launch (the IVF-PQ codebook loops run
//     every subspace, or every coarse list, in one launch a turn; the
//     TPU package vmaps or lax.maps them).
// csrc/nn_tile.cuh's register-tiled SIMT pass, the k > kSmallDim kernel
// before the tensor-core one, stays as a C entry point that no wrapper
// takes: the same-run yardstick (raft_fused_l2_nn_simt).  The small-dim
// kernel and the SIMT pass compute the same expression in the same order
// — acc = fmaf(x_j, y_j, acc) for j = 0..k-1 from 0, d = fmaxf(x_sq +
// y_sq - 2 acc, 0), a strict < for the first index — so both agree with
// the plain version, whose fp32 product sums in dimension order too, bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "nn_tile.cuh"
#include "nn_tile_tf32.cuh"

namespace {

constexpr int kSmallDim = 16;      // k at or below: the small-dim kernel
constexpr int kSmallThreads = 256;
constexpr int kSmallTile = 512;    // rows of y a shared-memory tile

template <int D>
__global__ void __launch_bounds__(kSmallThreads)
small_dim_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ x_sq,
                 const float* __restrict__ y_sq, int m, int n,
                 int take_sqrt, float* __restrict__ dmin,
                 int* __restrict__ idx) {
  __shared__ float ys[kSmallTile * D];
  __shared__ float yq[kSmallTile];
  // member b of a batch: its own m rows of x against its own n rows of y
  const size_t b = blockIdx.y;
  x += b * m * D;
  x_sq += b * m;
  y += b * n * D;
  y_sq += b * n;
  dmin += b * m;
  idx += b * m;
  const int r = blockIdx.x * kSmallThreads + threadIdx.x;
  const bool live = r < m;
  float xr[D];
#pragma unroll
  for (int t = 0; t < D; ++t) xr[t] = live ? x[(size_t)r * D + t] : 0.f;
  const float xs = live ? x_sq[r] : 0.f;
  float best = INFINITY;
  int best_idx = 0;
  for (int c0 = 0; c0 < n; c0 += kSmallTile) {
    const int rows = min(kSmallTile, n - c0);
    __syncthreads();     // the previous tile is read by every thread
    for (int e = threadIdx.x; e < rows * D; e += kSmallThreads)
      ys[e] = y[(size_t)c0 * D + e];
    for (int e = threadIdx.x; e < rows; e += kSmallThreads)
      yq[e] = y_sq[c0 + e];
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < D; ++t) acc = fmaf(xr[t], ys[j * D + t], acc);
      const float d = fmaxf(xs + yq[j] - 2.f * acc, 0.f);
      if (d < best) {
        best = d;
        best_idx = c0 + j;
      }
    }
  }
  if (live) {
    dmin[r] = take_sqrt ? sqrtf(best) : best;
    idx[r] = best_idx;
  }
}

// grid (row blocks, members): one launch for a whole batch
template <int D>
void launch_small(const float* x, const float* y, const float* x_sq,
                  const float* y_sq, int batch, int m, int n, int take_sqrt,
                  float* dmin, int* idx, cudaStream_t s) {
  const dim3 grid((m + kSmallThreads - 1) / kSmallThreads, batch);
  small_dim_kernel<D><<<grid, kSmallThreads, 0, s>>>(
      x, y, x_sq, y_sq, m, n, take_sqrt, dmin, idx);
}

// the small-dim kernel unrolled for k = 1..kSmallDim
using SmallLaunch = void (*)(const float*, const float*, const float*,
                             const float*, int, int, int, int, float*, int*,
                             cudaStream_t);
constexpr SmallLaunch kSmall[kSmallDim] = {
    launch_small<1>,  launch_small<2>,  launch_small<3>,  launch_small<4>,
    launch_small<5>,  launch_small<6>,  launch_small<7>,  launch_small<8>,
    launch_small<9>,  launch_small<10>, launch_small<11>, launch_small<12>,
    launch_small<13>, launch_small<14>, launch_small<15>, launch_small<16>};

}  // namespace

// the tensor-core pass (3xTF32), any k >= 1: warpgroups (2 or 4) a
// block of 64 rows each; layout: the block's shared-memory layout for (k,
// warpgroups), 6 host ints in NnLayout's order, from ops/fused_l2_nn.py's
// nn_tf32_layout
extern "C" int raft_fused_l2_nn(const void* x, const void* y,
                                const void* x_sq, const void* y_sq, int m,
                                int n, int k, int take_sqrt, int warpgroups,
                                const void* layout, void* dmin, void* idx,
                                void* stream) {
  using raft_mma::NnLayout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NnLayout L;
  memcpy(&L, layout, sizeof L);
  if (n < 1 || k < 1 || (warpgroups != 2 && warpgroups != 4)
      || !raft_mma::nn_layout_ok(L, warpgroups, k))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  auto xf = static_cast<const float*>(x);
  auto yf = static_cast<const float*>(y);
  auto xq = static_cast<const float*>(x_sq);
  auto yq = static_cast<const float*>(y_sq);
  auto dm = static_cast<float*>(dmin);
  auto ix = static_cast<int*>(idx);
  const bool vec = k % 4 == 0 && ((uintptr_t)x & 15) == 0
                   && ((uintptr_t)y & 15) == 0;
#define RAFT_NN_LAUNCH(WG, RES, VEC)                                         \
  raft_mma::launch_nn_tf32<WG, RES, VEC>(xf, yf, xq, yq, m, n, k, take_sqrt, \
                                         L, dm, ix, s)
#define RAFT_NN_LAUNCH_WG(WG)                                                \
  (L.resident ? (vec ? RAFT_NN_LAUNCH(WG, true, true)                       \
                     : RAFT_NN_LAUNCH(WG, true, false))                     \
              : (vec ? RAFT_NN_LAUNCH(WG, false, true)                      \
                     : RAFT_NN_LAUNCH(WG, false, false)))
  return (int)(warpgroups == 2 ? RAFT_NN_LAUNCH_WG(2) : RAFT_NN_LAUNCH_WG(4));
#undef RAFT_NN_LAUNCH_WG
#undef RAFT_NN_LAUNCH
}

// the SIMT pass, any k: the yardstick no wrapper takes
extern "C" int raft_fused_l2_nn_simt(const void* x, const void* y,
                                     const void* x_sq, const void* y_sq,
                                     int m, int n, int k, int take_sqrt,
                                     void* dmin, void* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (m > 0)
    raft_nn::nn_kernel<<<(m + raft_nn::BM - 1) / raft_nn::BM,
                         raft_nn::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(x_sq), static_cast<const float*>(y_sq), m,
        n, k, take_sqrt, static_cast<int*>(idx), static_cast<float*>(dmin));
  return (int)cudaGetLastError();
}

// the small-dim kernel, 1 <= k <= kSmallDim, over a batch of `batch`
// independent problems laid out member after member: x (batch, m, k), y
// (batch, n, k), their norms (batch, m) and (batch, n), outputs (batch, m);
// member b's rows see only member b's rows of y.  batch 1 is one problem.
extern "C" int raft_fused_l2_nn_small_dim(const void* x, const void* y,
                                          const void* x_sq, const void* y_sq,
                                          int batch, int m, int n, int k,
                                          int take_sqrt, void* dmin,
                                          void* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || k > kSmallDim || batch < 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && batch > 0)
    kSmall[k - 1](static_cast<const float*>(x), static_cast<const float*>(y),
                  static_cast<const float*>(x_sq),
                  static_cast<const float*>(y_sq), batch, m, n, take_sqrt,
                  static_cast<float*>(dmin), static_cast<int*>(idx), s);
  return (int)cudaGetLastError();
}

// Kernel H: fused L2 distance + 1-nearest-neighbour argmin.
//
// Replaces raft_tpu/ops/fused_l2_nn_pallas.py:65 fused_l2_nn_pallas (body
// _kernel), the reference's fusedL2NN.  Contract, for x (m, k) and y
// (n, k) fp32:
//   d[i, j] = max(x_sq[i] + y_sq[j] - 2 x[i] . y[j], 0)   fp32 products
//   dmin[i] = min_j d[i, j]   (sqrt(dmin) when asked)
//   idx[i]  = the FIRST j reaching that minimum
// The (m, n) matrix is never written.  The TPU kernel pads y to its tile
// with +3.0e38 norms; here every edge is bounds-checked instead.
//
// What bounds it on an H100: operations — 2*m*n*k fp32 multiply-adds
// (0.27 TFLOP at 1,000,000 x 1,024 x 128) against (m + n)*k*4 bytes.
// Plain fp32 FMAs, not TF32 tensor cores: TF32 keeps ten mantissa bits of
// each factor and would change the rounding of every distance, so the
// bound is the fp32 peak (67 TFLOP/s).  Two kernels, which the wrapper
// (ops/fused_l2_nn.py, SMALL_DIM) picks by k alone:
//   k > kSmallDim: csrc/nn_tile.cuh's register-tiled SIMT pass: 128 x 128
//     tiles, 8 x 8 accumulators a thread summed in dimension order, y
//     streamed through shared memory 32 dimensions a stage, a running
//     (min, first index) per row in registers, a lexicographic (distance,
//     index) reduce across the 16 threads of a row;
//   k <= kSmallDim (the IVF-PQ codebook fits: 65,536 x 2 -> 256): a
//     32-dimension stage would be mostly zeros, so one thread holds one
//     x row in registers, y streams through shared memory as whole rows
//     (read by every thread at once, a broadcast), and the thread sweeps
//     the rows of y in increasing order.  The bound there is under 2 us;
//     the launch is the floor.
// Both compute the same expression in the same order — acc = fmaf(x_j,
// y_j, acc) for j = 0..k-1 from 0, d = fmaxf(x_sq + y_sq - 2 acc, 0), a
// strict < for the first index — so both agree with the plain version,
// whose fp32 product sums in dimension order too, bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "nn_tile.cuh"

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

template <int D>
void launch_small(const float* x, const float* y, const float* x_sq,
                  const float* y_sq, int m, int n, int take_sqrt,
                  float* dmin, int* idx, cudaStream_t s) {
  small_dim_kernel<D><<<(m + kSmallThreads - 1) / kSmallThreads,
                        kSmallThreads, 0, s>>>(x, y, x_sq, y_sq, m, n,
                                               take_sqrt, dmin, idx);
}

// the small-dim kernel unrolled for k = 1..kSmallDim
using SmallLaunch = void (*)(const float*, const float*, const float*,
                             const float*, int, int, int, float*, int*,
                             cudaStream_t);
constexpr SmallLaunch kSmall[kSmallDim] = {
    launch_small<1>,  launch_small<2>,  launch_small<3>,  launch_small<4>,
    launch_small<5>,  launch_small<6>,  launch_small<7>,  launch_small<8>,
    launch_small<9>,  launch_small<10>, launch_small<11>, launch_small<12>,
    launch_small<13>, launch_small<14>, launch_small<15>, launch_small<16>};

}  // namespace

// the SIMT tile, any k
extern "C" int raft_fused_l2_nn(const void* x, const void* y,
                                const void* x_sq, const void* y_sq, int m,
                                int n, int k, int take_sqrt, void* dmin,
                                void* idx, void* stream) {
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

// the small-dim kernel, 1 <= k <= kSmallDim
extern "C" int raft_fused_l2_nn_small_dim(const void* x, const void* y,
                                          const void* x_sq, const void* y_sq,
                                          int m, int n, int k, int take_sqrt,
                                          void* dmin, void* idx,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || k > kSmallDim) return (int)cudaErrorInvalidValue;
  if (m > 0)
    kSmall[k - 1](static_cast<const float*>(x), static_cast<const float*>(y),
                  static_cast<const float*>(x_sq),
                  static_cast<const float*>(y_sq), m, n, take_sqrt,
                  static_cast<float*>(dmin), static_cast<int*>(idx), s);
  return (int)cudaGetLastError();
}

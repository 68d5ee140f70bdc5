// Kernel H's register-tiled SIMT pass, the k > 16 kernel before the
// tensor-core one (nn_tile_tf32.cuh): no wrapper takes it any more; it
// stays as fused_l2_nn.cu's raft_fused_l2_nn_simt, the same-run yardstick.
// For each row of x, the minimum over the rows of y of
// d = max(x_sq[r] + y_sq[c] - 2 x . y, 0) and the FIRST index reaching
// it, without ever writing the (m, n) matrix.
//
// A block of kThreads threads owns BM rows of x and streams y in tiles of
// BN rows through shared memory, BK dimensions a stage; each thread keeps
// TM x TN accumulators (rows ty + 16 i, columns tx + 16 j) in registers.
// Each accumulator sums its products in dimension order 0..dim-1 in plain
// fp32 FMAs, so a plain version that accumulates in the same order
// reproduces it bit for bit (the contract does not ask for that: the
// reference's product is a dot at Precision.HIGHEST).  After each y
// tile a thread folds its columns into a running (min, first index) per
// row with a strict < in increasing column order; the 16 threads sharing
// a row then reduce by (distance, index) lexicographically.  Rows and
// columns past the edges are bounds-checked: staged as zeros (adding 0*0
// leaves a sum unchanged) and never folded in.  What bounds it: fp32 FMAs
// at 67 TFLOP/s.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace raft_nn {

constexpr int kThreads = 256;
constexpr int BM = 128;   // rows of x per block
constexpr int BN = 128;   // rows of y per tile
constexpr int BK = 32;    // dimensions per shared-memory stage
constexpr int TM = 8;     // rows per thread (strided by 16)
constexpr int TN = 8;     // columns per thread (strided by 16)

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
          const float* __restrict__ x_sq, const float* __restrict__ y_sq,
          int n, int k, int dim, int take_sqrt, int* __restrict__ labels,
          float* __restrict__ dmin) {
  // +1 pad: the staging stores (consecutive threads, consecutive kk)
  // and the compute loads (consecutive threads, consecutive rows or
  // columns) both fall on distinct banks
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;        // column lane: cols tx + 16*j
  const int ty = tid >> 4;        // row lane: rows ty + 16*i
  const int row0 = blockIdx.x * BM;

  float xs[TM];
  float best[TM];
  int best_idx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    xs[i] = r < n ? x_sq[r] : 0.f;
    best[i] = INFINITY;
    best_idx[i] = 0;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += BK) {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr < n && gk < dim) ? x[(size_t)gr * dim + gk] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gc = c0 + r, gk = k0 + kk;
        Bs[kk][r] = (gc < k && gk < dim) ? y[(size_t)gc * dim + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // running min / first argmin: this thread's columns come in
    // increasing order, so a strict < keeps the first minimum
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < k) {
        const float cs = y_sq[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float d = fmaxf(xs[i] + cs - 2.f * acc[i][j], 0.f);
          if (d < best[i]) {
            best[i] = d;
            best_idx[i] = col;
          }
        }
      }
    }
  }

  // merge the 16 threads sharing each row (one half-warp): smaller value
  // wins, equal values go to the smaller index
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best[i];
    int id = best_idx[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      if (ov < v || (ov == v && oi < id)) {
        v = ov;
        id = oi;
      }
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < n) {
      labels[r] = id;
      dmin[r] = take_sqrt ? sqrtf(v) : v;
    }
  }
}

}  // namespace raft_nn

// The register-tiled nearest-row pass shared by Kernel A's assignment
// (kmeans_update.cu) and Kernel H (fused_l2_nn.cu): for each row of x,
// the minimum over the rows of y of a distance built from the dot
// product, and the FIRST index reaching it, without ever writing the
// (n, k) matrix.
//
// A block of kThreads threads owns BM rows of x and streams y in tiles of
// BN rows through shared memory, BK dimensions a stage; each thread keeps
// TM x TN accumulators (rows ty + 16 i, columns tx + 16 j) in registers.
// Each accumulator sums its products in dimension order 0..dim-1 in plain
// fp32 FMAs (no tensor cores), so a plain version that accumulates in the
// same order reproduces it bit for bit.  After each y tile a thread folds
// its columns into a running (min, first index) per row with a strict <
// in increasing column order; the 16 threads sharing a row then reduce by
// (distance, index) lexicographically.  Rows and columns past the edges
// are bounds-checked: staged as zeros (adding 0*0 leaves a sum unchanged)
// and never folded in.
//
// The epilogue is the one difference between the two users:
//   kRowNorm == false (Kernel A):  d = y_sq[c] - 2 acc
//   kRowNorm == true  (Kernel H):  d = max(x_sq[r] + y_sq[c] - 2 acc, 0),
//                                  and sqrt(d) on the way out if asked.
//
// kCut cuts the pass into the parts the k-means profiles time
// (profiles/kmeans_decomp_r5.py:67 run, profiles/kmeans_kernel_r5.py:77
// run_variant), as Kernel A variants; kCutAssign, the default, is the
// pass Kernels A and H run, unchanged:
//   kCutMm:       the product alone; dmin[r] = d[r, 0], and every
//                 accumulator is folded into a per-warp checksum written
//                 to aux[block * kWarps + warp], or nvcc would drop the
//                 products nothing reads and the cut would time less than
//                 the product;
//   kCutMmMin:    + the row min into dmin (no labels);
//   kCutMmArgmin: + the labels, and their sum into *label_sum (an exact
//                 integer, one atomic per warp);
//   kCutMxuOnly:  the row min, and every column's sum of d over the
//                 block's real rows added into aux[c] (one atomic per
//                 column per block, after a shared-memory reduce).

#pragma once

#include <cuda_bf16.h>
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
constexpr int kWarps = kThreads / 32;

constexpr int kCutAssign = 0;
constexpr int kCutMm = 1;
constexpr int kCutMmMin = 2;
constexpr int kCutMmArgmin = 3;
constexpr int kCutMxuOnly = 4;

__device__ __forceinline__ float elem(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float elem(const float* p, size_t i) {
  return p[i];
}

template <typename T, bool kRowNorm, int kCut = kCutAssign>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const T* __restrict__ x, const T* __restrict__ y,
          const float* __restrict__ x_sq, const float* __restrict__ y_sq,
          int n, int k, int dim, int take_sqrt, int* __restrict__ labels,
          float* __restrict__ dmin, float* __restrict__ aux,
          unsigned long long* __restrict__ label_sum) {
  // the cuts without labels keep no index
  constexpr bool kArg = kCut == kCutAssign || kCut == kCutMmArgmin;
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
  float chk = 0.f;     // kCutMm: checksum of every accumulator
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    xs[i] = (kRowNorm && r < n) ? x_sq[r] : 0.f;
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
        As[kk][r] = (gr < n && gk < dim) ? elem(x, (size_t)gr * dim + gk)
                                          : 0.f;
      }
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gc = c0 + r, gk = k0 + kk;
        Bs[kk][r] = (gc < k && gk < dim) ? elem(y, (size_t)gc * dim + gk)
                                          : 0.f;
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

    if constexpr (kCut == kCutMm) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) chk += acc[i][j];
      if (c0 == 0 && tx == 0) {            // column 0 is (tx 0, j 0)
#pragma unroll
        for (int i = 0; i < TM; ++i) best[i] = y_sq[0] - 2.f * acc[i][0];
      }
      continue;
    }

    float colsum[TN];   // kCutMxuOnly: this thread's rows, per column
    // running min / first argmin: this thread's columns come in
    // increasing order, so a strict < keeps the first minimum
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      colsum[j] = 0.f;
      if (col < k) {
        const float cs = y_sq[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float d = kRowNorm ? fmaxf(xs[i] + cs - 2.f * acc[i][j], 0.f)
                                   : cs - 2.f * acc[i][j];
          if constexpr (kCut == kCutMxuOnly) {
            if (row0 + ty + 16 * i < n) colsum[j] += d;
          }
          if (d < best[i]) {
            best[i] = d;
            if constexpr (kArg) best_idx[i] = col;
          }
        }
      }
    }
    if constexpr (kCut == kCutMxuOnly) {
      // the 16 threads of a column (one per ty) through shared memory:
      // As is free until the next tile's staging, after the barrier below
      float* red = &As[0][0];              // [16][BN] of As's BK*(BM+1)
#pragma unroll
      for (int j = 0; j < TN; ++j) red[ty * BN + tx + 16 * j] = colsum[j];
      __syncthreads();
      if (tid < BN && c0 + tid < k) {
        float sum = 0.f;
        for (int t = 0; t < 16; ++t) sum += red[t * BN + tid];
        atomicAdd(aux + c0 + tid, sum);
      }
      __syncthreads();
    }
  }

  if constexpr (kCut == kCutMm) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      chk += __shfl_xor_sync(0xffffffffu, chk, off);
    if ((tid & 31) == 0) aux[blockIdx.x * kWarps + (tid >> 5)] = chk;
  }
  unsigned long long lsum = 0;   // kCutMmArgmin: this lane's labels

  // merge the 16 threads sharing each row (one half-warp): smaller value
  // wins, equal values go to the smaller index
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best[i];
    int id = best_idx[i];
    if constexpr (kCut != kCutMm) {        // kCutMm: d[r, 0] is in tx 0
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, id, off);
        if (ov < v || (ov == v && oi < id)) {
          v = ov;
          id = oi;
        }
      }
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < n) {
      if constexpr (kArg) labels[r] = id;
      if constexpr (kCut == kCutMmArgmin) lsum += (unsigned long long)id;
      dmin[r] = take_sqrt ? sqrtf(v) : v;
    }
  }
  if constexpr (kCut == kCutMmArgmin) {
    // the row sums sit in lanes 0 and 16 (tx 0 of the warp's two rows)
    lsum += __shfl_down_sync(0xffffffffu, lsum, 16);
    if ((tid & 31) == 0) atomicAdd(label_sum, lsum);
  }
}

}  // namespace raft_nn

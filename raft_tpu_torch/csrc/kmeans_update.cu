// Kernel A: one Lloyd pass of balanced k-means — nearest-centroid
// assignment over bf16-rounded rows and centroids, then the weighted
// per-cluster sums and counts.
//
// Replaces raft_tpu/ops/kmeans_update_pallas.py:78 fused_assign_update
// (stage 1: an XLA product + argmin; stage 2: the Pallas one-hot
// epilogue _epi_kernel).  Contract, as there:
//   dmin[i]  = min_c (c_sq[c] - 2 * bf16(x[i]) . bf16(c[c]))   fp32
//   label[i] = the FIRST c reaching that minimum
//   sums[c]  = sum over rows labelled c of w[i] * bf16(x[i])   fp32
//   counts[c]= sum over rows labelled c of w[i]; rows with w == 0 add
//              nothing.
//
// What bounds it on an H100: operations — 2*n*k*dim per pass (0.52
// TFLOP at 500,000 x 4096 x 128) against ~0.13 GB of bytes.  This first
// design is a SIMT register-tiled product in plain fp32 FMAs on the
// bf16-rounded values (no tensor cores): a 128x128 (rows x centroids)
// tile per block, 8x8 accumulators per thread, centroid tiles streamed
// through shared memory, a running min/argmin per row in registers, so
// the (n, k) distance matrix never leaves the SM.  Each accumulator sums
// its products in dimension order 0..dim-1; a product of two bf16 values
// is exact in fp32, so the plain PyTorch version, which accumulates in
// the same order, reproduces dmin and the labels bit for bit.  The update
// is a second kernel: one warp per row, atomicAdd into sums/counts
// (summation order varies from run to run; counts of unit weights stay
// exact).  mma.sync / wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;   // rows per block
constexpr int BN = 128;   // centroids per tile
constexpr int BK = 32;    // dimensions per shared-memory stage
constexpr int TM = 8;     // rows per thread (strided by 16)
constexpr int TN = 8;     // centroids per thread (strided by 16)

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ c,
              const float* __restrict__ c_sq, int n, int k, int dim,
              int* __restrict__ labels, float* __restrict__ dmin) {
  // +1 pad: the staging stores (consecutive threads, consecutive kk)
  // and the compute loads (consecutive threads, consecutive rows or
  // centroids) both fall on distinct banks
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;        // centroid lane: cols tx + 16*j
  const int ty = tid >> 4;        // row lane: rows ty + 16*i
  const int row0 = blockIdx.x * BM;

  float best[TM];
  int best_idx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
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
      // stage rows and centroids (zero past the edges: adding 0*0 to an
      // accumulator leaves it unchanged, so padding never alters a sum)
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr < n && gk < dim) ? bf16_at(x, (size_t)gr * dim + gk)
                                          : 0.f;
      }
      for (int e = tid; e < BN * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gc = c0 + r, gk = k0 + kk;
        Bs[kk][r] = (gc < k && gk < dim) ? bf16_at(c, (size_t)gc * dim + gk)
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

    // running min / first argmin: this thread's centroids come in
    // increasing order, so a strict < keeps the first minimum
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < k) {
        const float cs = c_sq[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float d = cs - 2.f * acc[i][j];
          if (d < best[i]) {
            best[i] = d;
            best_idx[i] = col;
          }
        }
      }
    }
  }

  // merge the 16 threads sharing each row (one half-warp): smaller value
  // wins, equal values go to the smaller centroid index
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
      dmin[r] = v;
    }
  }
}

// one warp per row: weighted row into its cluster's sum
__global__ void __launch_bounds__(kThreads)
update_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ w, const int* __restrict__ labels,
              int n, int dim, float* __restrict__ sums,
              float* __restrict__ counts) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float wr = w[row];
  if (wr == 0.f) return;
  const int lab = labels[row];
  if (lane == 0) atomicAdd(counts + lab, wr);
  for (int j = lane; j < dim; j += 32)
    atomicAdd(sums + (size_t)lab * dim + j,
              wr * bf16_at(x, (size_t)row * dim + j));
}

}  // namespace

extern "C" int raft_kmeans_assign_update(const void* x, const void* w,
                                         const void* c, const void* c_sq,
                                         int n, int k, int dim, void* labels,
                                         void* sums, void* counts, void* dmin,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)k * dim, s);
  cudaMemsetAsync(counts, 0, sizeof(float) * (size_t)k, s);
  if (n > 0) {
    assign_kernel<<<(n + BM - 1) / BM, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(c), static_cast<const float*>(c_sq),
        n, k, dim, static_cast<int*>(labels), static_cast<float*>(dmin));
    const size_t warps_per_block = kThreads / 32;
    update_kernel<<<(unsigned)((n + warps_per_block - 1) / warps_per_block),
                    kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const int*>(labels), n, dim, static_cast<float*>(sums),
        static_cast<float*>(counts));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* raft_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

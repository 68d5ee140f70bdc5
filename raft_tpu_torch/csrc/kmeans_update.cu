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
// the same order, reproduces dmin and the labels bit for bit.  The
// assignment is nn_tile.cuh's nn_kernel, shared with Kernel H.  The update
// is a second kernel: one warp per row, atomicAdd into sums/counts
// (summation order varies from run to run; counts of unit weights stay
// exact).  mma.sync / wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_tile.cuh"

namespace {

constexpr int kThreads = raft_nn::kThreads;

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
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
    raft_nn::nn_kernel<__nv_bfloat16, false>
        <<<(n + raft_nn::BM - 1) / raft_nn::BM, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(c), nullptr,
            static_cast<const float*>(c_sq), n, k, dim, 0,
            static_cast<int*>(labels), static_cast<float*>(dmin));
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

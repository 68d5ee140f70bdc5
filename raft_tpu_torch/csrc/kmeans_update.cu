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
// What bounds it on an H100: operations — 2*n*k*dim bf16 products per
// pass (0.52 TFLOP at 500,000 x 4096 x 128) against ~0.13 GB of bytes.
// The assignment is nn_tile_mma.cuh's tensor-core tile (wgmma m64n128k16,
// bf16 -> fp32): the rows stay in shared memory, centroid tiles stream
// through two cp.async stages, and each tile's epilogue folds the
// accumulators into a running (min, first index) per row where they lie,
// so the (n, k) distance matrix never leaves the SM.  The bf16 products
// are exact in fp32 but the tensor core adds them in its own order, so
// dmin is the plain version's to within rounding (~dim 2^-24 (|x|^2 +
// |c|^2)) and a label may differ at a near-tie; ops/kmeans_update.py's
// check_assignment states the tolerance.  The update is a second kernel:
// one warp per row, atomicAdd into sums/counts (summation order varies
// from run to run; counts of unit weights stay exact): a tenth of the
// pass at 500,000 x 4,096, a quarter at 1M x 1,024, and most of it at
// the mesocluster passes' k = 91 - 128, where the atomics pile onto few
// clusters.
//
// raft_kmeans_pass_cut runs the same pass cut into the parts the k-means
// profiles time (nn_tile_mma.cuh's kCut), as Kernel A variants:
//   mm / mmmin / mmargmin: replace profiles/kmeans_decomp_r5.py:67 run
//     (body _make_kernel :31) at its cuts: the product alone, + the row
//     min, + the labels (counts[:] = their sum, an exact integer rounded
//     once to fp32 — the TPU kernel adds each tile's fp32 sum of labels
//     and broadcasts it over the row);
//   uw (= run's "full"): profiles/kmeans_kernel_r5.py:77 run_variant's
//     _kernel_uw :36 — Kernel A with unit weights and no weight multiply:
//     sums of bf16(x) and row counts;
//   mxuonly: run_variant's _kernel_mxuonly :59 — the row min and counts[c]
//     = the sum over rows of d[:, c].
// The TPU variants pad x with zero rows to their tile, and those rows
// enter uw's counts and mxuonly's column sums: a layout artifact of the
// TPU.  Here only the n real rows count.  The TPU's tile sweep (512 to
// 4,096 rows) is a VMEM knob with no counterpart: every cut runs on
// nn_tile_mma.cuh's tile, as Kernel A does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_tile_mma.cuh"

namespace {

constexpr int kThreads = 256;   // update_kernel: 8 rows a block

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// one warp per row: weighted row into its cluster's sum (kWeighted ==
// false: the unit-weight pass, no weight read and no multiply)
template <bool kWeighted = true>
__global__ void __launch_bounds__(kThreads)
update_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ w, const int* __restrict__ labels,
              int n, int dim, float* __restrict__ sums,
              float* __restrict__ counts) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float wr = kWeighted ? w[row] : 1.f;
  if (kWeighted && wr == 0.f) return;
  const int lab = labels[row];
  if (lane == 0) atomicAdd(counts + lab, wr);
  for (int j = lane; j < dim; j += 32) {
    const float v = bf16_at(x, (size_t)row * dim + j);
    atomicAdd(sums + (size_t)lab * dim + j, kWeighted ? wr * v : v);
  }
}

// counts[:] = the exact sum of the labels, rounded once
__global__ void fill_label_sum(const unsigned long long* __restrict__ total,
                               int k, float* __restrict__ counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < k) counts[c] = (float)*total;
}

// the unit-weight or weighted update of every row, one warp a row
template <bool kWeighted>
void update(const void* x, const void* w, const void* labels, int n,
            int dim, void* sums, void* counts, cudaStream_t s) {
  const size_t rows_per_block = kThreads / 32;
  update_kernel<kWeighted>
      <<<(unsigned)((n + rows_per_block - 1) / rows_per_block), kThreads, 0,
         s>>>(static_cast<const __nv_bfloat16*>(x),
              static_cast<const float*>(w), static_cast<const int*>(labels),
              n, dim, static_cast<float*>(sums),
              static_cast<float*>(counts));
}

}  // namespace

extern "C" int raft_kmeans_assign_update(const void* x, const void* w,
                                         const void* c, const void* c_sq,
                                         int n, int k, int dim, void* labels,
                                         void* sums, void* counts, void* dmin,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)k * dim, s);
  cudaMemsetAsync(counts, 0, sizeof(float) * (size_t)k, s);
  if (n > 0) {
    const cudaError_t e = raft_mma::launch_assign<raft_mma::kCutAssign>(
        x, c, c_sq, n, k, dim, labels, dmin, nullptr, nullptr, s);
    if (e != cudaSuccess) return (int)e;
    update<true>(x, w, labels, n, dim, sums, counts, s);
  }
  return (int)cudaGetLastError();
}

// The cuts, by cut: 0 mm, 1 mmmin, 2 mmargmin, 3 uw, 4 mxuonly (see the
// note above).  sums (k, dim) and counts (k,) are zeroed first; aux:
// mm's checksums (ceil(n / 256) * 16 floats); label_sum: one zeroed 64-bit
// scratch word for mmargmin.  labels (n,) is written by mmargmin and uw.
extern "C" int raft_kmeans_pass_cut(const void* x, const void* c,
                                    const void* c_sq, int n, int k, int dim,
                                    int cut, void* labels, void* sums,
                                    void* counts, void* dmin, void* aux,
                                    void* label_sum, void* stream) {
  using namespace raft_mma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cut < 0 || cut > 4 || k < 1 || (cut == 0 && aux == nullptr)
      || (cut == 2 && label_sum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)k * dim, s);
  cudaMemsetAsync(counts, 0, sizeof(float) * (size_t)k, s);
  if (cut == 2) cudaMemsetAsync(label_sum, 0, sizeof(unsigned long long), s);
  cudaError_t e = cudaSuccess;
  if (n > 0) {
    switch (cut) {
      case 0:
        e = launch_assign<kCutMm>(x, c, c_sq, n, k, dim, labels, dmin, aux,
                                  label_sum, s);
        break;
      case 1:
        e = launch_assign<kCutMmMin>(x, c, c_sq, n, k, dim, labels, dmin,
                                     aux, label_sum, s);
        break;
      case 2:
        e = launch_assign<kCutMmArgmin>(x, c, c_sq, n, k, dim, labels, dmin,
                                        aux, label_sum, s);
        break;
      case 3:
        e = launch_assign<kCutAssign>(x, c, c_sq, n, k, dim, labels, dmin,
                                      aux, label_sum, s);
        if (e == cudaSuccess)
          update<false>(x, nullptr, labels, n, dim, sums, counts, s);
        break;
      default:
        e = launch_assign<kCutMxuOnly>(x, c, c_sq, n, k, dim, labels, dmin,
                                       counts, label_sum, s);
    }
  }
  if (e != cudaSuccess) return (int)e;
  if (cut == 2)
    fill_label_sum<<<(k + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const unsigned long long*>(label_sum), k,
        static_cast<float*>(counts));
  return (int)cudaGetLastError();
}

extern "C" const char* raft_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

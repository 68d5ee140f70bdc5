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
// Design: csrc/nn_tile.cuh's register-tiled SIMT pass, the one Kernel A's
// assignment runs, on fp32 values: 128 x 128 tiles, 8 x 8 accumulators a
// thread summed in dimension order, y streamed through shared memory, a
// running (min, first index) per row in registers, a lexicographic
// (distance, index) reduce across the 16 threads of a row.  Plain fp32
// FMAs, not TF32 tensor cores: TF32 keeps ten mantissa bits of each
// factor and would change the rounding of every distance.  The bound is
// therefore the fp32 peak (67 TFLOP/s), not the tensor cores'.

#include <cuda_runtime.h>

#include "nn_tile.cuh"

extern "C" int raft_fused_l2_nn(const void* x, const void* y,
                                const void* x_sq, const void* y_sq, int m,
                                int n, int k, int take_sqrt, void* dmin,
                                void* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (m > 0)
    raft_nn::nn_kernel<float, true>
        <<<(m + raft_nn::BM - 1) / raft_nn::BM, raft_nn::kThreads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(y),
            static_cast<const float*>(x_sq), static_cast<const float*>(y_sq),
            m, n, k, take_sqrt, static_cast<int*>(idx),
            static_cast<float*>(dmin));
  return (int)cudaGetLastError();
}

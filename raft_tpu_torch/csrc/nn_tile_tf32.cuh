// Kernel H's nearest-centroid pass on Hopper's TF32 tensor cores, as
// 3xTF32 (fused_l2_nn.cu, dim > 16): for each row of x, the minimum over
// the rows of y of d = max(x_sq + y_sq - 2 x . y, 0) and the FIRST index
// reaching it, without ever writing the (m, n) matrix.
//
// What bounds it: operations.  At 1,000,000 x 128 -> 4,096 the function
// needs 1.05 TFLOP of fp32-accurate products against 0.5 GB of bytes: 15.6
// ms at the 67 TFLOP/s of fp32 FFMA, 6.4 ms as three TF32 products at 495
// TFLOP/s.  The design is Kernel A's assign_kernel (nn_tile_mma.cuh) with
// Kernel F's hi / lo split (flat_list_scan.cu):
//
//   - a block is WG warpgroups (ops/fused_l2_nn.py's warpgroups_for: four
//     once such blocks fill the SMs, else two, Kernel A's rule) and owns
//     64 WG rows of x, split once into TF32 hi and lo parts (x = hi + lo
//     within 2^-22 |x|) and stored as the wgmma A operand, K-major in
//     128-byte swizzle atoms of 32 fp32 dims; resident for the block's
//     life where the layout fits (ops/fused_l2_nn.py's nn_tf32_layout
//     computes it and the launch passes it in: up to dim 160 at two
//     warpgroups, 64 at four), else staged 32 dims a step with the
//     centroids (x re-read per centroid tile);
//   - the centroids stream in tiles of 128 rows x 32 dims through two
//     stages: a step's fp32 values are loaded into registers two steps
//     ahead, split into hi and lo there and stored swizzled while the
//     tensor cores work on the other stage.  y is never pre-split in
//     device memory: every block re-reads all of it from L2, and two
//     arrays would double that traffic;
//   - per 8 dims three wgmma m64n128k8 TF32 products, lo.hi + hi.lo +
//     hi.hi, into one fp32 accumulator (64 a thread);
//   - after a tile's last dim step the accumulator fragment is folded
//     where it lies (nn_tile_mma.cuh's fold_fragment, as Kernel A):
//     d = max(x_sq + y_sq[col] - 2 acc, 0) into a running (min, first
//     index) per row with a strict < in increasing column order; after
//     the last tile the four threads sharing a row reduce by (d, index)
//     lexicographically (reduce_quad).  Columns at or past n read y_sq =
//     +inf and are never kept; rows at or past m are staged as zeros and
//     never written.
//
// Rows load 16 bytes at a time where dim % 4 == 0 and x and y are 16-byte
// aligned (kVec), else one value at a time; past the row's dim the
// operands hold zeros, up to the stage's multiple of 32, and every stage
// multiplies all 32 of its dims.
//
// Numerics: 3xTF32 drops lo.lo and rounds each lo part, so each product
// x_i y_i is off by at most ~3 2^-22 |x_i y_i|, and x . y by at most ~1.5
// 2^-20 (|x|^2 + |y|^2) (Cauchy-Schwarz), before the tensor core's own
// fp32 summation order.  So d differs from a sequential fp32 sum by about
// that much, within the 1e-5 (max |x|^2 + max |y|^2) the card tests hold
// it to, and an index may change at a near-tie.  Equal rows of y give
// equal products, so the first of them still wins.  The JAX kernel's
// product is a dot at Precision.HIGHEST, not a sequential fp32 sum either.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_tile_mma.cuh"

namespace raft_mma {

constexpr int kTf32Dims = 32;        // fp32 dims a step: one atom column
constexpr int kTf32Op = BN * 128;    // bytes of 128 rows x kTf32Dims (16 KB)
constexpr int kNnSmemLimit = 232448; // an H100 block's dynamic shared memory

// The block's dynamic shared memory, in the field order of
// ops/fused_l2_nn.py's NnLayout, which computes it (the one copy of the
// formula): resident (x's every dim stays in shared memory), then byte
// offsets from the 1024-aligned base: x's hi parts at 0 (resident: atom
// column c at c * a_step; else stage s at s * a_step), their lo parts
// a_lo further; stage s's centroids, hi then lo, at b + s * 2 kTf32Op;
// tile t's y_sq at csq + (t & 1) * BN * 4; total, the bytes to request.
struct NnLayout {
  int resident, a_step, a_lo, b, csq, total;
};

template <int WG, bool kResident, bool kVec>
__global__ void __launch_bounds__(WG * 128, 1)
nn_tf32_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ x_sq,
               const float* __restrict__ y_sq, int m, int n, int dim,
               int take_sqrt, const NnLayout L, float* __restrict__ dmin,
               int* __restrict__ idx) {
  constexpr int kThreads = WG * 128;
  constexpr int BM = WG * kRowsWg;
  constexpr int kChunksB = BN * 8 / kThreads;  // a step's 16-byte chunks a
  constexpr int kChunksA = BM * 8 / kThreads;  // thread, of y and of x
  extern __shared__ __align__(128) unsigned char smem[];
  // the layout's base, 1024-byte aligned for the swizzle atoms
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;
  const int quad = lane & 3;
  const int row0 = blockIdx.x * BM;
  // this thread's two rows in the block (fragment rows r and r + 8)
  const int rloc = wg * kRowsWg + (warp & 3) * 16 + (lane >> 2);
  const int nchunks = (dim + kTf32Dims - 1) / kTf32Dims;
  const int nsteps = ((n + BN - 1) / BN) * nchunks;

  // step s's operands in registers: chunk e = tid + kThreads i is row e /
  // 8, dims 4 (e % 8) on of the step's 32 (eight lanes a row's 128
  // contiguous bytes); at a tile's first step, threads < 32 also 4 of its
  // y_sq
  float4 rb[kChunksB], ra[kChunksA];
  uint4 rq = make_uint4(0u, 0u, 0u, 0u);
  auto load_step = [&](int s) {
    const int t = s / nchunks, qc = s - t * nchunks;
    const int c0 = t * BN;
#pragma unroll
    for (int i = 0; i < kChunksB; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 3, d = qc * kTf32Dims + 4 * (e & 7);
      rb[i] = row_chunk<kVec>(y + (size_t)(c0 + r) * dim, d, dim,
                              c0 + r < n);
    }
    if constexpr (!kResident) {
#pragma unroll
      for (int i = 0; i < kChunksA; ++i) {
        const int e = tid + i * kThreads;
        const int r = e >> 3, d = qc * kTf32Dims + 4 * (e & 7);
        ra[i] = row_chunk<kVec>(x + (size_t)(row0 + r) * dim, d, dim,
                                row0 + r < m);
      }
    }
    if (qc == 0 && tid < BN / 4) rq = csq_quad(y_sq, c0 + 4 * tid, n);
  };
  // ... then split into stage s & 1, the y_sq into tile t's (t & 1)
  auto store = [&](int s) {
    const int stage = s & 1;
    const int t = s / nchunks, qc = s - t * nchunks;
    const uint32_t b = sbase + L.b + stage * 2 * kTf32Op;
#pragma unroll
    for (int i = 0; i < kChunksB; ++i) {
      const int e = tid + i * kThreads;
      const uint32_t off = sw128_offset(BN, e >> 3, e & 7);
      store_split(b + off, b + kTf32Op + off, rb[i]);
    }
    if constexpr (!kResident) {
      const uint32_t a = sbase + stage * L.a_step;
#pragma unroll
      for (int i = 0; i < kChunksA; ++i) {
        const int e = tid + i * kThreads;
        const uint32_t off = sw128_offset(BM, e >> 3, e & 7);
        store_split(a + off, a + L.a_lo + off, ra[i]);
      }
    }
    if (qc == 0 && tid < BN / 4)
      st_shared16(sbase + L.csq + (t & 1) * BN * 4 + 16 * tid, rq);
  };

  if constexpr (kResident) {
    // every dim of the block's rows, atom column c at c * a_step
    for (int e = tid; e < nchunks * BM * 8; e += kThreads) {
      const int c = e / (BM * 8), rem = e - c * (BM * 8);
      const int r = rem >> 3;
      const uint32_t off = c * L.a_step + sw128_offset(BM, r, rem & 7);
      store_split(sbase + off, sbase + L.a_lo + off,
                  row_chunk<kVec>(x + (size_t)(row0 + r) * dim,
                                  c * kTf32Dims + 4 * (rem & 7), dim,
                                  row0 + r < m));
    }
  }
  // two steps in flight: step s + 1's operands are stored while step s
  // multiplies, and step s + 2's loads run behind them
  load_step(0);
  store(0);
  if (nsteps > 1) load_step(1);

  float xs[2];
  const bool row_ok[2] = {row0 + rloc < m, row0 + rloc + 8 < m};
#pragma unroll
  for (int h = 0; h < 2; ++h) xs[h] = row_ok[h] ? x_sq[row0 + rloc + 8 * h]
                                                : 0.f;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  float best[2] = {INFINITY, INFINITY};
  int best_idx[2] = {0, 0};

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s & 1;
    const int t = s / nchunks, qc = s - t * nchunks;
    // step s's operands (stored last step) and its tile's y_sq are in
    // shared memory, and every warpgroup is done with step s - 1's stage
    fence_proxy_async();
    __syncthreads();

    // A: this warpgroup's 64 rows (8 row groups in); B: the stage
    const uint32_t a_hi = sbase + (kResident ? qc : stage) * L.a_step
                          + wg * 8 * 1024;
    const uint32_t a_lo = a_hi + L.a_lo;
    const uint32_t b_hi = sbase + L.b + stage * 2 * kTf32Op;
    const uint32_t b_lo = b_hi + kTf32Op;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // all four k8 steps of the stage, zeros past dim included: around a
    // loop that stopped at the last live k-step ptxas fenced the
    // accumulators between products (its C7519 remark) and the pass ran
    // slower
#pragma unroll
    for (int ks = 0; ks < kTf32Dims / 8; ++ks) {
      const uint32_t o = ks << 5;    // 32 bytes a k8 step in the atom
      const uint64_t xh = desc_sw128(a_hi + o), xl = desc_sw128(a_lo + o);
      const uint64_t yh = desc_sw128(b_hi + o), yl = desc_sw128(b_lo + o);
      wgmma_m64n128k8_tf32(acc, xl, yh, (qc == 0 && ks == 0) ? 0 : 1);
      wgmma_m64n128k8_tf32(acc, xh, yl, 1);
      wgmma_m64n128k8_tf32(acc, xh, yh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // meanwhile the next step's operands go to the other stage, and the
    // loads of the one after start
    if (s + 1 < nsteps) {
      store(s + 1);
      if (s + 2 < nsteps) load_step(s + 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (qc != nchunks - 1) continue;

    // epilogue of centroid tile t
    fold_fragment<true>(
        acc, reinterpret_cast<const float*>(base + L.csq + (t & 1) * BN * 4),
        t * BN, quad, best, best_idx, [&](float q, float a, int h) {
          return fmaxf(xs[h] + q - 2.f * a, 0.f);
        });
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best[h];
    int id = best_idx[h];
    reduce_quad(v, id);
    if (quad == 0 && row_ok[h]) {
      const int r = row0 + rloc + 8 * h;
      dmin[r] = take_sqrt ? sqrtf(v) : v;
      idx[r] = id;
    }
  }
}

// the layout's offsets ascend from 0, the swizzled operands' on 1024-byte
// atoms, x's hi and lo parts fit below the centroids' stages, and the
// whole fits an H100 block
inline bool nn_layout_ok(const NnLayout& L, int wg, int dim) {
  const int op_a = wg * kRowsWg * 128;
  const int atoms = (dim + kTf32Dims - 1) / kTf32Dims;
  const int a_bytes = L.resident ? 2 * atoms * op_a : 4 * op_a;
  return L.a_step > 0 && L.a_step % 1024 == 0 && L.a_lo % 1024 == 0
         && L.b % 1024 == 0 && L.a_lo >= (L.resident ? atoms : 1) * op_a
         && L.b >= a_bytes && L.csq >= L.b + 4 * kTf32Op
         && L.total >= L.csq + 2 * BN * 4 + 1024 && L.total <= kNnSmemLimit;
}

template <int WG, bool kResident, bool kVec>
cudaError_t launch_nn_tf32(const float* x, const float* y, const float* x_sq,
                           const float* y_sq, int m, int n, int dim,
                           int take_sqrt, const NnLayout& L, float* dmin,
                           int* idx, cudaStream_t s) {
  // once a device: the most shared memory an H100 block takes
  static unsigned set_on = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!((set_on >> dev) & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        nn_tf32_kernel<WG, kResident, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kNnSmemLimit);
    if (e != cudaSuccess) return e;
    set_on |= 1u << dev;
  }
  constexpr int BM = WG * kRowsWg;
  nn_tf32_kernel<WG, kResident, kVec><<<(m + BM - 1) / BM, WG * 128, L.total,
                                        s>>>(x, y, x_sq, y_sq, m, n, dim,
                                             take_sqrt, L, dmin, idx);
  return cudaGetLastError();
}

}  // namespace raft_mma

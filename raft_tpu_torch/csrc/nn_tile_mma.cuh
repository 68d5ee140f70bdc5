// Kernel A's nearest-centroid pass on Hopper's bf16 tensor cores: for
// each row of x, the minimum over the centroids of d = c_sq - 2 x . c and
// the FIRST index reaching it, without ever writing the (n, k) matrix.
//
// What bounds it: operations, 2 n k dim bf16 products (0.52 TFLOP at
// 500,000 x 4,096 x 128) against ~0.13 GB of bytes, so the product runs
// on the tensor cores.  The design:
//
//   - a block is WG warpgroups and owns 64 WG rows of x, staged once into
//     shared memory for the block's whole life (dims padded with zeros to
//     a multiple of 16: a zero adds nothing);
//   - the centroids stream through a ring of 2 shared-memory stages,
//     128 centroids a stage, loaded by cp.async (16-byte chunks, zero-fill
//     past the edges), so tile t + 1 is in flight while tile t is
//     multiplied and reduced;
//   - each warpgroup multiplies its 64 rows by the 128 centroids with
//     wgmma.mma_async m64n128k16 (bf16 x bf16 -> fp32, both operands
//     K-major in shared memory in 128-byte swizzle atoms of 8 rows x 64
//     dims, written swizzled by the cp.async addresses), accumulators in
//     registers (64 a thread);
//   - the epilogue reads the accumulator fragment where it lies: a thread
//     holds rows (r, r + 8) and columns 8 j + 2 (lane % 4) + {0, 1},
//     forms d = c_sq[col] - 2 acc, and keeps a running (min, first index)
//     per row with a strict < in increasing column order; after the last
//     tile the four threads sharing a row reduce by (d, index)
//     lexicographically.  Columns at or past k read c_sq = +inf and are
//     never folded in; rows at or past n are never written.
//
// Every block re-reads the centroid tiles from L2, 2 bytes a centroid
// element per 64 WG rows; at 128-row blocks that traffic, not the
// product, held the pass (at 1M x 128 -> 1,024 on an H100: 0.86 ms for
// the product cut, 0.68 ms of it with the products removed, 0.52 ms with
// the reloads removed).  So a block is four warpgroups (256 rows, one
// block an SM, half the traffic) once such blocks fill the SMs, and two
// (128 rows, two blocks an SM, one's epilogue overlapping the other's
// products) below that, down to the per-mesocluster fits' few thousand
// rows, where 64-row blocks measured no faster.  Dimensions past 128
// stream too: the x rows and the centroids then come in chunks of 128
// dims through the same two stages (x re-read per centroid tile), and
// each tile's accumulators sum over the chunks.
//
// Numerics: each product of two bf16 values is exact in fp32; the tensor
// core adds them in its own order, not in dimension order, so d differs
// from a sequential fp32 sum by rounding (bounded by ~dim 2^-24 (|x|^2 +
// |c|^2)) and a label may differ at a near-tie.
//
// kCut cuts the pass into the parts the k-means profiles time
// (profiles/kmeans_decomp_r5.py:67 run, profiles/kmeans_kernel_r5.py:77
// run_variant); kCutAssign, the default, is Kernel A's assignment:
//   kCutMm:       the product alone; dmin[r] = d[r, 0], and every
//                 accumulator is folded into a per-warp checksum written
//                 to aux[block * warps + warp], or nvcc would drop the
//                 products nothing reads;
//   kCutMmMin:    + the row min into dmin (no labels);
//   kCutMmArgmin: + the labels, and their sum into *label_sum (an exact
//                 integer, one atomic per warp);
//   kCutMxuOnly:  the row min, and every column's sum of d over the real
//                 rows added into aux[c] (one atomic per column per block,
//                 after a shared-memory reduce).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace raft_mma {

constexpr int kCutAssign = 0;
constexpr int kCutMm = 1;
constexpr int kCutMmMin = 2;
constexpr int kCutMmArgmin = 3;
constexpr int kCutMxuOnly = 4;

// byte offsets into the block's dynamic shared memory: stage s's x rows
// at x + s * x_step (x_step 0 when the rows stay resident), its
// centroids at c + s * c_step, their norms at csq + s * BN * 4
struct Layout {
  int x, x_step, c, c_step, csq, red, total;
};

__host__ __device__ inline Layout layout(int wg, int kc, bool resident,
                                         bool red) {
  Layout L;
  const int xb = align1024(operand_bytes(kRowsWg * wg, kc));
  L.x = 0;
  L.x_step = resident ? 0 : xb;
  L.c = resident ? xb : 2 * xb;
  L.c_step = align1024(operand_bytes(BN, kc));
  L.csq = L.c + 2 * L.c_step;
  L.red = L.csq + 2 * BN * 4;
  L.total = L.red + (red ? 4 * wg * BN * 4 : 0) + 1024;   // + alignment
  return L;
}

// c_sq of centroids [col, col + 4) as the bits st_shared16 stores; +inf
// past k
__device__ __forceinline__ uint4 csq_quad(const float* __restrict__ c_sq,
                                          int col, int k) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = col + i < k ? c_sq[col + i] : INFINITY;
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// c_sq of centroids [c0, c0 + 128) at dst; +inf past k
__device__ __forceinline__ void stage_csq(uint32_t dst,
                                          const float* __restrict__ c_sq,
                                          int c0, int k, bool vec, int tid) {
  if (tid >= BN / 4) return;
  const int col = c0 + 4 * tid;
  if (vec && col + 3 < k)
    cp_async16(dst + 16 * tid, c_sq + col, 16);
  else
    st_shared16(dst + 16 * tid, csq_quad(c_sq, col, k));
}

// The epilogue of one centroid tile [c0, c0 + 128) on a warpgroup's
// accumulator fragment: this thread's rows r and r + 8 (h = 0, 1) take
// d = dist(cs[col - c0], acc, h) at its columns 8 j + 2 (lane % 4) + {0,
// 1}, in increasing order, into a running (min, first index) with a
// strict <; cs holds the tile's c_sq (+inf past the edge, never kept).
// kArg: keep the index too.
template <bool kArg, class Dist>
__device__ __forceinline__ void fold_fragment(const float (&acc)[kAccs],
                                              const float* cs, int c0,
                                              int quad, float (&best)[2],
                                              int (&best_idx)[2], Dist dist) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 q2 =
        *reinterpret_cast<const float2*>(cs + 8 * j + 2 * quad);
    const int col = c0 + 8 * j + 2 * quad;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d0 = dist(q2.x, acc[4 * j + 2 * h], h);
      const float d1 = dist(q2.y, acc[4 * j + 2 * h + 1], h);
      if (d0 < best[h]) {
        best[h] = d0;
        if constexpr (kArg) best_idx[h] = col;
      }
      if (d1 < best[h]) {
        best[h] = d1;
        if constexpr (kArg) best_idx[h] = col + 1;
      }
    }
  }
}

// merge the 4 threads sharing a fragment row: smaller value wins, equal
// values go to the smaller index
__device__ __forceinline__ void reduce_quad(float& v, int& id) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    if (ov < v || (ov == v && oi < id)) {
      v = ov;
      id = oi;
    }
  }
}

template <int WG, int kCut>
__global__ void __launch_bounds__(WG * 128, 4 / WG)
assign_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ c,
              const float* __restrict__ c_sq, int n, int k, int dim,
              int* __restrict__ labels, float* __restrict__ dmin,
              float* __restrict__ aux,
              unsigned long long* __restrict__ label_sum) {
  constexpr int kThreads = WG * 128;
  constexpr int BM = WG * kRowsWg;
  // the cuts without labels keep no index
  constexpr bool kArg = kCut == kCutAssign || kCut == kCutMmArgmin;
  extern __shared__ __align__(128) unsigned char smem[];

  const int kp = (dim + 15) & ~15;
  const bool resident = kp <= kKc;
  const int kc = resident ? kp : kKc;
  const int nq = (kp + kc - 1) / kc;
  const int nsteps = ((k + BN - 1) / BN) * nq;
  const Layout L = layout(WG, kc, resident, kCut == kCutMxuOnly);
  // the layout's base, 1024-byte aligned for the swizzle atoms: as a
  // shared address (copies, descriptors) and as a pointer (epilogue)
  unsigned char* base =
      smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const bool vec_x = dim % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_c = dim % 8 == 0 && ((uintptr_t)c & 15) == 0;
  const bool vec_q = ((uintptr_t)c_sq & 15) == 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;            // warp in the block
  const int wg = tid >> 7;              // warpgroup in the block
  const int quad = lane & 3;
  const int row0 = blockIdx.x * BM;
  // this thread's two rows in the block (fragment rows r and r + 8)
  const int rloc = wg * kRowsWg + (warp & 3) * 16 + (lane >> 2);

  auto load_step = [&](int s, int stage) {
    const int t = s / nq, q = s - (s / nq) * nq;
    if (!resident)
      stage_rows(sbase + L.x + stage * L.x_step, x, BM, row0, n, dim, q * kc,
                 kc, vec_x, tid, kThreads);
    stage_rows(sbase + L.c + stage * L.c_step, c, BN, t * BN, k, dim, q * kc,
               kc, vec_c, tid, kThreads);
    stage_csq(sbase + L.csq + stage * BN * 4, c_sq, t * BN, k, vec_q, tid);
  };

  if (resident)
    stage_rows(sbase + L.x, x, BM, row0, n, dim, 0, kc, vec_x, tid,
               kThreads);
  load_step(0, 0);
  cp_async_commit();

  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  float best[2] = {INFINITY, INFINITY};
  int best_idx[2] = {0, 0};
  float chk = 0.f;     // kCutMm: checksum of every accumulator
  const bool row_ok[2] = {row0 + rloc < n, row0 + rloc + 8 < n};

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s & 1;
    const int t = s / nq, q = s - (s / nq) * nq;
    // every warpgroup is done with step s - 1's stage before it refills
    __syncthreads();
    if (s + 1 < nsteps) load_step(s + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();
    fence_proxy_async();
    __syncthreads();

    // A: this warpgroup's 64 rows (8 row groups in); B: the stage
    const uint32_t a0 = sbase + L.x + stage * L.x_step + wg * 8 * 1024;
    const uint32_t b0 = sbase + L.c + stage * L.c_step;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < (kc >> 4); ++ks) {
      // atom column ks / 4, 32 bytes a k16 step within it
      const uint64_t da =
          desc_sw128(a0 + ((ks >> 2) * (BM >> 3) << 10) + ((ks & 3) << 5));
      const uint64_t db =
          desc_sw128(b0 + ((ks >> 2) * (BN >> 3) << 10) + ((ks & 3) << 5));
      wgmma_m64n128k16(acc, da, db, (q == 0 && ks == 0) ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (q != nq - 1) continue;

    // epilogue of centroid tile t
    const float* cs =
        reinterpret_cast<const float*>(base + L.csq + stage * BN * 4);
    const int c0 = t * BN;
    if constexpr (kCut == kCutMm) {
#pragma unroll
      for (int i = 0; i < kAccs; ++i) chk += acc[i];
      if (t == 0 && quad == 0) {        // column 0: j 0, quad 0, first of pair
        best[0] = cs[0] - 2.f * acc[0];
        best[1] = cs[0] - 2.f * acc[2];
      }
      continue;
    } else {
      fold_fragment<kArg>(acc, cs, c0, quad, best, best_idx,
                          [](float q, float a, int) { return q - 2.f * a; });
      if constexpr (kCut == kCutMxuOnly) {
        float colsum[32];   // this thread's rows, per column
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 q2 = *reinterpret_cast<const float2*>(cs + 8 * j
                                                             + 2 * quad);
          colsum[2 * j] = colsum[2 * j + 1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (row_ok[h]) {
              colsum[2 * j] += q2.x - 2.f * acc[4 * j + 2 * h];
              colsum[2 * j + 1] += q2.y - 2.f * acc[4 * j + 2 * h + 1];
            }
          }
        }
        // the 8 row lanes of each column in the warp, then the block's
        // warps through shared memory (free until the next step's loads)
        float* red = reinterpret_cast<float*>(base + L.red);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float v = colsum[i];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          colsum[i] = v;
        }
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            red[warp * BN + 8 * j + 2 * lane] = colsum[2 * j];
            red[warp * BN + 8 * j + 2 * lane + 1] = colsum[2 * j + 1];
          }
        }
        __syncthreads();
        if (tid < BN && c0 + tid < k) {
          float sum = 0.f;
          for (int w = 0; w < 4 * WG; ++w) sum += red[w * BN + tid];
          atomicAdd(aux + c0 + tid, sum);
        }
      }
    }
  }

  if constexpr (kCut == kCutMm) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      chk += __shfl_xor_sync(0xffffffffu, chk, off);
    if (lane == 0) aux[blockIdx.x * (4 * WG) + warp] = chk;
  }
  unsigned long long lsum = 0;   // kCutMmArgmin: this lane's labels
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best[h];
    int id = best_idx[h];
    // kCutMm: d[r, 0] is in quad 0
    if constexpr (kCut != kCutMm) reduce_quad(v, id);
    const int r = row0 + rloc + 8 * h;
    if (quad == 0 && r < n) {
      if constexpr (kArg) labels[r] = id;
      if constexpr (kCut == kCutMmArgmin) lsum += (unsigned long long)id;
      dmin[r] = v;
    }
  }
  if constexpr (kCut == kCutMmArgmin) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (lane == 0) atomicAdd(label_sum, lsum);
  }
}

// blocks of four warpgroups (256 rows) once they fill the SMs, else of
// two (128 rows), so a few thousand rows still spread over the card
inline int row_warpgroups(int n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return (n + 4 * kRowsWg - 1) / (4 * kRowsWg) >= sms ? 4 : 2;
}

template <int WG, int kCut>
cudaError_t launch_assign_wg(const __nv_bfloat16* x,
                             const __nv_bfloat16* c, const float* c_sq,
                             int n, int k, int dim, int* labels, float* dmin,
                             float* aux, unsigned long long* label_sum,
                             cudaStream_t s) {
  const int kp = (dim + 15) & ~15;
  const bool resident = kp <= kKc;
  const Layout L = layout(WG, resident ? kp : kKc, resident,
                          kCut == kCutMxuOnly);
  // once a device: the largest layout this kernel takes (dims past 128
  // stream x too)
  static unsigned set_on = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!((set_on >> dev) & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        assign_kernel<WG, kCut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        layout(WG, kKc, false, kCut == kCutMxuOnly).total);
    if (e != cudaSuccess) return e;
    set_on |= 1u << dev;
  }
  constexpr int BM = WG * kRowsWg;
  assign_kernel<WG, kCut><<<(n + BM - 1) / BM, WG * 128, L.total, s>>>(
      x, c, c_sq, n, k, dim, labels, dmin, aux, label_sum);
  return cudaGetLastError();
}

// one assignment pass (n >= 1, k >= 1); aux holds ceil(n / 256) * 16
// floats (one a warp) for kCutMm, k for kCutMxuOnly
template <int kCut>
cudaError_t launch_assign(const void* x, const void* c, const void* c_sq,
                          int n, int k, int dim, void* labels, void* dmin,
                          void* aux, void* label_sum, cudaStream_t s) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto cb = static_cast<const __nv_bfloat16*>(c);
  auto q = static_cast<const float*>(c_sq);
  auto lab = static_cast<int*>(labels);
  auto dm = static_cast<float*>(dmin);
  auto ax = static_cast<float*>(aux);
  auto ls = static_cast<unsigned long long*>(label_sum);
  return row_warpgroups(n) == 4
             ? launch_assign_wg<4, kCut>(xb, cb, q, n, k, dim, lab, dm, ax,
                                         ls, s)
             : launch_assign_wg<2, kCut>(xb, cb, q, n, k, dim, lab, dm, ax,
                                         ls, s);
}

}  // namespace raft_mma

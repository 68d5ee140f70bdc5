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

namespace raft_mma {

constexpr int kRowsWg = 64;   // rows of x per warpgroup (wgmma M)
constexpr int BN = 128;       // centroids per stage (wgmma N)
constexpr int kKc = 128;      // dims per stage at most
constexpr int kAccs = 64;     // fp32 accumulators a thread (64 x 128 / 128)

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

__host__ __device__ inline int align1024(int b) { return (b + 1023) & ~1023; }

// bytes of one staged (R rows x kc dims) operand: 128-byte swizzle atoms
// of 8 rows x 64 dims
__host__ __device__ inline int operand_bytes(int rows, int kc) {
  return ((kc + 63) / 64) * rows * 128;
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// make this thread's shared-memory writes (cp.async and st.shared, the
// generic proxy) visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle
// atoms: start address (1024-byte aligned but for a k16 step's offset in
// the atom), 8-row groups 1024 bytes apart, the leading offset unused
// (encoded 1), layout type 1 (128-byte swizzle); fields in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[kAccs]) {
#pragma unroll
  for (int i = 0; i < kAccs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) . B (128 x 16, K-major)^T; scale_d == 0
// ignores d's old value
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kAccs],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Stage rows [row0, row0 + R) x dims [k0, k0 + kc) of a row-major bf16
// (nvalid, dim) matrix at shared address dst (1024-byte aligned), K-major
// in 128-byte swizzle atoms: element (r, kk) at ((kk / 64) * (R / 8) +
// r / 8) * 1024 + (r % 8) * 128 + (((kk / 8) % 8) ^ (r % 8)) * 16 +
// (kk % 8) * 2, the pattern wgmma's 128-byte swizzle reads.  Each thread
// moves 16-byte chunks; the 8 lanes of a store phase take 8 consecutive
// rows of one chunk column (distinct banks after the XOR) and lanes 8
// apart take a row's next 16 bytes (full 32-byte sectors).  Past the
// edges the chunk is zeros.  vec: every chunk is 16 bytes aligned (dim %
// 8 == 0 and an aligned base), so it goes by cp.async; else element by
// element through registers.
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src, int R,
                                           int row0, int nvalid, int dim,
                                           int k0, int kc, bool vec,
                                           int tid, int nthreads) {
  const int kpairs = kc >> 4;
  const int total = (R * kc) >> 3;
  for (int e = tid; e < total; e += nthreads) {
    const int lane = e & 31, w = e >> 5;
    const int rg = 2 * (w / kpairs) + (lane >> 4);
    const int kg = 2 * (w % kpairs) + ((lane >> 3) & 1);
    const uint32_t at = dst + (((kg >> 3) * (R >> 3) + rg) << 10)
                        + ((lane & 7) << 7) + (((kg & 7) ^ (lane & 7)) << 4);
    const int grow = row0 + rg * 8 + (lane & 7);
    const int gcol = k0 + kg * 8;
    if (vec) {
      const bool ok = grow < nvalid && gcol < dim;
      cp_async16(at, ok ? src + (size_t)grow * dim + gcol : src,
                 ok ? 16 : 0);
    } else {
      uint32_t w2[4];
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        uint32_t lo = 0, hi = 0;
        if (grow < nvalid && gcol + i < dim)
          lo = __bfloat16_as_ushort(src[(size_t)grow * dim + gcol + i]);
        if (grow < nvalid && gcol + i + 1 < dim)
          hi = __bfloat16_as_ushort(src[(size_t)grow * dim + gcol + i + 1]);
        w2[i / 2] = lo | (hi << 16);
      }
      st_shared16(at, make_uint4(w2[0], w2[1], w2[2], w2[3]));
    }
  }
}

// c_sq of centroids [c0, c0 + 128) at dst; +inf past k
__device__ __forceinline__ void stage_csq(uint32_t dst,
                                          const float* __restrict__ c_sq,
                                          int c0, int k, bool vec, int tid) {
  if (tid >= BN / 4) return;
  const int col = c0 + 4 * tid;
  if (vec && col + 3 < k) {
    cp_async16(dst + 16 * tid, c_sq + col, 16);
  } else {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = col + i < k ? c_sq[col + i] : INFINITY;
    st_shared16(dst + 16 * tid, make_uint4(__float_as_uint(v[0]),
                                           __float_as_uint(v[1]),
                                           __float_as_uint(v[2]),
                                           __float_as_uint(v[3])));
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
      float colsum[32];   // kCutMxuOnly: this thread's rows, per column
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 q2 = *reinterpret_cast<const float2*>(cs + 8 * j
                                                           + 2 * quad);
        const int col = c0 + 8 * j + 2 * quad;
        colsum[2 * j] = colsum[2 * j + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = q2.x - 2.f * acc[4 * j + 2 * h];
          const float d1 = q2.y - 2.f * acc[4 * j + 2 * h + 1];
          if constexpr (kCut == kCutMxuOnly) {
            if (row_ok[h]) {
              colsum[2 * j] += d0;
              colsum[2 * j + 1] += d1;
            }
          }
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
      if constexpr (kCut == kCutMxuOnly) {
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
  // merge the 4 threads sharing each row: smaller value wins, equal
  // values go to the smaller index
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best[h];
    int id = best_idx[h];
    if constexpr (kCut != kCutMm) {      // kCutMm: d[r, 0] is in quad 0
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

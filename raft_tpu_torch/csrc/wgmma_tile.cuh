// The Hopper tensor-core pieces Kernels A-H share: the wgmma m64n128k16
// bf16 -> fp32 product (A-E, G) and the m64n128k8 TF32 one with the hi /
// lo split of 3xTF32 and its fp32 row loads (F, H) with their accumulator
// fragment, the shared-memory descriptor of a K-major operand in 128-byte
// swizzle atoms, the swizzled staging of bf16 rows by cp.async, and the
// fences between the generic and the async proxy.  Descriptors and
// swizzle are built by hand (no CUTLASS).  The byte layout is the same
// for both types: an atom is 8 rows of 128 bytes (64 bf16 or 32 fp32
// dims), and a k-step (k16 bf16, k8 TF32) is 32 bytes of it.
//
// Fragment of one warpgroup's 64 x 128 fp32 accumulator (kAccs = 64 a
// thread): warp w of the warpgroup holds rows 16 (w % 4) + lane / 4 and
// + 8, thread's columns 8 j + 2 (lane % 4) + {0, 1} for j in 0..15;
// acc[4 j + 2 h + e] is (row + 8 h, column 8 j + 2 (lane % 4) + e).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace raft_mma {

constexpr int kRowsWg = 64;   // rows of A per warpgroup (wgmma M)
constexpr int BN = 128;       // rows of B per stage (wgmma N)
constexpr int kKc = 128;      // dims per stage at most
constexpr int kAccs = 64;     // fp32 accumulators a thread (64 x 128 / 128)

__host__ __device__ inline int align1024(int b) { return (b + 1023) & ~1023; }

// bytes of one staged (R rows x kc dims) operand: 128-byte swizzle atoms
// of 8 rows x 64 dims
__host__ __device__ inline int operand_bytes(int rows, int kc) {
  return ((kc + 63) / 64) * rows * 128;
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

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// d (+)= A (64 x 8, K-major) . B (128 x 8, K-major)^T in TF32 (each
// operand's low 13 mantissa bits ignored), fp32 accumulation; scale_d ==
// 0 ignores d's old value.  TF32 takes both operands K-major only.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[kAccs],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
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

// x rounded to TF32 (nearest, ties away; the low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 3xTF32's split of x: hi = tf32(x) and lo = tf32(x - hi) (x - hi is
// exact in fp32), so x = hi + lo within 2^-22 |x|
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// fp32 dims [d, d + 4) of a row, zeros when !ok and past dim: one 16-byte
// load where kVec (dim % 4 == 0 and the row 16-byte aligned), else one
// load a value
template <bool kVec>
__device__ __forceinline__ float4 row_chunk(const float* row, int d, int dim,
                                            bool ok) {
  if (!ok || d >= dim) return make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(row + d));
  return make_float4(__ldg(row + d), d + 1 < dim ? __ldg(row + d + 1) : 0.f,
                     d + 2 < dim ? __ldg(row + d + 2) : 0.f,
                     d + 3 < dim ? __ldg(row + d + 3) : 0.f);
}

// a chunk's TF32 hi parts at shared address hi, its lo parts at lo
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo,
                                            float4 v) {
  uint4 h, l;
  tf32_split(v.x, h.x, l.x);
  tf32_split(v.y, h.y, l.y);
  tf32_split(v.z, h.z, l.z);
  tf32_split(v.w, h.w, l.w);
  st_shared16(hi, h);
  st_shared16(lo, l);
}

// byte offset of 16-byte chunk kg (dims 8 kg .. 8 kg + 7) of row r in a
// staged R-row operand (the layout stage_rows writes)
__device__ __forceinline__ uint32_t sw128_offset(int R, int r, int kg) {
  return (((kg >> 3) * (R >> 3) + (r >> 3)) << 10) + ((r & 7) << 7)
         + (((kg & 7) ^ (r & 7)) << 4);
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
    const uint32_t at = dst + sw128_offset(R, rg * 8 + (lane & 7), kg);
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

}  // namespace raft_mma

// Kernel E: the IVF-PQ scan over the int8-quantized reconstruction cache,
// each (query, probe) pair writing its own top kt.
//
// Replaces raft_tpu/ops/pq_code_scan_pallas.py:441 grouped_recon8_scan
// (body _kernel_recon8).  Contract, as there:
//   sub    = qrot[q] - centers[list]               (fp32; zero past rot)
//   sub_sq = sum(sub^2)                            (fp32)
//   ip     = bf16(sub) . q8[list, row]             (fp32 accumulation)
//   d      = max(sub_sq + rsq8[list, row] - 2 scale[list] ip, 0)
// The dot is accumulated first and multiplied by the list's scale after,
// never dequantized per element, so the rounding is the JAX kernel's.  q8
// is exact in bf16 (|q| <= 127) and bf16 x int8 products are exact in
// fp32.  Rows with a negative id never enter the result; probes outside
// [0, n_lists) write kt (+inf, -1); ties go to the lowest slot.
//
// What bounds it on an H100: bytes — rot_pad int8 bytes, a 4-byte id and
// a 4-byte norm per probed live row (104 B at rot 96), against 2*rot
// operations per (query, row).  Design: QUERY-MAJOR, as Kernels B and D:
// one block per query walks its probes; each row is read with 16-byte
// loads by lanes_per_row lanes that hold the query's bf16 residual in
// registers and reduce the dot by shuffles; distances go to shared memory
// and the pair's top kt comes out of kt block-wide argmin rounds
// (scan_common.cuh).  A list is read once per query that probes it.
//
// Rows wider than 1,024 bytes (kWide) read the residual from shared
// memory instead of registers, so every width the TPU kernel's gate takes
// has a route here.
//
// Filters (kFilter; the TPU kernel's admission operand adm_words): the
// block's query has one row of packed words; a row whose id it rejects is
// not read and takes the dead row's +inf.  The unfiltered instantiation is
// the code without the test.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using namespace raft_scan;

// the residual in registers up to rot_pad 32 lanes * 2 * 16 = 1024; wider
// rows (kWide) read it from shared memory
constexpr int kMaxChunksPerLane = 2;

__device__ __forceinline__ float i8(uint32_t w, int b) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * b)) >> 24);
}

__device__ __forceinline__ float dot_word(const float* s, uint32_t w,
                                          float acc) {
  acc = fmaf(s[0], i8(w, 0), acc);
  acc = fmaf(s[1], i8(w, 1), acc);
  acc = fmaf(s[2], i8(w, 2), acc);
  acc = fmaf(s[3], i8(w, 3), acc);
  return acc;
}

__device__ __forceinline__ float dot16(const float* s, uint4 u, float acc) {
  acc = dot_word(s, u.x, acc);
  acc = dot_word(s + 4, u.y, acc);
  acc = dot_word(s + 8, u.z, acc);
  acc = dot_word(s + 12, u.w, acc);
  return acc;
}

template <bool kFilter, bool kWide>
__global__ void __launch_bounds__(kThreads)
recon8_kernel(const float* __restrict__ qrot,
              const float* __restrict__ centers,
              const int* __restrict__ probes, const uint4* __restrict__ data,
              const float* __restrict__ scales,
              const float* __restrict__ rsq8, const int* __restrict__ ids,
              int n_probes, int n_lists, int cap, int rot, int rot_pad,
              int kt, int lpr, const QueryWords fw,
              float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dist = reinterpret_cast<float*>(smem);     // cap
  float* s_sub = s_dist + cap;                        // rot_pad
  __shared__ float s_ssq;
  __shared__ float s_red_v[kWarps];
  __shared__ int s_red_s[kWarps];
  __shared__ int s_done;

  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = rot_pad / 16;            // 16-byte chunks per row
  const int rows_per_warp = 32 / lpr;
  const int lig = lane % lpr;              // lane within its row group
  const int grp = warp * rows_per_warp + lane / lpr;
  const int row_groups = kWarps * rows_per_warp;
  const float* qv = qrot + (size_t)q * rot;
  const int* frow = kFilter ? words_row(fw, q) : nullptr;

  for (int p = 0; p < n_probes; ++p) {
    const size_t pair = (size_t)q * n_probes + p;
    float* ov = out_v + pair * kt;
    int* oi = out_i + pair * kt;
    const int l = probes[pair];
    if (l < 0 || l >= n_lists) {            // uniform across the block
      write_empty_pair(kt, ov, oi);
      continue;
    }
    if (warp == 0) {
      float acc = 0.f;
      for (int e = lane; e < rot_pad; e += 32) {
        const float s = e < rot ? qv[e] - centers[(size_t)l * rot + e] : 0.f;
        acc = fmaf(s, s, acc);
        s_sub[e] = __bfloat162float(__float2bfloat16_rn(s));
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_ssq = acc;
    }
    __syncthreads();
    const float ssq = s_ssq;
    const float scale = scales[l];
    float sreg[kWide ? 1 : kMaxChunksPerLane][16];
    if (!kWide) {
#pragma unroll
      for (int j = 0; j < kMaxChunksPerLane; ++j) {
        const int ch = lig + j * lpr;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          sreg[j][e] = ch < nch ? s_sub[ch * 16 + e] : 0.f;
      }
    }
    const size_t base = (size_t)l * cap;
    // every lane runs every iteration, so the shuffles stay convergent
    for (int r0 = 0; r0 < cap; r0 += row_groups) {
      const int r = r0 + grp;
      int id = r < cap ? ids[base + r] : -1;
      if (kFilter && id >= 0 && !admits(frow, fw.n_words, id)) id = -1;
      float part = 0.f;
      if (id >= 0) {
        const uint4* row = data + (base + r) * nch;
        if (kWide) {
          // rows past the registers' 1,024 bytes: the residual is read
          // from shared memory, chunk by chunk
          for (int ch = lig; ch < nch; ch += lpr)
            part = dot16(s_sub + ch * 16, __ldg(row + ch), part);
        } else {
#pragma unroll
          for (int j = 0; j < kMaxChunksPerLane; ++j) {
            const int ch = lig + j * lpr;
            if (ch < nch) part = dot16(sreg[j], __ldg(row + ch), part);
          }
        }
      }
      for (int off = lpr >> 1; off; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lig == 0 && r < cap)
        s_dist[r] = id >= 0
            ? fmaxf(ssq + rsq8[base + r] - 2.f * scale * part, 0.f)
            : INFINITY;
    }
    __syncthreads();
    select_pair_topk(s_dist, ids + base, cap, kt, ov, oi, s_red_v, s_red_s,
                     &s_done);
  }
}

}  // namespace

// smem: the block's dynamic shared memory in bytes, the layout of
// recon8_kernel, as ops/pq_code_scan.py's recon8_smem_bytes sizes it (the
// one copy of the formula; its gate holds it to the card's limit).
// filter_words: null, or the queries' packed admission words (n_words
// int32 a row, filter_stride words between two queries' rows, 0 for one
// row broadcast); a pair then keeps only the rows its query admits.
extern "C" int raft_ivf_pq_scan_recon8(
    const void* qrot, const void* centers, const void* probes,
    const void* data, const void* scales, const void* rsq8, const void* ids,
    int nq, int n_probes, int n_lists, int cap, int rot, int rot_pad, int kt,
    int smem, void* out_v, void* out_i, const void* filter_words,
    int filter_stride, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QueryWords fw = query_words(filter_words, filter_stride, n_words);
  if (kt < 1 || rot_pad % 16 != 0 || rot_pad < rot || smem < 1
      || bad_words(fw))
    return (int)cudaErrorInvalidValue;
  const int nch = rot_pad / 16;
  int lpr = 1;
  while (lpr < nch && lpr < 32) lpr <<= 1;
  const bool wide = nch > 32 * kMaxChunksPerLane;
  const auto kernel =
      fw.words != nullptr ? (wide ? recon8_kernel<true, true>
                                  : recon8_kernel<true, false>)
                          : (wide ? recon8_kernel<false, true>
                                  : recon8_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0 && n_probes > 0)
    kernel<<<nq, kThreads, smem, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const uint4*>(data),
        static_cast<const float*>(scales), static_cast<const float*>(rsq8),
        static_cast<const int*>(ids), n_probes, n_lists, cap, rot, rot_pad,
        kt, lpr, fw, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

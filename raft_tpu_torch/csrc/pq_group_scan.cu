// Kernel B: the fused IVF-PQ reconstruction-cache scan with the
// per-query top-k kept on chip.
//
// Replaces raft_tpu/ops/pq_group_scan_pallas.py:410 grouped_l2_scan_fused
// (body _kernel_fused :370, with _fused_step / _merge_cols / _merge_topk
// :242-367).  Contract, as there:
//   sub    = qrot[q] - centers[list]                (fp32)
//   sub_sq = sum(sub^2)                             (fp32)
//   ip     = bf16(sub) . recon[list, row]           (fp32 accumulation)
//   d      = max(sub_sq + recon_sq[list, row] - 2 ip, 0)
// rows whose id is negative (padding, tombstones) never enter the result;
// each (query, probe) pair contributes at most its own top kt rows; the
// output is each query's top k ascending, (+inf, -1) on exhausted ranks.
//
// What bounds it on an H100: bytes.  The function needs each probed
// list's live rows once (~264 B a row at rot 128) and does only
// 2*rot operations per (query, row), far below the ~295 operations per
// byte where the card turns compute-bound.  This first design is
// QUERY-MAJOR: one block per query walks its n_probes lists, so no
// accumulator crosses blocks (the TPU kernel leans on its grid running
// in order; Hopper blocks do not).  Rows are read with 16-byte loads,
// lanes_per_row lanes per row and a shuffle reduction of the dot
// product; the query's bf16 residual sits in registers.  A row enters a
// shared-memory candidate buffer only if it beats the query's current
// k-th distance; the buffer is bitonic-sorted by (distance, row), its
// first min(kt, k) merge into the running top k by rank (older entries
// win ties, as the TPU accumulator does).  The cost of this design is
// that a list is read once per query probing it, not once per batch:
// the gap to the bound is recorded beside the kernel's time, and closing
// it (list-major pair groups, TMA, wgmma) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using namespace raft_scan;

constexpr int kMaxChunksPerLane = 4;   // rot <= 32 lanes * 4 * 8 = 1024

__device__ __forceinline__ float dot8(const float* s, uint4 u, float acc) {
  acc = fmaf(s[0], bf_lo(u.x), acc);
  acc = fmaf(s[1], bf_hi(u.x), acc);
  acc = fmaf(s[2], bf_lo(u.y), acc);
  acc = fmaf(s[3], bf_hi(u.y), acc);
  acc = fmaf(s[4], bf_lo(u.z), acc);
  acc = fmaf(s[5], bf_hi(u.z), acc);
  acc = fmaf(s[6], bf_lo(u.w), acc);
  acc = fmaf(s[7], bf_hi(u.w), acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ qrot,
            const float* __restrict__ centers,
            const int* __restrict__ probes, const uint4* __restrict__ recon,
            const float* __restrict__ rsq, const int* __restrict__ ids,
            int n_probes, int n_lists, int cap, int rot, int k, int kt,
            int sort_cap, int lpr, float* __restrict__ out_v,
            int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_topv = reinterpret_cast<float*>(smem);      // kMaxK
  int* s_topi = reinterpret_cast<int*>(s_topv + kMaxK);
  float* s_newv = reinterpret_cast<float*>(s_topi + kMaxK);
  int* s_newi = reinterpret_cast<int*>(s_newv + kMaxK);
  float* s_cv = reinterpret_cast<float*>(s_newi + kMaxK);  // sort_cap
  int* s_ci = reinterpret_cast<int*>(s_cv + sort_cap);
  int* s_cr = s_ci + sort_cap;
  float* s_sub = reinterpret_cast<float*>(s_cr + sort_cap);  // rot
  __shared__ float s_ssq;
  __shared__ int s_cnt;

  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = rot / 8;                 // 16-byte chunks per row
  const int rows_per_warp = 32 / lpr;
  const int lig = lane % lpr;              // lane within its row group
  const int grp = warp * rows_per_warp + lane / lpr;
  const int row_groups = kWarps * rows_per_warp;
  const float* qv = qrot + (size_t)q * rot;

  for (int i = tid; i < k; i += kThreads) {
    s_topv[i] = INFINITY;
    s_topi[i] = -1;
  }
  __syncthreads();

  for (int p = 0; p < n_probes; ++p) {
    const int l = probes[(size_t)q * n_probes + p];
    if (l < 0 || l >= n_lists) continue;    // uniform across the block
    if (warp == 0) {
      float acc = 0.f;
      for (int e = lane; e < rot; e += 32) {
        const float s = qv[e] - centers[(size_t)l * rot + e];
        acc = fmaf(s, s, acc);
        s_sub[e] = __bfloat162float(__float2bfloat16_rn(s));
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        s_ssq = acc;
        s_cnt = 0;
      }
    }
    __syncthreads();
    const float thr = s_topv[k - 1];        // current k-th best
    const float ssq = s_ssq;
    float sreg[kMaxChunksPerLane][8];
#pragma unroll
    for (int j = 0; j < kMaxChunksPerLane; ++j) {
      const int ch = lig + j * lpr;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sreg[j][e] = ch < nch ? s_sub[ch * 8 + e] : 0.f;
    }
    const size_t base = (size_t)l * cap;
    // every lane runs every iteration, so the shuffles stay convergent
    for (int r0 = 0; r0 < cap; r0 += row_groups) {
      const int r = r0 + grp;
      const int id = r < cap ? ids[base + r] : -1;
      float part = 0.f;
      if (id >= 0) {
        const uint4* row = recon + (base + r) * nch;
#pragma unroll
        for (int j = 0; j < kMaxChunksPerLane; ++j) {
          const int ch = lig + j * lpr;
          if (ch < nch) part = dot8(sreg[j], __ldg(row + ch), part);
        }
      }
      for (int off = lpr >> 1; off; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lig == 0 && id >= 0) {
        const float d = fmaxf(ssq + rsq[base + r] - 2.f * part, 0.f);
        if (d < thr) {
          const int pos = atomicAdd(&s_cnt, 1);
          s_cv[pos] = d;
          s_ci[pos] = id;
          s_cr[pos] = r;
        }
      }
    }
    __syncthreads();
    const int cnt = s_cnt;
    if (cnt > 0) {
      sort_candidates(s_cv, s_ci, s_cr, cnt);
      merge_topk(s_topv, s_topi, s_newv, s_newi, s_cv, s_ci,
                 min(cnt, min(kt, k)), k);
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += kThreads) {
    out_v[(size_t)q * k + i] = s_topv[i];
    out_i[(size_t)q * k + i] = s_topi[i];
  }
}

}  // namespace

// smem: the block's dynamic shared memory in bytes, the layout above, as
// ops/pq_group_scan.py's scan_smem_bytes sizes it (the one copy of the
// formula; its gate holds it to the card's limit).
extern "C" int raft_ivf_pq_scan_fused(const void* qrot, const void* centers,
                                      const void* probes, const void* recon,
                                      const void* rsq, const void* ids,
                                      int nq, int n_probes, int n_lists,
                                      int cap, int rot, int k, int kt,
                                      int smem, void* out_v, void* out_i,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || rot % 8 != 0 || rot / 8 > 32 * kMaxChunksPerLane
      || smem < 1)
    return (int)cudaErrorInvalidValue;
  const int nch = rot / 8;
  int lpr = 1;
  while (lpr < nch && lpr < 32) lpr <<= 1;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0)
    scan_kernel<<<nq, kThreads, smem, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const uint4*>(recon),
        static_cast<const float*>(rsq), static_cast<const int*>(ids),
        n_probes, n_lists, cap, rot, k, kt, next_pow2(cap), lpr,
        static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

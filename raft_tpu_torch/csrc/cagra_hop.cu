// Kernel I: one CAGRA graph-walk hop — score, dedupe and merge.
//
// Replaces raft_tpu/ops/cagra_hop_pallas.py:257 fused_hop (bodies
// _kernel_hop :129 and _kernel_hop_staged :167 over _hop_scores :103), the
// fused form of raft_tpu/neighbors/cagra.py's _merge_candidates +
// _bitonic_merge.  Contract, per query q (one block each):
//   key[j] = (q_sq + nb_sq[j]) - 2 * sum_d qp[d] * nb_p[j, d]      (L2)
//   key[j] =                   - sum_d qp[d] * nb_p[j, d]          (IP)
//     bf16 values, exact products, fp32 sums in dimension order;
//     nb_id[j] < 0 scores (+inf, -1);
//   candidate j dies (+inf, -1) if its id is in the buffer (the buffer
//     copy keeps its visited flag) or carried by a candidate i < j;
//   the candidates, sorted by (key, j), go reversed behind the sorted
//     buffer, padded to size = next_pow2(itopk + wd) with (+inf, -1):
//     [buffer | pad | candidates descending] is bitonic, and log2(size)
//     strict-'>' compare-exchange passes (ties keep their places) sort
//     it; the first itopk come out.
// This is _bitonic_merge's network position for position, so the result
// equals the plain version's bit for bit.
//
// What bounds it on an H100: bytes.  A hop reads each candidate's
// projected row once (wd * pdim * 2 B a query) and does 2 * pdim
// operations per candidate — far below the ~295 operations per byte
// where the card turns compute-bound.  Design: QUERY-MAJOR, one block per
// query and no batch cap (the TPU kernel rode queries on 128 lanes and
// capped the batch at 64; here the grid is nq).  One thread scores one
// candidate with 16-byte row loads against the query staged in shared
// memory, then checks its id against the buffer and the earlier
// candidates (O(wd * (itopk + wd)) shared-memory compares a query); the
// candidates are ranked by counting (a rank sort needs no passes),
// written straight to their reversed merge slots, and the merge runs in
// shared memory with one thread per compare-exchange (the dedupe, rank
// and merge are csrc/hop_merge.cuh, shared with the walk).  Up to 1,024
// threads a block; past that each thread takes every blockDim.x-th
// candidate and pair, so only shared memory bounds itopk, wd and pdim
// (opted in past 48 KB).  The walk's hops run in csrc/cagra_walk.cu, which gathers and
// decodes the packed table itself; this kernel serves the build's exact
// merge, whose full-width rows have no table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hop_merge.cuh"

namespace {

using hop_merge::kMaxThreads;
using hop_merge::kNarrowThreads;
using hop_merge::pow2_at_least;

constexpr int kSmemMax = 232448;          // an H100 block's opt-in maximum
constexpr int kSmemStatic = 48 * 1024;    // above this, opt in

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// sum_d q[d] * row[d] in dimension order (fma == mul + add here: a product
// of two bf16 values is exact in fp32)
template <bool kVec>
__device__ __forceinline__ float row_dot(const float* q,
                                         const __nv_bfloat16* row,
                                         int pdim) {
  float acc = 0.0f;
  if (kVec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < pdim / 8; ++c) {
      const uint4 u = __ldg(r4 + c);
      const float* s = q + 8 * c;
      acc = fmaf(s[0], bf_lo(u.x), acc);
      acc = fmaf(s[1], bf_hi(u.x), acc);
      acc = fmaf(s[2], bf_lo(u.y), acc);
      acc = fmaf(s[3], bf_hi(u.y), acc);
      acc = fmaf(s[4], bf_lo(u.z), acc);
      acc = fmaf(s[5], bf_hi(u.z), acc);
      acc = fmaf(s[6], bf_lo(u.w), acc);
      acc = fmaf(s[7], bf_hi(u.w), acc);
    }
  } else {
    for (int d = 0; d < pdim; ++d)
      acc = fmaf(q[d], __bfloat162float(row[d]), acc);
  }
  return acc;
}

template <int kThreads, bool kVec>
__global__ void __launch_bounds__(kThreads)
hop_kernel(const __nv_bfloat16* __restrict__ qp,
           const float* __restrict__ q_sq,
           const __nv_bfloat16* __restrict__ nb_p,
           const float* __restrict__ nb_sq,
           const int* __restrict__ nb_id,
           const float* __restrict__ buf_d,
           const int* __restrict__ buf_i,
           const uint8_t* __restrict__ visited,
           int itopk, int wd, int pdim, int ip_metric,
           float* __restrict__ out_d, int* __restrict__ out_i,
           uint8_t* __restrict__ out_v) {
  constexpr bool kOnePass = kThreads <= kNarrowThreads;
  extern __shared__ float smem[];
  const int S = pow2_at_least(itopk + wd);
  float* q = smem;                                   // pdim
  float* ck = q + pdim;                              // wd candidate keys
  int* ci = reinterpret_cast<int*>(ck + wd);         // wd candidate ids
  float* mk = reinterpret_cast<float*>(ci + wd);     // S merge keys
  int* mi = reinterpret_cast<int*>(mk + S);          // S merge ids
  int* mv = mi + S;                                  // S visited flags

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t row = blockIdx.x;

  for (int d = tid; d < pdim; d += T)
    q[d] = __bfloat162float(qp[row * pdim + d]);
  for (int t = tid; t < itopk; t += T) {
    mk[t] = buf_d[row * itopk + t];
    mi[t] = buf_i[row * itopk + t];
    mv[t] = visited[row * itopk + t];
  }
  __syncthreads();

  // score: one thread per candidate
  const float qsq = q_sq[row];
  for (int j = tid; j < wd; j += T) {
    const size_t c = row * wd + j;
    const int id = nb_id[c];
    float key = INFINITY;
    if (id >= 0) {
      const float ip = row_dot<kVec>(q, nb_p + c * pdim, pdim);
      key = ip_metric ? -ip : (qsq + nb_sq[c]) - 2.0f * ip;
    }
    ck[j] = key;
    ci[j] = id >= 0 ? id : -1;
  }
  __syncthreads();

  // dedupe against the buffer and the earlier candidates (decided on the
  // scored ids, applied after every thread has decided; bit b of `kill`
  // is the thread's b-th candidate, and the shared-memory gate keeps wd
  // below 32 * blockDim.x)
  unsigned kill = 0;
  for (int j = tid, b = 0; j < wd; j += T, ++b) {
    if (hop_merge::duplicate(ci[j], j, mi, itopk, ci)) kill |= 1u << b;
    if (kOnePass) break;
  }
  __syncthreads();
  for (int j = tid, b = 0; j < wd; j += T, ++b) {
    if ((kill >> b) & 1u) {
      ck[j] = INFINITY;
      ci[j] = -1;
    }
    if (kOnePass) break;
  }
  hop_merge::pad<kOnePass>(itopk, wd, S, mk, mi, mv);
  __syncthreads();
  hop_merge::place<kOnePass>(wd, S, ck, ci, mk, mi, mv);
  __syncthreads();
  hop_merge::bitonic<kOnePass>(S, mk, mi, mv);

  for (int t = tid; t < itopk; t += T) {
    out_d[row * itopk + t] = mk[t];
    out_i[row * itopk + t] = mi[t];
    out_v[row * itopk + t] = static_cast<uint8_t>(mv[t] != 0);
  }
}

}  // namespace

extern "C" int raft_cagra_hop(const void* qp, const void* q_sq,
                              const void* nb_p, const void* nb_sq,
                              const void* nb_id, const void* buf_d,
                              const void* buf_i, const void* visited, int nq,
                              int itopk, int wd, int pdim, int ip_metric,
                              int smem_bytes, void* out_d, void* out_i,
                              void* out_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq < 1 || itopk < 1 || wd < 1 || pdim < 1)
    return (int)cudaErrorInvalidValue;
  const int S = pow2_at_least(itopk + wd);
  if (smem_bytes != 4 * (pdim + 2 * wd + 3 * S) || smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int threads = hop_merge::block_threads(wd, S);
  const bool vec = pdim % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(nb_p) % 16 == 0;
  // blocks of up to 256 threads run the instantiation bounded at 256
  auto* kernel =
      threads <= kNarrowThreads
          ? (vec ? hop_kernel<kNarrowThreads, true>
                 : hop_kernel<kNarrowThreads, false>)
          : (vec ? hop_kernel<kMaxThreads, true>
                 : hop_kernel<kMaxThreads, false>);
  if (smem_bytes > kSmemStatic) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
#define RAFT_HOP_ARGS                                                        \
  static_cast<const __nv_bfloat16*>(qp), static_cast<const float*>(q_sq),    \
      static_cast<const __nv_bfloat16*>(nb_p),                               \
      static_cast<const float*>(nb_sq), static_cast<const int*>(nb_id),      \
      static_cast<const float*>(buf_d), static_cast<const int*>(buf_i),      \
      static_cast<const uint8_t*>(visited), itopk, wd, pdim, ip_metric,      \
      static_cast<float*>(out_d), static_cast<int*>(out_i),                  \
      static_cast<uint8_t*>(out_v)
  kernel<<<nq, threads, smem_bytes, s>>>(RAFT_HOP_ARGS);
#undef RAFT_HOP_ARGS
  return (int)cudaGetLastError();
}

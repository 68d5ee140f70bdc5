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
// memory; the dedupe (by compare up to 32 candidates, by a hash table in
// shared memory above), the rank (a count, or a bitonic sort of (key, j)
// in the table's memory) and the merge (one thread per compare-exchange)
// are csrc/hop_merge.cuh, shared with the walk.  Up to 256 threads a block
// hold one candidate and pair each; wider hops run 128 or 256 threads
// bounded at 64 registers, each looping over its candidates and pairs, so
// only shared memory bounds itopk, wd and pdim (opted in past 48 KB).  The
// walk's hops run in csrc/cagra_walk.cu, which gathers and decodes the
// packed table itself; this kernel serves the build's exact merge, whose
// full-width rows have no table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hop_merge.cuh"

namespace {

using hop_merge::kNarrowMinBlocks;
using hop_merge::kNarrowThreads;
using hop_merge::kWideMinBlocks;
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

// Dynamic shared memory of one block, as hop_kernel lays it out:
//   [hash table: hash_slots 64-bit, hashed only]
//   [merge network: S 64-bit entries] [q: pdim f32] [ck, ci: wd each]
// The Python twin is ops/cagra_hop.hop_smem_bytes.
__host__ inline int hop_base(int itopk, int wd, int pdim) {
  return 8 * pow2_at_least(itopk + wd) + 4 * (pdim + 2 * wd);
}

__host__ inline int hop_smem(int itopk, int wd, int pdim) {
  const int base = hop_base(itopk, wd, pdim);
  return base + hop_merge::hash_bytes(itopk, wd, base, kSmemMax);
}

template <int kThreads, bool kOnePass, bool kVec>
__global__ void __launch_bounds__(kThreads,
                                   kOnePass ? kNarrowMinBlocks
                                            : kWideMinBlocks)
hop_kernel(const __nv_bfloat16* __restrict__ qp,
           const float* __restrict__ q_sq,
           const __nv_bfloat16* __restrict__ nb_p,
           const float* __restrict__ nb_sq,
           const int* __restrict__ nb_id,
           const float* __restrict__ buf_d,
           const int* __restrict__ buf_i,
           const uint8_t* __restrict__ visited,
           int itopk, int wd, int pdim, int ip_metric, int hashed,
           float* __restrict__ out_d, int* __restrict__ out_i,
           uint8_t* __restrict__ out_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = pow2_at_least(itopk + wd);
  const int slots = hashed ? hop_merge::hash_slots(itopk, wd) : 0;
  unsigned long long* table =
      reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* mw = table + slots;            // S merge entries
  float* q = reinterpret_cast<float*>(mw + S);       // pdim
  float* ck = q + pdim;                              // wd candidate keys
  int* ci = reinterpret_cast<int*>(ck + wd);         // wd candidate ids
  // the dedupe's one int a candidate: merge slots past the buffer
  int* scratch = reinterpret_cast<int*>(mw + itopk);

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t row = blockIdx.x;

  for (int d = tid; d < pdim; d += T)
    q[d] = __bfloat162float(qp[row * pdim + d]);
  for (int t = tid; t < itopk; t += T)
    mw[t] = hop_merge::entry(buf_d[row * itopk + t], buf_i[row * itopk + t],
                             visited[row * itopk + t]);
  if (hashed) hop_merge::hash_clear(slots, table);
  __syncthreads();

  // score, one thread per candidate; the dedupe's start (the buffer's ids
  // into the table, or the compare's flags zeroed)
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
  if (hashed)
    hop_merge::hash_buffer(itopk, mw, slots, table);
  else
    hop_merge::compare_clear<kOnePass>(wd, scratch);
  __syncthreads();

  // dedupe against the buffer and the earlier candidates
  if (hashed)
    hop_merge::hash_candidates<kOnePass>(wd, ci, slots, table, scratch);
  else
    hop_merge::compare_mark<kOnePass>(itopk, wd, mw, ci, scratch);
  __syncthreads();
  if (hashed)
    hop_merge::hash_decide<kOnePass>(wd, scratch, table, ck, ci);
  else
    hop_merge::compare_decide<kOnePass>(wd, scratch, ck, ci);
  __syncthreads();

  // rank into the merge slots, merge
  hop_merge::pad<kOnePass>(itopk, wd, S, mw);
  hop_merge::rank<kOnePass>(hashed, wd, S, ck, ci, table, mw);
  hop_merge::bitonic<kOnePass>(S, itopk, mw);

  for (int t = tid; t < itopk; t += T) {
    const unsigned long long e = mw[t];
    out_d[row * itopk + t] = hop_merge::entry_key(e);
    out_i[row * itopk + t] = hop_merge::entry_id(e);
    out_v[row * itopk + t] = static_cast<uint8_t>(hop_merge::entry_visited(e));
  }
}

// a one-pass block (up to 256 threads) or a looping one (128 or 256
// threads, bounded at 64 registers)
decltype(&hop_kernel<kNarrowThreads, true, true>) hop_kernel_of(int wd, int S,
                                                                bool vec) {
  return hop_merge::one_pass(wd, S)
             ? (vec ? hop_kernel<kNarrowThreads, true, true>
                    : hop_kernel<kNarrowThreads, true, false>)
             : (vec ? hop_kernel<kNarrowThreads, false, true>
                    : hop_kernel<kNarrowThreads, false, false>);
}

}  // namespace

// The block size and resident blocks per SM of a hop launch of this shape
// (out[0] threads, out[1] blocks; host memory), as chip_smoke prints them.
extern "C" int raft_cagra_hop_resident(int itopk, int wd, int pdim,
                                       int smem_bytes, void* out) {
  int* o = static_cast<int*>(out);
  if (itopk < 1 || wd < 1 || pdim < 1 || smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int S = pow2_at_least(itopk + wd);
  o[0] = hop_merge::block_threads(wd, S);
  auto* kernel = hop_kernel_of(wd, S, pdim % 8 == 0);
  if (smem_bytes > kSmemStatic) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      o + 1, kernel, o[0], smem_bytes);
}

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
  if (smem_bytes != hop_smem(itopk, wd, pdim) || smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int S = pow2_at_least(itopk + wd);
  const int threads = hop_merge::block_threads(wd, S);
  const int hashed = smem_bytes != hop_base(itopk, wd, pdim);
  const bool vec = pdim % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(nb_p) % 16 == 0;
  auto* kernel = hop_kernel_of(wd, S, vec);
  if (smem_bytes > kSmemStatic) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<nq, threads, smem_bytes, s>>>(
      static_cast<const __nv_bfloat16*>(qp), static_cast<const float*>(q_sq),
      static_cast<const __nv_bfloat16*>(nb_p),
      static_cast<const float*>(nb_sq), static_cast<const int*>(nb_id),
      static_cast<const float*>(buf_d), static_cast<const int*>(buf_i),
      static_cast<const uint8_t*>(visited), itopk, wd, pdim, ip_metric,
      hashed, static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<uint8_t*>(out_v));
  return (int)cudaGetLastError();
}

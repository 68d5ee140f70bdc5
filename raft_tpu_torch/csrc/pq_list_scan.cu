// Kernels B and G, list-major: the IVF-PQ reconstruction-cache scans over
// pair groups, with the products on Hopper's bf16 tensor cores.
//
// Pass 1 (list_scan_kernel) replaces raft_tpu/ops/pq_group_scan_pallas.py
// :566 grouped_l2_scan (body _kernel), and is Kernel G; pass 1 then pass
// 2 (merge_kernel) replace :410 grouped_l2_scan_fused (body _kernel_fused
// :370, with its per-query merge _merge_cols / _merge_topk :242-367), and
// are Kernel B.  Contract, as there:
//   sub    = qrot[q] - centers[list]                (fp32)
//   sub_sq = sum(sub^2)                             (fp32)
//   ip     = bf16(sub) . recon[list, row]           (fp32 accumulation)
//   d      = max(sub_sq + recon_sq[list, row] - 2 ip, 0)
// rows whose id is negative never enter a result, a probe outside
// [0, n_lists) is an empty pair; each (query, probe) pair keeps its top kt
// by (distance, slot), ties to the lowest slot, (+inf, -1) past its live
// rows (pass 1's output, (nq, n_probes, kt)); each query keeps the top k
// of its pairs' candidates taken in probe order, ties to the earlier probe
// and then to the pair's own rank, (+inf, -1) on exhausted ranks (pass 2).
// With a filter (the TPU kernels' admission operand adm_words, here the
// queries' rows of packed words: filter_words), a row whose id the pair's
// query rejects never enters the pair's top kt (pass 1 only: list_fold.cuh
// tests the bit; pass 2 never sees a rejected row).
//
// What bounds it on an H100: bytes.  The function needs each distinct
// probed list's live rows once (rot * 2 + 8 bytes a row) and 2 * rot
// operations per (pair, row), far below the ~295 operations per byte
// where the card turns compute-bound.  The query-major kernels
// (pq_group_scan.cu, pair_scan.cu) read a list once per query probing it
// (~117 times at the flagship's 480,000 pairs over 4,096 lists).  Here the
// pairs come sorted by list in groups of 128 (neighbors/grouped.py
// build_groups, the TPU kernel's GROUP), and a block owns one group:
//   - its 128 residuals bf16(sub), computed in fp32 and staged once as the
//     wgmma A operand (two warpgroups x 64 rows, K-major, 128-byte
//     swizzle), sub_sq from the fp32 values;
//   - the list's bf16 rows stream through wgmma_tile.cuh's two cp.async
//     stages of 128 rows (the B operand), up to the list's last live row
//     only, and wgmma m64n128k16 multiplies each stage against the
//     residuals; rot past 128 streams in 128-dim chunks (A then re-staged
//     per chunk), so neither rot nor the capacity sizes shared memory;
//   - each stage's 128 x 128 distances go, 64 columns at a time, into the
//     stage just consumed, and each warp folds 16 pairs' rows into their
//     running top kt (list_fold.cuh's fold_rows, shared with Kernel F:
//     a ballot finds a 32-column chunk's candidates below the kt-th
//     value; each is inserted in slot order by shuffles, so ties keep the
//     lowest slot), held in shared memory: kt <= kKtMax;
//   - the pairs' top kt leave coalesced, at the pair index the group's
//     slot holds.  Extra blocks past the groups write the empty pairs.
// A list is read once per group of its pairs (~1.4 times a batch at the
// flagship).  Pass 2, one block per query, merges the query's n_probes
// sorted pair lists by a tree of stable rank merges (each element's rank
// in the other list by binary search: earlier lists win ties), keeping k,
// in chunks of kMergeEntries candidates merged after the running top k.
//
// Numerics: each bf16 product is exact in fp32, but the tensor core adds
// them in its own order, so d differs from a sequential fp32 sum by
// rounding (~rot 2^-24 (|sub|^2 + |row|^2)) and an id may change at a
// near-tie.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "list_fold.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace raft_list;
using namespace raft_mma;

constexpr int kKtMax = 64;           // KT_LIST_MAX, ops/pq_group_scan.py
constexpr int kRowsAtOnce = 4;       // pair rows a warp folds side by side
constexpr int kMaxK = 256;           // K_MAX, ops/pq_group_scan.py
constexpr int kMergeEntries = 2048;  // candidates a merge chunk reads
// A merge level of n lists of lc entries writes ceil(n / 2) lists of
// min(2 lc, k): past the chunk's n0 kt <= kMergeEntries when n is odd.
// At level j, ceil(n0 / 2^j) lists of lc_j <= min(kt 2^j, k) entries hold
// fewer than n0 kt + lc_j <= kMergeEntries + kMaxK, so each buffer takes
// that many.
constexpr int kMergeBuf = kMergeEntries + kMaxK;
constexpr int kMergeThreads = 256;

// byte offsets into pass 1's dynamic shared memory: stage s's residuals
// at a + s * a_step (a_step 0 when they stay resident), its list rows at
// b + s * b_step (each stage also holds a 128 x 64 fp32 distance half),
// its rows' norms and ids at key + s * BN * 8 (then the rows' keys: +inf
// on dead rows), the top kt
// values and slots (a row of kKtMax entries a pair), sub_sq and the
// group's pair indices
struct ScanLayout {
  int a, a_step, b, b_step, key, top_v, top_s, ssq, pair, total;
};

__host__ __device__ inline ScanLayout scan_layout(int rot) {
  const int kp = (rot + 15) & ~15;
  const bool resident = kp <= kKc;
  const int kc = resident ? kp : kKc;
  const int ab = align1024(operand_bytes(kGroup, kc));
  const int bb = operand_bytes(BN, kc);
  ScanLayout L;
  L.a = 0;
  L.a_step = resident ? 0 : ab;
  L.b = resident ? ab : 2 * ab;
  L.b_step = align1024(bb > kGroup * kHalf * 4 ? bb : kGroup * kHalf * 4);
  L.key = L.b + 2 * L.b_step;
  L.top_v = L.key + 2 * BN * 8;
  L.top_s = L.top_v + kGroup * kKtMax * 4;
  L.ssq = L.top_s + kGroup * kKtMax * 4;
  L.pair = L.ssq + kGroup * 4;
  L.total = L.pair + kGroup * 4 + 1024;   // + alignment
  return L;
}

// the norms and ids of list rows [r0, r0 + 128) into a stage's key
// arrays (BN floats, then BN ints) by cp.async, zeros past the capacity;
// the epilogue turns them into the rows' keys (key_rows)
__device__ __forceinline__ void stage_key(uint32_t dst,
                                          const float* __restrict__ rsq,
                                          const int* __restrict__ ids,
                                          size_t lbase, int r0, int cap,
                                          int tid) {
  if (tid >= BN) return;
  const int r = r0 + tid;
  const bool ok = r < cap;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * tid),
               "l"(ok ? rsq + lbase + r : rsq), "r"(ok ? 4 : 0)
               : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst + 4 * (BN + tid)),
               "l"(ok ? ids + lbase + r : ids), "r"(ok ? 4 : 0)
               : "memory");
}

// E: a row's top-kt entries a lane holds while it is folded, 1 for kt <=
// 32, else 2; kFilter: each pair keeps only the rows its query admits
// (adm, list_fold.cuh)
template <int E, bool kFilter>
__global__ void __launch_bounds__(kThreads, 1)
list_scan_kernel(const float* __restrict__ qrot,
                 const float* __restrict__ centers,
                 const int* __restrict__ probes,
                 const int* __restrict__ group_list,
                 const int* __restrict__ slot_pairs,
                 const __nv_bfloat16* __restrict__ recon,
                 const float* __restrict__ rsq, const int* __restrict__ ids,
                 int n_groups, int n_pairs, int n_probes, int n_lists,
                 int cap, int rot, int kt, const Admit adm,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_extent;
  const int tid = threadIdx.x;
  if (blockIdx.x >= n_groups) {
    write_empty_pairs(blockIdx.x - n_groups, probes, n_pairs, n_lists, kt,
                      out_v, out_i);
    return;
  }

  const int g = blockIdx.x;
  const int l = group_list[g];
  const int kp = (rot + 15) & ~15;
  const bool resident = kp <= kKc;
  const int kc = resident ? kp : kKc;
  const int nchunks = (kp + kc - 1) / kc;
  const ScanLayout L = scan_layout(rot);
  // the layout's base, 1024-byte aligned for the swizzle atoms
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  float* top_v = reinterpret_cast<float*>(base + L.top_v);
  int* top_s = reinterpret_cast<int*>(base + L.top_s);
  float* ssq = reinterpret_cast<float*>(base + L.ssq);
  int* s_pair = reinterpret_cast<int*>(base + L.pair);
  const size_t lbase = (size_t)l * cap;
  const float* cen = centers + (size_t)l * rot;
  const __nv_bfloat16* rows = recon + lbase * rot;
  const bool vec = rot % 8 == 0 && ((uintptr_t)recon & 15) == 0;

  if (tid == 0) s_extent = 0;
  start_group(slot_pairs, g, s_pair, top_v, top_s, kKtMax, tid);
  __syncthreads();
  norms_and_extent(qrot, cen, s_pair, n_pairs, n_probes, rot, ids, lbase,
                   cap, ssq, &s_extent, tid);
  __syncthreads();
  const int extent = s_extent;
  const int nsteps = ((extent + BN - 1) / BN) * nchunks;

  auto load_step = [&](int s, int stage) {
    const int t = s / nchunks, q = s - t * nchunks;
    if (!resident)
      stage_residuals<true>(sbase + L.a + stage * L.a_step, qrot, cen,
                            s_pair, n_pairs, n_probes, rot, q * kc, kc, tid);
    stage_rows(sbase + L.b + stage * L.b_step, rows, BN, t * BN, extent, rot,
               q * kc, kc, vec, tid, kThreads);
    stage_key(sbase + L.key + stage * BN * 8, rsq, ids, lbase, t * BN, cap,
              tid);
  };

  if (resident)
    stage_residuals<true>(sbase + L.a, qrot, cen, s_pair, n_pairs, n_probes,
                          rot, 0, kc, tid);
  if (nsteps > 0) load_step(0, 0);
  cp_async_commit();

  const int wg = tid >> 7;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s & 1;
    const int t = s / nchunks, q = s - t * nchunks;
    // every thread is done with step s - 1's stage before it refills
    __syncthreads();
    if (s + 1 < nsteps) load_step(s + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();
    fence_proxy_async();
    __syncthreads();

    const uint32_t a0 = sbase + L.a + stage * L.a_step + wg * 8 * 1024;
    const uint32_t b0 = sbase + L.b + stage * L.b_step;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < (kc >> 4); ++ks) {
      const uint64_t da = desc_sw128(
          a0 + ((ks >> 2) * (kGroup >> 3) << 10) + ((ks & 3) << 5));
      const uint64_t db =
          desc_sw128(b0 + ((ks >> 2) * (BN >> 3) << 10) + ((ks & 3) << 5));
      wgmma_m64n128k16(acc, da, db, (q == 0 && ks == 0) ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (q != nchunks - 1) continue;

    // epilogue of row tile t: both warpgroups' products are done before
    // the stage's rows are overwritten by distances (rows at or past the
    // extent, padding or past the capacity, are dead)
    fold_window<E, kRowsAtOnce, kFilter>(
        acc, reinterpret_cast<float*>(base + L.key + stage * BN * 8), ssq,
        reinterpret_cast<float*>(base + L.b + stage * L.b_step), top_v,
        top_s, kKtMax, s_pair, n_pairs, kt, t * BN, extent, adm,
        [](float dot, float key, float ss) {
          return fmaxf(ss + key - 2.f * dot, 0.f);
        });
  }

  __syncthreads();
  write_top(top_v, top_s, kKtMax, s_pair, n_pairs, kt, ids, lbase, out_v,
            out_i);
}

// entries of the sorted list v[0, n) below x (or_equal: at or below x)
__device__ __forceinline__ int count_below(const float* v, int n, float x,
                                           bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x || (or_equal && v[mid] == x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One level of the merge tree: n sorted lists of length lc (sv, si) ->
// ceil(n / 2) sorted lists of length lo <= 2 lc (dv, di), list 2i merged
// with 2i + 1.  An element's output rank is its own position plus the
// other list's elements strictly below it (the first list's) or at or
// below it (the second's), so the earlier list wins ties and each list
// keeps its order.  An odd last list passes through, padded with
// (+inf, -1).  Ends with the block synchronised.
__device__ void merge_level(const float* sv, const int* si, int n, int lc,
                            int lo, float* dv, int* di) {
  const int pairs = (n + 1) >> 1;
  for (int e = threadIdx.x; e < pairs * 2 * lc; e += blockDim.x) {
    const int pr = e / (2 * lc), w = e - pr * 2 * lc;
    const int second = w >= lc, pos = second ? w - lc : w;
    const int self = 2 * pr + second, other = 2 * pr + 1 - second;
    if (self >= n) continue;
    const float v = sv[self * lc + pos];
    int rank = pos;
    if (other < n) rank += count_below(sv + other * lc, lc, v, second);
    if (rank < lo) {
      dv[pr * lo + rank] = v;
      di[pr * lo + rank] = si[self * lc + pos];
    }
  }
  if (n & 1) {
    for (int p = lc + threadIdx.x; p < lo; p += blockDim.x) {
      dv[(pairs - 1) * lo + p] = INFINITY;
      di[(pairs - 1) * lo + p] = -1;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
             int n_probes, int kt, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  __shared__ float buf_v[2][kMergeBuf];
  __shared__ int buf_i[2][kMergeBuf];
  __shared__ float run_v[kMaxK];
  __shared__ int run_i[kMaxK];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int chunk = kMergeEntries / kt;      // probes a chunk
  for (int i = tid; i < k; i += kMergeThreads) {
    run_v[i] = INFINITY;
    run_i[i] = -1;
  }
  __syncthreads();
  for (int p0 = 0; p0 < n_probes; p0 += chunk) {
    const int n0 = min(chunk, n_probes - p0);
    const size_t off = ((size_t)q * n_probes + p0) * kt;
    for (int e = tid; e < n0 * kt; e += kMergeThreads) {
      buf_v[0][e] = pv[off + e];
      buf_i[0][e] = pi[off + e];
    }
    __syncthreads();
    int n = n0, lc = kt, src = 0;
    while (n > 1) {
      const int lo = min(2 * lc, k);
      merge_level(buf_v[src], buf_i[src], n, lc, lo, buf_v[src ^ 1],
                  buf_i[src ^ 1]);
      n = (n + 1) >> 1;
      lc = lo;
      src ^= 1;
    }
    // the chunk's top lc (<= k) merges after the running top k: the
    // running list holds earlier probes, so it wins ties
    float* mv = buf_v[src ^ 1];
    int* mi = buf_i[src ^ 1];
    for (int e = tid; e < k; e += kMergeThreads) {
      mv[e] = run_v[e];
      mi[e] = run_i[e];
      mv[k + e] = e < lc ? buf_v[src][e] : INFINITY;
      mi[k + e] = e < lc ? buf_i[src][e] : -1;
    }
    __syncthreads();
    merge_level(mv, mi, 2, k, k, run_v, run_i);
  }
  for (int i = tid; i < k; i += kMergeThreads) {
    out_v[(size_t)q * k + i] = run_v[i];
    out_i[(size_t)q * k + i] = run_i[i];
  }
}

}  // namespace

namespace {

template <int E, bool kFilter>
int launch_list_scan(int blocks, int smem, cudaStream_t s, const void* qrot,
                     const void* centers, const void* probes,
                     const void* group_list, const void* slot_pairs,
                     const void* recon, const void* rsq, const void* ids,
                     int n_groups, int n_pairs, int n_probes, int n_lists,
                     int cap, int rot, int kt, const Admit& adm, void* out_v,
                     void* out_i) {
  cudaError_t err = cudaFuncSetAttribute(
      list_scan_kernel<E, kFilter>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    list_scan_kernel<E, kFilter><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const int*>(group_list),
        static_cast<const int*>(slot_pairs),
        static_cast<const __nv_bfloat16*>(recon),
        static_cast<const float*>(rsq), static_cast<const int*>(ids),
        n_groups, n_pairs, n_probes, n_lists, cap, rot, kt, adm,
        static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1 (Kernel G): every (query, probe) pair's top kt (1 <= kt <= 64)
// over the bf16 recon cache, out (nq, n_probes, kt).  group_list
// (n_groups,) and slot_pairs (n_groups, 128) come from
// neighbors/grouped.py build_groups (nq * n_probes marks an empty slot);
// probes (nq, n_probes) say which pairs no group holds.  smem: the
// block's dynamic shared memory, as ops/pq_group_scan.py's
// list_scan_smem_bytes sizes it (a Python copy of scan_layout; the entry
// point refuses less than scan_layout needs).  filter_words: null, or the
// queries' packed admission words (n_words int32 a row, filter_stride
// words between two queries' rows, 0 for one row broadcast); a pair then
// keeps only the rows its query admits.
extern "C" int raft_ivf_pq_list_scan(const void* qrot, const void* centers,
                                     const void* probes,
                                     const void* group_list,
                                     const void* slot_pairs,
                                     const void* recon, const void* rsq,
                                     const void* ids, int n_groups, int nq,
                                     int n_probes, int n_lists, int cap,
                                     int rot, int kt, int smem, void* out_v,
                                     void* out_i, const void* filter_words,
                                     int filter_stride, int n_words,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt < 1 || kt > kKtMax || rot < 8 || rot % 8 != 0 || cap < 1
      || n_groups < 0 || smem < scan_layout(rot).total
      || (filter_words != nullptr && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
  const auto run =
      filter_words != nullptr
          ? (kt <= 32 ? launch_list_scan<1, true> : launch_list_scan<2, true>)
          : (kt <= 32 ? launch_list_scan<1, false>
                      : launch_list_scan<2, false>);
  return run(blocks, smem, s, qrot, centers, probes, group_list, slot_pairs,
             recon, rsq, ids, n_groups, n_pairs, n_probes, n_lists, cap, rot,
             kt, adm, out_v, out_i);
}

// Pass 2 (with pass 1, Kernel B): each query's top k (kt <= k <= 256) of
// its pairs' sorted top kt, pair_v / pair_i (nq, n_probes, kt); out (nq, k).
extern "C" int raft_ivf_pq_merge_pairs(const void* pair_v, const void* pair_i,
                                       int nq, int n_probes, int kt, int k,
                                       void* out_v, void* out_i,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt < 1 || k < kt || k > kMaxK || n_probes < 0)
    return (int)cudaErrorInvalidValue;
  if (nq > 0)
    merge_kernel<<<nq, kMergeThreads, 0, s>>>(
        static_cast<const float*>(pair_v), static_cast<const int*>(pair_i),
        n_probes, kt, k, static_cast<float*>(out_v),
        static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

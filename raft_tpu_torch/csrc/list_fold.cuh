// The block skeleton that the list-major scans share: Kernels B and G's
// pass 1 (pq_list_scan.cu), its twin over the PQ codes for Kernels C and
// D (pq_code_list_scan.cu) and Kernel F's (flat_list_scan.cu); each scan
// keeps only its operand staging and products.  The two PQ passes also
// share the residual staging (stage_residuals) and the group's prologue
// (norms_and_extent).  A block of kThreads
// threads owns one group of kGroup (query, probe) pairs of one list
// (start_group); each 128-row window of the list multiplies into 128 x
// 128 products, which fold_window turns into distances in shared memory,
// 64 columns at a time, and folds into each pair's running top kt, held in
// shared memory as rows of `stride` entries (stride >= kt; ascending by
// (distance, slot)); write_top writes them out.  The blocks past the
// groups write the pairs no group holds (write_empty_pairs).
//
// The row keys: each tile stages its rows' norms and ids (BN floats, then
// BN ints), and key_rows turns them into the rows' keys, +inf on a row
// past the tile's live end or with a negative id, so its distance is +inf
// and never kept.
//
// Filters (kFilter): a pair's query may reject a row's id
// (filters/bitset.py: bit id & 31 of word id >> 5 of the query's row of
// packed words).  That is per (pair, row), so no row key can carry it;
// fold_rows tests the bit only for a column whose distance is below the
// pair's kt-th entry, before the ballot that would insert it, so a
// rejected row never enters the pair's top kt and admission costs one
// word load (L2-resident: a query's row is n_rows / 8 bytes) per
// candidate that would be inserted, not one per product.  The unfiltered
// instantiation is the code without the test.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "wgmma_tile.cuh"

namespace raft_list {

using raft_mma::BN;

constexpr int kGroup = 128;          // pairs a group (grouped.GROUP)
constexpr int kThreads = 256;        // two warpgroups, 64 pairs each
constexpr int kHalf = 64;            // distance columns a fold takes

// A filter's admission operand: the rows of packed words, q_stride words
// apart (0: one row broadcast to the batch), n_words words a row; pair p
// is query p / n_probes.
struct Admit {
  const int* words;
  long long q_stride;
  int n_words;
  int n_probes;
};

// whether pair p's query admits id (scan_common.cuh's bit rule)
__device__ __forceinline__ bool admitted(const Admit& adm, int p, int id) {
  const long long q = p / adm.n_probes;
  return raft_scan::admits(adm.words + q * adm.q_stride, adm.n_words, id);
}

// a staged tile's keys in place of its norms: the norm, or +inf at or past
// `end` and on a row with a negative id
__device__ __forceinline__ void key_rows(float* key, int r0, int end,
                                         int tid) {
  if (tid >= BN) return;
  const int id = reinterpret_cast<const int*>(key + BN)[tid];
  if (r0 + tid >= end || id < 0) key[tid] = INFINITY;
}

// the kt-th entry of a row whose lane l holds entries l (+ 32), to every
// lane
template <int E>
__device__ __forceinline__ float kth_entry(const float (&v)[E], int kt) {
  if constexpr (E == 1) return __shfl_sync(0xffffffffu, v[0], kt - 1);
  return kt <= 32 ? __shfl_sync(0xffffffffu, v[0], kt - 1)
                  : __shfl_sync(0xffffffffu, v[E - 1], kt - 33);
}

// Fold distance columns [0, 64) (slots slot0 + c) of the group's pair
// rows into their sorted top kt.  Warp w takes rows 16 w .. 16 w + 15, R
// at a time; while it works on a row, lane l holds the row's entries l
// (and l + 32: E = 2, kt <= 64), +inf past the row's `stride` stored
// entries (never kept: they sort after the kt-th).  A 32-column chunk's
// candidates below a row's kt-th value are found by one ballot and
// inserted in slot order, each after every equal entry (its place: the
// entries at or below it, counted by ballot; the rest shift up one lane),
// so ties keep the lowest slot; after each insertion a ballot against the
// new kt-th value drops the chunk's candidates that no longer qualify.
// The rows' insertions are independent, so the warp runs them side by
// side (straight-line code over the rows, predicated where a row has no
// candidate left) and their shuffle latencies overlap.  dist holds row r's
// column c at r * kHalf + (c ^ (r & 31)).  kFilter: a candidate also needs
// its pair's query to admit its id (col_ids: the 64 columns' row ids).
template <int E, int R, bool kFilter>
__device__ __forceinline__ void fold_rows(float* top_v, int* top_s,
                                         int stride, const float* dist,
                                         const int* s_pair, int n_pairs,
                                         int kt, int slot0, int warp,
                                         int lane, const int* col_ids,
                                         const Admit& adm) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kRows = kGroup / (kThreads / 32);
  // every lane's entries are stored (a constant where stride is)
  const bool full = stride >= 32 * E;
  for (int r0 = warp * kRows; r0 < (warp + 1) * kRows; r0 += R) {
    float v[R][E], thr[R], d[R];
    int s[R][E];
    unsigned mask[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = 32 * e + lane;
        const bool kept = full || idx < stride;
        v[j][e] = kept ? top_v[(r0 + j) * stride + idx] : INFINITY;
        s[j][e] = kept ? top_s[(r0 + j) * stride + idx] : INT_MAX;
      }
      thr[j] = kth_entry<E>(v[j], kt);
    }
    for (int c0 = 0; c0 < kHalf; c0 += 32) {
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = r0 + j;
        d[j] = dist[r * kHalf + ((c0 + lane) ^ (r & 31))];
        const int p = s_pair[r];
        bool cand = d[j] < thr[j];
        if constexpr (kFilter)
          cand = cand && p < n_pairs && admitted(adm, p, col_ids[c0 + lane]);
        mask[j] = p < n_pairs ? __ballot_sync(kAll, cand) : 0u;
        any |= mask[j];
      }
      while (any) {
        any = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const unsigned m = mask[j];
          const int b = __ffs(m) - 1;             // -1: no candidate left
          const float x = __shfl_sync(kAll, d[j], b & 31);
          const bool ins = m != 0 && x < thr[j];
          int pos = 0;
#pragma unroll
          for (int e = 0; e < E; ++e)
            pos += __popc(__ballot_sync(kAll, v[j][e] <= x));
          float up[E];
          int us[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            up[e] = __shfl_up_sync(kAll, v[j][e], 1);
            us[e] = __shfl_up_sync(kAll, s[j][e], 1);
          }
          if constexpr (E == 2) {
            const float w = __shfl_sync(kAll, v[j][0], 31);
            const int ws = __shfl_sync(kAll, s[j][0], 31);
            if (lane == 0) {
              up[1] = w;
              us[1] = ws;
            }
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int idx = 32 * e + lane;
            if (ins && idx >= pos) {
              v[j][e] = idx == pos ? x : up[e];
              s[j][e] = idx == pos ? slot0 + c0 + b : us[e];
            }
          }
          thr[j] = kth_entry<E>(v[j], kt);
          // the chunk's later candidates still below the new kt-th value
          mask[j] = m & (m - 1) & __ballot_sync(kAll, d[j] < thr[j]);
          any |= mask[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = 32 * e + lane;
        if (full || idx < stride) {
          top_v[(r0 + j) * stride + idx] = v[j][e];
          top_s[(r0 + j) * stride + idx] = s[j][e];
        }
      }
    }
  }
}

// A block past the groups, the b-th: (+inf, -1) at every rank of the
// pairs [b kThreads, (b + 1) kThreads) whose probe lies outside [0,
// n_lists), which no group holds.
__device__ __forceinline__ void write_empty_pairs(int b, const int* probes,
                                                  int n_pairs, int n_lists,
                                                  int kt, float* out_v,
                                                  int* out_i) {
  const int p = b * kThreads + threadIdx.x;
  if (p < n_pairs && (probes[p] < 0 || probes[p] >= n_lists)) {
    for (int t = 0; t < kt; ++t) {
      out_v[(size_t)p * kt + t] = INFINITY;
      out_i[(size_t)p * kt + t] = -1;
    }
  }
}

// Dims [k0, k0 + kc) of the group's residuals bf16(qrot[q] - cen), row r
// the group's slot r (zeros for an empty slot and past rot), as the wgmma
// A operand at shared address dst (128-byte swizzle atoms, the layout of
// raft_mma::stage_rows).  kWhole: rot % 8 == 0, so a 16-byte chunk is all
// in or all out (Kernels B and G); else each value is tested (the codes
// pass takes any rot).
template <bool kWhole>
__device__ __forceinline__ void stage_residuals(
    uint32_t dst, const float* __restrict__ qrot,
    const float* __restrict__ cen, const int* s_pair, int n_pairs,
    int n_probes, int rot, int k0, int kc, int tid) {
  const int nkg = kc >> 3;
  for (int e = tid; e < kGroup * nkg; e += kThreads) {
    const int r = e / nkg, kg = e - r * nkg;
    const int gcol = k0 + kg * 8;
    const int p = s_pair[r];
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (p < n_pairs && gcol < rot) {
      const float* qv = qrot + (size_t)(p / n_probes) * rot + gcol;
      const float* cv = cen + gcol;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = 0.f, b = 0.f;
        if (kWhole || gcol + 2 * i < rot) a = qv[2 * i] - cv[2 * i];
        if (kWhole || gcol + 2 * i + 1 < rot)
          b = qv[2 * i + 1] - cv[2 * i + 1];
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
        const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
        w[i] = lo | (hi << 16);
      }
    }
    raft_mma::st_shared16(dst + raft_mma::sw128_offset(kGroup, r, kg),
                          make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// A group block's prologue over its list (rows lbase .. lbase + cap):
// one past the list's last row with an id >= 0, max-reduced into
// *s_extent (0 before; rows past it are padding and never streamed), and
// each slot's sub_sq = sum((qrot[q] - cen)^2) from the fp32 residuals
// into ssq (0 on an empty slot; warp w takes rows w, w + 8, ...).  The
// caller synchronises after.
__device__ __forceinline__ void norms_and_extent(
    const float* __restrict__ qrot, const float* __restrict__ cen,
    const int* s_pair, int n_pairs, int n_probes, int rot,
    const int* __restrict__ ids, size_t lbase, int cap, float* ssq,
    int* s_extent, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int last = 0;
  for (int r = tid; r < cap; r += kThreads)
    if (ids[lbase + r] >= 0) last = r + 1;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) atomicMax(s_extent, last);
  for (int r = warp; r < kGroup; r += kThreads / 32) {
    const int p = s_pair[r];
    float acc = 0.f;
    if (p < n_pairs) {
      const float* qv = qrot + (size_t)(p / n_probes) * rot;
      for (int e = lane; e < rot; e += 32) {
        const float s = qv[e] - cen[e];
        acc = fmaf(s, s, acc);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) ssq[r] = acc;
  }
}

// A group block's start: group g's pair indices (slot_pairs row g) into
// s_pair, and its pairs' top-kt rows emptied.  The caller synchronises.
__device__ __forceinline__ void start_group(const int* slot_pairs, int g,
                                            int* s_pair, float* top_v,
                                            int* top_s, int stride, int tid) {
  if (tid < kGroup) s_pair[tid] = slot_pairs[(size_t)g * kGroup + tid];
  for (int i = tid; i < kGroup * stride; i += kThreads) {
    top_v[i] = INFINITY;
    top_s[i] = INT_MAX;
  }
}

// The epilogue of one 128-row window (list rows row0 ..): both
// warpgroups' 64 x 128 products in acc (the wgmma fragment) become
// distances dist_of(product, row key, pair norm ssq) in dist, the stage
// just consumed, 64 columns at a time (row r's column c at r * kHalf + (c
// ^ (r & 31))), and each half folds into the pairs' top kt (fold_rows, R
// rows at once); a half at or past the list's live end holds no row that
// can be kept and is skipped.  key: the window's staged norms and ids
// (key_rows makes them keys here; rows at or past end are +inf).  kFilter:
// each pair keeps only the rows its query admits (adm).  Called by every
// thread once the products are done; ends synchronised.
template <int E, int R, bool kFilter, class Dist>
__device__ __forceinline__ void fold_window(
    const float (&acc)[raft_mma::kAccs], float* key, const float* ssq,
    float* dist, float* top_v, int* top_s, int stride, const int* s_pair,
    int n_pairs, int kt, int row0, int end, const Admit& adm, Dist dist_of) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3;
  // this thread's two pair rows in the group (fragment rows r and r + 8)
  const int rloc = (tid >> 7) * raft_mma::kRowsWg + (warp & 3) * 16
                   + (lane >> 2);
  key_rows(key, row0, end, tid);
  const int* ids = reinterpret_cast<const int*>(key + BN);
  __syncthreads();
  const float ss[2] = {ssq[rloc], ssq[rloc + 8]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row0 + kHalf * h >= end) break;         // no live row left
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = 8 * h + j;
      const int c = 8 * j + 2 * quad;
      const float2 kv = *reinterpret_cast<const float2*>(key + kHalf * h + c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rloc + 8 * hh;
        float* drow = dist + row * kHalf;
        drow[c ^ (row & 31)] = dist_of(acc[4 * jj + 2 * hh], kv.x, ss[hh]);
        drow[(c + 1) ^ (row & 31)] =
            dist_of(acc[4 * jj + 2 * hh + 1], kv.y, ss[hh]);
      }
    }
    __syncthreads();
    fold_rows<E, R, kFilter>(top_v, top_s, stride, dist, s_pair, n_pairs,
                             kt, row0 + kHalf * h, warp, lane, ids + kHalf * h,
                             adm);
    __syncthreads();
  }
}

// Each of the group's pairs' top kt to out (nq * n_probes, kt) at the
// pair index its slot holds, coalesced (consecutive threads, consecutive
// ranks): the values, and the ids of the list rows (ids[lbase + slot]),
// -1 where the value is +inf.  The caller synchronises first.
__device__ __forceinline__ void write_top(const float* top_v,
                                          const int* top_s, int stride,
                                          const int* s_pair, int n_pairs,
                                          int kt, const int* ids,
                                          size_t lbase, float* out_v,
                                          int* out_i) {
  for (int e = threadIdx.x; e < kGroup * kt; e += kThreads) {
    const int r = e / kt, i = e - r * kt;
    const int p = s_pair[r];
    if (p >= n_pairs) continue;
    const float v = top_v[r * stride + i];
    out_v[(size_t)p * kt + i] = v;
    out_i[(size_t)p * kt + i] =
        v < INFINITY ? ids[lbase + top_s[r * stride + i]] : -1;
  }
}

}  // namespace raft_list

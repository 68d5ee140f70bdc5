// Block-level pieces shared by the IVF-PQ scan kernels (Kernels B-E):
// bf16 unpacking, the candidate buffer's bitonic sort and its rank merge
// into a query's running top k (Kernels B and C), and the per-(query,
// probe) top-kt selection (Kernels D and E).
//
// Every function here is called by ALL threads of a block of kThreads
// threads and ends with the block synchronised.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace raft_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;

__host__ __device__ inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ bool key_greater(float va, int ra, float vb,
                                            int rb) {
  return va > vb || (va == vb && ra > rb);
}

// Sort the first cnt (> 0) entries of the candidate buffer (value cv, id
// ci, row cr) ascending by (value, row); pads to the next power of two
// with (+inf, -1, INT_MAX).  The buffer holds next_pow2(cap) entries.
__device__ inline void sort_candidates(float* cv, int* ci, int* cr, int cnt) {
  const int tid = threadIdx.x;
  const int P = next_pow2(cnt);
  for (int i = cnt + tid; i < P; i += kThreads) {
    cv[i] = INFINITY;
    ci[i] = -1;
    cr[i] = INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += kThreads) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const float va = cv[lo], vb = cv[hi];
        const int ra = cr[lo], rb = cr[hi];
        if (key_greater(va, ra, vb, rb) == asc) {
          cv[lo] = vb;
          cv[hi] = va;
          cr[lo] = rb;
          cr[hi] = ra;
          const int ia = ci[lo];
          ci[lo] = ci[hi];
          ci[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// Merge the m best sorted candidates (cv, ci) into the running top k
// (topv, topi) by rank: an old entry counts the new ones strictly below
// it, a new entry the old ones at or below it, so old entries win ties,
// as the TPU accumulator does.  newv/newi are k-entry scratch.
__device__ inline void merge_topk(float* topv, int* topi, float* newv,
                                  int* newi, const float* cv, const int* ci,
                                  int m, int k) {
  const int tid = threadIdx.x;
  for (int i = tid; i < k; i += kThreads) {
    const float v = topv[i];
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cv[mid] < v) lo = mid + 1; else hi = mid;
    }
    if (i + lo < k) {
      newv[i + lo] = v;
      newi[i + lo] = topi[i];
    }
  }
  for (int j = tid; j < m; j += kThreads) {
    const float v = cv[j];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (topv[mid] <= v) lo = mid + 1; else hi = mid;
    }
    if (j + lo < k) {
      newv[j + lo] = v;
      newi[j + lo] = ci[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    topv[i] = newv[i];
    topi[i] = newi[i];
  }
  __syncthreads();
}

// One (query, probe) pair's top kt by (distance, slot) out of dist[0, cap)
// (+inf marks a slot that must not be returned; the buffer is consumed):
// kt rounds of a block-wide lexicographic argmin, so ties go to the lowest
// slot, as the TPU extraction gives.  Writes kt (value, id) pairs to
// out_v / out_i, (+inf, -1) once the live slots are exhausted.  red_v,
// red_s are kWarps-entry scratch, done one int.
__device__ inline void select_pair_topk(float* dist,
                                        const int* __restrict__ ids, int cap,
                                        int kt, float* out_v, int* out_i,
                                        float* red_v, int* red_s, int* done) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) *done = 0;
  for (int t = 0; t < kt; ++t) {
    float bv = INFINITY;
    int bs = INT_MAX;
    for (int r = tid; r < cap; r += kThreads) {
      const float v = dist[r];
      if (v < bv) {
        bv = v;
        bs = r;
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (ov < bv || (ov == bv && os < bs)) {
        bv = ov;
        bs = os;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_s[warp] = bs;
    }
    __syncthreads();
    if (tid == 0) {
      float v = red_v[0];
      int s = red_s[0];
      for (int w = 1; w < kWarps; ++w) {
        if (red_v[w] < v || (red_v[w] == v && red_s[w] < s)) {
          v = red_v[w];
          s = red_s[w];
        }
      }
      if (v < INFINITY) {
        out_v[t] = v;
        out_i[t] = ids[s];
        dist[s] = INFINITY;
      } else {
        for (int u = t; u < kt; ++u) {
          out_v[u] = INFINITY;
          out_i[u] = -1;
        }
        *done = 1;
      }
    }
    __syncthreads();
    if (*done) break;
  }
  __syncthreads();
}

// A pair with no list to scan (probe outside [0, n_lists)): kt (+inf, -1).
__device__ inline void write_empty_pair(int kt, float* out_v, int* out_i) {
  for (int t = threadIdx.x; t < kt; t += kThreads) {
    out_v[t] = INFINITY;
    out_i[t] = -1;
  }
}

}  // namespace raft_scan

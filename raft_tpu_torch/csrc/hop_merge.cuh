// The merge half of a CAGRA hop, shared by Kernel I's two routes: the hop
// kernel (csrc/cagra_hop.cu) and the one-launch walk (csrc/cagra_walk.cu).
//
// raft_tpu/neighbors/cagra.py's _merge_candidates + _bitonic_merge position
// for position (the plain version is ops/cagra_hop.merge_candidates):
//   candidate j dies (+inf, -1) if its id is < 0, is in the buffer (the
//     buffer copy keeps its visited flag) or is carried by a candidate
//     i < j;
//   the candidates, ranked by (key, j), go reversed behind the sorted
//     buffer, padded to S = next_pow2(itopk + wd) with (+inf, -1):
//     [buffer | pad | candidates descending] is bitonic, and log2(S)
//     strict-'>' compare-exchange passes (ties keep their places) sort it.
// The network lives in shared memory: keys mk, ids mi, visited flags mv,
// S entries each, the buffer in the first itopk.  A block runs
// block_threads(wd, S) threads, at most kMaxThreads: where the candidates
// or the compare-exchange pairs of a pass outnumber them, each thread
// takes every blockDim.x-th one, so any itopk and wd run the same network
// (only shared memory bounds them).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hop_merge {

constexpr int kMaxThreads = 1024;
// blocks of at most this many threads run an instantiation bounded at it
// (the register budget the kernels had before they widened past 256); in
// such a block each thread holds at most one candidate, one padding slot
// and one compare-exchange pair of a pass (block_threads), so the loops
// below stop after one pass (kOnePass)
constexpr int kNarrowThreads = 256;

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// threads of a block: a power of two in [32, kMaxThreads], >= wd and
// >= S / 2 where that fits
__host__ inline int block_threads(int wd, int S) {
  const int t = pow2_at_least(wd > S / 2 ? wd : S / 2);
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// whether candidate j (id ``id``) dies: masked, already buffered, or
// carried by an earlier candidate (cand_i holds the unmasked ids)
__device__ __forceinline__ bool duplicate(int id, int j, const int* buf_i,
                                          int itopk, const int* cand_i) {
  bool dup = id < 0;
  for (int t = 0; t < itopk && !dup; ++t) dup = buf_i[t] == id;
  for (int i = 0; i < j && !dup; ++i) dup = cand_i[i] == id;
  return dup;
}

// (+inf, -1, unvisited) between the buffer and the candidates
template <bool kOnePass>
__device__ __forceinline__ void pad(int itopk, int wd, int S, float* mk,
                                    int* mi, int* mv) {
  for (int p = itopk + threadIdx.x; p < S - wd; p += blockDim.x) {
    mk[p] = INFINITY;
    mi[p] = -1;
    mv[p] = 0;
    if (kOnePass) break;
  }
}

// every candidate j, ranked by (key, position) among the wd (deduplicated)
// candidates, into merge slot S - 1 - rank, unvisited (each thread takes
// every blockDim.x-th candidate)
template <bool kOnePass>
__device__ __forceinline__ void place(int wd, int S, const float* ck,
                                      const int* ci, float* mk, int* mi,
                                      int* mv) {
  for (int j = threadIdx.x; j < wd; j += blockDim.x) {
    const float kj = ck[j];
    int r = 0;
    for (int i = 0; i < wd; ++i) {
      const float ki = ck[i];
      r += (ki < kj) || (ki == kj && i < j);
    }
    mk[S - 1 - r] = kj;
    mi[S - 1 - r] = ci[j];
    mv[S - 1 - r] = 0;
    if (kOnePass) break;
  }
}

// _bitonic_merge's passes, strict '>'.  The caller has synchronised the
// block after writing the network; it is synchronised again on return.
// Pair p of a pass of stride <= 32 lies in [64 (p / 32), 64 (p / 32) + 64),
// and thread t takes the pairs t + k blockDim.x (blockDim.x a multiple of
// 32): so a warp keeps to its own entries through those passes, which need
// only the warp's barrier.
template <bool kOnePass>
__device__ __forceinline__ void bitonic(int S, float* mk, int* mi, int* mv) {
  const int half = S >> 1;
  for (int stride = half; stride > 0; stride >>= 1) {
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int lo = 2 * stride * (t / stride) + (t % stride);
      const int hi = lo + stride;
      const float a = mk[lo], b = mk[hi];
      if (a > b) {
        mk[lo] = b;
        mk[hi] = a;
        const int ii = mi[lo];
        mi[lo] = mi[hi];
        mi[hi] = ii;
        const int vv = mv[lo];
        mv[lo] = mv[hi];
        mv[hi] = vv;
      }
      if (kOnePass) break;
    }
    if (stride > 32)
      __syncthreads();
    else
      __syncwarp();
  }
  __syncthreads();
}

}  // namespace hop_merge

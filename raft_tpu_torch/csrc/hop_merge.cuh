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
// block_threads(wd, S) threads, so one thread holds at most one candidate
// and one compare-exchange pair of a pass.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hop_merge {

constexpr int kMaxThreads = 256;

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// threads of a block: >= wd and >= S / 2, a power of two in [32, 256]
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
__device__ __forceinline__ void pad(int itopk, int wd, int S, float* mk,
                                    int* mi, int* mv) {
  for (int p = itopk + threadIdx.x; p < S - wd; p += blockDim.x) {
    mk[p] = INFINITY;
    mi[p] = -1;
    mv[p] = 0;
  }
}

// candidate j, ranked by (key, position) among the wd (deduplicated)
// candidates, into merge slot S - 1 - rank, unvisited
__device__ __forceinline__ void place(int j, int wd, int S, const float* ck,
                                      const int* ci, float* mk, int* mi,
                                      int* mv) {
  const float kj = ck[j];
  int r = 0;
  for (int i = 0; i < wd; ++i) {
    const float ki = ck[i];
    r += (ki < kj) || (ki == kj && i < j);
  }
  mk[S - 1 - r] = kj;
  mi[S - 1 - r] = ci[j];
  mv[S - 1 - r] = 0;
}

// _bitonic_merge's passes, strict '>'.  The caller has synchronised the
// block after writing the network; it is synchronised again on return.
// A pass of stride <= 32 keeps each warp inside its own 64 entries (thread
// t's pair lies in [64 (t / 32), 64 (t / 32) + 64)), so those passes need
// only the warp's barrier.
__device__ __forceinline__ void bitonic(int S, float* mk, int* mi, int* mv) {
  const int t = threadIdx.x;
  for (int stride = S >> 1; stride > 0; stride >>= 1) {
    if (t < (S >> 1)) {
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
    }
    if (stride > 32)
      __syncthreads();
    else
      __syncwarp();
  }
  __syncthreads();
}

}  // namespace hop_merge

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
// The network lives in shared memory: S 64-bit entries, the buffer in the
// first itopk, each a key's bits above (id + 1) | visited << 31 (ids are
// below 2^31 - 1), so a compare-exchange moves two words, not six.  Until
// the candidates are placed, the network's slots past the buffer
// (S - itopk >= wd of them) are the dedupe's scratch: one int a
// candidate.
//
// Dedupe, two ways with one result (no serial chain of loads either way):
//   - compare (wd <= kCompareMaxWd, or where the table does not fit):
//     each thread takes buffer slots and compares its id with every
//     candidate's (broadcast reads), each candidate's thread compares with
//     the earlier candidates, and a match flags the candidate;
//   - hash: an open-addressing table of H = next_pow2(2 (itopk + wd))
//     64-bit slots, (id << 32) | j', j' = 0 for a buffer id and j + 1 for
//     candidate j; home slot (id * 0x9E3779B1 mod 2^32) >> (32 - log2 H),
//     then linear probing.  The buffer's ids go in first (atomicCAS),
//     then each live candidate's (atomicCAS, or atomicMin of j' on its id's
//     slot): candidate j lives iff its slot ends holding j + 1.  The table
//     is cleared while the merge runs, for the next hop.
// Rank, two ways with one result: a count over the wd candidates a thread,
// or (past kSortMinWd candidates, with the hash table) a bitonic sort of
// (key, j) packed in 64 bits — (key, j) is a total order, so both place
// candidate j in merge slot S - 1 - rank — run in the table's memory,
// which the dedupe no longer needs.
//
// A block runs block_threads(wd, S) threads.  Up to kNarrowThreads each
// holds at most one candidate and one compare-exchange pair of a pass
// (kOnePass; a loop over the buffer still loops); past that, so that
// several blocks stay resident on an SM, a block of 128 (wd <= kSmallWd)
// or 256 threads takes every blockDim.x-th candidate, slot and pair, and
// its instantiation is bounded at kNarrowThreads threads with
// kWideMinBlocks blocks (64 registers a thread).  So any itopk and wd run
// the same network, and only shared memory bounds them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hop_merge {

// both instantiations' thread bound; the looping one keeps kWideMinBlocks
// blocks of it a SM (64 registers a thread)
constexpr int kNarrowThreads = 256;
constexpr int kWideMinBlocks = 4;
// the looping block's threads: 128 where the candidates fit kSmallWd, else
// 256.  A walk of itopk 512 width 1 keeps 8 blocks of 128 a SM, all of
// 1,000 queries in one wave: 4.40 ms against 7.47 in blocks of 256; itopk
// 256 width 16 (512 candidates) ran 1.35 ms in blocks of 256 against 1.55
// in blocks of 128 (in turns on one H100; the parent design's blocks of
// 512 threads, 2 a SM: 44.6 and 5.4)
constexpr int kSmallWd = 64;
// candidates at most this many dedupe by compare, more by the hash table
constexpr int kCompareMaxWd = 32;
// candidates at most this many rank by a count, more (with the hash
// table) by a sort: a walk of 64 candidates (the search shape) ranks in
// 0.2 ms by the count and 0.7 by the sort, 512 (itopk 256 width 16) in
// 0.45 by the sort and 1.4 by the count (profiles/cagra_walk_decomp.py).
// A one-pass block holds at most 256 candidates, so only looping blocks
// sort.
constexpr int kSortMinWd = 256;
// the one-pass table walks' and hops' blocks a SM, their register budget
// (40 registers): in turns on one H100 the search batch (5,000 q, itopk
// 64 width 2) ran 0.807 ms at 6 against 0.832 at 8 (32 registers, 64 B
// spilled), 0.898 at 4 and 1.093 at 1; the serving bucket 0.196 / 0.217 /
// 0.193 / 0.190; the self-walk chunk 0.411 / 0.390 / 0.492 / 0.688.  The
// exact-row source's blocks are bounded by their staged rows' shared
// memory (5 or 6 a SM), so its instantiations take no register budget
// (3.50 ms at 1 against 3.70 at 6 on its 1M walk).
constexpr int kNarrowMinBlocks = 6;
constexpr unsigned long long kEmpty = ~0ull;

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// whether a block of this shape holds one candidate and pair a thread
__host__ __device__ inline bool one_pass(int wd, int S) {
  return pow2_at_least(wd > S / 2 ? wd : S / 2) <= kNarrowThreads;
}

// threads of a block: a power of two >= wd and >= S / 2 (at least 32) in
// one pass, else 128 or 256 looping
__host__ inline int block_threads(int wd, int S) {
  if (!one_pass(wd, S)) return wd <= kSmallWd ? 128 : 256;
  const int t = pow2_at_least(wd > S / 2 ? wd : S / 2);
  return t < 32 ? 32 : t;
}

// slots of the dedupe's hash table
__host__ __device__ inline int hash_slots(int itopk, int wd) {
  return pow2_at_least(2 * (itopk + wd));
}

// the table's bytes where a shape dedupes by hash and they fit beside
// `base` bytes, else 0 (the compare dedupe needs none); the Python twin is
// ops/cagra_hop.hash_bytes
__host__ inline int hash_bytes(int itopk, int wd, int base, int smem_max) {
  const int bytes = 8 * hash_slots(itopk, wd);
  return wd > kCompareMaxWd && base + bytes <= smem_max ? bytes : 0;
}

// a merge network entry: (key, id, visited flag) in 64 bits
__device__ __forceinline__ unsigned long long entry(float key, int id,
                                                   int visited) {
  return (static_cast<unsigned long long>(__float_as_uint(key)) << 32) |
         (static_cast<uint32_t>(id + 1) | (visited ? 0x80000000u : 0u));
}
__device__ __forceinline__ float entry_key(unsigned long long e) {
  return __uint_as_float(static_cast<uint32_t>(e >> 32));
}
__device__ __forceinline__ int entry_id(unsigned long long e) {
  return static_cast<int>(static_cast<uint32_t>(e) & 0x7fffffffu) - 1;
}
__device__ __forceinline__ int entry_visited(unsigned long long e) {
  return static_cast<int>(static_cast<uint32_t>(e) >> 31);
}
constexpr unsigned long long kVisited = 0x80000000ull;

__device__ __forceinline__ int home_slot(int id, int slots) {
  return static_cast<int>((static_cast<uint32_t>(id) * 0x9E3779B1u) >>
                          (32 - (__ffs(slots) - 1)));
}

// id into the table with tag jp: its slot (an id already there keeps the
// smaller tag)
__device__ __forceinline__ int hash_insert(unsigned long long* table,
                                           int slots, int id, uint32_t jp) {
  const unsigned long long v =
      (static_cast<unsigned long long>(static_cast<uint32_t>(id)) << 32) | jp;
  int s = home_slot(id, slots);
  while (true) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(table + s);
    if (cur == kEmpty) {
      cur = atomicCAS(table + s, kEmpty, v);
      if (cur == kEmpty) return s;
    }
    if (static_cast<uint32_t>(cur >> 32) == static_cast<uint32_t>(id)) {
      if (jp < static_cast<uint32_t>(cur)) atomicMin(table + s, v);
      return s;
    }
    s = (s + 1) & (slots - 1);
  }
}

__device__ __forceinline__ void hash_clear(int slots,
                                           unsigned long long* table) {
  for (int x = threadIdx.x; x < slots; x += blockDim.x) table[x] = kEmpty;
}

// the buffer's ids into the cleared table (itopk may outnumber the
// threads of a one-pass block: every loop over the buffer loops)
__device__ __forceinline__ void hash_buffer(int itopk,
                                            const unsigned long long* mw,
                                            int slots,
                                            unsigned long long* table) {
  for (int t = threadIdx.x; t < itopk; t += blockDim.x) {
    const int id = entry_id(mw[t]);
    if (id >= 0) hash_insert(table, slots, id, 0u);
  }
}

// after hash_buffer and a barrier: each live candidate's id into the
// table, its slot (or -1) into scratch[j]
template <bool kOnePass>
__device__ __forceinline__ void hash_candidates(int wd, const int* ci,
                                                int slots,
                                                unsigned long long* table,
                                                int* scratch) {
  for (int j = threadIdx.x; j < wd; j += blockDim.x) {
    const int id = ci[j];
    scratch[j] = id >= 0 ? hash_insert(table, slots, id, j + 1u) : -1;
    if (kOnePass) break;
  }
}

// after hash_candidates and a barrier: dead candidates (+inf, -1) in
// ck / ci, in place
template <bool kOnePass>
__device__ __forceinline__ void hash_decide(int wd, const int* scratch,
                                            const unsigned long long* table,
                                            float* ck, int* ci) {
  for (int j = threadIdx.x; j < wd; j += blockDim.x) {
    const int s = scratch[j];
    if (s < 0 || static_cast<uint32_t>(table[s]) != j + 1u) {
      ck[j] = INFINITY;
      ci[j] = -1;
    }
    if (kOnePass) break;
  }
}

// zeroed flags, one a candidate (before compare_mark, a barrier apart)
template <bool kOnePass>
__device__ __forceinline__ void compare_clear(int wd, int* flag) {
  for (int j = threadIdx.x; j < wd; j += blockDim.x) {
    flag[j] = 0;
    if (kOnePass) break;
  }
}

// flag[j] = 1 where candidate j's id is in the buffer or carried by a
// candidate i < j (flags are only ever set, so the writes may race).
// Against the buffer each thread holds four of its slots' ids in registers
// and reads each candidate's id once for the four; against the earlier
// candidates one warp's match where all of them fit a warp.
template <bool kOnePass>
__device__ __forceinline__ void compare_mark(int itopk, int wd,
                                             const unsigned long long* mw,
                                             const int* ci, int* flag) {
  const int T = blockDim.x;
  for (int t = threadIdx.x; t < itopk; t += 4 * T) {
    int b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      b[u] = t + u * T < itopk ? entry_id(mw[t + u * T]) : -1;
    for (int i = 0; i < wd; ++i) {
      const int c = ci[i];
      if (c >= 0 && (c == b[0] || c == b[1] || c == b[2] || c == b[3]))
        flag[i] = 1;
    }
  }
  if (wd <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int id = lane < wd ? ci[lane] : -2 - lane;   // lanes past wd
      const unsigned same = __match_any_sync(0xffffffffu, id);  // match none
      if (lane < wd && (same & ((1u << lane) - 1u))) flag[lane] = 1;
    }
    return;
  }
  for (int j = threadIdx.x; j < wd; j += T) {
    const int id = ci[j];
    bool dup = false;
    for (int i = 0; i < j; ++i) dup |= ci[i] == id;
    if (dup) flag[j] = 1;
    if (kOnePass) break;
  }
}

// after compare_mark and a barrier: dead candidates (+inf, -1), in place
template <bool kOnePass>
__device__ __forceinline__ void compare_decide(int wd, const int* flag,
                                               float* ck, int* ci) {
  for (int j = threadIdx.x; j < wd; j += blockDim.x) {
    if (ci[j] < 0 || flag[j]) {
      ck[j] = INFINITY;
      ci[j] = -1;
    }
    if (kOnePass) break;
  }
}

// (+inf, -1, unvisited) between the buffer and the candidates
template <bool kOnePass>
__device__ __forceinline__ void pad(int itopk, int wd, int S,
                                    unsigned long long* mw) {
  for (int p = itopk + threadIdx.x; p < S - wd; p += blockDim.x) {
    mw[p] = entry(INFINITY, -1, 0);
    if (kOnePass) break;
  }
}

// every candidate j, ranked by (key, position) among the wd (deduplicated)
// candidates, into merge slot S - 1 - rank, unvisited (each thread takes
// every blockDim.x-th candidate)
template <bool kOnePass>
__device__ __forceinline__ void place(int wd, int S, const float* ck,
                                      const int* ci,
                                      unsigned long long* mw) {
  for (int j = threadIdx.x; j < wd; j += blockDim.x) {
    const float kj = ck[j];
    int r = 0;
    for (int i = 0; i < wd; ++i) {
      const float ki = ck[i];
      r += (ki < kj) || (ki == kj && i < j);
    }
    mw[S - 1 - r] = entry(kj, ci[j], 0);
    if (kOnePass) break;
  }
}

// (key, j) as one 64-bit value in the same order: the key's bits mapped to
// an unsigned order (-0 read as +0, as '<' and '==' read it) above j
__device__ __forceinline__ unsigned long long sort_key(float key, int j) {
  const uint32_t u = __float_as_uint(__fadd_rn(key, 0.0f));
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<uint32_t>(j);
}

// place's result by a sort: the wd candidates' (key, j) sorted ascending
// in `keys` (next_pow2(wd) 64-bit slots, the hash table's memory), then
// candidate j of rank r into merge slot S - 1 - r.  The caller has
// synchronised the block after ck / ci were final; it is synchronised
// again on return.
template <bool kOnePass>
__device__ __forceinline__ void sort_place(int wd, int S, const float* ck,
                                           const int* ci,
                                           unsigned long long* keys,
                                           unsigned long long* mw) {
  const int P = pow2_at_least(wd);
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    keys[j] = j < wd ? sort_key(ck[j], j) : kEmpty;
  __syncthreads();
  // a bitonic sort; pairs of a pass of stride <= 32 keep to the warp's
  // entries (as in bitonic below), so only a stride above 32, before or
  // after, needs the block's barrier
  for (int k = 2; k <= P; k <<= 1) {
    for (int st = k >> 1; st > 0; st >>= 1) {
      const int ls = __ffs(st) - 1;        // log2 st: shifts, no division
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int lo = ((t >> ls) << (ls + 1)) | (t & (st - 1));
        const int hi = lo + st;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
        if (kOnePass) break;
      }
      const int next = st > 1 ? st >> 1 : k;
      if (st > 32 || next > 32)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < wd; r += blockDim.x) {
    const int j = static_cast<int>(static_cast<uint32_t>(keys[r]));
    mw[S - 1 - r] = entry(ck[j], ci[j], 0);
    if (kOnePass) break;
  }
  __syncthreads();
}

// every candidate into its merge slot: by the sort in the table's memory
// where the hop is hashed with more than kSortMinWd candidates (looping
// blocks only), else by the count.  The caller has synchronised the block
// after ck / ci were final; it is synchronised again on return.
template <bool kOnePass>
__device__ __forceinline__ void rank(bool hashed, int wd, int S,
                                     const float* ck, const int* ci,
                                     unsigned long long* table,
                                     unsigned long long* mw) {
  if constexpr (!kOnePass) {
    if (hashed && wd > kSortMinWd) {
      sort_place<kOnePass>(wd, S, ck, ci, table, mw);
      return;
    }
  }
  place<kOnePass>(wd, S, ck, ci, mw);
  __syncthreads();
}

// _bitonic_merge's passes, strict '>', as far as they reach the first
// `keep` slots (the buffer that comes out; the slots past it are scratch
// until the next hop writes them): after the pass of stride st the later
// passes stay inside aligned blocks of st slots, so of that pass only the
// pairs of the blocks of 2 st that start below `keep` — a prefix of the
// pair indices — can move a value into the first `keep`, and the others
// are left out (at itopk 512 width 1, 2,816 of 5,120 compare-exchanges a
// hop run; the first `keep` slots come out as the whole network's).
// The caller has synchronised the block after writing the network; it is
// synchronised again on return.  Pair p of a pass of stride <= 32 lies in
// [64 (p / 32), 64 (p / 32) + 64), and thread t takes the pairs
// t + k blockDim.x (blockDim.x a multiple of 32): so a warp keeps to its
// own entries through those passes, which need only the warp's barrier.
// With `table` set, the dedupe's hash table is cleared for the next hop on
// the way.
template <bool kOnePass>
__device__ __forceinline__ void bitonic(int S, int keep,
                                        unsigned long long* mw, int slots = 0,
                                        unsigned long long* table = nullptr) {
  if (table != nullptr) hash_clear(slots, table);
  for (int stride = S >> 1; stride > 0; stride >>= 1) {
    const int ls = __ffs(stride) - 1;      // log2 stride: shifts, no division
    const int pairs = ((keep + 2 * stride - 1) >> (ls + 1)) << ls;
    for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
      const int lo = ((t >> ls) << (ls + 1)) | (t & (stride - 1));
      const int hi = lo + stride;
      const unsigned long long a = mw[lo], b = mw[hi];
      if (entry_key(a) > entry_key(b)) {
        mw[lo] = b;
        mw[hi] = a;
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

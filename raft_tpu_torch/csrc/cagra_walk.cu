// Kernel I, the walk route: a whole CAGRA graph walk in one launch.
//
// Replaces raft_tpu/ops/cagra_hop_pallas.py:257 fused_hop together with the
// loop that drives it, raft_tpu/neighbors/cagra.py's _search_impl_walk
// while_loop (parent selection, the fat-row gather and decode, the hop),
// and, with the exact-row source, the direct walk _search_impl (:1857, XLA
// in the JAX package).
// Contract, per query (one block each), from a seeded sorted buffer
// (keys, ids, visited flags; itopk each), for at most max_iter hops:
//   1. parents: search_width times, the first slot that is unvisited, has
//      an id >= 0 and a finite key; if none, the first unvisited slot
//      (clamped to itopk - 1) with parent id -1; the slot is marked
//      visited (ops/cagra_walk.select_parents);
//   2. each live parent's deg candidates from one of three row sources:
//      - the packed table's fat row, deg neighbors of `unit` int16 lanes:
//        bf16 (unit pdim + 4: pdim bf16, the f32 squared norm, the int32
//        id) or int8 (unit pdim / 2 + 3: two int8 a lane, low byte first,
//        a uint16 norm code dequantized as scales[1] + scales[2] * code
//        with the product and the sum each rounded, the int32 id);
//      - exact rows (kExact): the parent's graph row, deg int32 ids, each
//        candidate scored on its fp32 dataset row;
//      a dead parent's deg candidates are (+inf, -1);
//   3. keys: for a table, as Kernel I's hop (csrc/cagra_hop.cu): exact
//      bf16 products summed in fp32 in dimension order, (q_sq + nb_sq) -
//      2 ip (L2) or -ip (InnerProduct); for exact rows, fp32 products and
//      sums each rounded, in dimension order (no contraction), then
//      max((q_sq + x_sq) - 2 ip, 0) (L2) or -ip (the JAX dists_to); then
//      the hop's dedupe, rank and bitonic merge (csrc/hop_merge.cuh);
//   4. a query whose buffer is all visited stops: such a buffer is a fixed
//      point of the hop, so the result is the fixed hop count's.
// With a filter (kFilter; filters/bitset.py's packed words, the query's
// row filter_stride words from the last, 0 for one row broadcast), a
// candidate whose id the query rejects becomes id -1 where step 2 reads
// the ids, exactly like a dead parent's: neither kept nor expanded (the
// JAX walk's per-hop admission, raft_tpu/neighbors/cagra.py:1792).  One
// word load (L2-resident) per candidate.
// The result equals ops/cagra_walk.cagra_walk_plain (select_parents ->
// expand -> cagra_hop_plain per hop) and, for exact rows,
// ops/cagra_walk.cagra_walk_exact_plain, bit for bit.
//
// What bounds it on an H100: bytes, and the latency of a chain of
// dependent hops.  A hop reads each parent's fat row once (at the search
// shape, 2 x 32 x 40 B) and does 2 pdim operations per candidate; the next
// parents are known only after the merge, so nothing can be prefetched.
// Exact rows read dim fp32 values per candidate (64 x 384 B a hop at dim
// 96, width 2, degree 32) from rows scattered over the dataset.
// Design: QUERY-MAJOR and persistent, one block per query for the whole
// walk.  The query (fp32) and the merge network (buffer, padding,
// candidates) stay in shared memory across hops, read from and written to
// device memory once.  A hop is: warp 0 picks the parents by ballots; the
// block copies their fat rows into shared memory with 16-byte loads (each
// table row starts 256-byte aligned: W is a multiple of 128 lanes; one
// neighbor's slice is not 16-byte aligned, so the decode reads the staged
// copy lane by lane) and reads the candidates' ids; one thread scores one
// candidate; the dedupe (csrc/hop_merge.cuh) runs with no serial chain of
// loads: by compare for up to 32 candidates, by a hash table in shared
// memory above; the rank counts, or past 256 candidates sorts (key, j);
// the merge network's entries are 64-bit (key, id, visited), one thread a
// compare-exchange, block barriers only at strides above 32, and only the
// pairs that can reach the buffer run.  Where the staged rows would not
// fit in shared memory (wide wd x pdim), the kStaged = false variant
// scores straight from the table.
// Exact rows: the candidates' ids come from the parents' graph rows, then
// the block copies their fp32 rows (and norms) into shared memory with
// cp.async, consecutive lanes on consecutive 16 bytes of a row, so a hop's
// rows are all in flight at once and every load is coalesced; one thread
// per candidate sums from shared memory (rows padded to an odd number of
// 16-byte units, so the quarter-warps' 16-byte reads meet no bank
// conflict).  Where the rows would not fit, kStaged = false reads each
// row from device memory in its candidate's thread.
// Block size: up to 256 threads hold one candidate and one pair of a pass
// each; wider walks (itopk 512 width 1, itopk 256 width 16) run 128 or 256
// threads bounded at 64 registers, so that several blocks stay resident
// on an SM, each thread looping over its candidates, slots and pairs.
// Only shared memory bounds itopk and wd.

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
// The steps of a hop the kernel runs: all of them as built.
// profiles/cagra_walk_decomp.py rebuilds it with fewer, to time each step:
// 1 parents, 2 + candidate ids and staged rows, 3 + keys, 4 + dedupe,
// 5 + rank, 6 + merge.
constexpr int kHopSteps = 6;
// The exact-row source's least block: its blocks are few a SM (their
// staged rows' shared memory), so more threads each start the copies and
// run the network faster — the 1M direct walk (itopk 64 width 2, 64
// threads by the merge's rule) ran 2.84 ms in blocks of 128 against 3.26
// in blocks of 64 and 3.96 in blocks of 256, in turns on one H100.
constexpr int kExactMinThreads = 128;

__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }

__host__ __device__ inline int walk_unit(int pdim, int quant) {
  return quant ? pdim / 2 + 3 : pdim + 4;
}

// f32 values a staged exact row takes: dim rounded up to 16 bytes, to an
// odd count of 16-byte units
__host__ __device__ inline int exact_stride(int dim) {
  const int r = (dim + 3) & ~3;
  return (r / 4) % 2 ? r : r + 4;
}

// Dynamic shared memory of one block without the dedupe's table; the
// Python twin is ops/cagra_walk._walk_base_bytes.
//   [stage: width x round8(deg unit) int16 fat rows, or wd x
//    exact_stride(dim) f32 exact rows; staged only]
//   [hash table: hash_slots 64-bit, hashed only]
//   [merge network: S 64-bit entries] [q: pdim f32] [ck, ci: wd each]
//   [par_id, par_ok: width each] [done: 1]
// Exact rows: pdim is the dataset's dim.
__host__ inline int walk_base(int itopk, int width, int deg, int pdim,
                              int quant, int staged, int exact) {
  const int wd = width * deg;
  const int S = pow2_at_least(itopk + wd);
  int stage = 0;
  if (staged)
    stage = exact ? wd * exact_stride(pdim) * 4
                  : width * round8(deg * walk_unit(pdim, quant)) * 2;
  return stage + 8 * S + 4 * (pdim + 2 * wd + 2 * width + 1);
}

// the whole block's bytes, the table where it is used and fits; the
// Python twins are ops/cagra_walk.walk_smem_bytes / walk_exact_smem_bytes
// (the gate tests them, the launch passes them)
__host__ inline int walk_smem(int itopk, int width, int deg, int pdim,
                              int quant, int staged, int exact) {
  const int base = walk_base(itopk, width, deg, pdim, quant, staged, exact);
  return base + hop_merge::hash_bytes(itopk, width * deg, base, kSmemMax);
}

// the operands of one walk launch
struct WalkArgs {
  const void* q;                 // (nq, pdim) bf16, or (nq, dim) f32 exact
  const float* q_sq;             // (nq,)
  const int16_t* table;          // (n, table_w) packed rows; null if exact
  int table_w;
  int vec;                       // 16-byte loads of table or exact rows
  int hashed;                    // dedupe and rank by the hash table
  const float* scales;           // int8 table: [a, sq_min, sq_scale]
  const int* graph;              // exact: (n, deg) int32
  const float* rows;             // exact: (n, dim) f32 dataset
  const float* rows_sq;          // exact: (n,) f32 squared norms
  const float* buf_d;
  const int* buf_i;
  const uint8_t* visited;
  int itopk, width, deg, pdim, max_iter, ip_metric;
  const int* filter_words;
  long long filter_stride;
  int n_words;
  float* out_d;
  int* out_i;
  uint8_t* out_v;
  int* out_hops;
};

// 32 bits from two int16 lanes, low half first
__device__ __forceinline__ uint32_t lanes32(const int16_t* p) {
  return static_cast<uint32_t>(static_cast<uint16_t>(p[0])) |
         (static_cast<uint32_t>(static_cast<uint16_t>(p[1])) << 16);
}

// one neighbor's key from its `unit` lanes (shared or device memory)
template <bool kQuant>
__device__ __forceinline__ float neighbor_key(const float* q,
                                              const int16_t* nb, int pdim,
                                              float qsq, float s1, float s2,
                                              int ip_metric) {
  float acc = 0.0f;
  float nsq;
  if (kQuant) {
    const int h = pdim >> 1;
    for (int c = 0; c < h; ++c) {
      const int u = static_cast<uint16_t>(nb[c]);
      const int lo = ((u & 0xff) ^ 0x80) - 0x80;       // sign-extended
      const int hi = (((u >> 8) & 0xff) ^ 0x80) - 0x80;
      acc = fmaf(q[2 * c], static_cast<float>(lo), acc);
      acc = fmaf(q[2 * c + 1], static_cast<float>(hi), acc);
    }
    // the plain version rounds the product, then the sum: no contraction
    nsq = __fadd_rn(s1, __fmul_rn(s2, static_cast<float>(
                                          static_cast<uint16_t>(nb[h]))));
  } else {
    for (int d = 0; d < pdim; ++d)
      acc = fmaf(q[d],
                 __uint_as_float(static_cast<uint32_t>(
                                     static_cast<uint16_t>(nb[d])) << 16),
                 acc);
    nsq = __uint_as_float(lanes32(nb + pdim));
  }
  return ip_metric ? -acc : (qsq + nsq) - 2.0f * acc;
}

// one candidate's key from its fp32 dataset row x (device memory, or a
// staged copy in shared memory): the product and the sum each rounded, in
// dimension order (the plain loop's arithmetic)
template <bool kShared>
__device__ __forceinline__ float exact_key(const float* q, const float* x,
                                           int dim, int vec, float qsq,
                                           float xsq, int ip_metric) {
  float acc = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int c = 0; c < (dim >> 2); ++c) {
      const float4 v = kShared ? x4[c] : __ldg(x4 + c);
      const float* s = q + 4 * c;
      acc = __fadd_rn(acc, __fmul_rn(s[0], v.x));
      acc = __fadd_rn(acc, __fmul_rn(s[1], v.y));
      acc = __fadd_rn(acc, __fmul_rn(s[2], v.z));
      acc = __fadd_rn(acc, __fmul_rn(s[3], v.w));
    }
  } else {
    for (int d = 0; d < dim; ++d)
      acc = __fadd_rn(acc, __fmul_rn(q[d], kShared ? x[d] : __ldg(x + d)));
  }
  if (ip_metric) return -acc;
  return fmaxf(__fsub_rn(__fadd_rn(qsq, xsq), __fmul_rn(2.0f, acc)), 0.0f);
}

// cp.async: `bytes` (4 or 16) from device to shared memory, not through
// registers; completed by cp_async_wait_all
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// whether the query whose packed admission row is `words` (n_words
// words) admits id (an id past the row, or negative, is not admitted)
__device__ __forceinline__ bool admitted(const int* words, int n_words,
                                         int id) {
  const int w = id >> 5;
  return id >= 0 && w < n_words && ((__ldg(words + w) >> (id & 31)) & 1);
}

template <int kThreads, bool kOnePass, bool kStaged, bool kQuant,
          bool kFilter, bool kExact>
__global__ void __launch_bounds__(
    kThreads, kOnePass ? (kExact ? 1 : kNarrowMinBlocks) : kWideMinBlocks)
    walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int itopk = a.itopk, width = a.width, deg = a.deg, pdim = a.pdim;
  const int A = itopk;
  const int wd = width * deg;
  const int S = pow2_at_least(itopk + wd);
  const int unit = walk_unit(pdim, kQuant);
  const int du = deg * unit;              // lanes of one fat row
  const int stride = round8(du);          // a staged row, 16-byte multiple
  const int xstride = exact_stride(pdim);  // a staged exact row, f32
  const bool hashed = a.hashed;
  const int slots = hashed ? hop_merge::hash_slots(itopk, wd) : 0;
  int16_t* stage = reinterpret_cast<int16_t*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw);
  size_t off = 0;
  if (kStaged)
    off = kExact ? static_cast<size_t>(wd) * xstride * 4
                 : static_cast<size_t>(width) * stride * 2;
  unsigned long long* table =
      reinterpret_cast<unsigned long long*>(smem_raw + off);
  unsigned long long* mw = table + slots;            // S merge entries
  float* q = reinterpret_cast<float*>(mw + S);       // pdim
  float* ck = q + pdim;                              // wd candidate keys
  int* ci = reinterpret_cast<int*>(ck + wd);         // wd candidate ids
  int* par_id = ci + wd;                             // width parent ids
  int* par_ok = par_id + width;                      // width live flags
  int* done = par_ok + width;
  // the dedupe's one int a candidate: merge slots past the buffer, free
  // until pad and place
  int* scratch = reinterpret_cast<int*>(mw + itopk);

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const size_t row = blockIdx.x;
  const int id_off = kQuant ? pdim / 2 + 1 : pdim + 2;
  const float s1 = kQuant ? a.scales[1] : 0.0f;
  const float s2 = kQuant ? a.scales[2] : 0.0f;
  const int* fw = kFilter ? a.filter_words + row * a.filter_stride : nullptr;
  const int16_t* tab = a.table;
  const int table_w = a.table_w;

  for (int d = tid; d < pdim; d += T)
    q[d] = kExact ? static_cast<const float*>(a.q)[row * pdim + d]
                  : __bfloat162float(static_cast<const __nv_bfloat16*>(
                        a.q)[row * pdim + d]);
  for (int t = tid; t < itopk; t += T)
    mw[t] = hop_merge::entry(a.buf_d[row * itopk + t],
                             a.buf_i[row * itopk + t],
                             a.visited[row * itopk + t]);
  if (hashed) hop_merge::hash_clear(slots, table);
  __syncthreads();
  const float qsq = a.q_sq[row];
  // the end of a hop cut short (kHopSteps): the table cleared, as the
  // merge would have cleared it
  auto cut = [&] {
    if (hashed) hop_merge::hash_clear(slots, table);
    __syncthreads();
  };

  int hops = 0;
  for (int it = 0; it < a.max_iter; ++it) {
    // 1. parents, by warp 0; an all-visited buffer ends the walk
    if (tid < 32) {
      bool any_unvisited = false;
      for (int s = 0; s < width; ++s) {
        int first_good = A, first_unv = A;
        for (int c = 0; c < A; c += 32) {
          const int t = c + lane;
          const unsigned long long e = t < A ? mw[t] : 0ull;
          const bool unv = t < A && !hop_merge::entry_visited(e);
          const bool good = unv && hop_merge::entry_id(e) >= 0 &&
                            !isinf(hop_merge::entry_key(e));
          const unsigned bu = __ballot_sync(0xffffffffu, unv);
          const unsigned bg = __ballot_sync(0xffffffffu, good);
          if (first_unv == A && bu) first_unv = c + __ffs(bu) - 1;
          if (bg) {
            first_good = c + __ffs(bg) - 1;
            break;
          }
        }
        if (s == 0) any_unvisited = first_unv < A;
        const bool ok = first_good < A;
        int pc = ok ? first_good : first_unv;
        pc = pc < A - 1 ? pc : A - 1;
        if (lane == 0) {
          const unsigned long long e = mw[pc];
          par_id[s] = ok ? hop_merge::entry_id(e) : -1;
          par_ok[s] = ok;
          mw[pc] = e | hop_merge::kVisited;
        }
        __syncwarp();
      }
      if (lane == 0) *done = !any_unvisited;
    }
    __syncthreads();
    if (*done) break;
    ++hops;

    if constexpr (kHopSteps < 2) {
      cut();
      continue;
    }
    // 2. the candidates' ids (-1 under a dead parent, or rejected by the
    // filter), the parents' fat rows into shared memory, and the dedupe's
    // start: the buffer's ids into the table, or the compare's flags
    // zeroed (while the loads are in flight)
    for (int j = tid; j < wd; j += T) {
      const int s = j / deg, r = j - s * deg;
      int id = -1;
      if (par_ok[s])
        id = kExact ? __ldg(a.graph + static_cast<size_t>(par_id[s]) * deg + r)
                    : static_cast<int>(lanes32(
                          tab + static_cast<size_t>(par_id[s]) * table_w +
                          r * unit + id_off));
      if constexpr (kFilter)
        if (id >= 0 && !admitted(fw, a.n_words, id)) id = -1;
      ci[j] = id;
      if (kOnePass) break;
    }
    if (kStaged && !kExact) {
      if (a.vec) {
        const int n16 = stride >> 3;
        uint4* st4 = reinterpret_cast<uint4*>(stage);
        for (int x = tid; x < width * n16; x += T) {
          const int s = x / n16, v = x - s * n16;
          if (par_ok[s])
            st4[x] = __ldg(reinterpret_cast<const uint4*>(
                               tab + static_cast<size_t>(par_id[s]) *
                                         table_w) + v);
        }
      } else {
        for (int x = tid; x < width * du; x += T) {
          const int s = x / du, v = x - s * du;
          if (par_ok[s])
            stage[s * stride + v] =
                tab[static_cast<size_t>(par_id[s]) * table_w + v];
        }
      }
    }
    if (kHopSteps >= 4) {
      if (hashed)
        hop_merge::hash_buffer(itopk, mw, slots, table);
      else
        hop_merge::compare_clear<kOnePass>(wd, scratch);
    }
    __syncthreads();

    // exact rows: each live candidate's fp32 row into shared memory,
    // consecutive lanes on consecutive 16 bytes of a row, and its norm
    // into ck[j]
    if constexpr (kExact && kStaged) {
      if (a.vec) {
        const int n4 = pdim >> 2;
        for (int x = tid; x < wd * n4; x += T) {
          const int j = x / n4, c = x - j * n4;
          const int id = ci[j];
          if (id >= 0)
            cp_async<16>(xs + j * xstride + 4 * c,
                         a.rows + static_cast<size_t>(id) * pdim + 4 * c);
        }
      } else {
        for (int x = tid; x < wd * pdim; x += T) {
          const int j = x / pdim, c = x - j * pdim;
          const int id = ci[j];
          if (id >= 0)
            cp_async<4>(xs + j * xstride + c,
                        a.rows + static_cast<size_t>(id) * pdim + c);
        }
      }
      for (int j = tid; j < wd; j += T) {
        const int id = ci[j];
        if (id >= 0) cp_async<4>(ck + j, a.rows_sq + id);
        if (kOnePass) break;
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // 3. score, one thread per candidate, and the dedupe's marks: each
    // live id into the table, or the compare against the buffer and the
    // earlier candidates
    for (int j = tid; j < wd; j += T) {
      const int s = j / deg, r = j - s * deg;
      const int id = ci[j];
      float key = INFINITY;
      if (kHopSteps >= 3 && id >= 0) {
        if constexpr (kExact) {
          key = kStaged
                    ? exact_key<true>(q, xs + j * xstride, pdim, a.vec, qsq,
                                      ck[j], a.ip_metric)
                    : exact_key<false>(
                          q, a.rows + static_cast<size_t>(id) * pdim, pdim,
                          a.vec, qsq, __ldg(a.rows_sq + id), a.ip_metric);
        } else {
          const int16_t* nb =
              kStaged ? stage + s * stride + r * unit
                      : tab + static_cast<size_t>(par_id[s]) * table_w +
                            r * unit;
          key = neighbor_key<kQuant>(q, nb, pdim, qsq, s1, s2, a.ip_metric);
        }
      }
      ck[j] = key;
      if (kOnePass) break;
    }
    if (kHopSteps >= 4) {
      if (hashed)
        hop_merge::hash_candidates<kOnePass>(wd, ci, slots, table, scratch);
      else
        hop_merge::compare_mark<kOnePass>(itopk, wd, mw, ci, scratch);
    }
    __syncthreads();
    if constexpr (kHopSteps < 4) {
      cut();
      continue;
    }
    // 4. dead candidates (+inf, -1)
    if (hashed)
      hop_merge::hash_decide<kOnePass>(wd, scratch, table, ck, ci);
    else
      hop_merge::compare_decide<kOnePass>(wd, scratch, ck, ci);
    __syncthreads();
    if constexpr (kHopSteps < 5) {
      cut();
      continue;
    }

    // 5. rank into the merge slots, 6. merge (clearing the table)
    hop_merge::pad<kOnePass>(itopk, wd, S, mw);
    hop_merge::rank<kOnePass>(hashed, wd, S, ck, ci, table, mw);
    if constexpr (kHopSteps < 6) {
      cut();
      continue;
    }
    hop_merge::bitonic<kOnePass>(S, itopk, mw, slots,
                                 hashed ? table : nullptr);
  }

  for (int t = tid; t < itopk; t += T) {
    const unsigned long long e = mw[t];
    a.out_d[row * itopk + t] = hop_merge::entry_key(e);
    a.out_i[row * itopk + t] = hop_merge::entry_id(e);
    a.out_v[row * itopk + t] = static_cast<uint8_t>(hop_merge::entry_visited(e));
  }
  if (tid == 0 && a.out_hops != nullptr) a.out_hops[row] = hops;
}

// launch, or with `resident` set only write the blocks of this launch that
// one SM holds at once
template <int kThreads, bool kOnePass, bool kStaged, bool kQuant,
          bool kFilter, bool kExact>
int launch_bounded(int nq, int threads, int smem_bytes, cudaStream_t s,
                   const WalkArgs& args, int* resident) {
  auto* kernel =
      walk_kernel<kThreads, kOnePass, kStaged, kQuant, kFilter, kExact>;
  if (smem_bytes > kSmemStatic) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  if (resident != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, kernel, threads, smem_bytes);
  kernel<<<nq, threads, smem_bytes, s>>>(args);
  return (int)cudaGetLastError();
}

// a one-pass block (up to 256 threads) or a looping one (128 or 256
// threads, bounded at 64 registers); the exact-row source's blocks take at
// least kExactMinThreads
template <bool kStaged, bool kQuant, bool kFilter, bool kExact>
int launch(int nq, int smem_bytes, cudaStream_t s, const WalkArgs& args,
           int* resident = nullptr) {
  const int wd = args.width * args.deg;
  const int S = pow2_at_least(args.itopk + wd);
  int threads = hop_merge::block_threads(wd, S);
  if (kExact && threads < kExactMinThreads) threads = kExactMinThreads;
  if (resident != nullptr) resident[0] = threads;
  int* blocks = resident != nullptr ? resident + 1 : nullptr;
  return hop_merge::one_pass(wd, S)
             ? launch_bounded<kNarrowThreads, true, kStaged, kQuant, kFilter,
                              kExact>(nq, threads, smem_bytes, s, args, blocks)
             : launch_bounded<kNarrowThreads, false, kStaged, kQuant, kFilter,
                              kExact>(nq, threads, smem_bytes, s, args,
                                      blocks);
}

WalkArgs common_args(const void* q, const void* q_sq, const void* buf_d,
                     const void* buf_i, const void* visited, int itopk,
                     int width, int deg, int pdim, int max_iter,
                     int ip_metric, const void* filter_words,
                     int filter_stride, int n_words, void* out_d,
                     void* out_i, void* out_v, void* hops) {
  WalkArgs a = {};
  a.q = q;
  a.q_sq = static_cast<const float*>(q_sq);
  a.buf_d = static_cast<const float*>(buf_d);
  a.buf_i = static_cast<const int*>(buf_i);
  a.visited = static_cast<const uint8_t*>(visited);
  a.itopk = itopk;
  a.width = width;
  a.deg = deg;
  a.pdim = pdim;
  a.max_iter = max_iter;
  a.ip_metric = ip_metric;
  a.filter_words = static_cast<const int*>(filter_words);
  a.filter_stride = filter_stride;
  a.n_words = n_words;
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.out_v = static_cast<uint8_t*>(out_v);
  a.out_hops = static_cast<int*>(hops);
  return a;
}

bool bad_common(int nq, int itopk, int width, int deg, int pdim,
                int max_iter, const void* filter_words, int filter_stride,
                int n_words) {
  return nq < 1 || itopk < 1 || width < 1 || deg < 1 || pdim < 1 ||
         max_iter < 0 ||
         (filter_words != nullptr && (n_words < 1 || filter_stride < 0));
}

// whether the exact-row source stages its rows: where they fit
__host__ inline int exact_staged(int itopk, int width, int deg, int dim) {
  return walk_base(itopk, width, deg, dim, 0, 1, 1) <= kSmemMax;
}

#define RAFT_WALK_TABLE(FILT, ...)                                       \
  (staged ? (quant ? launch<true, true, FILT, false>(__VA_ARGS__)        \
                   : launch<true, false, FILT, false>(__VA_ARGS__))      \
          : (quant ? launch<false, true, FILT, false>(__VA_ARGS__)       \
                   : launch<false, false, FILT, false>(__VA_ARGS__)))
#define RAFT_WALK_EXACT(FILT, ...)                                       \
  (staged ? launch<true, false, FILT, true>(__VA_ARGS__)                 \
          : launch<false, false, FILT, true>(__VA_ARGS__))

}  // namespace

// filter_words: null, or the queries' packed admission words (n_words int32
// a row, filter_stride words between two queries' rows, 0 for one row
// broadcast to the batch).
extern "C" int raft_cagra_walk(const void* qp, const void* q_sq,
                               const void* table, int table_w,
                               const void* scales, const void* buf_d,
                               const void* buf_i, const void* visited, int nq,
                               int itopk, int width, int deg, int pdim,
                               int quant, int max_iter, int ip_metric,
                               int staged, int smem_bytes, void* out_d,
                               void* out_i, void* out_v, void* hops,
                               const void* filter_words, int filter_stride,
                               int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_common(nq, itopk, width, deg, pdim, max_iter, filter_words,
                 filter_stride, n_words) ||
      (quant && (pdim % 2 != 0 || scales == nullptr)) ||
      table_w < deg * walk_unit(pdim, quant))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != walk_smem(itopk, width, deg, pdim, quant, staged, 0) ||
      smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  WalkArgs a = common_args(qp, q_sq, buf_d, buf_i, visited, itopk, width,
                           deg, pdim, max_iter, ip_metric, filter_words,
                           filter_stride, n_words, out_d, out_i, out_v, hops);
  a.table = static_cast<const int16_t*>(table);
  a.table_w = table_w;
  a.vec = table_w % 8 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  a.hashed = smem_bytes != walk_base(itopk, width, deg, pdim, quant, staged, 0);
  a.scales = static_cast<const float*>(scales);
  return filter_words != nullptr
             ? RAFT_WALK_TABLE(true, nq, smem_bytes, s, a)
             : RAFT_WALK_TABLE(false, nq, smem_bytes, s, a);
}

// The exact-row source: q (nq, dim) f32, graph (n, deg) int32, rows (n, dim)
// f32 and rows_sq (n,) f32 in device memory.
extern "C" int raft_cagra_walk_exact(const void* q, const void* q_sq,
                                     const void* graph, const void* rows,
                                     const void* rows_sq, const void* buf_d,
                                     const void* buf_i, const void* visited,
                                     int nq, int itopk, int width, int deg,
                                     int dim, int max_iter, int ip_metric,
                                     int smem_bytes, void* out_d, void* out_i,
                                     void* out_v, void* hops,
                                     const void* filter_words,
                                     int filter_stride, int n_words,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_common(nq, itopk, width, deg, dim, max_iter, filter_words,
                 filter_stride, n_words) ||
      graph == nullptr || rows == nullptr || rows_sq == nullptr)
    return (int)cudaErrorInvalidValue;
  const int staged = exact_staged(itopk, width, deg, dim);
  if (smem_bytes != walk_smem(itopk, width, deg, dim, 0, staged, 1) ||
      smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  WalkArgs a = common_args(q, q_sq, buf_d, buf_i, visited, itopk, width, deg,
                           dim, max_iter, ip_metric, filter_words,
                           filter_stride, n_words, out_d, out_i, out_v, hops);
  a.graph = static_cast<const int*>(graph);
  a.rows = static_cast<const float*>(rows);
  a.rows_sq = static_cast<const float*>(rows_sq);
  a.vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  a.hashed = smem_bytes != walk_base(itopk, width, deg, dim, 0, staged, 1);
  return filter_words != nullptr ? RAFT_WALK_EXACT(true, nq, smem_bytes, s, a)
                                 : RAFT_WALK_EXACT(false, nq, smem_bytes, s, a);
}

// The block size and resident blocks per SM of a walk launch of this shape
// (out[0] threads, out[1] blocks; host memory): what chip_smoke and the
// profiles print beside the walk's times.
extern "C" int raft_cagra_walk_resident(int itopk, int width, int deg,
                                        int pdim, int quant, int staged,
                                        int exact, int filter, int smem_bytes,
                                        void* out) {
  if (itopk < 1 || width < 1 || deg < 1 || pdim < 1 || smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  WalkArgs a = {};
  a.itopk = itopk;
  a.width = width;
  a.deg = deg;
  int* o = static_cast<int*>(out);
  if (exact)
    return filter ? RAFT_WALK_EXACT(true, 1, smem_bytes, nullptr, a, o)
                  : RAFT_WALK_EXACT(false, 1, smem_bytes, nullptr, a, o);
  return filter ? RAFT_WALK_TABLE(true, 1, smem_bytes, nullptr, a, o)
                : RAFT_WALK_TABLE(false, 1, smem_bytes, nullptr, a, o);
}

// Kernel F, list-major: the IVF-Flat scan over pair groups, with the fp32
// products on Hopper's TF32 tensor cores as 3xTF32.
//
// Replaces raft_tpu/ops/pq_group_scan_pallas.py:637 grouped_flat_l2_scan
// (body _kernel_flat :546, a dot_general at Precision.HIGHEST), which the
// JAX package's IVF-Flat search runs over pair groups
// (raft_tpu/neighbors/ivf_flat.py:612 _search_impl_grouped).  Contract, as
// there and as the query-major route (pair_scan.cu Fp32Rows):
//   L2:  d = max(q_sq + d_sq[tile, row] - 2 q . x[tile, row], 0),
//        q_sq = sum(q^2) in fp32
//   IP:  d = -(q . x[tile, row])  (the wrapper negates the kept values
//        back; an exhausted slot leaves as (-inf, -1))
// over raw fp32 rows; rows whose id is negative never enter a result, a
// probe outside [0, n_tiles) is an empty pair (a super-tile dedupe
// sentinel among them), and each (query, probe) pair keeps its top kt by
// (distance, slot), ties to the lowest slot, (+inf, -1) past its live
// rows: out (nq, n_probes, kt).  A tile is a list, or a super-tile of
// n_sub adjacent lists of rows / n_sub slots each (ivf_flat's F).  With a
// filter (filter_words, as pq_list_scan.cu's pass 1 takes it) a pair keeps
// only the rows its query admits (list_fold.cuh's admission test).
//
// What bounds it on an H100: operations, barely.  The function needs each
// probed tile's live rows once (dim * 4 + 8 bytes a row) and 2 * dim
// fp32 operations per (pair, live row).  At IVF-Flat nlist 4096 with 64
// probes that is ~0.5 GB against ~40 GFLOP: 0.6 ms at the 67 TFLOP/s of
// fp32 FFMA, 0.24 ms as three TF32 products at 495 TFLOP/s, 0.16 ms of
// bytes.  The query-major route reads a tile once per query probing it
// (~156 times a batch there).  Here the pairs come sorted by tile in
// groups of 128 (neighbors/grouped.py build_groups, the TPU kernel's
// GROUP), and a block owns one group:
//   - its 128 queries, split into TF32 hi and lo parts (x = hi + lo within
//     2^-22 |x|), are the wgmma A operand (two warpgroups x 64 rows,
//     K-major, 128-byte swizzle atoms of 32 fp32 dims), resident for all
//     dims where shared memory allows (the layout, which
//     ops/pair_scan.py's flat_list_scan_layout computes and the launch
//     passes in), else staged with the rows 32 dims at a time; q_sq from
//     the fp32 values;
//   - the tile's rows stream through two stages of 128 rows x 32 dims (the
//     B operand), loaded into registers two steps ahead, split into hi and
//     lo there and stored while the tensor cores work on the other stage;
//     a stage's products are three wgmma m64n128k8 TF32 per 8 dims, lo.hi
//     + hi.lo + hi.hi into one fp32 accumulator;
//   - a tile is streamed per sub-list, each up to its last live row, in
//     windows of 128 rows, so a super-tile's padding between sub-lists is
//     never read;
//   - each window's 128 x 128 distances go, 64 columns at a time, into
//     the stage just consumed and fold into each pair's top kt
//     (list_fold.cuh, shared with Kernels B and G), rows of
//     round8(kt) entries in shared memory: kt <= kKtMax;
//   - the pairs' top kt leave coalesced, at the pair index the group's
//     slot holds.  Extra blocks past the groups write the empty pairs.
// The group's block skeleton (pairs, empty pairs, window epilogue,
// write-out) is list_fold.cuh's, shared with Kernels B and G.  Any dim
// >= 1: rows load 16 bytes at a time where dim % 4 == 0 and the operands
// are 16-byte aligned, else one fp32 value at a time; past the row's dim
// the operands hold zeros, up to the k-step's multiple of 8.
//
// Numerics: 3xTF32 drops lo.lo and rounds each lo part, so each product
// q_i x_i is off by at most ~3 2^-22 |q_i x_i|, and q . x by at most ~1.5
// 2^-20 (|q|^2 + |x|^2) (Cauchy-Schwarz), before the tensor core's own
// fp32 summation order: within the 1e-5 (max |q|^2 + max |x|^2) that the
// card tests hold F to.  An id may change at a near-tie.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "list_fold.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace raft_list;
using namespace raft_mma;

constexpr int kKtMax = 64;           // KT_LIST_MAX, ops/pq_group_scan.py
constexpr int kRowsAtOnce = 8;       // pair rows a warp folds side by side
                                     // (B and G fold 4)
constexpr int kMaxSub = 8;           // sub-lists a tile (ivf_flat's F <= 8)
constexpr int kDims = 32;            // fp32 dims a stage: one atom column
constexpr int kOp = BN * 128;        // bytes of 128 rows x kDims (16 KB)
constexpr int kSmemLimit = 232448;   // an H100 block's dynamic shared memory

// The block's dynamic shared memory, in the order of
// ops/pair_scan.py's FlatLayout, which computes it (the one copy of the
// formula): resident (the queries' every dim stays in shared memory) and
// stride (the entries of a pair's top-kt row), then byte offsets from the
// 1024-aligned base: the queries' hi parts at 0 (resident: atom column c
// at c * a_step; else stage s at s * a_step), their lo parts a_lo
// further; stage s's rows, hi then lo, at b + s * 2 kOp (each stage also
// holds a 128 x 64 fp32 distance half); window w's row norms and ids at
// key + (w & 1) * BN * 8; the top-kt values and slots, q_sq, the group's
// pair indices, then each sub-list's live end (kMaxSub ints) and first
// window (kMaxSub + 1); total, the bytes to request.
struct FlatLayout {
  int resident, stride, a_step, a_lo, b, key, top_v, top_s, ssq, pair, sub,
      total;
};

// a row's distance from its product and key (+inf: never kept)
__device__ __forceinline__ float row_distance(float dot, float key,
                                              float q_sq, int ip) {
  if (!(key < INFINITY)) return INFINITY;
  return ip ? -dot : fmaxf(q_sq + key - 2.f * dot, 0.f);
}

// E: a row's top-kt entries a lane holds while it is folded, 1 for kt <=
// 32, else 2; kResident: the layout keeps the queries resident; kVec: the
// operands load 16 bytes at a time (wgmma_tile.cuh's row_chunk); kFilter:
// each pair keeps only the rows its query admits (adm, list_fold.cuh)
template <int E, bool kResident, bool kVec, bool kFilter>
__global__ void __launch_bounds__(kThreads, 1)
flat_list_scan_kernel(const float* __restrict__ queries,
                      const int* __restrict__ probes,
                      const int* __restrict__ group_list,
                      const int* __restrict__ slot_pairs,
                      const float* __restrict__ data,
                      const float* __restrict__ norms,
                      const int* __restrict__ ids, int n_groups,
                      int n_pairs, int n_probes, int n_tiles, int rows,
                      int n_sub, int dim, int kt, int ip,
                      const FlatLayout L, const Admit adm,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  if (blockIdx.x >= n_groups) {
    write_empty_pairs(blockIdx.x - n_groups, probes, n_pairs, n_tiles, kt,
                      out_v, out_i);
    return;
  }

  const int g = blockIdx.x;
  const int l = group_list[g];
  // the layout's base, 1024-byte aligned for the swizzle atoms
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const int stride = L.stride;
  float* top_v = reinterpret_cast<float*>(base + L.top_v);
  int* top_s = reinterpret_cast<int*>(base + L.top_s);
  float* ssq = reinterpret_cast<float*>(base + L.ssq);
  int* s_pair = reinterpret_cast<int*>(base + L.pair);
  int* s_end = reinterpret_cast<int*>(base + L.sub);
  int* s_win = s_end + kMaxSub;
  const size_t lbase = (size_t)l * rows;
  const float* tile = data + lbase * dim;
  const int sub_rows = rows / n_sub;
  const int nchunks = (dim + kDims - 1) / kDims;
  const int kp = (dim + 7) & ~7;
  const int lane = tid & 31, warp = tid >> 5;

  start_group(slot_pairs, g, s_pair, top_v, top_s, stride, tid);
  if (tid < kMaxSub) s_end[tid] = 0;
  // a group without a pair (past the exact count of a static one) scans
  // nothing and writes nothing
  if (!__syncthreads_or(tid < kGroup && s_pair[tid] < n_pairs)) return;
  // each sub-list's live end, one past its last row with an id >= 0: the
  // lanes of a warp on one sub-list reduce together
  for (int r0 = 0; r0 < rows; r0 += kThreads) {
    const int r = r0 + tid;
    const int sub = min(r, rows - 1) / sub_rows;
    const int end = r < rows && ids[lbase + r] >= 0 ? r + 1 : 0;
    const unsigned same = __match_any_sync(0xffffffffu, sub);
    const int last = __reduce_max_sync(same, end);
    if (lane == __ffs(same) - 1 && last > 0) atomicMax(&s_end[sub], last);
  }
  // q_sq from the fp32 queries: warp w takes rows w, w + 8, ...
  for (int r = warp; r < kGroup; r += kThreads / 32) {
    const int p = s_pair[r];
    float acc = 0.f;
    if (p < n_pairs && !ip) {
      const float* qv = queries + (size_t)(p / n_probes) * dim;
      for (int e = lane; e < dim; e += 32) acc = fmaf(qv[e], qv[e], acc);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) ssq[r] = acc;
  }
  __syncthreads();
  // the 128-row windows: sub-list s's from its first row to its live end
  if (tid == 0) {
    int w = 0;
    for (int s = 0; s < n_sub; ++s) {
      s_win[s] = w;
      const int start = s * sub_rows;
      if (s_end[s] > start) w += (s_end[s] - start + BN - 1) / BN;
    }
    s_win[n_sub] = w;
  }
  __syncthreads();
  const int nsteps = s_win[n_sub] * nchunks;

  // window w's first row and its sub-list's live end
  auto window = [&](int w, int& row0, int& end) {
    int s = 0;
    while (s + 1 < n_sub && s_win[s + 1] <= w) ++s;
    row0 = s * sub_rows + (w - s_win[s]) * BN;
    end = s_end[s];
  };
  // the query of group slot r, or null on an empty slot
  auto query_of = [&](int r) -> const float* {
    const int p = s_pair[r];
    return p < n_pairs ? queries + (size_t)(p / n_probes) * dim : nullptr;
  };

  // step s's operands in registers: thread tid takes 16-byte chunks e =
  // tid + 256 i (row e / 8, dims 4 (e % 8) on of the step's 32), eight
  // lanes a row's 128 contiguous bytes; at a window's first step, thread
  // tid < 128 also its row's norm and id
  float4 rb[4], ra[4];
  float kn = 0.f;
  int kid = -1;
  auto load_step = [&](int s) {
    const int w = s / nchunks, qc = s - w * nchunks;
    int row0, end;
    window(w, row0, end);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 3, d = qc * kDims + 4 * (e & 7);
      rb[i] = row_chunk<kVec>(tile + (size_t)(row0 + r) * dim, d, dim,
                              row0 + r < end);
      if constexpr (!kResident) {
        const float* q = query_of(r);
        ra[i] = row_chunk<kVec>(q, d, dim, q != nullptr);
      }
    }
    if (qc == 0 && tid < BN) {
      const int r = row0 + tid;
      kn = r < end && norms != nullptr ? norms[lbase + r] : 0.f;
      kid = r < end ? ids[lbase + r] : -1;
    }
  };
  // ... then in stage s & 1, the keys in window w's key arrays (w & 1)
  auto store = [&](int s) {
    const int stage = s & 1;
    const int w = s / nchunks, qc = s - w * nchunks;
    const uint32_t b = sbase + L.b + stage * 2 * kOp;
    const uint32_t a = sbase + stage * L.a_step;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const uint32_t off = sw128_offset(BN, e >> 3, e & 7);
      store_split(b + off, b + kOp + off, rb[i]);
      if constexpr (!kResident) store_split(a + off, a + L.a_lo + off, ra[i]);
    }
    if (qc == 0 && tid < BN) {
      float* key = reinterpret_cast<float*>(base + L.key + (w & 1) * BN * 8);
      key[tid] = kn;
      reinterpret_cast<int*>(key + BN)[tid] = kid;
    }
  };

  if constexpr (kResident) {
    // every dim of the group's queries, atom column c at a + c * kOp
    for (int e = tid; e < nchunks * kGroup * 8; e += kThreads) {
      const int c = e / (kGroup * 8), rem = e - c * kGroup * 8;
      const float* q = query_of(rem >> 3);
      const uint32_t off = c * kOp + sw128_offset(kGroup, rem >> 3, rem & 7);
      store_split(sbase + off, sbase + L.a_lo + off,
                  row_chunk<kVec>(q, c * kDims + 4 * (rem & 7), dim,
                                  q != nullptr));
    }
  }
  // two steps in flight: step s + 1's operands are stored while step s
  // multiplies, and step s + 2's loads run behind them
  if (nsteps > 0) {
    load_step(0);
    store(0);
  }
  if (nsteps > 1) load_step(1);

  const int wg = tid >> 7;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s & 1;
    const int w = s / nchunks, qc = s - w * nchunks;
    // step s's operands (stored last step) and its window's keys are in
    // shared memory, and every thread is done with step s - 1's stage
    fence_proxy_async();
    __syncthreads();

    const uint32_t a_hi = sbase + (kResident ? qc : stage) * L.a_step
                          + wg * 8 * 1024;
    const uint32_t a_lo = a_hi + L.a_lo;
    const uint32_t b_hi = sbase + L.b + stage * 2 * kOp;
    const uint32_t b_lo = b_hi + kOp;
    const int ksteps = min(kDims, kp - qc * kDims) >> 3;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t o = ks << 5;
      const uint64_t dah = desc_sw128(a_hi + o), dal = desc_sw128(a_lo + o);
      const uint64_t dbh = desc_sw128(b_hi + o), dbl = desc_sw128(b_lo + o);
      wgmma_m64n128k8_tf32(acc, dal, dbh, (qc == 0 && ks == 0) ? 0 : 1);
      wgmma_m64n128k8_tf32(acc, dah, dbl, 1);
      wgmma_m64n128k8_tf32(acc, dah, dbh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // meanwhile the next step's operands go to the other stage, and the
    // loads of the one after start
    if (s + 1 < nsteps) {
      store(s + 1);
      if (s + 2 < nsteps) load_step(s + 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (qc != nchunks - 1) continue;

    // epilogue of window w: both warpgroups' products are done before the
    // stage's rows are overwritten by distances
    int row0, end;
    window(w, row0, end);
    fold_window<E, kRowsAtOnce, kFilter>(
        acc, reinterpret_cast<float*>(base + L.key + (w & 1) * BN * 8), ssq,
        reinterpret_cast<float*>(base + L.b + stage * 2 * kOp), top_v, top_s,
        stride, s_pair, n_pairs, kt, row0, end, adm,
        [ip](float dot, float key, float ss) {
          return row_distance(dot, key, ss, ip);
        });
  }

  __syncthreads();
  write_top(top_v, top_s, stride, s_pair, n_pairs, kt, ids, lbase, out_v,
            out_i);
}

template <int E, bool kResident, bool kVec, bool kFilter>
int launch(int blocks, cudaStream_t s, const void* queries,
           const void* probes, const void* group_list,
           const void* slot_pairs, const void* data, const void* norms,
           const void* ids, int n_groups, int n_pairs, int n_probes,
           int n_tiles, int rows, int n_sub, int dim, int kt, int ip,
           const FlatLayout& L, const Admit& adm, void* out_v,
           void* out_i) {
  cudaError_t err = cudaFuncSetAttribute(
      flat_list_scan_kernel<E, kResident, kVec, kFilter>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    flat_list_scan_kernel<E, kResident, kVec, kFilter>
        <<<blocks, kThreads, L.total, s>>>(
        static_cast<const float*>(queries), static_cast<const int*>(probes),
        static_cast<const int*>(group_list),
        static_cast<const int*>(slot_pairs), static_cast<const float*>(data),
        static_cast<const float*>(norms), static_cast<const int*>(ids),
        n_groups, n_pairs, n_probes, n_tiles, rows, n_sub, dim, kt, ip, L,
        adm, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// the layout's offsets ascend from 0, the swizzled operands' on 1024-byte
// atoms, and its top-kt rows hold kt
bool layout_ok(const FlatLayout& L, int kt) {
  const int at[] = {L.a_lo, L.b, L.key, L.top_v, L.top_s, L.ssq, L.pair,
                    L.sub, L.total};
  for (int i = 0; i + 1 < 9; ++i)
    if (at[i] <= 0 || at[i] > at[i + 1]) return false;
  return L.a_step > 0 && L.a_step % 1024 == 0 && L.a_lo % 1024 == 0
         && L.b % 1024 == 0 && L.stride >= kt && L.total <= kSmemLimit;
}

}  // namespace

// Kernel F's list-major pass: every (query, probe) pair's top kt (1 <= kt
// <= 64) over raw fp32 tiles, out (nq, n_probes, kt), the InnerProduct
// values as -q.x (ip != 0; norms unused and may be null).  data (n_tiles,
// rows, dim), any dim >= 1, as the queries; a tile is n_sub sub-lists of
// rows / n_sub slots.  group_list (n_groups,) and slot_pairs (n_groups,
// 128) come from neighbors/grouped.py build_groups (nq * n_probes marks an
// empty slot); probes (nq, n_probes) say which pairs no group holds.
// layout: the block's shared-memory layout for (dim, kt), 12 host ints in
// FlatLayout's order, from ops/pair_scan.py's flat_list_scan_layout.
// filter_words / filter_stride / n_words: a filter's packed admission
// words as pq_list_scan.cu's pass 1 takes them (null: unfiltered).
extern "C" int raft_ivf_flat_list_scan(
    const void* queries, const void* probes, const void* group_list,
    const void* slot_pairs, const void* data, const void* norms,
    const void* ids, int n_groups, int nq, int n_probes, int n_tiles,
    int rows, int n_sub, int dim, int kt, int ip, const void* layout,
    void* out_v, void* out_i, const void* filter_words, int filter_stride,
    int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FlatLayout L;
  memcpy(&L, layout, sizeof L);
  if (kt < 1 || kt > kKtMax || dim < 1 || rows < 1 || n_sub < 1
      || n_sub > kMaxSub || rows % n_sub != 0 || n_groups < 0
      || (!ip && norms == nullptr) || !layout_ok(L, kt)
      || (filter_words != nullptr && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const bool vec = dim % 4 == 0 && ((uintptr_t)queries & 15) == 0
                   && ((uintptr_t)data & 15) == 0;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
#define RAFT_FLAT_LAUNCH(E, RES, VEC, FILT)                                  \
  launch<E, RES, VEC, FILT>(blocks, s, queries, probes, group_list,         \
                            slot_pairs, data, norms, ids, n_groups, n_pairs,\
                            n_probes, n_tiles, rows, n_sub, dim, kt, ip, L, \
                            adm, out_v, out_i)
#define RAFT_FLAT_LAUNCH_E(E, FILT)                                          \
  (L.resident ? (vec ? RAFT_FLAT_LAUNCH(E, true, true, FILT)                \
                     : RAFT_FLAT_LAUNCH(E, true, false, FILT))              \
              : (vec ? RAFT_FLAT_LAUNCH(E, false, true, FILT)               \
                     : RAFT_FLAT_LAUNCH(E, false, false, FILT)))
  if (filter_words != nullptr)
    return kt <= 32 ? RAFT_FLAT_LAUNCH_E(1, true) : RAFT_FLAT_LAUNCH_E(2, true);
  return kt <= 32 ? RAFT_FLAT_LAUNCH_E(1, false)
                  : RAFT_FLAT_LAUNCH_E(2, false);
#undef RAFT_FLAT_LAUNCH_E
#undef RAFT_FLAT_LAUNCH
}

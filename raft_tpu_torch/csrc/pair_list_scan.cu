// Kernels F and G's large-kt route, list-major: every (query, probe) pair's
// top kt (1 <= kt <= 256) over full-width rows, the pairs grouped by list,
// the products on Hopper's tensor cores.  ops/pair_scan.py routes F and G
// here from kt 65 (below, the list-major passes flat_list_scan.cu and
// pq_list_scan.cu keep their rows by ballot insertion); the profile
// variants of both run here at every kt.
//
// Replaces raft_tpu/ops/pq_group_scan_pallas.py:637 grouped_flat_l2_scan
// (Kernel F, body _kernel_flat) and :566 grouped_l2_scan (Kernel G, body
// _kernel) at per-pair kt past KT_LIST_MAX, and the switches of
// profiles/group_kernel_decomp_r5.py:50 run_var (body _kernel_var :28).
// Contract, as pair_scan.cu's query-major route states it:
//   F, L2:  d = max(q_sq + d_sq[tile, row] - 2 q . x[tile, row], 0)
//   F, IP:  d = -(q . x[tile, row])   (the wrapper negates the kept values
//           back; an exhausted slot leaves as (-inf, -1))
//   G:      sub = qrot[q] - centers[list], sub_sq = sum(sub^2) (fp32),
//           d = max(sub_sq + rsq[list, row] - 2 bf16(sub) . recon[list, row], 0)
// Rows with a negative id never enter a result, a probe outside [0,
// n_lists) is an empty pair, and each pair keeps its top kt by (distance,
// slot), ties to the lowest slot, (+inf, -1) past its live rows: out (nq,
// n_probes, kt).  With a filter (the TPU kernels' admission operand
// adm_words, here the queries' rows of packed words) a pair keeps only the
// rows its query admits.  The variants: extract == 0 writes each pair's
// cap distances, the formula at every slot (an empty slot is whatever row
// it holds; a probe outside [0, n_lists) is +inf), no selection; gather ==
// 0 takes the pair's query row p of a pre-gathered (nq * n_probes, width)
// tensor instead of row p / n_probes.
//
// What bounds it on an H100: bytes.  The function needs each probed list's
// live rows once (F: dim * 4 + 8 bytes a row; G: rot * 2 + 8) against 2 *
// width operations per (pair, live row): as 3xTF32 (F, three TF32 products
// at 495 TFLOP/s) or bf16 (G, 989 TFLOP/s) that is below the bytes at
// every shape chip_smoke drives.  The query-major kernel (pair_scan.cu)
// read a list once per query probing it and selected by kt block-wide
// argmin rounds (two barriers a kept row).  Here:
//   - the pairs come sorted by list (neighbors/grouped.py build_groups) in
//     groups of up to 64, one warpgroup's wgmma M; a block owns a group
//     (64 pair rows; fewer where the kept rows need the shared memory:
//     ops/pair_scan.py's pair_list_layout picks the size, 32 at kt past
//     128), so a list is read once per group, not once per query;
//   - the list's rows stream through shared memory 128 rows a window by
//     cp.async, up to the list's (each sub-list's) last live row: F
//     through a ring of three raw fp32 stages of 32 dims (two steps in
//     flight), split in shared memory into TF32 hi and lo parts for the
//     3xTF32 wgmma m64n128k8 of flat_list_scan.cu (lo.hi + hi.lo + hi.hi),
//     the group's queries split once (resident, where they fit) or each
//     step from registers loaded a step ahead; G through two bf16 operand
//     stages (one step ahead), wgmma m64n128k16 against bf16(qrot -
//     center), rounded once and staged per pair as pq_list_scan.cu's pass
//     1 stages it;
//   - warpgroup 0 multiplies; each window's 64 x 128 distances go to
//     shared memory and all eight warps keep the pairs' top kt: a row below
//     its pair's kt-th kept distance (the threshold) goes to the pair's
//     candidate buffer (32 or 64 entries: one ballot a 32-column chunk),
//     and a buffer that would overflow is merged into the pair's kept rows
//     (a power of two >= kt entries, ascending by (distance, slot)) by one
//     warp in registers over 64-bit (distance, slot) keys: a bitonic sort
//     of the buffer, the elementwise minimum of the kept rows and the
//     reversed buffer (the merged rows' smallest half, bitonic) and a
//     bitonic merge; the threshold is then the new kt-th entry.  No block
//     barrier per kept row.  A merge is a chain of ~28 dependent shuffle
//     steps (21 to sort 64 buffered entries, 7 to merge 128 kept ones),
//     so a warp keeps two pair rows side by side and merges both when
//     either buffer fills (profiles/pair_list_decomp.py measures the
//     parts);
//   - a filter's bit is tested only for a would-be candidate (below the
//     threshold), as list_fold.cuh tests it;
//   - the kept rows leave coalesced at the pair index the group's slot
//     holds; the raw variant writes each window's distances straight from
//     shared memory.  Extra blocks past the groups write the pairs no
//     group holds.
// Ties: every merge orders by (distance, slot), so the lowest slot wins as
// in the plain versions' stable sort.  Numerics are the list-major
// passes': F's 3xTF32 is within ~1.5 2^-20 (|q|^2 + |x|^2) of fp32; G's
// bf16 products are exact, summed in the tensor core's order.
//
// Kernels D and E past kt 64 (ops/pq_code_scan.py routes them here from
// kt 65 to KT_MAX, 128) run G's kernel with another row source (kSrc):
// Kernel D replaces raft_tpu/ops/pq_code_scan_pallas.py:367
// grouped_code_scan (body _kernel_codes), Kernel E :441
// grouped_recon8_scan (body _kernel_recon8), each at per-pair kt past
// KT_LIST_MAX.  Their contracts are pq_code_list_scan.cu's:
//   D:  row = concat_j bf16(book[j][code_j(row)]), d as G's over it
//   E:  d = max(sub_sq + rsq8[list, row] - (2 scale[list]) (bf16(sub) .
//       q8[list, row]), 0), the scale applied to the summed dot
// What bounds them on an H100: bytes (a row is W + 8 bytes: 56 at the
// deep codes, 104 at its int8 rows).  The query-major kernels
// (pq_code_scan.cu, pq_recon8_scan.cu) read a list once per query probing
// it and kept a pair's top kt by kt block-wide argmin rounds.  Here a
// step's rows come in by cp.async into a raw stage one step ahead (the
// packed codes of its 128 rows as one run of bytes; the int8 rows, the
// step's dims of each) and are built into the bf16 operand stage before
// the step's products (row_source.cuh, as pq_code_list_scan.cu builds
// them): the codes decoded through the bf16 books, read from global
// memory (L2-resident), zeros past rot; the int8 values converted (exact
// in bf16), the list's scale multiplying the summed dot in the distance.
// The residuals, the products, the keep and the write-out are G's, so on
// the same norms D gives G's pass over the decoded rows bit for bit, and
// E with every scale 1 and rot_pad = round16(rot) G's pass over q8 as
// bf16 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "list_fold.cuh"
#include "row_source.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace raft_mma;
using raft_list::Admit;
using raft_list::admitted;
using raft_rows::convert_int8_rows;
using raft_rows::decode_rows;
using raft_rows::int8_row_stride;
using raft_rows::kInt8;

constexpr int kThreads = 256;      // warpgroup 0 multiplies; 8 warps keep
constexpr int kWarps = kThreads / 32;
constexpr int kM = 64;             // pair rows of the tile (wgmma M)
constexpr int kKtMax = 256;        // K_MAX, ops/pq_group_scan.py
constexpr int kKeepMax = kKtMax / 32;  // kept entries a lane holds
constexpr int kBufMax = 2;         // buffered entries a lane holds (64)
constexpr int kMaxSub = 8;         // sub-lists a tile (ivf_flat's F)
constexpr int kDims = 32;          // fp32 dims a step (F)
constexpr int kRing = 3;           // F's raw stages
constexpr int kRaw = BN * 128;     // 128 rows x 32 fp32 dims (16 KB)
constexpr int kSmemLimit = 232448; // an H100 block's dynamic shared memory
constexpr unsigned kAll = 0xffffffffu;

// The block's dynamic shared memory, in the field order of ops/pair_scan.py's
// PairLayout, which computes it (the one copy of the formula): the group's
// pairs, a pair's kept entries (a power of two >= kt, >= 32) and candidate
// buffer (32 or 64), whether the A operand stays resident, then byte
// offsets from the 1024-aligned base: A (F: hi parts, atom column or stage
// a_step apart, lo parts a_lo further; G: bf16(sub), chunk stage a_step
// apart), b (F: raw stage s at b + s b_step, its rows' norms and ids kRaw
// in; G: operand stage s, also the window's distances), op (F: the split
// B operand, hi then lo, also the window's distances), key (F: the
// window's keys then ids; G: stage s's norms and ids at key + s * 1024),
// the kept values and slots, the buffers' values and slots, each pair's
// buffered count and threshold, q_sq / sub_sq, the pair indices, the
// sub-lists' ends and windows (and G's extent); the raw stages of D and E
// (stage s at raw + s raw_step; F and G: raw_step 0);
// total, the bytes to request.
struct PairLayout {
  int group, keep, buf, resident, a, a_step, a_lo, b, b_step, op, key,
      keep_v, keep_s, buf_v, buf_s, cnt, thr, ssq, pair, sub, raw, raw_step,
      total;
};

// A (distance, slot) entry as one 64-bit key that orders as (distance,
// slot): the distance's bits made order-preserving as an unsigned integer
// above the slot.  kEmpty, (+inf, INT_MAX), is the largest key a row holds.
using Key = unsigned long long;
constexpr Key kEmpty = (0xff800000ull << 32) | 0x7fffffffull;

__device__ __forceinline__ Key pack_key(float v, int s) {
  uint32_t b = __float_as_uint(v + 0.f);     // -0 as +0: equal values tie
  // on the slot
  b ^= (b & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return ((Key)b << 32) | (uint32_t)s;
}

__device__ __forceinline__ float key_value(Key k) {
  uint32_t b = (uint32_t)(k >> 32);
  b ^= (b & 0x80000000u) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(b);
}

// (a, b) <- (min, max), within a thread
__device__ __forceinline__ void ce(Key& a, Key& b) {
  const Key lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// a compare-exchange with the lane `stride` away: this lane's new entry,
// the smaller of the two where keep_min, else the larger
__device__ __forceinline__ Key ce_lane(Key k, int stride, bool keep_min) {
  const Key p = __shfl_xor_sync(kAll, k, stride);
  return (p < k) == keep_min ? p : k;
}

// The per-pair state of a block's keep, in shared memory.
struct Keep {
  float* keep_v;   // group x P kept values, ascending
  int* keep_s;     // their slots (INT_MAX: empty)
  float* buf_v;    // group x Bc buffered candidates
  int* buf_s;
  int* cnt;        // buffered entries a pair
  float* thr;      // a pair's kt-th kept value
  int P, Bc;
};

// A warp merges the buffered candidates of R pair rows (nb[j] of row
// rows[j]'s Bc, 0 for none) into their P kept entries, the R rows side by
// side so their latencies overlap: each row's buffer (empty past nb)
// sorted bitonically in registers (entry i at lane i % 32, register
// i / 32), min(kept[i], buffer[P - 1 - i]) — the merged rows' P smallest,
// a bitonic sequence — and its bitonic merge.  thr[j] becomes row j's new
// kt-th value.
template <int R>
__device__ void flush_rows(const Keep& K, const int (&rows)[R],
                           const int (&nb)[R], float (&thr)[R], int kt,
                           int lane) {
  __syncwarp();
  const int P = K.P, Bc = K.Bc, E = P >> 5, EB = Bc >> 5;
  Key b[R][kBufMax];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int e = 0; e < kBufMax; ++e) {
      const int i = 32 * e + lane;
      b[j][e] = e < EB && i < nb[j]
          ? pack_key(K.buf_v[rows[j] * Bc + i], K.buf_s[rows[j] * Bc + i])
          : kEmpty;
    }
  }
  for (int size = 2; size <= Bc; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {          // Bc 64, size 64: a lane's two entries
#pragma unroll
        for (int j = 0; j < R; ++j) ce(b[j][0], b[j][1]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < kBufMax; ++e) {
        if (e < EB) {
          const bool keep_min = ((lane & stride) == 0)
                                == (((32 * e + lane) & size) == 0);
#pragma unroll
          for (int j = 0; j < R; ++j)
            b[j][e] = ce_lane(b[j][e], stride, keep_min);
        }
      }
    }
  }
  // the buffer reversed and padded to P: entry 32 e + lane of it is the
  // buffer's entry 32 (E - 1 - e) + 31 - lane
  Key rev[R][kBufMax];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int e = 0; e < kBufMax; ++e)
      rev[j][e] = __shfl_sync(kAll, b[j][e], 31 - lane);
  }
  Key c[R][kKeepMax];
#pragma unroll
  for (int e = 0; e < kKeepMax; ++e) {
    const int eb = E - 1 - e;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      c[j][e] = kEmpty;
      if (e < E) {
        const int at = rows[j] * P + 32 * e + lane;
        const Key k = pack_key(K.keep_v[at], K.keep_s[at]);
        const Key r = eb == 0 ? rev[j][0]
                              : (eb == 1 && EB == 2 ? rev[j][1] : kEmpty);
        c[j][e] = r < k ? r : k;
      }
    }
  }
  for (int stride = P >> 1; stride >= 32; stride >>= 1) {
    const int se = stride >> 5;
#pragma unroll
    for (int e = 0; e < kKeepMax; ++e) {
      // compile-time partner indices for each of the three strides
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (se == 4 && (e & 4) == 0 && (e | 4) < E) ce(c[j][e], c[j][e | 4]);
        if (se == 2 && (e & 2) == 0 && (e | 2) < E) ce(c[j][e], c[j][e | 2]);
        if (se == 1 && (e & 1) == 0 && (e | 1) < E) ce(c[j][e], c[j][e | 1]);
      }
    }
  }
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool keep_min = (lane & stride) == 0;
#pragma unroll
    for (int e = 0; e < kKeepMax; ++e) {
      if (e < E) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          c[j][e] = ce_lane(c[j][e], stride, keep_min);
      }
    }
  }
  const int ek = (kt - 1) >> 5;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    Key t = kEmpty;
#pragma unroll
    for (int e = 0; e < kKeepMax; ++e) {
      if (e < E) {
        const int at = rows[j] * P + 32 * e + lane;
        K.keep_v[at] = key_value(c[j][e]);
        K.keep_s[at] = (int)(uint32_t)c[j][e];
      }
      if (e == ek) t = c[j][e];
    }
    thr[j] = key_value(__shfl_sync(kAll, t, (kt - 1) & 31));
  }
  __syncwarp();
}

constexpr int kRowsAtOnce = 2;     // pair rows a warp keeps side by side

// Fold one window's distances (row r's column c at dist[r * BN + (c ^ (r &
// 31))]; slots row0 + c; columns at or past end are dead) into the group's
// keep: warp w takes pair rows w and w + 8, then w + 16 and w + 24, ...,
// two side by side; a 32-column chunk's values below a row's threshold
// (and, kFilter, whose id its query admits) go to the row's buffer by one
// ballot, both rows' buffers first merged (flush_rows) when either's
// would not hold them.
template <bool kFilter>
__device__ void fold_keep(const Keep& K, const float* dist, const int* kid,
                          const int* s_pair, int n_pairs, int group, int kt,
                          int row0, int end, const Admit& adm) {
  constexpr int R = kRowsAtOnce;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // group is a multiple of R * kWarps (16, 32 or 64)
  for (int base = warp; base < group; base += R * kWarps) {
    int rows[R], p[R], cnt[R];
    float thr[R];
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      rows[j] = base + j * kWarps;
      p[j] = s_pair[rows[j]];
      any |= p[j] < n_pairs;
      thr[j] = p[j] < n_pairs ? K.thr[rows[j]] : -INFINITY;
      cnt[j] = K.cnt[rows[j]];
    }
    if (!any) continue;
    for (int c0 = 0; c0 < BN && row0 + c0 < end; c0 += 32) {
      float d[R];
      bool cand[R];
      unsigned m[R], all = 0u;
      bool full = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        d[j] = dist[rows[j] * BN + ((c0 + lane) ^ (rows[j] & 31))];
        cand[j] = d[j] < thr[j];
        if constexpr (kFilter) {
          if (cand[j]) cand[j] = admitted(adm, p[j], kid[c0 + lane]);
        }
        m[j] = __ballot_sync(kAll, cand[j]);
        all |= m[j];
        full |= cnt[j] + __popc(m[j]) > K.Bc;
      }
      if (all == 0u) continue;
      if (full) {
        flush_rows<R>(K, rows, cnt, thr, kt, lane);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (!(p[j] < n_pairs)) thr[j] = -INFINITY;
          cnt[j] = 0;
          cand[j] = cand[j] && d[j] < thr[j];
          m[j] = __ballot_sync(kAll, cand[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (cand[j]) {
          const int pos = cnt[j] + __popc(m[j] & ((1u << lane) - 1u));
          K.buf_v[rows[j] * K.Bc + pos] = d[j];
          K.buf_s[rows[j] * K.Bc + pos] = row0 + c0 + lane;
        }
        cnt[j] += __popc(m[j]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (p[j] < n_pairs) K.thr[rows[j]] = thr[j];
        K.cnt[rows[j]] = cnt[j];
      }
    }
  }
}

// every pair row's last buffered candidates merged in; ends synchronised
__device__ void flush_all(const Keep& K, const int* s_pair, int n_pairs,
                          int group, int kt) {
  constexpr int R = kRowsAtOnce;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = warp; base < group; base += R * kWarps) {
    int rows[R], cnt[R];
    float thr[R];
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      rows[j] = base + j * kWarps;
      cnt[j] = s_pair[rows[j]] < n_pairs ? K.cnt[rows[j]] : 0;
      any |= cnt[j] > 0;
    }
    if (any) flush_rows<R>(K, rows, cnt, thr, kt, lane);
  }
  __syncthreads();
}

// each pair's top kt to out (n_pairs, kt) at its pair index, coalesced:
// the values, and the ids of the list rows (ids[lbase + slot]), -1 where
// the value is +inf
__device__ void write_keep(const Keep& K, const int* s_pair, int n_pairs,
                           int group, int kt, const int* ids, size_t lbase,
                           float* out_v, int* out_i) {
  for (int e = threadIdx.x; e < group * kt; e += kThreads) {
    const int r = e / kt, i = e - r * kt;
    const int p = s_pair[r];
    if (p >= n_pairs) continue;
    const float v = K.keep_v[r * K.P + i];
    out_v[(size_t)p * kt + i] = v;
    out_i[(size_t)p * kt + i] =
        v < INFINITY ? ids[lbase + K.keep_s[r * K.P + i]] : -1;
  }
}

// the raw variant: one window's distances of each pair row to out (n_pairs,
// width) at slots row0 + c < end, a row's 128 columns by one warp
__device__ void write_raw(const float* dist, const int* s_pair, int n_pairs,
                          int group, int width, int row0, int end,
                          float* out_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < group; r += kWarps) {
    const int p = s_pair[r];
    if (p >= n_pairs) continue;
    float* o = out_v + (size_t)p * width;
    for (int c = lane; c < BN && row0 + c < end; c += 32)
      o[row0 + c] = dist[r * BN + (c ^ (r & 31))];
  }
}

// A block past the groups, the b-th: the pairs [b kThreads, (b + 1)
// kThreads) whose probe lies outside [0, n_lists), which no group holds,
// get +inf at each of their `width` places (and id -1 where out_i).
__device__ void write_empty(int b, const int* probes, int n_pairs,
                            int n_lists, int width, float* out_v,
                            int* out_i) {
  const int p = b * kThreads + threadIdx.x;
  if (p < n_pairs && (probes[p] < 0 || probes[p] >= n_lists)) {
    for (int t = 0; t < width; ++t) {
      out_v[(size_t)p * width + t] = INFINITY;
      if (out_i != nullptr) out_i[(size_t)p * width + t] = -1;
    }
  }
}

// Warpgroup 0's 64 x 128 products (acc, the wgmma fragment) as distances
// dist_of(product, column key, row norm) into dist, row r's column c at
// r * BN + (c ^ (r & 31)); rows at or past group are not written.
template <class Dist>
__device__ __forceinline__ void write_dist(const float (&acc)[kAccs],
                                           const float* key, const float* ssq,
                                           float* dist, int group,
                                           Dist dist_of) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  const int rloc = warp * 16 + (lane >> 2);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rloc + 8 * hh;
    if (row >= group) continue;
    const float ss = ssq[row];
    float* drow = dist + row * BN;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * quad;
      drow[c ^ (row & 31)] = dist_of(acc[4 * j + 2 * hh], key[c], ss);
      drow[(c + 1) ^ (row & 31)] =
          dist_of(acc[4 * j + 2 * hh + 1], key[c + 1], ss);
    }
  }
}

// a 4-byte copy by cp.async (src_bytes 0: zeros)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src));
  return v;
}

// fp32 dims [d, d + 4) of a row, zeros when !ok and past dim: one 16-byte
// load where vec, else one value at a time
__device__ __forceinline__ float4 load4(const float* row, int d, int dim,
                                        bool ok, bool vec) {
  return vec ? row_chunk<true>(row, d, dim, ok)
             : row_chunk<false>(row, d, dim, ok);
}

__device__ __forceinline__ float row_distance(float dot, float key,
                                              float q_sq, int ip) {
  if (!(key < INFINITY)) return INFINITY;
  return ip ? -dot : fmaxf(q_sq + key - 2.f * dot, 0.f);
}

// The block's start: the group's pair indices (n_pairs past group), the
// keep emptied.  The caller synchronises.
__device__ void start_pairs(const int* slot_pairs, int g, int group,
                            int n_pairs, int* s_pair, const Keep& K,
                            bool extract) {
  const int tid = threadIdx.x;
  if (tid < kM)
    s_pair[tid] = tid < group ? slot_pairs[(size_t)g * group + tid] : n_pairs;
  if (!extract) return;
  for (int i = tid; i < group * K.P; i += kThreads) {
    K.keep_v[i] = INFINITY;
    K.keep_s[i] = INT_MAX;
  }
  if (tid < kM) {
    K.cnt[tid] = 0;
    K.thr[tid] = INFINITY;
  }
}

__device__ __forceinline__ Keep make_keep(unsigned char* base,
                                          const PairLayout& L) {
  return Keep{reinterpret_cast<float*>(base + L.keep_v),
              reinterpret_cast<int*>(base + L.keep_s),
              reinterpret_cast<float*>(base + L.buf_v),
              reinterpret_cast<int*>(base + L.buf_s),
              reinterpret_cast<int*>(base + L.cnt),
              reinterpret_cast<float*>(base + L.thr), L.keep, L.buf};
}

// ---------------------------------------------------------------------------
// Kernel F: fp32 rows, 3xTF32
// ---------------------------------------------------------------------------

// kResident: the group's queries keep every dim in shared memory;
// kExtract: keep each pair's top kt (else the raw variant); kFilter: each
// pair keeps only the rows its query admits
template <bool kResident, bool kExtract, bool kFilter>
__global__ void __launch_bounds__(kThreads, 1)
flat_pair_kernel(const float* __restrict__ queries,
                 const int* __restrict__ probes,
                 const int* __restrict__ group_list,
                 const int* __restrict__ slot_pairs,
                 const float* __restrict__ data,
                 const float* __restrict__ norms,
                 const int* __restrict__ ids, int n_groups, int n_pairs,
                 int n_probes, int n_tiles, int rows, int n_sub, int dim,
                 int kt, int ip, int gather, int vec, const PairLayout L,
                 const Admit adm, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = kExtract ? kt : rows;
  if (blockIdx.x >= n_groups) {
    write_empty(blockIdx.x - n_groups, probes, n_pairs, n_tiles, width,
                out_v, kExtract ? out_i : nullptr);
    return;
  }
  const int g = blockIdx.x;
  const int l = group_list[g];
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const int group = L.group;
  const Keep K = make_keep(base, L);
  float* ssq = reinterpret_cast<float*>(base + L.ssq);
  int* s_pair = reinterpret_cast<int*>(base + L.pair);
  int* s_end = reinterpret_cast<int*>(base + L.sub);
  int* s_win = s_end + kMaxSub;
  float* s_key = reinterpret_cast<float*>(base + L.key);
  int* s_kid = reinterpret_cast<int*>(s_key + BN);
  const size_t lbase = (size_t)l * rows;
  const float* tile = data + lbase * dim;
  const int sub_rows = rows / n_sub;
  const int nch = (dim + kDims - 1) / kDims;
  const int kp = (dim + 7) & ~7;

  start_pairs(slot_pairs, g, group, n_pairs, s_pair, K, kExtract);
  if (tid < kMaxSub) s_end[tid] = 0;
  // a group without a pair (past the exact count of a static one) scans
  // nothing and writes nothing
  if (!__syncthreads_or(tid < kM && s_pair[tid] < n_pairs)) return;
  if constexpr (kExtract) {
    // each sub-list's live end, one past its last row with an id >= 0
    for (int r0 = 0; r0 < rows; r0 += kThreads) {
      const int r = r0 + tid;
      const int sub = min(r, rows - 1) / sub_rows;
      const int end = r < rows && ids[lbase + r] >= 0 ? r + 1 : 0;
      const unsigned same = __match_any_sync(kAll, sub);
      const int last = __reduce_max_sync(same, end);
      if (lane == __ffs(same) - 1 && last > 0) atomicMax(&s_end[sub], last);
    }
  } else if (tid < n_sub) {
    s_end[tid] = (tid + 1) * sub_rows;      // raw: every slot
  }
  // the query of group slot r (null on an empty slot)
  auto query_of = [&](int r) -> const float* {
    const int p = s_pair[r];
    return p < n_pairs
        ? queries + (size_t)(gather ? p / n_probes : p) * dim : nullptr;
  };
  // q_sq from the fp32 queries: warp w takes rows w + 8 k, their loads in
  // flight together
  {
    const float* qv[kM / kWarps];
    float acc[kM / kWarps];
#pragma unroll
    for (int k = 0; k < kM / kWarps; ++k) {
      qv[k] = ip ? nullptr : query_of(warp + kWarps * k);
      acc[k] = 0.f;
    }
    for (int e = lane; e < dim; e += 32) {
#pragma unroll
      for (int k = 0; k < kM / kWarps; ++k)
        if (qv[k] != nullptr) acc[k] = fmaf(qv[k][e], qv[k][e], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kM / kWarps; ++k) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc[k] += __shfl_xor_sync(kAll, acc[k], off);
      if (lane == 0) ssq[warp + kWarps * k] = acc[k];
    }
  }
  __syncthreads();
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
  const int nsteps = s_win[n_sub] * nch;

  // window w's first row and its sub-list's live end
  auto window = [&](int w, int& row0, int& end) {
    int s = 0;
    while (s + 1 < n_sub && s_win[s + 1] <= w) ++s;
    row0 = s * sub_rows + (w - s_win[s]) * BN;
    end = s_end[s];
  };
  // step s's rows (dims [32 qc, 32 qc + 32) of window w's 128) into raw
  // stage s % kRing by cp.async, zeros past the live end and past dim; at
  // the window's last step also its rows' norms and ids
  auto fetch = [&](int s) {
    if (s >= nsteps) return;
    const int w = s / nch, qc = s - w * nch;
    int row0, end;
    window(w, row0, end);
    const uint32_t dst = sbase + L.b + (s % kRing) * L.b_step;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 3, d = qc * kDims + 4 * (e & 7);
      const uint32_t at = dst + sw128_offset(BN, r, e & 7);
      const bool ok = row0 + r < end && d < dim;
      const float* row = tile + (size_t)(row0 + r) * dim;
      if (vec) {
        cp_async16(at, ok ? row + d : tile, ok ? 16 : 0);
      } else {
        const float4 v = row_chunk<false>(row, d, dim, ok);
        st_shared16(at, make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                                   __float_as_uint(v.z),
                                   __float_as_uint(v.w)));
      }
    }
    if (qc == nch - 1 && tid < BN) {
      const int r = row0 + tid;
      const bool ok = r < end;
      const bool has_norm = ok && norms != nullptr;
      const bool has_id = ok && ids != nullptr;
      cp_async4(dst + kRaw + 4 * tid,
                has_norm ? static_cast<const void*>(norms + lbase + r)
                         : static_cast<const void*>(tile),
                has_norm ? 4 : 0);
      cp_async4(dst + kRaw + 4 * (BN + tid),
                has_id ? static_cast<const void*>(ids + lbase + r)
                       : static_cast<const void*>(tile),
                has_id ? 4 : 0);
    }
  };
  // the group's queries at step s's dims, in registers a step ahead
  float4 qa[2];
  auto load_a = [&](int s) {
    const int qc = s % nch;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreads;     // < kM * 8
      const float* q = query_of(e >> 3);
      qa[i] = load4(q, qc * kDims + 4 * (e & 7), dim, q != nullptr, vec);
    }
  };
  // step s's raw rows split into the TF32 operand (hi, then lo kRaw on);
  // the queries (not resident) from registers; at the window's last step
  // its keys: the norm, +inf past the live end and on a dead row
  // (extract)
  auto split = [&](int s) {
    const int w = s / nch, qc = s - w * nch;
    const uint32_t src = sbase + L.b + (s % kRing) * L.b_step;
    const uint32_t hi = sbase + L.op;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const uint32_t off = sw128_offset(BN, e >> 3, e & 7);
      const uint4 u = ld_shared16(src + off);
      store_split(hi + off, hi + kRaw + off,
                  make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                              __uint_as_float(u.z), __uint_as_float(u.w)));
    }
    if constexpr (!kResident) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * kThreads;
        const uint32_t off = sw128_offset(kM, e >> 3, e & 7);
        store_split(sbase + L.a + off, sbase + L.a + L.a_lo + off, qa[i]);
      }
    }
    if (qc == nch - 1 && tid < BN) {
      int row0, end;
      window(w, row0, end);
      const float* kf = reinterpret_cast<const float*>(
          base + L.b + (s % kRing) * L.b_step + kRaw);
      const int id = reinterpret_cast<const int*>(kf + BN)[tid];
      s_kid[tid] = id;
      s_key[tid] = row0 + tid < end && (!kExtract || id >= 0)
          ? kf[tid] : INFINITY;
    }
  };

  if constexpr (kResident) {
    // every dim of the group's queries, atom column c at a + c * a_step
    for (int e = tid; e < nch * kM * 8; e += kThreads) {
      const int c = e / (kM * 8), rem = e - c * kM * 8;
      const float* q = query_of(rem >> 3);
      const uint32_t off =
          c * L.a_step + sw128_offset(kM, rem >> 3, rem & 7);
      store_split(sbase + L.a + off, sbase + L.a + L.a_lo + off,
                  load4(q, c * kDims + 4 * (rem & 7), dim, q != nullptr,
                        vec));
    }
  } else if (nsteps > 0) {
    load_a(0);
  }
  fetch(0);
  cp_async_commit();
  fetch(1);
  cp_async_commit();

  const bool mma = tid < 128;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  float* dist = reinterpret_cast<float*>(base + L.op);

  for (int s = 0; s < nsteps; ++s) {
    const int w = s / nch, qc = s - w * nch;
    // step s's rows landed (this thread's copies, then everyone's); the
    // products and the window of step s - 1 are done with the operand
    cp_async_wait1();
    __syncthreads();
    split(s);
    fence_proxy_async();
    __syncthreads();
    // two steps in flight: step s + 2 into the stage step s - 1 used
    fetch(s + 2);
    cp_async_commit();
    if (!kResident && s + 1 < nsteps) load_a(s + 1);
    if (mma) {
      const uint32_t a_hi = sbase + L.a + (kResident ? qc * L.a_step : 0);
      const uint32_t a_lo = a_hi + L.a_lo;
      const uint32_t b_hi = sbase + L.op;
      const uint32_t b_lo = b_hi + kRaw;
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
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
    }
    if (qc != nch - 1) continue;

    // window w: its distances over the operand just multiplied, then the
    // keep (or the raw block)
    int row0, end;
    window(w, row0, end);
    if (mma)
      write_dist(acc, s_key, ssq, dist, group,
                 [ip](float dot, float key, float ss) {
                   return row_distance(dot, key, ss, ip);
                 });
    __syncthreads();
    if constexpr (kExtract)
      fold_keep<kFilter>(K, dist, s_kid, s_pair, n_pairs, group, kt, row0,
                         end, adm);
    else
      write_raw(dist, s_pair, n_pairs, group, width, row0, end, out_v);
  }
  cp_async_wait0();
  if constexpr (kExtract) {
    flush_all(K, s_pair, n_pairs, group, kt);
    write_keep(K, s_pair, n_pairs, group, kt, ids, lbase, out_v, out_i);
  }
}

// ---------------------------------------------------------------------------
// Kernels G, D and E: bf16 products over a list's rows
// ---------------------------------------------------------------------------

// where a step's rows come from (recon_pair_kernel's kSrc)
constexpr int kBf16Rows = 0;     // G: the bf16 recon cache by cp.async
                                 // straight into the operand stage
constexpr int kBuiltRows = 1;    // D, E: packed codes or int8 rows by
                                 // cp.async into a raw stage, built into
                                 // the operand stage (row_source.cuh)
constexpr int kBuiltMax = 1024;  // widest built rows (rot, rot_pad)

// D and E's rows (G: unused): data (n_lists, cap, W) bytes; bits 4 or 8,
// packed codes through the bf16 books (pq_dim, 2^bits, pq_len), read from
// global memory; or kInt8, int8 rows of W = rot_pad bytes whose list's
// scale (scales) multiplies the summed dot
struct BuiltRows {
  const uint8_t* data;
  const uint4* books;
  const float* scales;
  int bits, W, pq_len;
};

template <int kSrc, bool kResident, bool kExtract, bool kFilter>
__global__ void __launch_bounds__(kThreads, 1)
recon_pair_kernel(const float* __restrict__ qrot,
                  const float* __restrict__ centers,
                  const int* __restrict__ probes,
                  const int* __restrict__ group_list,
                  const int* __restrict__ slot_pairs,
                  const __nv_bfloat16* __restrict__ recon,
                  const BuiltRows src,
                  const float* __restrict__ rsq, const int* __restrict__ ids,
                  int n_groups, int n_pairs, int n_probes, int n_lists,
                  int cap, int rot, int kt, int gather, const PairLayout L,
                  const Admit adm, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBuilt = kSrc == kBuiltRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = kExtract ? kt : cap;
  if (blockIdx.x >= n_groups) {
    write_empty(blockIdx.x - n_groups, probes, n_pairs, n_lists, width,
                out_v, kExtract ? out_i : nullptr);
    return;
  }
  const int g = blockIdx.x;
  const int l = group_list[g];
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const int group = L.group;
  const Keep K = make_keep(base, L);
  float* ssq = reinterpret_cast<float*>(base + L.ssq);
  int* s_pair = reinterpret_cast<int*>(base + L.pair);
  int* s_extent = reinterpret_cast<int*>(base + L.sub);
  const size_t lbase = (size_t)l * cap;
  const float* cen = centers + (size_t)l * rot;
  const __nv_bfloat16* list = kBuilt ? nullptr : recon + lbase * rot;
  // D, E: int8 rows run the products over their W = rot_pad dims
  const bool int8_rows = kBuilt && src.bits == kInt8;
  const int kp = int8_rows ? src.W : (rot + 15) & ~15;
  const int kc = kResident ? kp : kKc;
  const int nch = (kp + kc - 1) / kc;
  const uint8_t* ldata = kBuilt ? src.data + lbase * src.W : nullptr;
  // the dot's factor in the distance: 2, or 2 scale[list] for int8 rows
  const float scale2 = int8_rows ? 2.f * src.scales[l] : 2.f;

  start_pairs(slot_pairs, g, group, n_pairs, s_pair, K, kExtract);
  if (tid == 0) *s_extent = kExtract ? 0 : cap;
  // a group without a pair (past the exact count of a static one) scans
  // nothing and writes nothing
  if (!__syncthreads_or(tid < kM && s_pair[tid] < n_pairs)) return;
  if constexpr (kExtract) {
    // one past the list's last row with an id >= 0
    int last = 0;
    for (int r = tid; r < cap; r += kThreads)
      if (ids[lbase + r] >= 0) last = r + 1;
    last = __reduce_max_sync(kAll, last);
    if (lane == 0) atomicMax(s_extent, last);
  }
  auto query_of = [&](int r) -> const float* {
    const int p = s_pair[r];
    return p < n_pairs
        ? qrot + (size_t)(gather ? p / n_probes : p) * rot : nullptr;
  };
  // sub_sq from the fp32 residuals: warp w takes rows w + 8 k, their
  // loads in flight together
  {
    const float* qv[kM / kWarps];
    float acc[kM / kWarps];
#pragma unroll
    for (int k = 0; k < kM / kWarps; ++k) {
      qv[k] = query_of(warp + kWarps * k);
      acc[k] = 0.f;
    }
    for (int e = lane; e < rot; e += 32) {
      const float c = cen[e];
#pragma unroll
      for (int k = 0; k < kM / kWarps; ++k) {
        if (qv[k] != nullptr) {
          const float s = qv[k][e] - c;
          acc[k] = fmaf(s, s, acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kM / kWarps; ++k) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc[k] += __shfl_xor_sync(kAll, acc[k], off);
      if (lane == 0) ssq[warp + kWarps * k] = acc[k];
    }
  }
  __syncthreads();
  const int extent = *s_extent;
  const int nsteps = ((extent + BN - 1) / BN) * nch;

  // dims [k0, k0 + kc) of the group's residuals bf16(qrot[q] - cen) as the
  // wgmma A operand at dst (zeros on an empty slot and past rot: G's rot
  // is a multiple of 8, D and E's any)
  auto stage_res = [&](uint32_t dst, int k0) {
    const int nkg = kc >> 3;
    for (int e = tid; e < kM * nkg; e += kThreads) {
      const int r = e / nkg, kg = e - r * nkg;
      const int gcol = k0 + kg * 8;
      const float* qv = query_of(r);
      uint32_t w4[4] = {0u, 0u, 0u, 0u};
      if (qv != nullptr && gcol < rot) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = 0.f, b = 0.f;
          if (!kBuilt || gcol + 2 * i < rot)
            a = qv[gcol + 2 * i] - cen[gcol + 2 * i];
          if (!kBuilt || gcol + 2 * i + 1 < rot)
            b = qv[gcol + 2 * i + 1] - cen[gcol + 2 * i + 1];
          const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
          const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
          w4[i] = lo | (hi << 16);
        }
      }
      st_shared16(dst + sw128_offset(kM, r, kg),
                  make_uint4(w4[0], w4[1], w4[2], w4[3]));
    }
  };
  // D, E: rows [r0, r0 + 128) (up to the extent) into the raw stage at
  // dst by cp.async.  Codes: 16-byte chunks of the run of their W-byte
  // rows from the 16-byte boundary at or below its first byte (the codes
  // are 16-byte aligned, so it lies inside them), the last chunk cut at
  // the run's end.  int8: dims [k0, k0 + kc) of each row, rows
  // int8_row_stride(kc) bytes apart, consecutive threads on consecutive
  // chunks of a row.
  const int rs = int8_row_stride(kc);
  auto load_raw = [&](int r0, int k0, uint32_t dst) {
    const int n = min(BN, extent - r0);
    if (int8_rows) {
      const int nc = min(kc, kp - k0) >> 4;
      const uint8_t* from = ldata + (size_t)r0 * src.W + k0;
      for (int e = tid; e < n * nc; e += kThreads) {
        const int r = e / nc, c = e - r * nc;
        cp_async16(dst + r * rs + 16 * c, from + (size_t)r * src.W + 16 * c,
                   16);
      }
    } else {
      const uint8_t* run = ldata + (size_t)r0 * src.W;
      const uint8_t* from = run - ((uintptr_t)run & 15);
      const int nbytes = (int)(run - from) + n * src.W;
      for (int c = tid; 16 * c < nbytes; c += kThreads)
        cp_async16(dst + 16 * c, from + 16 * c, min(16, nbytes - 16 * c));
    }
  };
  // D, E: step s's rows built from raw stage `stage` into operand stage
  // `stage`: the codes decoded through the books, the int8 values
  // converted; zeros past the extent and past rot
  auto build_rows = [&](int s, int stage) {
    const int t = s / nch, qq = s - t * nch;
    const int r0 = t * BN, n = min(BN, extent - r0);
    const uint32_t dst = sbase + L.b + stage * L.b_step;
    const uint8_t* raw = base + L.raw + stage * L.raw_step;
    if (int8_rows) {
      convert_int8_rows(dst, raw, n, rs, min(kc, kp - qq * kc), kc, tid);
      return;
    }
    raw += (uintptr_t)(ldata + (size_t)r0 * src.W) & 15;   // the head
    const int W = src.W, pq_len = src.pq_len, k0 = qq * kc;
    const auto* books = reinterpret_cast<const unsigned short*>(src.books);
    if (src.bits == 8)
      decode_rows<8>(dst, raw, books, n, W, rot, pq_len, k0, kc, tid);
    else
      decode_rows<4>(dst, raw, books, n, W, rot, pq_len, k0, kc, tid);
  };
  // step s's list rows into operand stage `stage` by cp.async (zeros past
  // the extent; D, E: into raw stage `stage`), with the rows' norms and
  // ids
  auto load_step = [&](int s, int stage) {
    const int t = s / nch, qq = s - t * nch;
    if (!kResident) stage_res(sbase + L.a + stage * L.a_step, qq * kc);
    if constexpr (kBuilt)
      load_raw(t * BN, qq * kc, sbase + L.raw + stage * L.raw_step);
    else
      stage_rows(sbase + L.b + stage * L.b_step, list, BN, t * BN, extent,
                 rot, qq * kc, kc, true, tid, kThreads);
    if (tid < BN) {
      const int r = t * BN + tid;
      const bool ok = r < cap;
      const uint32_t key = sbase + L.key + stage * 1024;
      const bool has_id = ok && ids != nullptr;
      cp_async4(key + 4 * tid, ok ? rsq + lbase + r : rsq, ok ? 4 : 0);
      cp_async4(key + 4 * (BN + tid),
                has_id ? static_cast<const void*>(ids + lbase + r)
                       : static_cast<const void*>(rsq),
                has_id ? 4 : 0);
    }
  };

  if constexpr (kResident) stage_res(sbase + L.a, 0);
  if (nsteps > 0) load_step(0, 0);
  cp_async_commit();

  const bool mma = tid < 128;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s & 1;
    const int t = s / nch, qq = s - t * nch;
    // every thread is done with step s - 1's stage before it refills
    __syncthreads();
    if (s + 1 < nsteps) load_step(s + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();
    if constexpr (kBuilt) {
      // step s's raw rows landed (every thread's copies), then built
      __syncthreads();
      build_rows(s, stage);
    }
    fence_proxy_async();
    __syncthreads();
    if (mma) {
      const uint32_t a0 = sbase + L.a + stage * L.a_step;
      const uint32_t b0 = sbase + L.b + stage * L.b_step;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < (kc >> 4); ++ks) {
        const uint64_t da = desc_sw128(
            a0 + ((ks >> 2) * (kM >> 3) << 10) + ((ks & 3) << 5));
        const uint64_t db = desc_sw128(
            b0 + ((ks >> 2) * (BN >> 3) << 10) + ((ks & 3) << 5));
        wgmma_m64n128k16(acc, da, db, (qq == 0 && ks == 0) ? 0 : 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
    }
    if (qq != nch - 1) continue;

    // row tile t: its keys (+inf at or past the extent and, extract, on a
    // dead row), its distances over the stage's rows, then the keep (or
    // the raw block)
    float* key = reinterpret_cast<float*>(base + L.key + stage * 1024);
    const int* kid = reinterpret_cast<const int*>(key + BN);
    if (tid < BN && (t * BN + tid >= extent || (kExtract && kid[tid] < 0)))
      key[tid] = INFINITY;
    __syncthreads();
    float* dist = reinterpret_cast<float*>(base + L.b + stage * L.b_step);
    if (mma) {
      if constexpr (kBuilt)      // int8 rows: the list's scale after the sum
        write_dist(acc, key, ssq, dist, group,
                   [scale2](float dot, float k, float ss) {
                     return k < INFINITY
                         ? fmaxf(ss + k - __fmul_rn(scale2, dot), 0.f)
                         : INFINITY;
                   });
      else
        write_dist(acc, key, ssq, dist, group,
                   [](float dot, float k, float ss) {
                     return k < INFINITY ? fmaxf(ss + k - 2.f * dot, 0.f)
                                         : INFINITY;
                   });
    }
    __syncthreads();
    if constexpr (kExtract)
      fold_keep<kFilter>(K, dist, kid, s_pair, n_pairs, group, kt, t * BN,
                         extent, adm);
    else
      write_raw(dist, s_pair, n_pairs, group, width, t * BN, extent, out_v);
  }
  cp_async_wait0();
  if constexpr (kExtract) {
    flush_all(K, s_pair, n_pairs, group, kt);
    write_keep(K, s_pair, n_pairs, group, kt, ids, lbase, out_v, out_i);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// the layout's offsets ascend, the operands sit on 1024-byte atoms, a
// pair's kept entries hold kt (a power of two, 32..256), its buffer 32 or
// 64 entries, the group 16, 32 or 64 pairs, the raw stages on
// 16 bytes and the two raw stages inside the block's bytes, all within the
// card's limit
bool layout_ok(const PairLayout& L, int kt, bool extract) {
  const int at[] = {L.a, L.b, L.op, L.key, L.keep_v, L.keep_s, L.buf_v,
                    L.buf_s, L.cnt, L.thr, L.ssq, L.pair, L.sub, L.raw,
                    L.total};
  for (int i = 0; i + 1 < 15; ++i)
    if (at[i] < 0 || at[i] > at[i + 1]) return false;
  const bool pow2 = L.keep >= 32 && L.keep <= kKtMax
                    && (L.keep & (L.keep - 1)) == 0;
  return (L.group == 16 || L.group == 32 || L.group == 64)
         && (!extract || (pow2 && L.keep >= kt && (L.buf == 32 || L.buf == 64)
                          && L.buf <= L.keep))
         && L.a % 1024 == 0 && L.b % 1024 == 0 && L.b_step % 1024 == 0
         && L.a_step % 1024 == 0 && L.a_lo % 1024 == 0 && L.op % 1024 == 0
         && L.raw % 16 == 0 && L.raw_step % 16 == 0
         && L.raw_step >= 0 && L.raw + 2 * L.raw_step <= L.total
         && L.total <= kSmemLimit;
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kResident, bool kExtract, bool kFilter>
int launch_flat(int blocks, cudaStream_t s, const void* queries,
                const void* probes, const void* group_list,
                const void* slot_pairs, const void* data, const void* norms,
                const void* ids, int n_groups, int n_pairs, int n_probes,
                int n_tiles, int rows, int n_sub, int dim, int kt, int ip,
                int gather, int vec, const PairLayout& L, const Admit& adm,
                void* out_v, void* out_i) {
  const auto kernel = flat_pair_kernel<kResident, kExtract, kFilter>;
  const int err = set_smem(kernel, L.total);
  if (err != 0) return err;
  if (blocks > 0)
    kernel<<<blocks, kThreads, L.total, s>>>(
        static_cast<const float*>(queries), static_cast<const int*>(probes),
        static_cast<const int*>(group_list),
        static_cast<const int*>(slot_pairs), static_cast<const float*>(data),
        static_cast<const float*>(norms), static_cast<const int*>(ids),
        n_groups, n_pairs, n_probes, n_tiles, rows, n_sub, dim, kt, ip,
        gather, vec, L, adm, static_cast<float*>(out_v),
        static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

template <int kSrc, bool kResident, bool kExtract, bool kFilter>
int launch_recon(int blocks, cudaStream_t s, const void* qrot,
                 const void* centers, const void* probes,
                 const void* group_list, const void* slot_pairs,
                 const void* recon, const BuiltRows& src, const void* rsq,
                 const void* ids, int n_groups, int n_pairs, int n_probes,
                 int n_lists, int cap, int rot, int kt, int gather,
                 const PairLayout& L, const Admit& adm, void* out_v,
                 void* out_i) {
  const auto kernel = recon_pair_kernel<kSrc, kResident, kExtract, kFilter>;
  const int err = set_smem(kernel, L.total);
  if (err != 0) return err;
  if (blocks > 0)
    kernel<<<blocks, kThreads, L.total, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const int*>(group_list),
        static_cast<const int*>(slot_pairs),
        static_cast<const __nv_bfloat16*>(recon), src,
        static_cast<const float*>(rsq), static_cast<const int*>(ids),
        n_groups, n_pairs, n_probes, n_lists, cap, rot, kt, gather, L, adm,
        static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// D and E's pass (extract, gather): the instantiation for the layout's
// residency and a filter (or none)
int launch_built(const BuiltRows& src, cudaStream_t s, const void* qrot,
                 const void* centers, const void* probes,
                 const void* group_list, const void* slot_pairs,
                 const void* rsq, const void* ids, int n_groups, int nq,
                 int n_probes, int n_lists, int cap, int rot, int kt,
                 const PairLayout& L, const void* filter_words,
                 int filter_stride, int n_words, void* out_v, void* out_i) {
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
#define RAFT_PAIR_BUILT(RES, FILT)                                           \
  launch_recon<kBuiltRows, RES, true, FILT>(                                \
      blocks, s, qrot, centers, probes, group_list, slot_pairs, nullptr,    \
      src, rsq, ids, n_groups, n_pairs, n_probes, n_lists, cap, rot, kt, 1, \
      L, adm, out_v, out_i)
  if (filter_words != nullptr)
    return L.resident ? RAFT_PAIR_BUILT(true, true)
                      : RAFT_PAIR_BUILT(false, true);
  return L.resident ? RAFT_PAIR_BUILT(true, false)
                    : RAFT_PAIR_BUILT(false, false);
#undef RAFT_PAIR_BUILT
}

}  // namespace

// Kernel F's pair-group pass: with extract != 0 every (query, probe)
// pair's top kt (1 <= kt <= 256) over raw fp32 tiles, out (nq, n_probes,
// kt), the InnerProduct values as -q.x (ip != 0; norms unused and may be
// null); with extract == 0 (L2 only) each pair's rows distances at every
// slot, out_v (nq, n_probes, rows), out_i and ids unused (ids may be
// null).  data (n_tiles, rows, dim), any dim >= 1; a tile is n_sub
// sub-lists of rows / n_sub slots (n_sub 1 for the raw variant).
// queries (nq, dim), or with gather == 0 (nq * n_probes, dim), a row a
// pair.  group_list (n_groups,) and slot_pairs (n_groups, layout's group)
// come from neighbors/grouped.py build_groups (nq * n_probes marks an empty
// slot); probes (nq, n_probes) say which pairs no group holds.  layout:
// 24 host ints in PairLayout's order, from ops/pair_scan.py's
// pair_list_layout.  filter_words / filter_stride / n_words: a filter's
// packed admission words as pq_list_scan.cu's pass 1 takes them (null:
// unfiltered; extract only).
extern "C" int raft_pair_list_scan_flat(
    const void* queries, const void* probes, const void* group_list,
    const void* slot_pairs, const void* data, const void* norms,
    const void* ids, int n_groups, int nq, int n_probes, int n_tiles,
    int rows, int n_sub, int dim, int kt, int ip, int gather, int extract,
    const void* layout, void* out_v, void* out_i, const void* filter_words,
    int filter_stride, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PairLayout L;
  memcpy(&L, layout, sizeof L);
  const bool filtered = filter_words != nullptr;
  if ((extract && (kt < 1 || kt > kKtMax || ids == nullptr))
      || (!extract && (ip || filtered || n_sub != 1)) || dim < 1
      || rows < 1 || n_sub < 1 || n_sub > kMaxSub || rows % n_sub != 0
      || n_groups < 0 || (!ip && norms == nullptr)
      || !layout_ok(L, kt, extract != 0)
      || (filtered && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const int vec = dim % 4 == 0 && ((uintptr_t)queries & 15) == 0
                  && ((uintptr_t)data & 15) == 0;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
#define RAFT_PAIR_FLAT(RES, EXT, FILT)                                       \
  launch_flat<RES, EXT, FILT>(blocks, s, queries, probes, group_list,       \
                              slot_pairs, data, norms, ids, n_groups,       \
                              n_pairs, n_probes, n_tiles, rows, n_sub, dim, \
                              kt, ip, gather, vec, L, adm, out_v, out_i)
  if (!extract)
    return L.resident ? RAFT_PAIR_FLAT(true, false, false)
                      : RAFT_PAIR_FLAT(false, false, false);
  if (filtered)
    return L.resident ? RAFT_PAIR_FLAT(true, true, true)
                      : RAFT_PAIR_FLAT(false, true, true);
  return L.resident ? RAFT_PAIR_FLAT(true, true, false)
                    : RAFT_PAIR_FLAT(false, true, false);
#undef RAFT_PAIR_FLAT
}

// Kernel G's pair-group pass: as raft_pair_list_scan_flat over the bf16
// recon cache (n_lists, cap, rot), rot a multiple of 8 and the rows
// 16-byte aligned: qrot (nq, rot) (gather == 0: (nq * n_probes, rot)),
// centers (n_lists, rot), rsq (n_lists, cap); the residual bf16(qrot -
// center) rounded once.  extract == 0: each pair's cap distances.
extern "C" int raft_pair_list_scan_recon(
    const void* qrot, const void* centers, const void* probes,
    const void* group_list, const void* slot_pairs, const void* recon,
    const void* rsq, const void* ids, int n_groups, int nq, int n_probes,
    int n_lists, int cap, int rot, int kt, int gather, int extract,
    const void* layout, void* out_v, void* out_i, const void* filter_words,
    int filter_stride, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PairLayout L;
  memcpy(&L, layout, sizeof L);
  const bool filtered = filter_words != nullptr;
  if ((extract && (kt < 1 || kt > kKtMax || ids == nullptr))
      || (!extract && filtered) || rot < 8 || rot % 8 != 0 || cap < 1
      || n_groups < 0 || centers == nullptr || rsq == nullptr
      || ((uintptr_t)recon & 15) != 0 || !layout_ok(L, kt, extract != 0)
      || L.resident != ((rot + 15) / 16 * 16 <= kKc)
      || (filtered && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
#define RAFT_PAIR_RECON(RES, EXT, FILT)                                      \
  launch_recon<kBf16Rows, RES, EXT, FILT>(                                  \
      blocks, s, qrot, centers, probes, group_list, slot_pairs, recon,      \
      BuiltRows{}, rsq, ids, n_groups, n_pairs, n_probes, n_lists, cap, rot, \
      kt, gather, L, adm, out_v, out_i)
  if (!extract)
    return L.resident ? RAFT_PAIR_RECON(true, false, false)
                      : RAFT_PAIR_RECON(false, false, false);
  if (filtered)
    return L.resident ? RAFT_PAIR_RECON(true, true, true)
                      : RAFT_PAIR_RECON(false, true, true);
  return L.resident ? RAFT_PAIR_RECON(true, true, false)
                    : RAFT_PAIR_RECON(false, true, false);
#undef RAFT_PAIR_RECON
}

// Kernel D's pair-group pass: every (query, probe) pair's top kt (1 <= kt
// <= 256; ops/pq_code_scan.py routes kt 65-128 here) over the packed
// codes (n_lists, cap, W) uint8, W = ceil(pq_dim pq_bits / 8), pq_bits 4
// or 8, decoded through the bf16 books (pq_dim, 2^pq_bits, pq_len), both
// 16-byte aligned, rot = pq_dim pq_len up to 1,024; rsq the rows' norms
// (of their bf16 reconstructions); qrot (nq, rot), centers (n_lists,
// rot); groups, probes, the layout (from ops/pq_code_scan.py's
// code_pair_list_layout) and a filter as raft_pair_list_scan_recon takes them.
extern "C" int raft_pair_list_scan_codes(
    const void* qrot, const void* centers, const void* probes,
    const void* group_list, const void* slot_pairs, const void* codes,
    const void* books, const void* rsq, const void* ids, int n_groups,
    int nq, int n_probes, int n_lists, int cap, int rot, int pq_dim,
    int pq_bits, int kt, const void* layout, void* out_v, void* out_i,
    const void* filter_words, int filter_stride, int n_words, void* stream) {
  PairLayout L;
  memcpy(&L, layout, sizeof L);
  const int W = (pq_dim * pq_bits + 7) / 8;
  if (kt < 1 || kt > kKtMax || ids == nullptr
      || (pq_bits != 4 && pq_bits != 8) || pq_dim < 1 || rot < 1
      || rot % pq_dim != 0 || rot > kBuiltMax || cap < 1 || n_groups < 0
      || centers == nullptr || rsq == nullptr || codes == nullptr
      || books == nullptr || ((uintptr_t)codes & 15) != 0
      || ((uintptr_t)books & 15) != 0 || !layout_ok(L, kt, true)
      || L.resident != (((rot + 15) & ~15) <= kKc)
      || L.raw_step < ((BN * W + 15) & ~15) + 16
      || (filter_words != nullptr && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const BuiltRows src{static_cast<const uint8_t*>(codes),
                      static_cast<const uint4*>(books), nullptr, pq_bits, W,
                      rot / pq_dim};
  return launch_built(src, static_cast<cudaStream_t>(stream), qrot, centers,
                      probes, group_list, slot_pairs, rsq, ids, n_groups, nq,
                      n_probes, n_lists, cap, rot, kt, L, filter_words,
                      filter_stride, n_words, out_v, out_i);
}

// Kernel E's pair-group pass: as raft_pair_list_scan_codes over the int8
// recon cache (n_lists, cap, rot_pad), 16-byte aligned, rot_pad a multiple
// of 16 from rot up to 1,024, zeros past rot; scales (n_lists,) the lists'
// scales, rsq8 the rows' dequantized norms; the layout from
// ops/pq_code_scan.py's recon8_pair_list_layout.
extern "C" int raft_pair_list_scan_recon8(
    const void* qrot, const void* centers, const void* probes,
    const void* group_list, const void* slot_pairs, const void* data,
    const void* scales, const void* rsq8, const void* ids, int n_groups,
    int nq, int n_probes, int n_lists, int cap, int rot, int rot_pad, int kt,
    const void* layout, void* out_v, void* out_i, const void* filter_words,
    int filter_stride, int n_words, void* stream) {
  PairLayout L;
  memcpy(&L, layout, sizeof L);
  const int kc = rot_pad <= kKc ? rot_pad : kKc;
  if (kt < 1 || kt > kKtMax || ids == nullptr || rot < 1 || rot_pad < rot
      || rot_pad % 16 != 0 || rot_pad > kBuiltMax || cap < 1 || n_groups < 0
      || centers == nullptr || rsq8 == nullptr || scales == nullptr
      || data == nullptr || ((uintptr_t)data & 15) != 0
      || !layout_ok(L, kt, true) || L.resident != (rot_pad <= kKc)
      || L.raw_step < BN * int8_row_stride(kc)
      || (filter_words != nullptr && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const BuiltRows src{static_cast<const uint8_t*>(data), nullptr,
                      static_cast<const float*>(scales), kInt8, rot_pad, 0};
  return launch_built(src, static_cast<cudaStream_t>(stream), qrot, centers,
                      probes, group_list, slot_pairs, rsq8, ids, n_groups, nq,
                      n_probes, n_lists, cap, rot, kt, L, filter_words,
                      filter_stride, n_words, out_v, out_i);
}

// Kernels F and G's query-major route: per-(query, probe) top-kt scans
// over full-width rows, one block per query.  Since the pair-group pass
// (pair_list_scan.cu: the pairs grouped by list, each probed list read
// once per group on tensor cores) took F and G's large kt (65-256) and the
// profile variants, ops/pair_scan.py runs this kernel only for shapes that
// pass's gate refuses (kt past 256, a row width past 1,024), and chip_smoke
// times it in turns beside the pass as the yardstick it replaced
// (pair_scan_variant_query_major for the variants).
//
// Kernel F replaces raft_tpu/ops/pq_group_scan_pallas.py:637
// grouped_flat_l2_scan (body _kernel_flat), the IVF-Flat scan over raw
// fp32 list rows:
//   L2:  d = max(q_sq + d_sq[list, row] - 2 q . x[list, row], 0)
//        q_sq = sum(q^2), the dot product summed in fp32
//   IP:  d = -(q . x[list, row])   (the wrapper negates the kept values
//        back; an exhausted slot leaves as (-inf, -1))
// Kernel G's query-major route replaces raft_tpu/ops/pq_group_scan_pallas.py
// :566 grouped_l2_scan (body _kernel), the IVF-PQ scan over the bf16
// reconstruction cache, where neither pq_list_scan.cu's list-major pass 1
// (kt <= 64) nor the pair-group pass takes the shape.  Kernel B's row
// arithmetic:
//   sub = qrot[q] - centers[list] (fp32), sub_sq = sum(sub^2),
//   d = max(sub_sq + rsq[list, row] - 2 bf16(sub) . recon[list, row], 0)
//   (the residual rounded to bf16 once, the products summed in fp32).
// In both, rows with a negative id never enter a result, a probe outside
// [0, n_lists) is an empty pair, and each pair writes its top kt by
// (distance, slot), ties to the lowest slot, (+inf, -1) once its live
// rows run out: out (nq, n_probes, kt).
//
// What bounds them on an H100: bytes — a probed row is dim * 4 B of fp32
// (F) or rot * 2 B of bf16 (G), plus a 4-byte id and a 4-byte norm,
// against 2 * dim operations per (query, row).  Design: QUERY-MAJOR, as
// Kernels B, D and E: one block per query walks its probes; the block
// stages the query (F) or the residual (G) once per probe, each row is
// read with 16-byte loads by lanes_per_row lanes holding the staged
// vector in registers (up to four 16-byte chunks a lane, so a 512-byte
// fp32 row takes eight lanes and three shuffle steps), the row's distance
// goes to shared memory and the pair's top kt comes out of kt block-wide
// argmin rounds (scan_common.cuh).  fp32 rows of a width off a multiple
// of 4, or not 16-byte aligned, load one value at a time, zeros past the
// width (the template switch kVec, as flat_list_scan.cu's); bf16 rows
// always load 16 bytes (the recon cache is a multiple of 8 wide).  The
// per-pair output goes to device
// memory, so kt needs no cap below the capacity; shared memory holds the
// pair's distances and the staged vector, sized at the real capacity by
// ops/pair_scan.py's pair_scan_smem_bytes.  A list is read once per query
// that probes it; IVF-Flat's super-tiles (F adjacent lists scanned as one
// tile) arrive here as lists of F * cap rows.
//
// Filters (kFilter; the TPU kernels' admission operand adm_words): the
// block's query has one row of packed words; a row whose id it rejects is
// treated as a dead row (negative id): not read, distance +inf, so it is
// never selected and the pair's slots past its admitted rows are (+inf,
// -1).  The unfiltered instantiation is the code without the test.
//
// Profile variants (template switches kExtract / kGather; the two library
// entry points above are <true, true>).  They replace the switches of
// profiles/group_kernel_decomp_r5.py:50 run_var (body _kernel_var :28),
// which splits the TPU's grouped scan into its query gather, its row scan
// and its top-kt extraction:
//   kExtract == false: no selection — every slot's distance goes to an
//     (nq, n_probes, cap) block, the formula at EVERY slot (an empty slot
//     is a zero row, so d = q_sq for L2), as _kernel_var writes its raw
//     (G, cap) block; an out-of-range probe's row is +inf.
//   kGather == false: the pair's query row comes from a pre-gathered
//     (nq * n_probes, dim) tensor by pair index, not from queries[q].
// The variants take no filter.
// The one-hot query gather of the TPU kernel has no counterpart: the
// kernel is query-major, so kGather == true reads queries[pair / n_probes]
// directly, as Kernels F and G do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using namespace raft_scan;

// fp32 rows: four values per 16-byte chunk
struct Fp32Rows {
  static constexpr int kPerChunk = 4;
  static constexpr int kMaxChunksPerLane = 8;   // dim <= 32 * 8 * 4
  static constexpr bool kScalar = true;         // one-value loads exist
  __device__ static __forceinline__ float dot(const float* s, uint4 u,
                                              float acc) {
    acc = fmaf(s[0], __uint_as_float(u.x), acc);
    acc = fmaf(s[1], __uint_as_float(u.y), acc);
    acc = fmaf(s[2], __uint_as_float(u.z), acc);
    acc = fmaf(s[3], __uint_as_float(u.w), acc);
    return acc;
  }
  // chunk ch (dims 4 ch .. 4 ch + 3 < dim + 3) of a row one value at a
  // time, zeros past dim
  __device__ static __forceinline__ uint4 partial(const void* data,
                                                  size_t row, int ch,
                                                  int dim) {
    const float* v = static_cast<const float*>(data) + row * dim + 4 * ch;
    const int left = dim - 4 * ch;
    return make_uint4(__float_as_uint(__ldg(v)),
                      left > 1 ? __float_as_uint(__ldg(v + 1)) : 0u,
                      left > 2 ? __float_as_uint(__ldg(v + 2)) : 0u,
                      left > 3 ? __float_as_uint(__ldg(v + 3)) : 0u);
  }
};

// bf16 rows: eight values per 16-byte chunk
struct Bf16Rows {
  static constexpr int kPerChunk = 8;
  static constexpr bool kScalar = false;        // 16-byte loads only
  static constexpr int kMaxChunksPerLane = 4;   // rot <= 32 * 4 * 8
  __device__ static __forceinline__ float dot(const float* s, uint4 u,
                                              float acc) {
    acc = fmaf(s[0], bf_lo(u.x), acc);
    acc = fmaf(s[1], bf_hi(u.x), acc);
    acc = fmaf(s[2], bf_lo(u.y), acc);
    acc = fmaf(s[3], bf_hi(u.y), acc);
    acc = fmaf(s[4], bf_lo(u.z), acc);
    acc = fmaf(s[5], bf_hi(u.z), acc);
    acc = fmaf(s[6], bf_lo(u.w), acc);
    acc = fmaf(s[7], bf_hi(u.w), acc);
    return acc;
  }
};

// centers == nullptr: Kernel F (stage the query as it is); else Kernel G
// (stage bf16(query - center)).  ip: InnerProduct form of Kernel F.
// kVec: rows load 16 bytes at a time (dim % kPerChunk == 0, data 16-byte
// aligned), else one value at a time (Rows::partial).  kExtract /
// kGather: the profile variants (see the note above).  kFilter: only the
// rows the query's row of fw admits (kExtract and kGather only).
template <class Rows, bool kVec, bool kExtract, bool kGather, bool kFilter>
__global__ void __launch_bounds__(kThreads)
pair_scan_kernel(const float* __restrict__ queries,
                 const float* __restrict__ centers,
                 const int* __restrict__ probes,
                 const void* __restrict__ data,
                 const float* __restrict__ norms,
                 const int* __restrict__ ids, int n_probes, int n_lists,
                 int cap, int dim, int kt, int lpr, int ip,
                 const QueryWords fw, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  constexpr int kPer = Rows::kPerChunk;
  constexpr int kMaxCh = Rows::kMaxChunksPerLane;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dist = reinterpret_cast<float*>(smem);     // cap
  float* s_vec = s_dist + cap;                        // dim
  __shared__ float s_ssq;
  __shared__ float s_red_v[kWarps];
  __shared__ int s_red_s[kWarps];
  __shared__ int s_done;

  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (dim + kPer - 1) / kPer; // 16-byte chunks per row
  const int rows_per_warp = 32 / lpr;
  const int lig = lane % lpr;              // lane within its row group
  const int grp = warp * rows_per_warp + lane / lpr;
  const int row_groups = kWarps * rows_per_warp;
  const int* frow = kFilter ? words_row(fw, q) : nullptr;

  for (int p = 0; p < n_probes; ++p) {
    const size_t pair = (size_t)q * n_probes + p;
    const float* qv = queries + (kGather ? (size_t)q : pair) * dim;
    // extract: the pair's kt values and ids; raw: its cap values
    float* ov = out_v + pair * (kExtract ? kt : cap);
    int* oi = kExtract ? out_i + pair * kt : nullptr;
    const int l = probes[pair];
    if (l < 0 || l >= n_lists) {            // uniform across the block
      if constexpr (kExtract) {
        write_empty_pair(kt, ov, oi);
      } else {
        for (int r = tid; r < cap; r += kThreads) ov[r] = INFINITY;
      }
      continue;
    }
    if (warp == 0) {
      float acc = 0.f;
      for (int e = lane; e < dim; e += 32) {
        float s = qv[e];
        if (centers != nullptr) s -= centers[(size_t)l * dim + e];
        acc = fmaf(s, s, acc);
        // G multiplies bf16(sub), rounded once; F the query as it is
        s_vec[e] = centers != nullptr
            ? __bfloat162float(__float2bfloat16_rn(s)) : s;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_ssq = acc;
    }
    __syncthreads();
    const float ssq = s_ssq;
    float sreg[kMaxCh][kPer];
#pragma unroll
    for (int j = 0; j < kMaxCh; ++j) {
      const int ch = lig + j * lpr;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        sreg[j][e] = ch < nch && (kVec || ch * kPer + e < dim)
                         ? s_vec[ch * kPer + e] : 0.f;
    }
    const size_t base = (size_t)l * cap;
    // every lane runs every iteration, so the shuffles stay convergent
    for (int r0 = 0; r0 < cap; r0 += row_groups) {
      const int r = r0 + grp;
      // raw: every slot of the list enters, empty ones too
      int id = r < cap ? (kExtract ? ids[base + r] : 0) : -1;
      // a row the query rejects is a dead row: not read, +inf
      if (kFilter && id >= 0 && !admits(frow, fw.n_words, id)) id = -1;
      float part = 0.f;
      if (id >= 0) {
        const uint4* row =
            static_cast<const uint4*>(data) + (base + r) * nch;
#pragma unroll
        for (int j = 0; j < kMaxCh; ++j) {
          const int ch = lig + j * lpr;
          if (ch >= nch) continue;
          if constexpr (kVec)
            part = Rows::dot(sreg[j], __ldg(row + ch), part);
          else
            part = Rows::dot(sreg[j], Rows::partial(data, base + r, ch, dim),
                             part);
        }
      }
      for (int off = lpr >> 1; off; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lig == 0 && r < cap) {
        float d = INFINITY;
        if (id >= 0)
          d = ip ? -part : fmaxf(ssq + norms[base + r] - 2.f * part, 0.f);
        if constexpr (kExtract) s_dist[r] = d;
        else ov[r] = d;
      }
    }
    // also keeps the next probe's staging from overwriting s_vec while a
    // warp still loads it
    __syncthreads();
    if constexpr (kExtract)
      select_pair_topk(s_dist, ids + base, cap, kt, ov, oi, s_red_v,
                       s_red_s, &s_done);
  }
}

// lanes per row: the fewest (a power of two, at most 32) that hold a row
// in at most four 16-byte chunks each
inline int lanes_per_row(int nch) {
  int lpr = 1;
  while (lpr < 32 && lpr * 4 < nch) lpr <<= 1;
  return lpr;
}

template <class Rows, bool kVec, bool kExtract, bool kGather, bool kFilter>
int run(const void* queries, const void* centers, const void* probes,
        const void* data, const void* norms, const void* ids, int nq,
        int n_probes, int n_lists, int cap, int dim, int kt, int lpr, int ip,
        int smem, const QueryWords& fw, void* out_v, void* out_i,
        cudaStream_t s) {
  const auto kernel =
      pair_scan_kernel<Rows, kVec, kExtract, kGather, kFilter>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0 && n_probes > 0)
    kernel<<<nq, kThreads, smem, s>>>(
        static_cast<const float*>(queries),
        static_cast<const float*>(centers), static_cast<const int*>(probes),
        data, static_cast<const float*>(norms),
        static_cast<const int*>(ids), n_probes, n_lists, cap, dim, kt, lpr,
        ip, fw, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// rows of a width off a multiple of kPerChunk, or not 16-byte aligned
// (vec false), take the one-value loads where Rows has them, else are
// refused
template <class Rows, bool kExtract, bool kGather, bool kFilter>
int run_rows(bool vec, const void* queries, const void* centers,
             const void* probes, const void* data, const void* norms,
             const void* ids, int nq, int n_probes, int n_lists, int cap,
             int dim, int kt, int lpr, int ip, int smem,
             const QueryWords& fw, void* out_v, void* out_i,
             cudaStream_t s) {
  if (vec)
    return run<Rows, true, kExtract, kGather, kFilter>(
        queries, centers, probes, data, norms, ids, nq, n_probes, n_lists,
        cap, dim, kt, lpr, ip, smem, fw, out_v, out_i, s);
  if constexpr (Rows::kScalar)
    return run<Rows, false, kExtract, kGather, kFilter>(
        queries, centers, probes, data, norms, ids, nq, n_probes, n_lists,
        cap, dim, kt, lpr, ip, smem, fw, out_v, out_i, s);
  return (int)cudaErrorInvalidValue;
}

// fw.words == nullptr: unfiltered (the only form of the profile variants)
template <class Rows, bool kExtract = true, bool kGather = true>
int launch(const void* queries, const void* centers, const void* probes,
           const void* data, const void* norms, const void* ids, int nq,
           int n_probes, int n_lists, int cap, int dim, int kt, int ip,
           int smem, const QueryWords& fw, void* out_v, void* out_i,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = (dim + Rows::kPerChunk - 1) / Rows::kPerChunk;
  const int lpr = lanes_per_row(nch);
  const bool vec = dim % Rows::kPerChunk == 0
                   && ((uintptr_t)data & 15) == 0;
  const bool filtered = fw.words != nullptr;
  if ((kExtract && kt < 1) || cap < 1 || dim < 1 || (!vec && !Rows::kScalar)
      || nch > lpr * Rows::kMaxChunksPerLane || smem < 1 || bad_words(fw)
      || (filtered && !(kExtract && kGather)))
    return (int)cudaErrorInvalidValue;
  if constexpr (kExtract && kGather) {
    if (filtered)
      return run_rows<Rows, kExtract, kGather, true>(
          vec, queries, centers, probes, data, norms, ids, nq, n_probes,
          n_lists, cap, dim, kt, lpr, ip, smem, fw, out_v, out_i, s);
  }
  return run_rows<Rows, kExtract, kGather, false>(
      vec, queries, centers, probes, data, norms, ids, nq, n_probes, n_lists,
      cap, dim, kt, lpr, ip, smem, fw, out_v, out_i, s);
}

}  // namespace

// smem: the block's dynamic shared memory in bytes (the pair's distances
// and the staged vector), as ops/pair_scan.py's pair_scan_smem_bytes sizes
// it (the one copy of the formula; its gate holds it to the card's limit).
// norms: the rows' squared norms (unused, and may be null, when ip != 0).
// filter_words: null, or the queries' packed admission words (n_words
// int32 a row, filter_stride words between two queries' rows, 0 for one
// row broadcast); a pair then keeps only the rows its query admits.
extern "C" int raft_ivf_flat_scan(const void* queries, const void* probes,
                                  const void* data, const void* norms,
                                  const void* ids, int nq, int n_probes,
                                  int n_lists, int cap, int dim, int kt,
                                  int ip, int smem, void* out_v,
                                  void* out_i, const void* filter_words,
                                  int filter_stride, int n_words,
                                  void* stream) {
  return launch<Fp32Rows>(queries, nullptr, probes, data, norms, ids, nq,
                          n_probes, n_lists, cap, dim, kt, ip, smem,
                          query_words(filter_words, filter_stride, n_words),
                          out_v, out_i, stream);
}

extern "C" int raft_ivf_pq_scan_recon(const void* qrot, const void* centers,
                                      const void* probes, const void* recon,
                                      const void* rsq, const void* ids,
                                      int nq, int n_probes, int n_lists,
                                      int cap, int rot, int kt, int smem,
                                      void* out_v, void* out_i,
                                      const void* filter_words,
                                      int filter_stride, int n_words,
                                      void* stream) {
  if (centers == nullptr) return (int)cudaErrorInvalidValue;
  return launch<Bf16Rows>(qrot, centers, probes, recon, rsq, ids, nq,
                          n_probes, n_lists, cap, rot, kt, 0, smem,
                          query_words(filter_words, filter_stride, n_words),
                          out_v, out_i, stream);
}

namespace {

template <class Rows>
int launch_variant(int gather, int extract, const void* queries,
                   const void* centers, const void* probes, const void* data,
                   const void* norms, const void* ids, int nq, int n_probes,
                   int n_lists, int cap, int dim, int kt, int smem,
                   void* out_v, void* out_i, void* stream) {
  constexpr int ip = 0;
  const QueryWords none = query_words(nullptr, 0, 0);
  if (gather && extract)
    return launch<Rows, true, true>(queries, centers, probes, data, norms,
                                    ids, nq, n_probes, n_lists, cap, dim,
                                    kt, ip, smem, none, out_v, out_i,
                                    stream);
  if (extract)
    return launch<Rows, true, false>(queries, centers, probes, data, norms,
                                     ids, nq, n_probes, n_lists, cap, dim,
                                     kt, ip, smem, none, out_v, out_i,
                                     stream);
  if (gather)
    return launch<Rows, false, true>(queries, centers, probes, data, norms,
                                     ids, nq, n_probes, n_lists, cap, dim,
                                     kt, ip, smem, none, out_v, out_i,
                                     stream);
  return launch<Rows, false, false>(queries, centers, probes, data, norms,
                                    ids, nq, n_probes, n_lists, cap, dim,
                                    kt, ip, smem, none, out_v, out_i,
                                    stream);
}

}  // namespace

// The profile variants of Kernels F (bf16_rows == 0: fp32 rows, queries
// as they are, centers null) and G (bf16_rows != 0: bf16 recon rows,
// residuals to centers), L2 only.  gather == 0: queries is (nq *
// n_probes, dim), one row per pair.  extract == 0: out_v is (nq,
// n_probes, cap), out_i unused and ids may be null; else both are (nq,
// n_probes, kt).
extern "C" int raft_pair_scan_variant(int bf16_rows, int gather, int extract,
                                      const void* queries,
                                      const void* centers,
                                      const void* probes, const void* data,
                                      const void* norms, const void* ids,
                                      int nq, int n_probes, int n_lists,
                                      int cap, int dim, int kt, int smem,
                                      void* out_v, void* out_i,
                                      void* stream) {
  if ((extract && ids == nullptr) || norms == nullptr
      || (bf16_rows != 0) != (centers != nullptr))
    return (int)cudaErrorInvalidValue;
  if (bf16_rows)
    return launch_variant<Bf16Rows>(gather, extract, queries, centers,
                                    probes, data, norms, ids, nq, n_probes,
                                    n_lists, cap, dim, kt, smem, out_v,
                                    out_i, stream);
  return launch_variant<Fp32Rows>(gather, extract, queries, nullptr, probes,
                                  data, norms, ids, nq, n_probes, n_lists,
                                  cap, dim, kt, smem, out_v, out_i, stream);
}

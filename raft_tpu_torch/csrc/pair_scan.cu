// Kernels F and G: per-(query, probe) top-kt scans over full-width rows.
//
// Kernel F replaces raft_tpu/ops/pq_group_scan_pallas.py:637
// grouped_flat_l2_scan (body _kernel_flat), the IVF-Flat scan over raw
// fp32 list rows:
//   L2:  d = max(q_sq + d_sq[list, row] - 2 q . x[list, row], 0)
//        q_sq = sum(q^2), the dot product summed in fp32
//   IP:  d = -(q . x[list, row])   (the wrapper negates the kept values
//        back; an exhausted slot leaves as (-inf, -1))
// Kernel G replaces raft_tpu/ops/pq_group_scan_pallas.py:566
// grouped_l2_scan (body _kernel), the IVF-PQ scan over the bf16
// reconstruction cache, with Kernel B's row arithmetic:
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
// argmin rounds (scan_common.cuh).  The per-pair output goes to device
// memory, so kt needs no cap below the capacity; shared memory holds the
// pair's distances and the staged vector, sized at the real capacity by
// ops/pair_scan.py's pair_scan_smem_bytes.  A list is read once per query
// that probes it; IVF-Flat's super-tiles (F adjacent lists scanned as one
// tile) arrive here as lists of F * cap rows.

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
  __device__ static __forceinline__ float dot(const float* s, uint4 u,
                                              float acc) {
    acc = fmaf(s[0], __uint_as_float(u.x), acc);
    acc = fmaf(s[1], __uint_as_float(u.y), acc);
    acc = fmaf(s[2], __uint_as_float(u.z), acc);
    acc = fmaf(s[3], __uint_as_float(u.w), acc);
    return acc;
  }
};

// bf16 rows: eight values per 16-byte chunk
struct Bf16Rows {
  static constexpr int kPerChunk = 8;
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
template <class Rows>
__global__ void __launch_bounds__(kThreads)
pair_scan_kernel(const float* __restrict__ queries,
                 const float* __restrict__ centers,
                 const int* __restrict__ probes,
                 const uint4* __restrict__ data,
                 const float* __restrict__ norms,
                 const int* __restrict__ ids, int n_probes, int n_lists,
                 int cap, int dim, int kt, int lpr, int ip,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
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
  const int nch = dim / kPer;              // 16-byte chunks per row
  const int rows_per_warp = 32 / lpr;
  const int lig = lane % lpr;              // lane within its row group
  const int grp = warp * rows_per_warp + lane / lpr;
  const int row_groups = kWarps * rows_per_warp;
  const float* qv = queries + (size_t)q * dim;

  for (int p = 0; p < n_probes; ++p) {
    const size_t pair = (size_t)q * n_probes + p;
    float* ov = out_v + pair * kt;
    int* oi = out_i + pair * kt;
    const int l = probes[pair];
    if (l < 0 || l >= n_lists) {            // uniform across the block
      write_empty_pair(kt, ov, oi);
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
        sreg[j][e] = ch < nch ? s_vec[ch * kPer + e] : 0.f;
    }
    const size_t base = (size_t)l * cap;
    // every lane runs every iteration, so the shuffles stay convergent
    for (int r0 = 0; r0 < cap; r0 += row_groups) {
      const int r = r0 + grp;
      const int id = r < cap ? ids[base + r] : -1;
      float part = 0.f;
      if (id >= 0) {
        const uint4* row = data + (base + r) * nch;
#pragma unroll
        for (int j = 0; j < kMaxCh; ++j) {
          const int ch = lig + j * lpr;
          if (ch < nch) part = Rows::dot(sreg[j], __ldg(row + ch), part);
        }
      }
      for (int off = lpr >> 1; off; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lig == 0 && r < cap) {
        float d = INFINITY;
        if (id >= 0)
          d = ip ? -part : fmaxf(ssq + norms[base + r] - 2.f * part, 0.f);
        s_dist[r] = d;
      }
    }
    __syncthreads();
    select_pair_topk(s_dist, ids + base, cap, kt, ov, oi, s_red_v, s_red_s,
                     &s_done);
  }
}

// lanes per row: the fewest (a power of two, at most 32) that hold a row
// in at most four 16-byte chunks each
inline int lanes_per_row(int nch) {
  int lpr = 1;
  while (lpr < 32 && lpr * 4 < nch) lpr <<= 1;
  return lpr;
}

template <class Rows>
int launch(const void* queries, const void* centers, const void* probes,
           const void* data, const void* norms, const void* ids, int nq,
           int n_probes, int n_lists, int cap, int dim, int kt, int ip,
           int smem, void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = dim / Rows::kPerChunk;
  const int lpr = lanes_per_row(nch);
  if (kt < 1 || cap < 1 || dim % Rows::kPerChunk != 0
      || nch > lpr * Rows::kMaxChunksPerLane || smem < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_scan_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0 && n_probes > 0)
    pair_scan_kernel<Rows><<<nq, kThreads, smem, s>>>(
        static_cast<const float*>(queries),
        static_cast<const float*>(centers), static_cast<const int*>(probes),
        static_cast<const uint4*>(data), static_cast<const float*>(norms),
        static_cast<const int*>(ids), n_probes, n_lists, cap, dim, kt, lpr,
        ip, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

// smem: the block's dynamic shared memory in bytes (the pair's distances
// and the staged vector), as ops/pair_scan.py's pair_scan_smem_bytes sizes
// it (the one copy of the formula; its gate holds it to the card's limit).
// norms: the rows' squared norms (unused, and may be null, when ip != 0).
extern "C" int raft_ivf_flat_scan(const void* queries, const void* probes,
                                  const void* data, const void* norms,
                                  const void* ids, int nq, int n_probes,
                                  int n_lists, int cap, int dim, int kt,
                                  int ip, int smem, void* out_v,
                                  void* out_i, void* stream) {
  return launch<Fp32Rows>(queries, nullptr, probes, data, norms, ids, nq,
                          n_probes, n_lists, cap, dim, kt, ip, smem, out_v,
                          out_i, stream);
}

extern "C" int raft_ivf_pq_scan_recon(const void* qrot, const void* centers,
                                      const void* probes, const void* recon,
                                      const void* rsq, const void* ids,
                                      int nq, int n_probes, int n_lists,
                                      int cap, int rot, int kt, int smem,
                                      void* out_v, void* out_i,
                                      void* stream) {
  if (centers == nullptr) return (int)cudaErrorInvalidValue;
  return launch<Bf16Rows>(qrot, centers, probes, recon, rsq, ids, nq,
                          n_probes, n_lists, cap, rot, kt, 0, smem, out_v,
                          out_i, stream);
}

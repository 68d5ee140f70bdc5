// Kernels C and D's query-major routes: IVF-PQ scans over the bit-packed
// PQ codes where a pair keeps more than 64 candidates (min(kt, k) for C,
// kt for D) or the list-major pass's books do not fit; below that C and D
// are pq_code_list_scan.cu's list-major pass.
//
// Kernel C replaces raft_tpu/ops/pq_code_scan_pallas.py:282
// grouped_code_scan_fused (body _kernel_codes_fused): each query's top k
// is kept on chip across its probes, as Kernel B keeps it.
// Kernel D replaces :367 grouped_code_scan (body _kernel_codes): each
// (query, probe) pair writes its own top kt.
//
// Contract, as there (the JAX kernels decode every row against the
// bf16-rounded codebook and take one bf16 product):
//   sub    = qrot[q] - centers[list]                  (fp32)
//   sub_sq = sum(sub^2)                               (fp32)
//   ip     = sum_j lut[j][code_j(row)],
//   lut[j][c] = sum_l bf16(sub)[j*pq_len + l] * bf16(book[j][c][l])
//   d      = max(sub_sq + rsq[list, row] - 2 ip, 0)
// A bf16 x bf16 product is exact in fp32 and the subspaces are disjoint,
// so ip is the JAX decode-then-dot value up to the order of fp32 sums.
// Codes are LSB-first; at pq_bits 4 and 8 no field crosses a byte.  Rows
// with a negative id never enter the result; probes outside [0, n_lists)
// are skipped (Kernel D writes (+inf, -1) for them).
//
// What bounds them on an H100: bytes.  The function needs each probed
// list's live rows once: pq_dim*pq_bits/8 bytes of codes plus a 4-byte id
// and a 4-byte norm (56 B at pq_dim 48, 8 bits), against 2*rot bf16
// operations per (query, row).  Design: QUERY-MAJOR, as Kernel B — one
// block per query walks its probes, so no accumulator crosses blocks.  The
// bf16 codebook is staged in shared memory once per block; per probe the
// block builds the reference's shared-memory LUT
// (compute_similarity_kernel, ivf_pq_search.cuh:611) and each thread
// scores one row at a time: 16-byte code loads where the row width allows
// it, pq_dim LUT reads.  Kernel C filters rows against the query's
// current k-th distance and merges them with Kernel B's sort and rank
// merge (scan_common.cuh); Kernel D selects each pair's top kt by kt
// block-wide argmin rounds over the pair's distances in shared memory.
// Where D's books and whole LUT do not fit in shared memory together
// (rot 256, pq_dim 128, 8 bits is one shape the Pallas gate admits), it
// reads the books from global memory (L2) and, where the LUT alone does
// not fit either, builds and sums it in chunks of a multiple of 32
// subspaces, each row's partial sum waiting in its distance slot: the sum
// goes on in subspace order, so the chunks give the one-LUT result bit
// for bit.
// The cost of this design, as Kernel B's: a list is read once per query
// that probes it, not once per batch.
//
// Filters (kFilter; the TPU kernels' admission operand adm_words): the
// block's query has one row of packed words.  Kernel C tests a row's bit
// only where its distance beats the query's k-th (a rejected row never
// enters the candidate buffer, so it takes none of the pair's min(kt, k)
// merge slots); Kernel D tests it before the row's codes are read, and a
// rejected row takes the dead row's +inf.  The unfiltered instantiations
// are the code without the test.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using namespace raft_scan;

// Per probe: the bf16-rounded residual sub (s_sub) and its fp32 squared
// norm (*s_ssq); ends with the block synchronised.
__device__ void probe_sub(const float* __restrict__ qv,
                          const float* __restrict__ center, int rot,
                          float* s_sub, float* s_ssq) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    float acc = 0.f;
    for (int e = lane; e < rot; e += 32) {
      const float s = qv[e] - center[e];
      acc = fmaf(s, s, acc);
      s_sub[e] = __bfloat162float(__float2bfloat16_rn(s));
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) *s_ssq = acc;
  }
  __syncthreads();
}

// The LUT of subspaces j_lo .. j_hi - 1 (s_lut, (j_hi - j_lo) << kBits
// entries) from the bf16 books cb, staged in shared memory or read from
// global memory (L2); ends with the block synchronised.
template <int kBits>
__device__ void chunk_lut(const unsigned short* cb, const float* s_sub,
                          int pq_len, int j_lo, int j_hi, float* s_lut) {
  const int n = (j_hi - j_lo) << kBits;
  const int base = j_lo << kBits;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int j = j_lo + (idx >> kBits);
    const unsigned short* c = cb + (size_t)(base + idx) * pq_len;
    const float* sj = s_sub + j * pq_len;
    float acc = 0.f;
    for (int l = 0; l < pq_len; ++l)
      acc = fmaf(sj[l], bf_lo(c[l]), acc);
    s_lut[idx] = acc;
  }
  __syncthreads();
}

// The LUT sum of the codes held in one little-endian word (its 4 bytes
// carry codes j0 .. j0 + 32/kBits - 1) that fall below j_hi, in subspace
// order; s_lut holds the subspaces from j_lo.
template <int kBits>
__device__ __forceinline__ float add_word(uint32_t w, int j0, int j_lo,
                                          int j_hi, const float* s_lut,
                                          float acc) {
  constexpr int kPer = 32 / kBits;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
#pragma unroll
  for (int f = 0; f < kPer; ++f) {
    const int j = j0 + f;
    if (j < j_hi)
      acc += s_lut[((j - j_lo) << kBits) + ((w >> (f * kBits)) & kMask)];
  }
  return acc;
}

// acc plus the LUT sum of subspaces j_lo .. j_hi - 1 of one row of W code
// bytes: 16-byte loads when vec16 (W % 16 == 0 and the codes 16-byte
// aligned), else byte loads.  j_lo * kBits is a multiple of 128 (a
// chunk's codes start on a 16-byte boundary); over 0 .. pq_dim from 0 it
// is the row's ip.
template <int kBits>
__device__ __forceinline__ float row_ip(const uint8_t* __restrict__ row,
                                        int W, int j_lo, int j_hi,
                                        bool vec16, const float* s_lut,
                                        float acc) {
  constexpr int kPer = 32 / kBits;
  const int b_lo = j_lo * kBits / 8;
  const int b_hi = min(W, (j_hi * kBits + 7) / 8);
  if (vec16) {
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int ch = b_lo / 16; ch * 16 < b_hi; ++ch) {
      const uint4 u = __ldg(rv + ch);
      const int j0 = ch * 4 * kPer;
      acc = add_word<kBits>(u.x, j0, j_lo, j_hi, s_lut, acc);
      acc = add_word<kBits>(u.y, j0 + kPer, j_lo, j_hi, s_lut, acc);
      acc = add_word<kBits>(u.z, j0 + 2 * kPer, j_lo, j_hi, s_lut, acc);
      acc = add_word<kBits>(u.w, j0 + 3 * kPer, j_lo, j_hi, s_lut, acc);
    }
  } else {
    for (int wi = b_lo / 4; wi * 4 < b_hi; ++wi) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int bi = wi * 4 + b;
        if (bi < W) w |= static_cast<uint32_t>(__ldg(row + bi)) << (8 * b);
      }
      acc = add_word<kBits>(w, wi * kPer, j_lo, j_hi, s_lut, acc);
    }
  }
  return acc;
}

__device__ void stage_books(const unsigned short* __restrict__ cb, int n,
                            unsigned short* s_cb) {
  for (int i = threadIdx.x; i < n; i += kThreads) s_cb[i] = cb[i];
  __syncthreads();
}

template <int kBits, bool kFilter>
__global__ void __launch_bounds__(kThreads)
codes_fused_kernel(const float* __restrict__ qrot,
                   const float* __restrict__ centers,
                   const int* __restrict__ probes,
                   const uint8_t* __restrict__ codes,
                   const unsigned short* __restrict__ books,
                   const float* __restrict__ rsq, const int* __restrict__ ids,
                   int n_probes, int n_lists, int cap, int rot, int pq_dim,
                   int pq_len, int W, int vec16, int k, int kt, int sort_cap,
                   const QueryWords fw, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_topv = reinterpret_cast<float*>(smem);           // kMaxK
  int* s_topi = reinterpret_cast<int*>(s_topv + kMaxK);
  float* s_newv = reinterpret_cast<float*>(s_topi + kMaxK);
  int* s_newi = reinterpret_cast<int*>(s_newv + kMaxK);
  float* s_cv = reinterpret_cast<float*>(s_newi + kMaxK);   // sort_cap
  int* s_ci = reinterpret_cast<int*>(s_cv + sort_cap);
  int* s_cr = s_ci + sort_cap;
  float* s_lut = reinterpret_cast<float*>(s_cr + sort_cap);  // pq_dim<<kBits
  float* s_sub = s_lut + (pq_dim << kBits);                  // rot
  unsigned short* s_cb = reinterpret_cast<unsigned short*>(s_sub + rot);
  __shared__ float s_ssq;
  __shared__ int s_cnt;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const float* qv = qrot + (size_t)q * rot;
  const int* frow = kFilter ? words_row(fw, q) : nullptr;

  for (int i = tid; i < k; i += kThreads) {
    s_topv[i] = INFINITY;
    s_topi[i] = -1;
  }
  stage_books(books, (pq_dim << kBits) * pq_len, s_cb);

  for (int p = 0; p < n_probes; ++p) {
    const int l = probes[(size_t)q * n_probes + p];
    if (l < 0 || l >= n_lists) continue;    // uniform across the block
    if (tid == 0) s_cnt = 0;    // probe_sub synchronises before the rows
    probe_sub(qv, centers + (size_t)l * rot, rot, s_sub, &s_ssq);
    chunk_lut<kBits>(s_cb, s_sub, pq_len, 0, pq_dim, s_lut);
    const float thr = s_topv[k - 1];        // current k-th best
    const float ssq = s_ssq;
    const size_t base = (size_t)l * cap;
    for (int r = tid; r < cap; r += kThreads) {
      const int id = ids[base + r];
      if (id < 0) continue;
      const float ip = row_ip<kBits>(codes + (base + r) * W, W, 0, pq_dim,
                                     vec16 != 0, s_lut, 0.f);
      const float d = fmaxf(ssq + rsq[base + r] - 2.f * ip, 0.f);
      if (d < thr && (!kFilter || admits(frow, fw.n_words, id))) {
        const int pos = atomicAdd(&s_cnt, 1);
        s_cv[pos] = d;
        s_ci[pos] = id;
        s_cr[pos] = r;
      }
    }
    __syncthreads();
    const int cnt = s_cnt;
    if (cnt > 0) {
      sort_candidates(s_cv, s_ci, s_cr, cnt);
      merge_topk(s_topv, s_topi, s_newv, s_newi, s_cv, s_ci,
                 min(cnt, min(kt, k)), k);
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += kThreads) {
    out_v[(size_t)q * k + i] = s_topv[i];
    out_i[(size_t)q * k + i] = s_topi[i];
  }
}

template <int kBits, bool kFilter>
__global__ void __launch_bounds__(kThreads)
codes_pair_kernel(const float* __restrict__ qrot,
                  const float* __restrict__ centers,
                  const int* __restrict__ probes,
                  const uint8_t* __restrict__ codes,
                  const unsigned short* __restrict__ books,
                  const float* __restrict__ rsq, const int* __restrict__ ids,
                  int n_probes, int n_lists, int cap, int rot, int pq_dim,
                  int pq_len, int W, int vec16, int kt, int lut_sub,
                  int staged, const QueryWords fw,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dist = reinterpret_cast<float*>(smem);            // cap
  float* s_lut = s_dist + cap;                               // lut_sub<<kBits
  float* s_sub = s_lut + (lut_sub << kBits);                 // rot
  unsigned short* s_cb = reinterpret_cast<unsigned short*>(s_sub + rot);
  __shared__ float s_ssq;
  __shared__ float s_red_v[kWarps];
  __shared__ int s_red_s[kWarps];
  __shared__ int s_done;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const float* qv = qrot + (size_t)q * rot;
  const int* frow = kFilter ? words_row(fw, q) : nullptr;
  const unsigned short* cb = books;
  if (staged) {
    stage_books(books, (pq_dim << kBits) * pq_len, s_cb);
    cb = s_cb;
  }

  for (int p = 0; p < n_probes; ++p) {
    const size_t pair = (size_t)q * n_probes + p;
    float* ov = out_v + pair * kt;
    int* oi = out_i + pair * kt;
    const int l = probes[pair];
    if (l < 0 || l >= n_lists) {            // uniform across the block
      write_empty_pair(kt, ov, oi);
      continue;
    }
    probe_sub(qv, centers + (size_t)l * rot, rot, s_sub, &s_ssq);
    const float ssq = s_ssq;
    const size_t base = (size_t)l * cap;
    // lut_sub subspaces at a time: a row's partial sum waits in s_dist
    // and goes on in subspace order, so the chunks add up to the one-LUT
    // value bit for bit
    for (int j0 = 0; j0 < pq_dim; j0 += lut_sub) {
      const int j1 = min(pq_dim, j0 + lut_sub);
      const bool last = j1 == pq_dim;
      chunk_lut<kBits>(cb, s_sub, pq_len, j0, j1, s_lut);
      for (int r = tid; r < cap; r += kThreads) {
        const int id = ids[base + r];
        if (id < 0 || (kFilter && !admits(frow, fw.n_words, id))) {
          if (last) s_dist[r] = INFINITY;
          continue;
        }
        const float ip = row_ip<kBits>(codes + (base + r) * W, W, j0, j1,
                                       vec16 != 0, s_lut,
                                       j0 == 0 ? 0.f : s_dist[r]);
        s_dist[r] = last ? fmaxf(ssq + rsq[base + r] - 2.f * ip, 0.f) : ip;
      }
      __syncthreads();
    }
    select_pair_topk(s_dist, ids + base, cap, kt, ov, oi, s_red_v, s_red_s,
                     &s_done);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Kernel D's LUT chunks hold a multiple of kLutStep subspaces, so each
// chunk's codes start on a 16-byte boundary at 4 and 8 bits
constexpr int kLutStep = 32;

bool bad_shape(int rot, int pq_dim, int pq_bits, int W, int smem) {
  return (pq_bits != 4 && pq_bits != 8) || pq_dim < 1 || rot % pq_dim != 0
         || W != (pq_dim * pq_bits + 7) / 8 || smem < 1;
}

// Kernel C's and D's instantiation at pq_bits
template <bool kFilter>
auto fused_kernel(int pq_bits) {
  return pq_bits == 8 ? codes_fused_kernel<8, kFilter>
                      : codes_fused_kernel<4, kFilter>;
}

template <bool kFilter>
auto pair_kernel(int pq_bits) {
  return pq_bits == 8 ? codes_pair_kernel<8, kFilter>
                      : codes_pair_kernel<4, kFilter>;
}

}  // namespace

// smem: the block's dynamic shared memory in bytes, the layout of the
// kernel it launches, as ops/pq_code_scan.py's codes_fused_smem_bytes /
// codes_layout size it (the one copy of the formulas; the gates hold
// them to the card's limit and choose between C and D by them).
// filter_words: null, or the queries' packed admission words (n_words
// int32 a row, filter_stride words between two queries' rows, 0 for one
// row broadcast); a query then keeps only the rows it admits.
extern "C" int raft_ivf_pq_scan_codes_fused(
    const void* qrot, const void* centers, const void* probes,
    const void* codes, const void* books, const void* rsq, const void* ids,
    int nq, int n_probes, int n_lists, int cap, int rot, int pq_dim,
    int pq_bits, int W, int vec16, int k, int kt, int smem, void* out_v,
    void* out_i, const void* filter_words, int filter_stride, int n_words,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QueryWords fw = query_words(filter_words, filter_stride, n_words);
  if (k < 1 || k > kMaxK || kt < 1
      || bad_shape(rot, pq_dim, pq_bits, W, smem) || bad_words(fw))
    return (int)cudaErrorInvalidValue;
  const int pq_len = rot / pq_dim;
  const auto kernel = fw.words != nullptr ? fused_kernel<true>(pq_bits)
                                          : fused_kernel<false>(pq_bits);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0)
    kernel<<<nq, kThreads, smem, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const uint8_t*>(codes),
        static_cast<const unsigned short*>(books),
        static_cast<const float*>(rsq), static_cast<const int*>(ids),
        n_probes, n_lists, cap, rot, pq_dim, pq_len, W, vec16, k, kt,
        next_pow2(cap), fw, static_cast<float*>(out_v),
        static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

extern "C" int raft_ivf_pq_scan_codes(
    const void* qrot, const void* centers, const void* probes,
    const void* codes, const void* books, const void* rsq, const void* ids,
    int nq, int n_probes, int n_lists, int cap, int rot, int pq_dim,
    int pq_bits, int W, int vec16, int kt, int smem, int lut_sub, int staged,
    void* out_v, void* out_i, const void* filter_words, int filter_stride,
    int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QueryWords fw = query_words(filter_words, filter_stride, n_words);
  if (kt < 1 || bad_shape(rot, pq_dim, pq_bits, W, smem) || bad_words(fw)
      || lut_sub < 1 || (lut_sub < pq_dim && lut_sub % kLutStep != 0)
      || (staged && lut_sub < pq_dim))
    return (int)cudaErrorInvalidValue;
  const int pq_len = rot / pq_dim;
  const auto kernel = fw.words != nullptr ? pair_kernel<true>(pq_bits)
                                          : pair_kernel<false>(pq_bits);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0 && n_probes > 0)
    kernel<<<nq, kThreads, smem, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const uint8_t*>(codes),
        static_cast<const unsigned short*>(books),
        static_cast<const float*>(rsq), static_cast<const int*>(ids),
        n_probes, n_lists, cap, rot, pq_dim, pq_len, W, vec16, kt, lut_sub,
        staged, fw, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// Kernels C, D and E, list-major: the IVF-PQ scans over the bit-packed PQ
// codes and over the int8 recon cache as pass 1 of Kernels B and G's
// list-major route (pq_list_scan.cu), each list's rows turned in shared
// memory into the bf16 rows that pass multiplies on Hopper's tensor cores.
// The row source is a template switch (kBits: 4 or 8, the codes' field
// width; kInt8, Kernel E's int8 rows); everything else is one pass.
//
// code_list_scan_kernel is pass 1 on the codes.  Alone it is Kernel D and
// replaces raft_tpu/ops/pq_code_scan_pallas.py:367 grouped_code_scan (body
// _kernel_codes); followed by pq_list_scan.cu's merge_kernel (pass 2) it
// is Kernel C and replaces :282 grouped_code_scan_fused (body
// _kernel_codes_fused).  Contract, as there and as the recon pass 1 with
// its rows decoded:
//   row    = concat_j bf16(book[j][code_j(row)])   (codes LSB-first)
//   sub    = qrot[q] - centers[list]                (fp32)
//   sub_sq = sum(sub^2)                             (fp32)
//   ip     = bf16(sub) . row                        (fp32 accumulation)
//   d      = max(sub_sq + rsq[list, row] - 2 ip, 0)
// The decoded rows are the bf16 recon cache's bits and the products run on
// the same tiles in the same order, so on the same norms the pass gives
// pq_list_scan.cu's pass 1 over the cache bit for bit.  Rows whose id is
// negative never enter a result; each (query, probe) pair keeps its top kt
// by (distance, slot), ties to the lowest slot, (+inf, -1) past its live
// rows and on a probe outside [0, n_lists): out (nq, n_probes, kt).  With
// a filter (filter_words, as pq_list_scan.cu's pass 1 takes it) a pair
// keeps only the rows its query admits (list_fold.cuh's admission test).
//
// What bounds it on an H100: bytes.  The function needs each probed
// list's live rows once, W = ceil(pq_dim pq_bits / 8) bytes of codes plus
// a 4-byte id and a 4-byte norm a row (56 B at the deep shape, where the
// recon cache takes 2 rot + 8 = 200 B), and 2 rot operations per (pair,
// row), far below the ~295 operations a byte where the card turns
// compute-bound.  The query-major kernels (pq_code_scan.cu) read a list
// once per query that probes it and score each row through a per-pair
// LUT.  Here, as the TPU kernel does (decode the list once, one shared
// distance GEMM), a block owns one group of 128 pairs of one list
// (neighbors/grouped.py build_groups):
//   - the bf16 codebook (pq_dim, 2^pq_bits, pq_len) is staged in shared
//     memory once per block;
//   - per step of 128 list rows, up to the list's last live row, the rows'
//     packed codes (one contiguous run of 128 W bytes) come in by cp.async
//     one step ahead, into one of two raw stages;
//   - while step s's asynchronous wgmma runs, the block decodes step s +
//     1's codes through the books into the other B stage, in the 128-byte
//     swizzle layout wgmma reads.  A 16-byte chunk holds 8 dims, which may
//     span several subspaces (pq_len 1, 2, 3, ...), so each chunk is
//     assembled by dimension (a 32-bit book word a subspace at pq_len
//     2), zeros past rot: any rot with rot % pq_dim == 0.  The rows'
//     norms and ids go to the step's key stage beside them;
//   - the residuals, the products, the fold of each 128 x 128 window into
//     the pairs' top kt and the write-out are the recon pass's
//     (list_fold.cuh, wgmma_tile.cuh).
// A list is read once per group of its pairs.  The top-kt rows hold
// round8(kt) entries, so the books fit beside them at the flagship's shape
// (rot 128, 8 bits) up to kt 40.  ops/pq_code_scan.py's
// code_list_scan_smem_bytes mirrors code_layout; its gate holds it to the
// card's limit (the query-major kernels take what it refuses), the launch
// passes it, and the entry point refuses less than code_layout needs.
//
// Kernel E (kBits = kInt8) replaces raft_tpu/ops/pq_code_scan_pallas.py
// :441 grouped_recon8_scan (body _kernel_recon8, group-major as here) and
// keeps pq_recon8_scan.cu's contract:
//   ip = bf16(sub) . q8[list, row]                  (fp32 accumulation)
//   d  = max(sub_sq + rsq8[list, row] - (2 scale[list]) ip, 0)
// q8 is exact in bf16 (|q| <= 127), so its rows are converted, not
// dequantized: the list's scale multiplies the summed dot in the fold
// (scale2 = 2 scale[list], loaded once a group), as the JAX kernel
// applies it.  Its bytes are rot_pad int8 values, a 4-byte id and a
// 4-byte norm a live row (104 B at rot 96).  A step's rows come in by
// cp.async one step ahead, 16 bytes at a time, into a raw stage of rows
// padded to an odd number of 16-byte chunks; the block converts each
// 16-byte chunk (16 dims) into two 16-byte bf16 chunks of the B stage.
// The products run over rot_pad dims (zeros past rot in the residuals):
// on the same norms, with every scale 1 and rot_pad = round16(rot) (the
// port's cache), the pass gives pass 1 over q8[..., :rot] as bf16 rows
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "list_fold.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace raft_list;
using namespace raft_mma;

constexpr int kKtMax = 64;           // KT_LIST_MAX, ops/pq_group_scan.py
constexpr int kRowsAtOnce = 4;       // pair rows a warp folds side by side
constexpr int kInt8 = 0;             // the row source kBits of Kernel E

// the dims the products run over: round16(rot) for the codes, the int8
// rows' width W = rot_pad (a multiple of 16) for Kernel E
__host__ __device__ inline int pass_dims(int rot, int pq_bits, int W) {
  return pq_bits == kInt8 ? W : (rot + 15) & ~15;
}

// bytes a row takes in an int8 raw stage holding kc dims of each: an odd
// number of 16-byte chunks, so 8 consecutive rows' chunks lie in 8
// distinct bank groups
__host__ __device__ inline int int8_row_stride(int kc) {
  return ((kc >> 4) & 1) ? kc : kc + 16;
}

// byte offsets into the dynamic shared memory: pq_list_scan.cu's
// ScanLayout (residuals at a, list rows at b, keys, top kt, sub_sq, pair
// indices) with top-kt rows of `stride` = round8(kt) entries, then the
// bf16 books (none for int8 rows) and the two raw stages of a step's rows
// (packed codes: one run of 128 W bytes and its 16-byte head; int8: 128
// rows of int8_row_stride(kc) bytes)
struct CodeLayout {
  int a, a_step, b, b_step, key, top_v, top_s, ssq, pair, books, raw,
      raw_step, stride, total;
};

__host__ __device__ inline CodeLayout code_layout(int rot, int pq_bits,
                                                  int W, int kt) {
  const int kp = pass_dims(rot, pq_bits, W);
  const bool resident = kp <= kKc;
  const int kc = resident ? kp : kKc;
  const int ab = align1024(operand_bytes(kGroup, kc));
  const int bb = operand_bytes(BN, kc);
  CodeLayout L;
  L.stride = (kt + 7) & ~7;
  L.a = 0;
  L.a_step = resident ? 0 : ab;
  L.b = resident ? ab : 2 * ab;
  L.b_step = align1024(bb > kGroup * kHalf * 4 ? bb : kGroup * kHalf * 4);
  L.key = L.b + 2 * L.b_step;
  L.top_v = L.key + 2 * BN * 8;
  L.top_s = L.top_v + kGroup * L.stride * 4;
  L.ssq = L.top_s + kGroup * L.stride * 4;
  L.pair = L.ssq + kGroup * 4;
  L.books = L.pair + kGroup * 4;
  if (pq_bits == kInt8) {
    L.raw = L.books;
    L.raw_step = BN * int8_row_stride(kc);
  } else {
    L.raw = L.books + 2 * (rot << pq_bits);    // 32 rot B at least
    L.raw_step = ((BN * W + 15) & ~15) + 16;   // + the 16-byte head
  }
  L.total = L.raw + 2 * L.raw_step + 1024;     // + alignment
  return L;
}

// subspace j's code of a row of packed bytes (LSB-first; at 4 and 8 bits
// no field crosses a byte)
template <int kBits>
__device__ __forceinline__ int code_of(const uint8_t* row, int j) {
  if constexpr (kBits == 8) return row[j];
  return (row[j >> 1] >> ((j & 1) << 2)) & 15;
}

// Rows [0, n) of a step (their packed codes at raw, W bytes a row)
// decoded to dims [k0, k0 + kc) at shared address dst, in stage_rows's
// layout, through the bf16 books s_books (pq_dim, 2^kBits, pq_len); zeros
// past rot and on rows at or past n.  Thread t decodes row r = 8 ((t / 8)
// % 16) + t % 8 at 16-byte chunks (8 dims) t / 128, t / 128 + 2, ...: the
// 8 lanes of a store phase write 8 consecutive rows of one chunk column,
// distinct banks after the swizzle.  Dim d is entry d % pq_len of
// subspace d / pq_len's code's book row.  At pq_len 2 (the deep and
// flagship shapes) a 32-bit book word is one subspace's entry, a chunk's
// 4 word loads independent of each other; at another pq_len a chunk is
// assembled a dim at a time.
template <int kBits>
__device__ __forceinline__ void decode_rows(uint32_t dst, const uint8_t* raw,
                                            const unsigned short* s_books,
                                            int n, int W, int rot,
                                            int pq_len, int k0, int kc,
                                            int tid) {
  const int r = ((tid >> 3) & 15) * 8 + (tid & 7);
  const bool live = r < n;
  const uint8_t* row = raw + r * W;
  const uint32_t* s_words = reinterpret_cast<const uint32_t*>(s_books);
  for (int kg = tid >> 7; kg < (kc >> 3); kg += 2) {
    const int d0 = k0 + kg * 8;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (live && d0 < rot) {
      if (pq_len == 2) {                  // uniform across the block
        const int j0 = d0 >> 1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (d0 + 2 * i < rot)
            v[i] = s_words[((j0 + i) << kBits) + code_of<kBits>(row, j0 + i)];
      } else {
        int j = d0 / pq_len, l = d0 - j * pq_len;
        int entry = ((j << kBits) + code_of<kBits>(row, j)) * pq_len;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (d0 + i >= rot) break;
          v[i >> 1] |= (uint32_t)s_books[entry + l] << ((i & 1) << 4);
          if (++l == pq_len && d0 + i + 1 < rot) {      // next subspace
            l = 0;
            ++j;
            entry = ((j << kBits) + code_of<kBits>(row, j)) * pq_len;
          }
        }
      }
    }
    st_shared16(dst + sw128_offset(BN, r, kg),
                make_uint4(v[0], v[1], v[2], v[3]));
  }
}

// bytes 2h and 2h + 1 of four int8 values w as a bf16 pair (byte 2h the
// low half): each byte x is exact in fp32 as float(0x4B000000 | (x ^
// 0x80)) - (2^23 + 128), an integer whose bf16 is its upper 16 bits (the
// low 16 are zero), so a byte permute, an add and one permute of the pair
template <int h>
__device__ __forceinline__ uint32_t int8_pair_bf16(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + 2 * h))
                  - 8388736.f;
  const float b = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441 + 2 * h))
                  - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Rows [0, n) of a step's int8 rows at raw (rs bytes a row, the step's
// dims [k0, k0 + kw) of each) converted to bf16 at shared address dst,
// kc dims in stage_rows's layout; zeros on rows at or past n and past kw.
// Thread t takes row r = 8 ((t / 8) % 16) + t % 8 at 16-byte raw chunks
// (16 dims) t / 128, t / 128 + 2, ...: one 16-byte load (8 consecutive
// rows in distinct bank groups, rs / 16 being odd) and two 16-byte stores
// a chunk, the 8 lanes of a store phase on 8 consecutive rows of one chunk
// column, distinct banks after the swizzle.
__device__ __forceinline__ void convert_int8_rows(uint32_t dst,
                                                  const uint8_t* raw, int n,
                                                  int rs, int kw, int kc,
                                                  int tid) {
  const int r = ((tid >> 3) & 15) * 8 + (tid & 7);
  const bool live = r < n;
  for (int c = tid >> 7; c < (kc >> 4); c += 2) {
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (live && 16 * c < kw) {
      const uint4 u = *reinterpret_cast<const uint4*>(raw + r * rs + 16 * c);
      lo = make_uint4(int8_pair_bf16<0>(u.x), int8_pair_bf16<1>(u.x),
                      int8_pair_bf16<0>(u.y), int8_pair_bf16<1>(u.y));
      hi = make_uint4(int8_pair_bf16<0>(u.z), int8_pair_bf16<1>(u.z),
                      int8_pair_bf16<0>(u.w), int8_pair_bf16<1>(u.w));
    }
    st_shared16(dst + sw128_offset(BN, r, 2 * c), lo);
    st_shared16(dst + sw128_offset(BN, r, 2 * c + 1), hi);
  }
}

// E: a row's top-kt entries a lane holds while it is folded, 1 for kt <=
// 32, else 2.  kBits: 4 or 8, the rows are packed codes of that field
// width (books, W the code width, pq_len); kInt8, the rows are int8 of W
// = rot_pad bytes with a scale a list (scales; books and pq_len unused).
// kFilter: each pair keeps only the rows its query admits (adm,
// list_fold.cuh).
template <int kBits, int E, bool kFilter>
__global__ void __launch_bounds__(kThreads, 1)
code_list_scan_kernel(const float* __restrict__ qrot,
                      const float* __restrict__ centers,
                      const int* __restrict__ probes,
                      const int* __restrict__ group_list,
                      const int* __restrict__ slot_pairs,
                      const uint8_t* __restrict__ codes,
                      const uint4* __restrict__ books,
                      const float* __restrict__ scales,
                      const float* __restrict__ rsq,
                      const int* __restrict__ ids, int n_groups,
                      int n_pairs, int n_probes, int n_lists, int cap,
                      int rot, int pq_len, int W, int kt, const Admit adm,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_extent;
  const int tid = threadIdx.x;
  if (blockIdx.x >= n_groups) {
    write_empty_pairs(blockIdx.x - n_groups, probes, n_pairs, n_lists, kt,
                      out_v, out_i);
    return;
  }

  const int g = blockIdx.x;
  const int l = group_list[g];
  const int kp = pass_dims(rot, kBits, W);
  const bool resident = kp <= kKc;
  const int kc = resident ? kp : kKc;
  const int nchunks = (kp + kc - 1) / kc;
  const CodeLayout L = code_layout(rot, kBits, W, kt);
  // the layout's base, 1024-byte aligned for the swizzle atoms
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  float* top_v = reinterpret_cast<float*>(base + L.top_v);
  int* top_s = reinterpret_cast<int*>(base + L.top_s);
  float* ssq = reinterpret_cast<float*>(base + L.ssq);
  int* s_pair = reinterpret_cast<int*>(base + L.pair);
  const unsigned short* s_books =
      reinterpret_cast<const unsigned short*>(base + L.books);
  const size_t lbase = (size_t)l * cap;
  const float* cen = centers + (size_t)l * rot;
  const uint8_t* lcodes = codes + lbase * W;
  // the dot's factor in the distance: 2, or 2 scale[list] for int8 rows
  const float scale2 = kBits == kInt8 ? 2.f * scales[l] : 2.f;
  const int rs = int8_row_stride(kc);

  if (tid == 0) s_extent = 0;
  start_group(slot_pairs, g, s_pair, top_v, top_s, L.stride, tid);
  if constexpr (kBits != kInt8) {
    // the books, 16 bytes at a time (2 (rot << kBits) bytes in all)
    uint4* books_dst = reinterpret_cast<uint4*>(base + L.books);
    for (int i = tid; i < (rot << kBits) / 8; i += kThreads)
      books_dst[i] = __ldg(books + i);
  }
  __syncthreads();
  norms_and_extent(qrot, cen, s_pair, n_pairs, n_probes, rot, ids, lbase,
                   cap, ssq, &s_extent, tid);
  __syncthreads();
  const int extent = s_extent;
  const int nsteps = ((extent + BN - 1) / BN) * nchunks;

  // step s's rows (list rows from t BN up to the live extent) into raw
  // stage s & 1.  Codes: in 16-byte cp.async chunks from the 16-byte
  // boundary at or below the run's first byte (the codes are 16-byte
  // aligned, so it lies inside them); the last chunk stops at the run's
  // end.  int8: the chunk's dims of each row, 16 bytes a cp.async,
  // consecutive threads on consecutive chunks of a row
  auto load_raw = [&](int s) {
    const int t = s / nchunks;
    const int r0 = t * BN;
    const uint32_t dst = sbase + L.raw + (s & 1) * L.raw_step;
    if constexpr (kBits == kInt8) {
      const int k0 = (s - t * nchunks) * kc;
      const int nc = min(kc, kp - k0) >> 4;
      const uint8_t* src = lcodes + (size_t)r0 * W + k0;
      for (int e = tid; e < min(BN, extent - r0) * nc; e += kThreads) {
        const int r = e / nc, c = e - r * nc;
        cp_async16(dst + r * rs + 16 * c, src + (size_t)r * W + 16 * c, 16);
      }
    } else {
      const uint8_t* src = lcodes + (size_t)r0 * W;
      const uint8_t* from = src - ((uintptr_t)src & 15);
      const int nbytes = (int)(src - from) + min(BN, extent - r0) * W;
      for (int c = tid; 16 * c < nbytes; c += kThreads)
        cp_async16(dst + 16 * c, from + 16 * c, min(16, nbytes - 16 * c));
    }
  };
  // step s's operands into stage s & 1: where the residuals stream, their
  // dims of the step's chunk; its rows decoded (converted) from raw stage
  // s & 1; their norms and ids (0 and -1 past the extent) in its key stage
  auto decode_step = [&](int s) {
    const int stage = s & 1;
    const int t = s / nchunks, q = s - t * nchunks;
    const int r0 = t * BN;
    if (!resident)
      stage_residuals<false>(sbase + L.a + stage * L.a_step, qrot, cen,
                             s_pair, n_pairs, n_probes, rot, q * kc, kc,
                             tid);
    const uint32_t dst = sbase + L.b + stage * L.b_step;
    const unsigned char* raw = base + L.raw + stage * L.raw_step;
    if constexpr (kBits == kInt8) {
      convert_int8_rows(dst, raw, min(BN, extent - r0), rs,
                        min(kc, kp - q * kc), kc, tid);
    } else {
      const uintptr_t head = (uintptr_t)(lcodes + (size_t)r0 * W) & 15;
      decode_rows<kBits>(dst, raw + head, s_books, min(BN, extent - r0), W,
                         rot, pq_len, q * kc, kc, tid);
    }
    if (tid < BN) {
      float* key = reinterpret_cast<float*>(base + L.key + stage * BN * 8);
      const int r = r0 + tid;
      key[tid] = r < extent ? rsq[lbase + r] : 0.f;
      reinterpret_cast<int*>(key + BN)[tid] = r < extent ? ids[lbase + r]
                                                         : -1;
    }
  };

  if (resident)
    stage_residuals<false>(sbase + L.a, qrot, cen, s_pair, n_pairs,
                           n_probes, rot, 0, kc, tid);
  if (nsteps > 0) {
    load_raw(0);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();
    decode_step(0);
    if (nsteps > 1) load_raw(1);
    cp_async_commit();
  }

  const int wg = tid >> 7;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int stage = s & 1;
    const int t = s / nchunks, q = s - t * nchunks;
    // step s's operands are in shared memory, visible to wgmma, and every
    // thread is done with step s - 1's stage
    fence_proxy_async();
    __syncthreads();

    const uint32_t a0 = sbase + L.a + stage * L.a_step + wg * 8 * 1024;
    const uint32_t b0 = sbase + L.b + stage * L.b_step;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < (kc >> 4); ++ks) {
      const uint64_t da = desc_sw128(
          a0 + ((ks >> 2) * (kGroup >> 3) << 10) + ((ks & 3) << 5));
      const uint64_t db =
          desc_sw128(b0 + ((ks >> 2) * (BN >> 3) << 10) + ((ks & 3) << 5));
      wgmma_m64n128k16(acc, da, db, (q == 0 && ks == 0) ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // meanwhile step s + 1's rows (arrived) are decoded into the other
    // stage, and step s + 2's start coming in
    if (s + 1 < nsteps) {
      cp_async_wait0();
      __syncthreads();
      decode_step(s + 1);
      if (s + 2 < nsteps) load_raw(s + 2);
      cp_async_commit();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (q != nchunks - 1) continue;

    // epilogue of row tile t: both warpgroups' products are done before
    // the stage's rows are overwritten by distances; int8 rows take their
    // list's scale after the dot is summed, as the JAX kernel does
    fold_window<E, kRowsAtOnce, kFilter>(
        acc, reinterpret_cast<float*>(base + L.key + stage * BN * 8), ssq,
        reinterpret_cast<float*>(base + L.b + stage * L.b_step), top_v,
        top_s, L.stride, s_pair, n_pairs, kt, t * BN, extent, adm,
        [scale2](float dot, float key, float ss) {
          if constexpr (kBits == kInt8)
            return fmaxf(ss + key - __fmul_rn(scale2, dot), 0.f);
          else
            return fmaxf(ss + key - 2.f * dot, 0.f);
        });
  }

  __syncthreads();
  write_top(top_v, top_s, L.stride, s_pair, n_pairs, kt, ids, lbase, out_v,
            out_i);
}

template <int kBits, int E, bool kFilter>
int launch(int blocks, int smem, cudaStream_t s, const void* qrot,
           const void* centers, const void* probes, const void* group_list,
           const void* slot_pairs, const void* codes, const void* books,
           const void* scales, const void* rsq, const void* ids,
           int n_groups, int n_pairs, int n_probes, int n_lists, int cap,
           int rot, int pq_len, int W, int kt, const Admit& adm, void* out_v,
           void* out_i) {
  const auto kernel = code_list_scan_kernel<kBits, E, kFilter>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(qrot), static_cast<const float*>(centers),
        static_cast<const int*>(probes), static_cast<const int*>(group_list),
        static_cast<const int*>(slot_pairs),
        static_cast<const uint8_t*>(codes), static_cast<const uint4*>(books),
        static_cast<const float*>(scales), static_cast<const float*>(rsq),
        static_cast<const int*>(ids), n_groups, n_pairs, n_probes, n_lists,
        cap, rot, pq_len, W, kt, adm, static_cast<float*>(out_v),
        static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// the launch of row source kBits for kt and a filter (or none)
template <int kBits>
auto launcher(int kt, bool filtered) {
  return filtered ? (kt <= 32 ? launch<kBits, 1, true> : launch<kBits, 2, true>)
                  : (kt <= 32 ? launch<kBits, 1, false>
                              : launch<kBits, 2, false>);
}

}  // namespace

// Pass 1 over the packed codes (Kernel D; with pass 2, Kernel C): every
// (query, probe) pair's top kt (1 <= kt <= 64), out (nq, n_probes, kt).
// codes (n_lists, cap, W) uint8 and books (pq_dim, 2^pq_bits, pq_len)
// bf16, both 16-byte aligned; rsq the rows' norms (of their bf16
// reconstructions); group_list / slot_pairs from neighbors/grouped.py
// build_groups (nq * n_probes marks an empty slot); probes (nq, n_probes)
// say which pairs no group holds.  smem: the block's dynamic shared
// memory, as ops/pq_code_scan.py's code_list_scan_smem_bytes sizes it (a
// Python copy of code_layout; the entry point refuses less than
// code_layout needs).  filter_words / filter_stride / n_words: a filter's
// packed admission words as pq_list_scan.cu's pass 1 takes them (null:
// unfiltered).
extern "C" int raft_ivf_pq_code_list_scan(
    const void* qrot, const void* centers, const void* probes,
    const void* group_list, const void* slot_pairs, const void* codes,
    const void* books, const void* rsq, const void* ids, int n_groups,
    int nq, int n_probes, int n_lists, int cap, int rot, int pq_dim,
    int pq_bits, int kt, int smem, void* out_v, void* out_i,
    const void* filter_words, int filter_stride, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt < 1 || kt > kKtMax || (pq_bits != 4 && pq_bits != 8) || pq_dim < 1
      || rot < 1 || rot % pq_dim != 0 || cap < 1 || n_groups < 0
      || ((uintptr_t)codes & 15) != 0 || ((uintptr_t)books & 15) != 0
      || (filter_words != nullptr && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int W = (pq_dim * pq_bits + 7) / 8;
  if (smem < code_layout(rot, pq_bits, W, kt).total)
    return (int)cudaErrorInvalidValue;
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const int pq_len = rot / pq_dim;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
  const bool filtered = filter_words != nullptr;
  const auto run = pq_bits == 8 ? launcher<8>(kt, filtered)
                                : launcher<4>(kt, filtered);
  return run(blocks, smem, s, qrot, centers, probes, group_list, slot_pairs,
             codes, books, nullptr, rsq, ids, n_groups, n_pairs, n_probes,
             n_lists, cap, rot, pq_len, W, kt, adm, out_v, out_i);
}

// Pass 1 over the int8 recon cache (Kernel E, list-major): every (query,
// probe) pair's top kt (1 <= kt <= 64), out (nq, n_probes, kt).  data
// (n_lists, cap, rot_pad) int8, 16-byte aligned, rot_pad a multiple of 16
// at least rot, zeros past rot; scales (n_lists,) the lists' scales;
// rsq8 the rows' dequantized norms; groups and probes as above.  smem as
// ops/pq_code_scan.py's recon8_list_scan_smem_bytes sizes it (the entry
// point refuses less than code_layout needs); a filter as above.
extern "C" int raft_ivf_pq_recon8_list_scan(
    const void* qrot, const void* centers, const void* probes,
    const void* group_list, const void* slot_pairs, const void* data,
    const void* scales, const void* rsq8, const void* ids, int n_groups,
    int nq, int n_probes, int n_lists, int cap, int rot, int rot_pad, int kt,
    int smem, void* out_v, void* out_i, const void* filter_words,
    int filter_stride, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt < 1 || kt > kKtMax || rot < 1 || rot_pad < rot || rot_pad % 16 != 0
      || cap < 1 || n_groups < 0 || ((uintptr_t)data & 15) != 0
      || smem < code_layout(rot, kInt8, rot_pad, kt).total
      || (filter_words != nullptr && (n_words < 1 || filter_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int n_pairs = nq * n_probes;
  const int blocks = n_groups + (n_pairs + kThreads - 1) / kThreads;
  const Admit adm{static_cast<const int*>(filter_words), filter_stride,
                  n_words, n_probes};
  const auto run = launcher<kInt8>(kt, filter_words != nullptr);
  return run(blocks, smem, s, qrot, centers, probes, group_list, slot_pairs,
             data, nullptr, scales, rsq8, ids, n_groups, n_pairs, n_probes,
             n_lists, cap, rot, 0, rot_pad, kt, adm, out_v, out_i);
}

// The compact row sources of Kernels D and E: a list's rows turned in
// shared memory into the bf16 wgmma B operand (128 rows, 128-byte swizzle,
// wgmma_tile.cuh's stage_rows layout) from a raw stage that cp.async
// filled.  Two passes build on them: the list-major pass over the codes
// and the int8 rows (pq_code_list_scan.cu, kt <= 64) and the pair-group
// pass (pair_list_scan.cu, kt 65-128).
//
//   - packed codes (kBits 4 or 8): a row is W = ceil(pq_dim kBits / 8)
//     bytes, subspace j's field LSB-first; dim d is entry d % pq_len of
//     subspace d / pq_len's code's row of the bf16 books (pq_dim,
//     2^kBits, pq_len), zeros past rot;
//   - int8 rows (kInt8): a row is W = rot_pad int8 values, zeros past
//     rot, each exact in bf16 (|q| <= 127): converted, not dequantized
//     (the list's scale multiplies the summed dot).
//
// Both take 256 threads (two warpgroups) and cover a step's 128 rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace raft_rows {

using raft_mma::BN;
using raft_mma::sw128_offset;
using raft_mma::st_shared16;

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

// subspace j's code of a row of packed bytes (LSB-first; at 4 and 8 bits
// no field crosses a byte)
template <int kBits>
__device__ __forceinline__ int code_of(const uint8_t* row, int j) {
  if constexpr (kBits == 8) return row[j];
  return (row[j >> 1] >> ((j & 1) << 2)) & 15;
}

// Rows [0, n) of a step (their packed codes at raw, W bytes a row)
// decoded to dims [k0, k0 + kc) at shared address dst, in stage_rows's
// layout, through the bf16 books s_books (pq_dim, 2^kBits, pq_len; in
// shared or global memory); zeros past rot and on rows at or past n.
// Thread t decodes row r = 8 ((t / 8) % 16) + t % 8 at 16-byte chunks (8
// dims) t / 128, t / 128 + 2, ...: the 8 lanes of a store phase write 8
// consecutive rows of one chunk column, distinct banks after the swizzle.
// Dim d is entry d % pq_len of subspace d / pq_len's code's book row.  At
// pq_len 2 (the deep and flagship shapes) a 32-bit book word is one
// subspace's entry, a chunk's 4 word loads independent of each other; at
// another pq_len a chunk is assembled a dim at a time.
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

}  // namespace raft_rows

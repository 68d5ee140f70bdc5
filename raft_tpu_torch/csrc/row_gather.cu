// Kernel J: random row gather, out[i] = table[ids[i]].
//
// Replaces profiles/gather_bench.py:70 pallas_gather (body _gather_kernel
// :44): the TPU kernel keeps a block's ids in SMEM and copies each row
// HBM -> VMEM -> HBM with per-row double-buffered DMAs.  The CAGRA walk's
// table gather is this function.
//
// What bounds it on an H100: bytes — each gathered row is read once and
// written once (2 * M * row_bytes + 4 * M of ids), no arithmetic.  Design:
// a block of kThreads threads owns `rows` consecutive output rows (the
// TPU kernel's block of rows, a launch parameter); a row is copied by
// lanes_per_row lanes with 16-byte loads and stores, the fewest lanes (a
// power of two, at most 32) that cover the row's 16-byte chunks, so a
// 256-byte bf16 row is one load a lane on 16 lanes and a 512-byte f32 row
// one load a lane on 32.  The ids are read once per row by every lane of
// its group (one broadcast load); the row loads are independent, so many
// are in flight per SM without any staging through shared memory.  ids
// are in [0, N) by contract: nothing here checks them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint4* __restrict__ table,
                  const int* __restrict__ ids, int m, int chunks, int lpr,
                  int rows, uint4* __restrict__ out) {
  const int lane_in_row = threadIdx.x % lpr;
  const int row_in_pass = threadIdx.x / lpr;
  const int rows_per_pass = kThreads / lpr;
  const long long first = (long long)blockIdx.x * rows;
  const long long last = first + rows < m ? first + rows : (long long)m;
  for (long long i = first + row_in_pass; i < last; i += rows_per_pass) {
    const uint4* src = table + (size_t)__ldg(ids + i) * chunks;
    uint4* dst = out + (size_t)i * chunks;
    for (int c = lane_in_row; c < chunks; c += lpr) dst[c] = __ldg(src + c);
  }
}

}  // namespace

// row_bytes: a multiple of 16; table and out 16-byte aligned; rows >= 1
// output rows a block.
extern "C" int raft_row_gather(const void* table, const void* ids, int m,
                               int row_bytes, int rows, void* out,
                               void* stream) {
  if (row_bytes < 16 || row_bytes % 16 != 0 || rows < 1 || m < 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  int lpr = 1;
  while (lpr < 32 && lpr < chunks) lpr <<= 1;
  if (m > 0)
    row_gather_kernel<<<(unsigned)((m + (long long)rows - 1) / rows),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), static_cast<const int*>(ids), m,
        chunks, lpr, rows, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// A pointer chase: one thread follows next[] for `steps` loads, the address
// of each the value of the one before, and writes where it ended.
//
// It replaces no TPU kernel.  chip_smoke.py and the walk profiles time it
// to measure one dependent device-memory load's latency on the card: the
// unit of Kernel I's latency bound, since a walk's hops are a chain of
// such loads (the next parents are known only after the merge).  The loads
// skip L1 (ld.global.cg) and the caller draws a random cycle over an array
// well past the 50 MB L2, so each is a device-memory round trip.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start,
                             int steps, int* __restrict__ out) {
  int p = start;
  for (int i = 0; i < steps; ++i) p = __ldcg(next + p);
  *out = p;
}

}  // namespace

extern "C" int raft_mem_latency_chase(const void* next, int start, int steps,
                                      void* out, void* stream) {
  if (next == nullptr || out == nullptr || start < 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), start, steps, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

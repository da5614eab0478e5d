// T15, the dependent scalar walk: from x = 1, `steps` steps of
// x = tbl[x & 511] + x + 1 over a 512-word int32 table, in wrapping 32-bit
// arithmetic (uint32_t: signed overflow is undefined in C++). out (8, 128)
// float32 holds float32(x), rounded to nearest, in every cell.
//
// Replaces tools/microbench2.py:walk_kernel (:230, the pallas_call of
// run_walk at :247), whose table is a scalar-prefetch operand in SMEM and
// whose walk runs on the TPU's scalar unit.
//
// What bounds it on the H100: each step's load address is the last step's
// result, so a step is one shared-memory load latency plus two integer
// ops, and nothing overlaps. One thread walks; the block's 128 threads
// stage the table into shared memory (the analog of SMEM) first, and write
// the result's 1024 cells after.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTable = 512;

__global__ void walk_kernel(const int* __restrict__ tbl,
                            float* __restrict__ out, int steps) {
  __shared__ uint32_t t[kTable];
  __shared__ uint32_t result;
  for (int i = threadIdx.x; i < kTable; i += blockDim.x)
    t[i] = (uint32_t)tbl[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t x = 1;
    for (int j = 0; j < steps; ++j) x = t[x & (kTable - 1)] + x + 1u;
    result = x;
  }
  __syncthreads();
  const float v = __int2float_rn((int)result);
  for (int r = 0; r < 8; ++r) out[r * kLanes + threadIdx.x] = v;
}

}  // namespace

// tbl: (512,) int32; out: (8, 128) float32.
extern "C" int lz4t_probe_walk(const void* tbl, void* out, int steps,
                               void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  walk_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      (const int*)tbl, (float*)out, steps);
  return (int)cudaGetLastError();
}

// T8, the byte-extract probe: `reps` rounds in which each lane reads the
// 26 little-endian words at bytes pos + 4i .. pos + 4i + 3 (i < 26) of its
// byte stream and adds them to a 16-bit sum, which moves the next round's
// position. Lane L's stream is column L of an (R, 128) int32 tape: row r
// holds its bytes 4r .. 4r + 3, and bytes outside [0, 4R) read 0. Each
// round: pos = (pos0 + (acc & 63)) & mask, acc = (acc + sum of words) &
// 0xFFFF, in wrapping 32-bit arithmetic; the result is acc.
//
// Replaces tools/microbench4.py:banded_kernel (the pallas_call at :141),
// whose extract is lockstep_v4.py:extract_bytes_banded: a band-select
// scan over the slabs between the lanes' lowest and highest rows, then a
// per-lane rotate and byte shift. The tool's mask is 4R - 256, so its
// positions are 256-byte aligned; the kernel takes any position (any
// mask), with the byte shift of an unaligned one.
//
// What bounds it on the H100: each round is 27 independent loads of the
// lane's column (the 26 words and the next row for the byte shift) that
// the next round's position depends on, so a round costs about one L2
// latency however wide the lanes' span is. A warp's loads of one row
// index coalesce only where its lanes' positions agree. One thread a
// lane, one warp a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWords = 26;

__global__ void banded_kernel(const int* __restrict__ tape,
                              const int* __restrict__ pos0,
                              int* __restrict__ out, int rows, int reps,
                              int mask) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t* col = reinterpret_cast<const uint32_t*>(tape) + lane;
  const uint32_t p0 = (uint32_t)pos0[lane];
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    const int pos = (int)((p0 + (acc & 63)) & (uint32_t)mask);
    const int row = pos >> 2;                 // floor, also below zero
    const int sh = (pos & 3) * 8;
    uint32_t w[kWords + 1];
#pragma unroll
    for (int i = 0; i <= kWords; ++i) {
      const int rr = row + i;
      w[i] = (rr >= 0 && rr < rows) ? col[(size_t)rr * kLanes] : 0u;
    }
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      sum += sh ? (w[i] >> sh) | (w[i + 1] << (32 - sh)) : w[i];
    acc = (acc + sum) & 0xFFFFu;
  }
  out[lane] = (int)acc;
}

}  // namespace

// tape: (rows, 128) int32; pos0, out: (128,) int32.
extern "C" int lz4t_probe_banded(const void* tape, const void* pos0,
                                 void* out, int rows, int reps, int mask,
                                 void* stream) {
  if (rows < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  banded_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int*)tape, (const int*)pos0, (int*)out, rows, reps, mask);
  return (int)cudaGetLastError();
}

// T9 and T10, the per-lane word gather and scatter of the lockstep
// design: lane L of 128 walks its own row index over an (R, 128) int32
// array in device memory (R a power of two of at least 8), touching only
// column L. idx starts at L mod R and steps idx = (idx + L mod s + 1) mod R
// each round. All arithmetic is wrapping 32-bit (uint32_t).
//
// lz4t_probe_gather replaces tools/microbench3.py:make_gather.kern (the
// pallas_call at :88), s = 7: each of `reps` rounds adds tape[idx][L] to a
// sum. out (8, 128): row 0 the sums, rows 1-7 zero (the tool leaves them
// as the TPU's memory held them).
//
// lz4t_probe_scatter replaces make_scatter.kern (the pallas_call at :123),
// s = 5: round i writes idx + i at out[idx][L], the later write winning.
// The caller zeroes out first, so a cell no round writes is 0 (the tool
// leaves it undefined).
//
// What bounds them on the H100: the TPU finds a lane's row with a masked
// reduce (a masked where-write) over the whole (R, 128) block, R rows of
// work a round; here it is one indexed load (store). A warp's 32 lanes
// touch 32 rows 512 bytes apart a round, 32 sectors an access. The walk
// does not depend on the data, so the gather issues kGroup loads before it
// adds any of them: they overlap instead of each waiting out an L1 or L2
// round trip. The stores never wait. The arrays (8 MiB at R = 16384) stay
// in the 50 MB L2. One thread a lane, one warp a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroup = 16;     // gathers in flight a lane

__global__ void gather_kernel(const int* __restrict__ tape,
                              int* __restrict__ out, int rows, int reps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t* col = reinterpret_cast<const uint32_t*>(tape) + lane;
  const uint32_t mask = (uint32_t)rows - 1;
  const uint32_t step = (uint32_t)(lane % 7) + 1;
  uint32_t idx = (uint32_t)lane & mask;
  uint32_t acc = 0;
  int i = 0;
  for (; i + kGroup <= reps; i += kGroup) {
    uint32_t v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      v[k] = __ldg(col + (size_t)idx * kLanes);
      idx = (idx + step) & mask;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc += v[k];
  }
  for (; i < reps; ++i) {
    acc += __ldg(col + (size_t)idx * kLanes);
    idx = (idx + step) & mask;
  }
  out[lane] = (int)acc;
  for (int r = 1; r < 8; ++r) out[r * kLanes + lane] = 0;
}

__global__ void scatter_kernel(int* __restrict__ out, int rows, int reps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t* col = reinterpret_cast<uint32_t*>(out) + lane;
  const uint32_t mask = (uint32_t)rows - 1;
  const uint32_t step = (uint32_t)(lane % 5) + 1;
  uint32_t idx = (uint32_t)lane & mask;
  for (int i = 0; i < reps; ++i) {
    col[(size_t)idx * kLanes] = idx + (uint32_t)i;
    idx = (idx + step) & mask;
  }
}

bool bad_rows(int rows) { return rows < 8 || (rows & (rows - 1)) != 0; }

}  // namespace

// tape: (rows, 128) int32; out: (8, 128) int32.
extern "C" int lz4t_probe_gather(const void* tape, void* out, int rows,
                                 int reps, void* stream) {
  if (bad_rows(rows) || reps < 0) return (int)cudaErrorInvalidValue;
  gather_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int*)tape, (int*)out, rows, reps);
  return (int)cudaGetLastError();
}

// out: (rows, 128) int32, zeroed by the caller.
extern "C" int lz4t_probe_scatter(void* out, int rows, int reps,
                                  void* stream) {
  if (bad_rows(rows) || reps < 0) return (int)cudaErrorInvalidValue;
  scatter_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>(
      (int*)out, rows, reps);
  return (int)cudaGetLastError();
}

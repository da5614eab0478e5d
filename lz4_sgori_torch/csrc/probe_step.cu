// T11 and T12, the register-carried steps of the lockstep design: one
// thread a lane carries its state through `reps` rounds and writes it once
// at the end. Additions, products and left shifts wrap at 32 bits
// (uint32_t); right shifts, compares, min and max are int32's, as the
// tool's jnp ops on int32 are.
//
// lz4t_probe_fifo replaces tools/microbench3.py:make_fifo.kern (the
// pallas_call at :164): an 8-word FIFO, starting as the row iota, and
// sh = L & 7; each round rolls the column down by sh (row r takes row
// (r - sh) mod 8) in three stages, by 1, 2 and 4 rows where sh has that
// bit, adds 1, and steps sh = (sh + 1) & 7. out (8, 128) is the FIFO.
//
// lz4t_probe_state replaces make_state.kern (the pallas_call at :215):
// four states, the tool's (L, L + 1, L + 2, L + 3) or any others in
// `start`, through the body of :188-206, op for op. out (8, 128): row 0
// a + b + c + d, rows 1-7 zero (the tool leaves them as the TPU's memory
// held them).
//
// What bounds them on the H100: neither touches memory inside the loop.
// The TPU's (8, 128) vector ops become a lane's scalar ops: T11 is 24
// selects, 8 adds and the shift's step a round, with a chain of four
// (three selects and the add) between rounds; T12 is about 30 integer ops
// whose longest chain runs through most of them. The FIFO's 8 words stay
// in registers: the stages are unrolled, so every index is a constant (a
// dynamically indexed array would go to local memory and this would time
// that instead). One thread a lane, one warp a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

__device__ __forceinline__ int add(int x, int y) {
  return (int)((uint32_t)x + (uint32_t)y);
}

__global__ void fifo_kernel(int* __restrict__ out, int reps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int f[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) f[r] = r;
  int sh = lane & 7;
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int bit = 0; bit < 3; ++bit) {
      const int k = 1 << bit;
      const bool on = (sh & k) != 0;
      int g[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) g[r] = on ? f[(r - k) & 7] : f[r];
#pragma unroll
      for (int r = 0; r < 8; ++r) f[r] = g[r];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) f[r] = add(f[r], 1);
    sh = (sh + 1) & 7;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * kLanes + lane] = f[r];
}

__global__ void state_kernel(const int* __restrict__ start,
                             int* __restrict__ out, int reps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int a = start[lane], b = start[kLanes + lane], c = start[2 * kLanes + lane],
      d = start[3 * kLanes + lane];
  for (int i = 0; i < reps; ++i) {
    const int e = add(a, b) ^ c;
    const int f = d > 0 ? e : a;
    const int g = add(f >> 3, b & 255);
    const int h = min(g, c) | (int)((uint32_t)a << 1);
    const int a2 = (h & 1) != 0 ? add(a, 1) : a;
    const int b2 = add(b, g) & 0xFFFF;
    const int c2 = max(add(c, -1), h & 7);
    const int d2 = d ^ add(e, f);
    const int e2 = (int)((uint32_t)a2 * 3u + (uint32_t)b2) & 0xFFFFF;
    const int f2 = c2 > d2 ? e2 : f;
    const int g2 = add(g, f2 >> 2);
    const int h2 = h ^ g2;
    const int a3 = add(a2, h2 & 3);
    const int b3 = b2 < e2 ? b2 + 7 : b2;
    const int c3 = c2 | (a3 & 1);
    const int d3 = add(d2, g2);
    a = a3;
    b = b3;
    c = c3;
    d = d3;
  }
  out[lane] = add(add(a, b), add(c, d));
  for (int r = 1; r < 8; ++r) out[r * kLanes + lane] = 0;
}

}  // namespace

// out: (8, 128) int32.
extern "C" int lz4t_probe_fifo(void* out, int reps, void* stream) {
  if (reps < 0) return (int)cudaErrorInvalidValue;
  fifo_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>((int*)out,
                                                            reps);
  return (int)cudaGetLastError();
}

// start: (4, 128) int32, rows a, b, c, d; out: (8, 128) int32.
extern "C" int lz4t_probe_state(const void* start, void* out, int reps,
                                void* stream) {
  if (reps < 0) return (int)cudaErrorInvalidValue;
  state_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int*)start, (int*)out, reps);
  return (int)cudaGetLastError();
}

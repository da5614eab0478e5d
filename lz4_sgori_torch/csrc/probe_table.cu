// T6 and T7, the per-lane table probes: rounds of gets (and puts) on an
// (R, 128) int32 table in device memory, where lane L only ever reads and
// writes column L. All arithmetic is wrapping 32-bit (uint32_t).
//
// lz4t_probe_rounds replaces tools/microbench6.py:timed_kernel (the
// pallas_call at :50) with the bodies of its main() (:93-117): n rounds
// over a carry table, returning its rows [0, 8). With c0 = row 0 at the
// start of round i and h_k = (c0 * (k + 3) + i) & (R - 1):
//   getk      row 0 becomes the XOR of the K gets table[h_k];
//   putk      table[h_k] = c0 + k for k = 0..K-1 in order, the later
//             put winning; every hash and value is from the round's c0;
//   extract1  row 0 becomes table[(c0 + i) & (R - 1)].
//
// lz4t_probe_kget replaces tools/microbench4.py:kget_kernel (the
// pallas_call at :114): the (8192, 128) table starts with every row equal
// to seed; each of `reps` rounds reads K gets at
// h_k = (((acc * (2k + 1) + r * 977 + seed * k) * 0x9E3779B1) >> 19) & 8191,
// then, with puts, writes acc + k at h_k in order; then
// acc = (acc + the sum of the gets) & 0xFFFF. The result is acc.
//
// What bounds them on the H100: the TPU answers a get with a compare-and-
// select scan over the whole table; here it is one indexed load. A lane's
// rows are 512 bytes apart, so a warp's 32 gets of one round land in 32
// different lines: each round is a chain of dependent loads at L2
// latency (the 4 MiB table stays in the 50 MB L2), not a byte stream;
// the K gets of a round are a loop of loads (issuing them together,
// unrolled, measured no faster on the card). One thread a lane, one warp
// a block, so the four warps of the 128 lanes run on four SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kKgetRows = 8192;
constexpr uint32_t kGolden = 0x9E3779B1u;  // -1640531535 as an int32

enum Body { kGetK = 0, kPutK = 1, kExtract1 = 2 };

__global__ void rounds_kernel(int* __restrict__ tbl, int* __restrict__ out,
                              int body, int rows, int n, int K) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t* col = reinterpret_cast<uint32_t*>(tbl) + lane;
  const uint32_t mask = (uint32_t)rows - 1;
  for (int i = 0; i < n; ++i) {
    const uint32_t c0 = col[0];
    if (body == kGetK) {
      uint32_t x = 0;
      for (int k = 0; k < K; ++k)
        x ^= col[(size_t)((c0 * (uint32_t)(k + 3) + (uint32_t)i) & mask) *
                 kLanes];
      col[0] = x;
    } else if (body == kPutK) {
      for (int k = 0; k < K; ++k)
        col[(size_t)((c0 * (uint32_t)(k + 3) + (uint32_t)i) & mask) *
            kLanes] = c0 + (uint32_t)k;
    } else {
      col[0] = col[(size_t)((c0 + (uint32_t)i) & mask) * kLanes];
    }
  }
  for (int r = 0; r < 8; ++r) out[r * kLanes + lane] = (int)col[r * kLanes];
}

__device__ __forceinline__ uint32_t kget_hash(uint32_t acc, uint32_t r,
                                              uint32_t seed, uint32_t k) {
  return ((acc * (2 * k + 1) + r * 977u + seed * k) * kGolden >> 19) &
         (kKgetRows - 1);
}

__global__ void kget_kernel(int* __restrict__ tbl,
                            const int* __restrict__ seed,
                            int* __restrict__ out, int reps, int K,
                            int puts) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t* col = reinterpret_cast<uint32_t*>(tbl) + lane;
  const uint32_t s = (uint32_t)seed[lane];
  for (int r = 0; r < kKgetRows; ++r) col[r * kLanes] = s;
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    uint32_t sum = 0;
    for (int k = 0; k < K; ++k)
      sum += col[kget_hash(acc, r, s, k) * kLanes];
    if (puts)
      for (int k = 0; k < K; ++k)
        col[kget_hash(acc, r, s, k) * kLanes] = acc + (uint32_t)k;
    acc = (acc + sum) & 0xFFFFu;
  }
  out[lane] = (int)acc;
}

}  // namespace

// tbl: (rows, 128) int32, updated in place; out: (8, 128) int32.
extern "C" int lz4t_probe_rounds(void* tbl, void* out, int body, int rows,
                                 int n, int K, void* stream) {
  if (body < kGetK || body > kExtract1 || rows < 8 || (rows & (rows - 1)) ||
      n < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  rounds_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>(
      (int*)tbl, (int*)out, body, rows, n, K);
  return (int)cudaGetLastError();
}

// tbl: (8192, 128) int32 scratch, filled by the kernel; seed, out: (128,).
extern "C" int lz4t_probe_kget(void* tbl, const void* seed, void* out,
                               int reps, int K, int puts, void* stream) {
  if (reps < 0 || K < 0) return (int)cudaErrorInvalidValue;
  kget_kernel<<<kLanes / 32, 32, 0, (cudaStream_t)stream>>>(
      (int*)tbl, (const int*)seed, (int*)out, reps, K, puts);
  return (int)cudaGetLastError();
}

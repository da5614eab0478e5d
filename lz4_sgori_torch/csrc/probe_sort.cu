// T4, the bitonic column sort probe: each column of an (N, 128) int32
// array sorted on its own, ascending, in place.
//
// Replaces tools/sort_probe.py:_sort_kernel (the pallas_call at :73),
// which holds the whole array in VMEM and runs the network of
// bitonic_stages (:39): stage (j, k) compare-exchanges rows i and
// i + 2^k (bit k of i clear), keeping the minimum in row i where bit
// j + 1 of i is clear and the maximum where it is set.
//
// What bounds it on the H100: a column of 65,536 values is 256 KiB, more
// than a block's 227 KB of shared memory, so the network is split by
// distance. The stages of distance 2^k >= TILE rows run in device memory,
// one launch a stage (one thread a pair, 128 neighbouring threads on the
// 128 columns of a row pair, so every load coalesces). Every run of
// stages of distance below TILE runs in one launch on tiles of TILE rows
// by 32 columns (128 KiB of shared memory; a warp reads one row of 32
// columns, so no bank conflicts). At N = 65,536 that is 1 + 21 + 6 = 28
// launches for 136 stages, each reading and writing the 32 MiB array
// once: 28 passes where the bytes bound counts one. The network is
// data-independent, so the result is np.sort(x, axis=0) for any input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTileCols = 32;
constexpr int kTileRowsLog = 10;
constexpr int kTileThreads = 512;
constexpr int kTileBytes = (1 << kTileRowsLog) * kTileCols * 4;

// The pair of rows (lo, lo + 2^k) of pair index q at distance 2^k.
__device__ __forceinline__ int pair_lo(int q, int k) {
  return ((q >> k) << (k + 1)) | (q & ((1 << k) - 1));
}

__device__ __forceinline__ void exchange(int* a, int* b, bool desc) {
  const int x = *a, y = *b;
  const int mn = min(x, y), mx = max(x, y);
  *a = desc ? mx : mn;
  *b = desc ? mn : mx;
}

// One stage (j, k) over the whole array in device memory.
__global__ void stage_kernel(int* __restrict__ x, int pairs, int j, int k) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pairs * kLanes) return;
  const int col = e & (kLanes - 1);
  const int lo = pair_lo(e >> 7, k);
  const bool desc = (lo >> (j + 1)) & 1;
  exchange(x + (size_t)lo * kLanes + col,
           x + (size_t)(lo + (1 << k)) * kLanes + col, desc);
}

// For each j in [j0, j1], the stages (j, k) with k < tile_log, on a tile
// of 2^tile_log rows by 32 columns in shared memory.
__global__ void tile_kernel(int* __restrict__ x, int tile_log, int j0,
                            int j1) {
  extern __shared__ int s[];
  const int rows = 1 << tile_log;
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * kTileCols;
  const int n = rows * kTileCols;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    s[e] = x[(size_t)(row0 + e / kTileCols) * kLanes + col0 + e % kTileCols];
  __syncthreads();
  for (int j = j0; j <= j1; ++j) {
    for (int k = min(j, tile_log - 1); k >= 0; --k) {
      for (int e = threadIdx.x; e < n / 2; e += blockDim.x) {
        const int lo = pair_lo(e / kTileCols, k);
        const int c = e % kTileCols;
        const bool desc = ((row0 + lo) >> (j + 1)) & 1;
        exchange(&s[lo * kTileCols + c], &s[(lo + (1 << k)) * kTileCols + c],
                 desc);
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    x[(size_t)(row0 + e / kTileCols) * kLanes + col0 + e % kTileCols] = s[e];
}

}  // namespace

// Sorts each column of x (n rows of 128 int32, n a power of two) in place.
extern "C" int lz4t_probe_sort(void* x, int n, void* stream) {
  if (n <= 0 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  if (n == 1) return (int)cudaGetLastError();
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
  if (e != cudaSuccess) return (int)e;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const int tile_log = min(logn, kTileRowsLog);
  const dim3 tiles(n >> tile_log, kLanes / kTileCols);
  const int smem = (1 << tile_log) * kTileCols * 4;
  const cudaStream_t st = (cudaStream_t)stream;
  int* xs = (int*)x;
  tile_kernel<<<tiles, kTileThreads, smem, st>>>(xs, tile_log, 0,
                                                 tile_log - 1);
  const int pairs = n / 2;
  const int threads = 256;
  const int blocks = (pairs * kLanes + threads - 1) / threads;
  for (int j = tile_log; j < logn; ++j) {
    for (int k = j; k >= tile_log; --k)
      stage_kernel<<<blocks, threads, 0, st>>>(xs, pairs, j, k);
    tile_kernel<<<tiles, kTileThreads, smem, st>>>(xs, tile_log, j, j);
  }
  return (int)cudaGetLastError();
}

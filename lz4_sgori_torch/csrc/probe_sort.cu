// T4, the bitonic column sort probe: each column of an (N, 128) int32
// array x sorted on its own, ascending, into out.
//
// Replaces tools/sort_probe.py:_sort_kernel (the pallas_call at :73),
// which holds the whole array in VMEM and runs the network of
// bitonic_stages (:39): stage (j, k) compare-exchanges rows i and
// i + 2^k (bit k of i clear), keeping the minimum in row i where bit
// j + 1 of i is clear and the maximum where it is set.
//
// What bounds it on the H100: the bytes, one read of x and one write of
// out (64 MiB at N = 65,536), against the network's passes over the
// array. A column of 65,536 values is 256 KiB, more than a block's 227 KB
// of shared memory, so the network is split by distance into passes
// (plan below), each a launch that reads and writes the array once:
//
// - a tile pass runs, for each j of its range, the stages (j, k) with
//   k < 12 on tiles of 4096 rows by 8 columns (128 KiB of shared memory;
//   a row's 8 words are one 32-byte sector of the array), 512 threads a
//   tile. A round holds 16 values of a column 2^lo rows apart in each
//   thread's registers and runs up to four stages (k .. k - 3 = lo) on
//   them, so that one shared-memory round trip and one barrier serve four
//   stages; the first pass's first round runs all ten stages of j = 0-3
//   on 16 neighbouring rows. In every later round all pairs of a group
//   share one direction (bit j + 1 of its rows lies above the held ones),
//   so a group branches once and a pair is one min and one max. Rows sit
//   in the tile with their two low bits xored with a mix of bits 3-5
//   (slot), so that the 4 rows a warp reads at once fall in distinct
//   banks at every distance;
// - a global pass runs, for one j >= 12, up to four stages (k = khi ..
//   klo >= 12) in registers: a thread holds 2^(khi - klo + 1) rows 2^klo
//   apart of 4 neighbouring columns (16-byte loads; a warp reads a whole
//   row), compare-exchanges them and writes them back.
//
// The first pass (a tile pass over j = 0 .. 11) reads x and writes out;
// the others work on out in place. At N = 65,536 that is 1 tile pass,
// then for each j = 12 .. 15 a global pass and a tile pass: 9 passes and
// 33 tile rounds for the 136 stages (a global pass is split from the top
// every four stages, which happens from N = 2^17 on). The network is
// data-independent, so the result is np.sort(x, axis=0) for any input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTileCols = 8;        // slot's swizzle is for 8
constexpr int kTileLog = 12;        // log2 of a tile's rows
constexpr int kTileThreads = 512;
constexpr int kHeld = 4;            // log2 of a thread's values in a round
constexpr int kGlobalStages = 4;    // the most stages of a global pass
constexpr int kGlobalThreads = 256;
constexpr int kMaxLogN = 24;
static_assert(kHeld <= kTileLog, "a later round holds kHeld bits of a tile");

// the word of (row, col) in a tile: the row's two low bits xored with 1,
// 2 or 3 for each of its bits 3, 4 and 5 (a bijection within each 4
// rows), so that any two of the pairs of row bits a warp's 4 groups
// differ in (0-1, 0-4, 0-5, 3-4, 4-5) reach 4 bank groups. It is linear
// over xor: slot(a | b, c) = slot(a, c) ^ slot(b, 0) for rows a, b
// without a common bit.
__device__ __forceinline__ int slot(int row, int col) {
  const int mix = ((row >> 3) & 3) ^ (-((row >> 5) & 1) & 3);
  return ((row ^ mix) << 3) | col;
}

__device__ __forceinline__ void exchange(int& a, int& b, bool desc) {
  const int mn = min(a, b), mx = max(a, b);
  a = desc ? mx : mn;
  b = desc ? mn : mx;
}

// The first round of a tile's first pass: each group (a column and 2^HB
// neighbouring rows from base) holds its rows in registers and runs the
// stages (j, k) of j = 0 .. jn - 1, all with k < HB. A pair's direction
// is bit j + 1 of its first row: of m while j + 1 < HB, else of row0 |
// base.
template <int HB>
__device__ __forceinline__ void first_round(int* s, int tile_log, int row0,
                                            int jn) {
  constexpr int V = 1 << HB;
  const int groups = kTileCols << (tile_log - HB);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c = g % kTileCols, base = (g / kTileCols) << HB;
    const int word = slot(base, c);
    const bool dx = ((row0 | base) >> HB) & 1;
    int v[V];
#pragma unroll
    for (int m = 0; m < V; ++m) v[m] = s[word ^ slot(m, 0)];
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      if (j >= jn) break;
#pragma unroll
      for (int k = j; k >= 0; --k)
#pragma unroll
        for (int m = 0; m < V; ++m)
          if (!(m & (1 << k)))
            exchange(v[m], v[m | (1 << k)],
                     j + 1 < HB ? (m >> (j + 1)) & 1 : dx);
    }
#pragma unroll
    for (int m = 0; m < V; ++m) s[word ^ slot(m, 0)] = v[m];
  }
}

// Stages k = khi .. lo of held values v[m] (rows base + m 2^lo), every
// pair keeping its minimum first, or with kDesc its maximum.
template <int HB, bool kDesc>
__device__ __forceinline__ void held_stages(int (&v)[1 << HB], int lo,
                                            int khi) {
#pragma unroll
  for (int h = HB - 1; h >= 0; --h) {
    if (lo + h > khi) continue;
#pragma unroll
    for (int m = 0; m < (1 << HB); ++m)
      if (!(m & (1 << h))) {
        const int x = v[m], y = v[m | (1 << h)];
        v[m] = kDesc ? max(x, y) : min(x, y);
        v[m | (1 << h)] = kDesc ? min(x, y) : max(x, y);
      }
  }
}

// A later round, of stages (j, k) for k = khi .. lo (lo + HB > khi) with
// j + 1 >= lo + HB: each group (a base row, bits lo .. lo + HB - 1 clear,
// and a column) holds its 2^HB rows base + m 2^lo in registers, every
// pair of one direction, bit j + 1 of row0 | base: a branch a group,
// which a warp takes as one unless bit j + 1 is one of the row bits its
// 4 groups differ in (j = 4 alone, at lo 0 and 1).
template <int HB>
__device__ __forceinline__ void tile_round(int* s, int tile_log, int row0,
                                           int j, int lo, int khi) {
  constexpr int V = 1 << HB;
  const int groups = kTileCols << (tile_log - HB);
  int off[V];  // the words of rows m 2^lo, xored into a group's base word
#pragma unroll
  for (int m = 0; m < V; ++m) off[m] = slot(m << lo, 0);
#pragma unroll 1
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c = g % kTileCols, b = g / kTileCols;
    const int base = ((b >> lo) << (lo + HB)) | (b & ((1 << lo) - 1));
    const int word = slot(base, c);
    int v[V];
#pragma unroll
    for (int m = 0; m < V; ++m) v[m] = s[word ^ off[m]];
    if (((row0 | base) >> (j + 1)) & 1)
      held_stages<HB, true>(v, lo, khi);
    else
      held_stages<HB, false>(v, lo, khi);
#pragma unroll
    for (int m = 0; m < V; ++m) s[word ^ off[m]] = v[m];
  }
}

// For each j in j0 .. j1, the stages (j, k) with k < tile_log, on a tile
// of 2^tile_log rows by 8 columns read from src and written to dst (the
// same array but in the first pass); j1 < j0 copies the tile. Rounds: the
// first pass's j = 0 .. hb - 1 in one (hb = min(tile_log, kHeld)), then
// for each later j from k = min(j, tile_log - 1) down, hb stages a round.
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(const int* src, int* dst, int tile_log, int j0, int j1) {
  extern __shared__ int4 smem4[];
  int* s = (int*)smem4;
  const int row0 = blockIdx.x << tile_log, col0 = blockIdx.y * kTileCols;
  const int quads = (kTileCols / 4) << tile_log;
#pragma unroll 4
  for (int e = threadIdx.x; e < quads; e += blockDim.x) {
    const int row = e / (kTileCols / 4), c = 4 * (e % (kTileCols / 4));
    *(int4*)(s + slot(row, c)) =
        *(const int4*)(src + (size_t)(row0 + row) * kLanes + col0 + c);
  }
  __syncthreads();
  const int hb = min(tile_log, kHeld);
  int j = j0;
  if (j0 == 0 && j1 >= 0) {
    const int jn = min(hb, j1 + 1);
    if (hb == kHeld)
      first_round<kHeld>(s, tile_log, row0, jn);
    else if (hb == 3)
      first_round<3>(s, tile_log, row0, jn);
    else if (hb == 2)
      first_round<2>(s, tile_log, row0, jn);
    else
      first_round<1>(s, tile_log, row0, jn);
    __syncthreads();
    j = hb;
  }
  for (; j <= j1; ++j) {
    for (int khi = min(j, tile_log - 1); khi >= 0;) {
      const int lo = max(0, khi - kHeld + 1);
      tile_round<kHeld>(s, tile_log, row0, j, lo, khi);
      __syncthreads();
      khi = lo - 1;
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < quads; e += blockDim.x) {
    const int row = e / (kTileCols / 4), c = 4 * (e % (kTileCols / 4));
    *(int4*)(dst + (size_t)(row0 + row) * kLanes + col0 + c) =
        *(const int4*)(s + slot(row, c));
  }
}

// Stages (j, k) for k = klo + NS - 1 .. klo over the whole array, in
// registers: a thread holds rows base + m 2^klo (bits klo .. klo + NS - 1
// of base clear) of the 4 columns 4q .. 4q + 3; every row of the group
// has bit j + 1 of base, so one direction serves all its pairs.
template <int NS>
__global__ void __launch_bounds__(kGlobalThreads)
    global_kernel(int* x, int logn, int j, int klo) {
  constexpr int V = 1 << NS;
  const int e = blockIdx.x * kGlobalThreads + threadIdx.x;
  if (e >= (kLanes / 4) << (logn - NS)) return;
  const int q = e & 31, b = e >> 5;
  const int base = ((b >> klo) << (klo + NS)) | (b & ((1 << klo) - 1));
  const bool desc = (base >> (j + 1)) & 1;
  int4* p = (int4*)x + (size_t)base * (kLanes / 4) + q;
  const size_t step = (size_t)(kLanes / 4) << klo;
  int4 v[V];
#pragma unroll
  for (int m = 0; m < V; ++m) v[m] = p[m * step];
#pragma unroll
  for (int h = NS - 1; h >= 0; --h) {
#pragma unroll
    for (int m = 0; m < V; ++m)
      if (!(m & (1 << h))) {
        int4& a = v[m];
        int4& c = v[m | (1 << h)];
        exchange(a.x, c.x, desc);
        exchange(a.y, c.y, desc);
        exchange(a.z, c.z, desc);
        exchange(a.w, c.w, desc);
      }
  }
#pragma unroll
  for (int m = 0; m < V; ++m) p[m * step] = v[m];
}

template <int NS>
int launch_global(int* x, int logn, int j, int klo, cudaStream_t st) {
  const int threads = (kLanes / 4) << (logn - NS);
  global_kernel<NS><<<(threads + kGlobalThreads - 1) / kGlobalThreads,
                      kGlobalThreads, 0, st>>>(x, logn, j, klo);
  return (int)cudaGetLastError();
}

// The plan of a sort of 2^logn rows (sort_probe.plan in Python): a tile
// pass over j = 0 .. t - 1 (t = min(logn, 12)), then for each j = t ..
// logn - 1 the global passes of its stages k = j .. t, four at most each
// from the top, and a tile pass over j alone. Launched on st when x is
// not null; returns the passes, or a CUDA error code negated.
int run_plan(const int* x, int* out, int logn, cudaStream_t st) {
  const int tl = min(logn, kTileLog);
  const dim3 tiles(1 << (logn - tl), kLanes / kTileCols);
  const int smem = (kTileCols * 4) << tl;
  int passes = 0, e;
  auto tile = [&](const int* src, int j0, int j1) {
    ++passes;
    if (x == nullptr) return 0;
    tile_kernel<<<tiles, kTileThreads, smem, st>>>(src, out, tl, j0, j1);
    return (int)cudaGetLastError();
  };
  if ((e = tile(x, 0, tl - 1))) return -e;
  for (int j = tl; j < logn; ++j) {
    for (int khi = j; khi >= tl; khi -= kGlobalStages) {
      const int klo = max(tl, khi - kGlobalStages + 1);
      ++passes;
      if (x == nullptr) continue;
      switch (khi - klo + 1) {
        case 1: e = launch_global<1>(out, logn, j, klo, st); break;
        case 2: e = launch_global<2>(out, logn, j, klo, st); break;
        case 3: e = launch_global<3>(out, logn, j, klo, st); break;
        default: e = launch_global<4>(out, logn, j, klo, st); break;
      }
      if (e) return -e;
    }
    if ((e = tile(out, j, j))) return -e;
  }
  return passes;
}

// log2 of n, or -1 unless n is a power of two in [1, 2^kMaxLogN]
int log2_rows(int n) {
  if (n <= 0 || (n & (n - 1)) || n > 1 << kMaxLogN) return -1;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  return logn;
}

}  // namespace

// Sorts each column of x (n rows of 128 int32, n a power of two up to
// 2^24) into out (n rows of 128 int32, not overlapping x).
extern "C" int lz4t_probe_sort(const void* x, void* out, int n, void* stream) {
  const int logn = log2_rows(n);
  if (logn < 0 || x == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (kTileCols * 4) << kTileLog);
  if (e != cudaSuccess) return (int)e;
  const int passes =
      run_plan((const int*)x, (int*)out, logn, (cudaStream_t)stream);
  return passes < 0 ? -passes : 0;
}

// The launches (passes over the array) of a sort of n rows, or -1 for an
// n that lz4t_probe_sort refuses.
extern "C" int lz4t_probe_sort_passes(int n) {
  const int logn = log2_rows(n);
  return logn < 0 ? -1 : run_plan(nullptr, nullptr, logn, nullptr);
}

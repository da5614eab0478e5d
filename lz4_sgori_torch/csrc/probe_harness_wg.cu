// T14b's two readings that price the tensor cores' row gather and their
// triangular-matmul cumsum, written for the whole H100: from acc = 0 ((8,
// 128) float32), each iteration i of 0 .. r-1 computes the body's whole
// matrix product and adds its rows [:8] into acc, one float32 add a cell
// in iteration order; sink sums every element of every iteration's
// product (gather: the wrapping 32-bit sum of the float32 bit patterns;
// cumsum_mxu: a float64 sum).
//
// Replaces tools/microbench2.py:_harness.kernel (:40, the pallas_call of
// _harness.run at :60) around body_gather (:130) and body_cumsum_mxu
// (:296). The other three tensor-core readings stay in
// probe_harness_tc.cu.
//
// What bounds it on the H100: the tensor cores of every SM (2mnk a
// product at 4096 dense bf16 FLOP a clock an SM, 2048 TF32; the split
// TF32 of cumsum_mxu doubles its tensor work). The TPU runs the harness
// sequentially on one core (grid (1,)); here a persistent grid of one
// block an SM walks a static list of work items (iteration i, row band),
// item w of the block's list being blockIdx.x + w * gridDim.x (a
// warpgroup's, for the gather), so that a call's bits depend only on its
// inputs and the grid. Products run on wgmma (sm_90a):
//
// - gather: onehot((lcg(ids + i) >> 7) & 511, 512) @ data_bf, m64n128k16
//   bf16 -> f32, a 64-row band a warpgroup. The one-hot A is built in
//   registers from the band's indices, computed by the warpgroup that uses
//   them (no block-wide barrier); B (data_bf, 128 KiB) is transposed once a
//   block into shared memory, K-major with the 128-byte swizzle. Every
//   product and sum is exact (one non-zero term a row).
// - cumsum_mxu: tri @ float32(a512 + i), m64n128k8 TF32, a 128-row band a
//   block (two warpgroups of 64 rows). tri's band tiles (128 rows x 32 k)
//   arrive by TMA into a 4-stage ring with mbarriers (A from shared
//   memory). B is converted once an (item, 32-k chunk) by all 256 threads
//   into the other of two buffers while the last chunk's wgmmas run, from
//   a512 values loaded a chunk earlier (their L2 latency hidden); a
//   barrier a chunk. Each element x is split into hi = x
//   with its 13 low mantissa bits cleared and lo = x - hi rounded to TF32
//   (exact for |x| < 2^22, so rows 0-7, sums of at most 8 integers below
//   2^21, are exact), written K-major ([n][k], TF32 wgmma has no
//   transpose) with the 128-byte swizzle; two wgmmas a k step.
//
// Across blocks: the band-0 item of iteration i writes its rows 0-7 to
// scratch[i] (8 x 128 float32); each block writes its sink partial (a
// float64, or a uint32 for the gather); a second kernel of one block adds
// scratch[0 .. r-1] into acc in iteration order with __fadd_rn and sums
// the partials in block order. r = 0 gives acc = 0 and sink = 0.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHi = 0xffffe000u;  // a float's sign, exponent, 10 mantissa bits
constexpr int kTile = 128 * 128;       // bytes: 128 rows of one 128-byte swizzle row

__device__ __forceinline__ uint32_t lcg(uint32_t x) {
  return x * 1664525u + 1013904223u;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// dynamic shared memory rounded up to 1024 bytes (the swizzle's period)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// element (row, 16-byte chunk q) of a swizzled 128-byte-row tile
__device__ __forceinline__ int swz(int row, int q) {
  return row * 128 + ((q ^ (row & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators across a wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int q = 0; q < 64; ++q) asm volatile("" : "+f"(d[q])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D64                                                                \
  D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28), D4(32),     \
      D4(36), D4(40), D4(44), D4(48), D4(52), D4(56), D4(60)
#define R64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A (64 x 8, shared, K-major) B (8 x 128, shared, K-major), TF32
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", %64, %65, p, 1, 1;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, registers) B (16 x 128, shared, K-major), bf16
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// TMA: the (32 k, 128 rows) float32 box at (k0, m0) of map into dst,
// completing on bar
__device__ __forceinline__ void tma_load(const CUtensorMap& map, void* dst,
                                         uint64_t* bar, int k0, int m0) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(kTile)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)&map), "r"(smem_u32(bar)), "r"(k0), "r"(m0)
      : "memory");
}

// rows 0-7 of a finished band-0 tile (warp 0 of its warpgroup) to dst
__device__ __forceinline__ void store_rows(const float (&d)[64], float* dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *(float2*)(dst + g * 128 + 8 * j + 2 * t) = make_float2(d[4 * j],
                                                            d[4 * j + 1]);
}

// ---- gather: a 64-row band a warpgroup, data_bf resident ----

namespace ga {
constexpr int kThreads = 256, kWgs = kThreads / 128;
constexpr int kBands = 2048 / 64;
constexpr int kSmem = 1024 + 8 * kTile + 32;  // B: 8 tiles of 64 k
}  // namespace ga

// a bf16 pair (k, k + 1) of the one-hot row of index v: 1.0 at column v
__device__ __forceinline__ uint32_t onehot(int v, int k) {
  const int d = v - k;
  return d == 0 ? 0x3f80u : d == 1 ? 0x3f800000u : 0u;
}

__global__ void __launch_bounds__(ga::kThreads, 1)
    gather_kernel(const int* __restrict__ ids,
                  const uint16_t* __restrict__ data, int r,
                  float* __restrict__ scratch, uint32_t* __restrict__ part) {
  extern __shared__ uint8_t raw[];
  uint8_t* bs = aligned_smem(raw);
  uint32_t* red = (uint32_t*)(bs + 8 * kTile);
  const int tid = threadIdx.x;
  // data_bf (512 k, 128 n) into 8 tiles (128 n, 64 k), K-major, swizzled
  for (int e = tid; e < 128 * 64; e += ga::kThreads) {
    const int n = e & 127, o = e >> 7;  // o: the k octet
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)__ldg(data + (8 * o + 2 * j) * 128 + n) |
             (uint32_t)__ldg(data + (8 * o + 2 * j + 1) * 128 + n) << 16;
    *(uint4*)(bs + (o >> 3) * kTile + swz(n, o & 7)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_proxy_async();
  __syncthreads();
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int items = r * ga::kBands, stride = gridDim.x * ga::kWgs;
  const uint64_t db = desc(bs);
  uint32_t sink = 0;
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (int w = blockIdx.x * ga::kWgs + (tid >> 7); w < items; w += stride) {
    const uint32_t i = (uint32_t)(w / ga::kBands);
    const int row = (w % ga::kBands) * 64 + 16 * warp + g;
    const int v0 = ((int)lcg((uint32_t)__ldg(ids + row) + i) >> 7) & 511;
    const int v1 = ((int)lcg((uint32_t)__ldg(ids + row + 8) + i) >> 7) & 511;
    uint32_t a[2][4][4];  // two chunks of 64 k in flight
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      uint32_t(&x)[4][4] = a[kc & 1];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 64 * kc + 16 * s + 2 * t;
        x[s][0] = onehot(v0, k);
        x[s][1] = onehot(v1, k);
        x[s][2] = onehot(v0, k + 8);
        x[s][3] = onehot(v1, k + 8);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_bf16(d, x[s], db + (kc * kTile >> 4) + 2 * s, kc | s);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(d);
#pragma unroll
    for (int q = 0; q < 64; ++q) sink += __float_as_uint(d[q]);
    if (w % ga::kBands == 0 && warp == 0)
      store_rows(d, scratch + (size_t)i * 1024);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sink += __shfl_xor_sync(kFull, sink, m);
  if (lane == 0) red[tid >> 5] = sink;
  __syncthreads();
  if (tid == 0) {
    uint32_t tot = 0;
    for (int q = 0; q < ga::kThreads / 32; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// ---- cumsum_mxu: a 128-row band a block, tri through a TMA ring ----

namespace cs {
constexpr int kThreads = 256, kStages = 4;
constexpr int kChunks = 512 / 32;  // 32-k chunks of a product
constexpr int kBands = 512 / 128;
constexpr int kSmem = 1024 + kStages * kTile + 4 * kTile + kStages * 8 + 64;
}  // namespace cs

// a thread's share of chunk kc of a: 4 k of one column, 4 times
__device__ __forceinline__ void fetch(const int* __restrict__ a, int kc,
                                      int (&v)[4][4]) {
  const int n = threadIdx.x & 127, q0 = threadIdx.x >> 7;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[u][e] = __ldg(a + (32 * kc + 4 * (q0 + 2 * u) + e) * 128 + n);
}

// that share of B = float32(a + i) as hi and lo, (128 n, 32 k) K-major,
// swizzled
__device__ __forceinline__ void convert(const int (&v)[4][4], uint32_t i,
                                        uint8_t* hi, uint8_t* lo) {
  const int n = threadIdx.x & 127, q0 = threadIdx.x >> 7;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __int2float_rn((int)((uint32_t)v[u][e] + i));
      h[e] = __float_as_uint(x) & kHi;
      l[e] = tf32(x - __uint_as_float(h[e]));
    }
    const int off = swz(n, q0 + 2 * u);
    *(uint4*)(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *(uint4*)(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__global__ void __launch_bounds__(cs::kThreads, 1)
    cumsum_kernel(const __grid_constant__ CUtensorMap tri,
                  const int* __restrict__ a, int r,
                  float* __restrict__ scratch, double* __restrict__ part) {
  extern __shared__ uint8_t raw[];
  uint8_t* ring = aligned_smem(raw);
  uint8_t* bb = ring + cs::kStages * kTile;  // 2 x (hi, lo)
  uint64_t* full = (uint64_t*)(bb + 4 * kTile);
  double* red = (double*)(full + cs::kStages);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int G = gridDim.x, items = r * cs::kBands;
  const int mine = (int)blockIdx.x < items
                       ? (items - 1 - (int)blockIdx.x) / G + 1 : 0;
  const int nc = mine * cs::kChunks;  // the block's chunks, in order
  auto item = [&](int c) { return (int)blockIdx.x + c / cs::kChunks * G; };
  auto load = [&](int c, int st) {
    tma_load(tri, ring + st * kTile, full + st, 32 * (c % cs::kChunks),
             128 * (item(c) % cs::kBands));
  };
  // B of chunk c from the a values fetched for it a chunk earlier
  int v[4][4];
  auto stage_b = [&](int c) {
    uint8_t* b = bb + (c & 1) * 2 * kTile;
    convert(v, (uint32_t)(item(c) / cs::kBands), b, b + kTile);
    if (c + 1 < nc) fetch(a, (c + 1) % cs::kChunks, v);
  };
  if (tid == 0) {
    for (int s = 0; s < cs::kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < cs::kStages && c < nc; ++c) load(c, c);
  }
  if (nc > 0) {
    fetch(a, 0, v);
    stage_b(0);
  }
  fence_proxy_async();
  __syncthreads();
  double sink = 0.0;
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int kc = c % cs::kChunks, st = c % cs::kStages;
    mbar_wait(full + st, (uint32_t)(c / cs::kStages) & 1);
    const uint8_t* b = bb + (c & 1) * 2 * kTile;
    const uint64_t da = desc(ring + st * kTile + wg * (kTile / 2));
    const uint64_t dh = desc(b), dl = desc(b + kTile);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32(d, da + 2 * s, dh + 2 * s, kc | s);
      wgmma_tf32(d, da + 2 * s, dl + 2 * s, 1);
    }
    wgmma_commit();
    if (c + 1 < nc) stage_b(c + 1);  // while the wgmmas run
    wgmma_wait<0>();
    fence_acc(d);
    fence_proxy_async();
    __syncthreads();  // B of c + 1 written; ring slot st and B of c free
    if (tid == 0 && c + cs::kStages < nc) load(c + cs::kStages, st);
    if (kc == cs::kChunks - 1) {
      const int w = item(c);
#pragma unroll
      for (int q = 0; q < 64; ++q) sink += (double)d[q];
      if (w % cs::kBands == 0 && tid < 32)
        store_rows(d, scratch + (size_t)(w / cs::kBands) * 1024);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sink += __shfl_xor_sync(kFull, sink, m);
  if ((tid & 31) == 0) red[tid >> 5] = sink;
  __syncthreads();
  if (tid == 0) {
    double tot = 0.0;
    for (int q = 0; q < cs::kThreads / 32; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// acc: scratch[0 .. r-1] added in iteration order, a thread a cell; sink:
// the blocks' partials in block order
template <bool kF64>
__global__ void __launch_bounds__(1024)
    finish_kernel(const float* __restrict__ scratch, int r,
                  const void* __restrict__ part, int grid,
                  float* __restrict__ out, void* __restrict__ sink) {
  const int q = threadIdx.x;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < r; ++i)
    acc = __fadd_rn(acc, scratch[(size_t)i * 1024 + q]);
  out[q] = acc;
  if (q == 0) {
    if (kF64) {
      double tot = 0.0;
      for (int b = 0; b < grid; ++b) tot += ((const double*)part)[b];
      *(double*)sink = tot;
    } else {
      uint32_t tot = 0;
      for (int b = 0; b < grid; ++b) tot += ((const uint32_t*)part)[b];
      *(int*)sink = (int)tot;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (the library links no -lcuda)
EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &got);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                          cudaEnableDefault, &got);
#endif
  return e == cudaSuccess && got == cudaDriverEntryPointSuccess
             ? (EncodeTiled)fn : nullptr;
}

template <class K>
int shared_bytes(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// scratch: r x 4 KiB of rows, then grid x 8 bytes of partials
int run_gather(const void* ids, const void* data, int r, void* out,
               void* sink, float* scratch, int grid, cudaStream_t st) {
  void* part = scratch + (size_t)r * 1024;
  int e;
  if ((e = shared_bytes(gather_kernel, ga::kSmem))) return e;
  gather_kernel<<<grid, ga::kThreads, ga::kSmem, st>>>(
      (const int*)ids, (const uint16_t*)data, r, scratch, (uint32_t*)part);
  if ((e = (int)cudaGetLastError())) return e;
  finish_kernel<false><<<1, 1024, 0, st>>>(scratch, r, part, grid,
                                           (float*)out, sink);
  return (int)cudaGetLastError();
}

int run_cumsum_mxu(const void* a512, const void* tri, int r, void* out,
                   void* sink, float* scratch, int grid, cudaStream_t st) {
  void* part = scratch + (size_t)r * 1024;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {512, 512}, strides[1] = {512 * 4};
  const cuuint32_t box[2] = {32, 128}, one[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)tri, dims,
             strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int e;
  if ((e = shared_bytes(cumsum_kernel, cs::kSmem))) return e;
  cumsum_kernel<<<grid, cs::kThreads, cs::kSmem, st>>>(
      map, (const int*)a512, r, scratch, (double*)part);
  if ((e = (int)cudaGetLastError())) return e;
  finish_kernel<true><<<1, 1024, 0, st>>>(scratch, r, part, grid,
                                          (float*)out, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0-1 in the order of the bodies of this source in
// lz4_sgori_torch.probes.microbench2.BODIES; in0, in1: the body's inputs;
// out: (8, 128) float32; sink: one int32 (gather) or float64; scratch: r x
// 4 KiB, then grid x 8 bytes of partials; grid: the blocks, one an SM.
extern "C" int lz4t_probe_harness_wg(int body, const void* in0,
                                     const void* in1, int r, void* out,
                                     void* sink, void* scratch, int grid,
                                     void* stream) {
  if (r < 0 || r >= 1 << 26 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  switch (body) {
    case 0: return run_gather(in0, in1, r, out, sink, sc, grid, st);
    case 1: return run_cumsum_mxu(in0, in1, r, out, sink, sc, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

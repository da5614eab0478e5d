// T14b, two of the tensor-core readings of the primitive-rate harness:
// from acc = 0 ((8, 128) float32, in shared memory), each iteration i of
// 0 .. r-1 computes one body's whole matrix product on the tensor cores
// and adds its rows [:8] into acc, one float32 add a cell an iteration in
// iteration order. sink sums every element of every iteration's whole
// product in float64, so that no part of it can be left out.
//
// Replaces tools/microbench2.py:_harness.kernel (:40, the pallas_call of
// _harness.run at :60) with two bodies of its main() that run on the
// MXU: body_mxu (:115) in bf16 and body_cumsum_mxu_lane (:307). body_mxu
// in f32, body_gather (:130) and body_cumsum_mxu (:296) run in
// probe_harness_wg.cu (wgmma on a persistent grid of every SM).
//
// What bounds it on the H100: the tensor cores of one SM (4096 dense bf16
// FLOP a clock, 2048 TF32), the shared-memory reads of the B fragments,
// and the L2 reads of A into one SM. The TPU runs the harness on one core
// with its inputs in VMEM (grid (1,)); here it is one block of 256 threads
// (8 warps) on one SM, written with mma.sync (a simple first kernel;
// wgmma and TMA are later work). A, 512 KiB, exceeds a block's 227 KiB
// of shared memory: every warp reads its A fragments from L2 with
// 16-byte loads, one chunk ahead, and B sits in shared memory. Each warp
// computes tiles of 32 rows x 64 columns (2 x 8 mma tiles, 64 float32
// accumulators a thread). The k order inside a chunk is permuted so that
// a thread's A fragments and B fragments of two mma steps are 16
// consecutive bytes in memory; the product is the same sum.
//
// - mxu_bf16: m16n8k16 bf16 -> f32, B (mB, 128 KiB) resident in shared
//   memory, transposed; the factor (i & 1) + 1, a power of two, scales
//   the f32 product (the same bits as scaling a).
// - cumsum_mxu_lane: float32(a512 + i) @ triu in split TF32: each
//   element x of A is hi = x with its 13 low mantissa bits cleared plus lo
//   = x - hi rounded to TF32, two mma each, exact for |x| < 2^22; triu
//   (64 KiB) resident.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAccWords = 8 * 128;
constexpr uint32_t kHi = 0xffffe000u;   // a float's sign, exponent, 10 mantissa bits
constexpr int kBt = 272;                // words a row of a transposed bf16 B (512 k)
constexpr int kTriu = 130;              // words a row of triu (128 columns)

__device__ __forceinline__ uint32_t lcg(uint32_t x) {
  return x * 1664525u + 1013904223u;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t comp(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg4(const void* p) {
  return __ldg((const uint4*)p);
}

// ---- sinks: each thread's share, summed over the block at the end ----

struct FSink {  // float64 sum of the elements
  double s = 0.0;
  __device__ void add(float v) { s += (double)v; }
  __device__ void store(void* out, double* red) {
    double x = s;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      double tot = 0.0;
      for (int w = 0; w < kWarps; ++w) tot += red[w];
      *(double*)out = tot;
    }
  }
};

// A finished tile (rows row0 .. row0 + 31, columns col0 .. col0 + 63),
// each element times f: into the sink, and rows 0-7 into acc.
template <class Sink>
__device__ __forceinline__ void finish_tile(const float (&c)[2][8][4],
                                            float f, int row0, int col0,
                                            float* acc, Sink& sink) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) sink.add(c[m][j][q] * f);
  if (row0 == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* a = acc + g * 128 + col0 + 8 * j + 2 * t;
      a[0] = __fadd_rn(a[0], c[0][j][0] * f);
      a[1] = __fadd_rn(a[1], c[0][j][1] * f);
    }
  }
}

// ---- bf16: c += A[row0 .. +31, 0 .. 511] B[.., col0 .. +63] ----
// la(k0, a) gives a[m][h] = the 8 bf16 of A's row row0 + 16m + 8h + g at
// physical k k0 + 8t .. 8t + 7. mma step s of the chunk takes physical k
// 8t + 4s + {0, 1} as the logical 2t, 2t + 1 and 8t + 4s + {2, 3} as 2t +
// 8, 2t + 9; bt holds B transposed (bt[n * kBt + k / 2] the bf16 pair k,
// k + 1 of column n), so that one 16-byte read gives both steps' B
// fragments of a column.
template <class ALoad>
__device__ __forceinline__ void gemm_bf16(const ALoad& la,
                                          const uint32_t* bt, int col0,
                                          float (&c)[2][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* brow = bt + (col0 + g) * kBt + 4 * t;
  uint4 a[2][2];
  la(0, a);
#pragma unroll 1
  for (int k0 = 0; k0 < 512; k0 += 32) {
    uint4 an[2][2];
    la(k0 + 32 < 512 ? k0 + 32 : k0, an);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 b = *(const uint4*)(brow + 8 * j * kBt + k0 / 2);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(c[m][j], a[m][0].x, a[m][1].x, a[m][0].y, a[m][1].y, b.x,
                 b.y);
        mma_bf16(c[m][j], a[m][0].z, a[m][1].z, a[m][0].w, a[m][1].w, b.z,
                 b.w);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = an[m][0];
      a[m][1] = an[m][1];
    }
  }
}

// ---- TF32: c += A[row0 .. +31, 0 .. K) B[.., col0 .. +63] ----
// la(k0, a) gives a[m][h] = the 4 float32 (as bits) of A's row row0 + 16m
// + 8h + g at physical k k0 + 4t .. 4t + 3; mma step s of the 16-k chunk
// takes physical 4t + 2s as the logical t and 4t + 2s + 1 as t + 4. bs
// holds B as it is (bs[k * S + n]), already TF32; A's elements as hi +
// lo, two mma each.
template <int S, class ALoad>
__device__ __forceinline__ void gemm_tf32(const ALoad& la, int K,
                                          const uint32_t* bs, int col0,
                                          float (&c)[2][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint4 a[2][2];
  la(0, a);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint4 an[2][2];
    la(k0 + 16 < K ? k0 + 16 : k0, an);
    uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t x = comp(a[m][h], q);
          ah[m][h][q] = x & kHi;
          al[m][h][q] = tf32(__uint_as_float(x) - __uint_as_float(x & kHi));
        }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t* p = bs + (k0 + 4 * t + 2 * s) * S + col0 + 8 * j + g;
        const uint32_t bh0 = p[0], bh1 = p[S];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_tf32(c[m][j], ah[m][0][2 * s], ah[m][1][2 * s],
                   ah[m][0][2 * s + 1], ah[m][1][2 * s + 1], bh0, bh1);
          mma_tf32(c[m][j], al[m][0][2 * s], al[m][1][2 * s],
                   al[m][0][2 * s + 1], al[m][1][2 * s + 1], bh0, bh1);
        }
      }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = an[m][0];
      a[m][1] = an[m][1];
    }
  }
}

// ---- A loaders: the rows row0 + 16m + 8h + g of a thread ----

struct RowsBf16 {  // bf16 (rows, 512), 8 at k0 + 8t
  const uint16_t* a;
  int row0;
  __device__ void operator()(int k0, uint4 (&out)[2][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        out[m][h] = ldg4(a + (row0 + 16 * m + 8 * h + g) * 512 + k0 + 8 * t);
  }
};

struct RowsInt {  // float32(a + i) of int32 (rows, 128), 4 at k0 + 4t
  const int* a;
  uint32_t i;
  int row0;
  __device__ void operator()(int k0, uint4 (&out)[2][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v =
            ldg4(a + (row0 + 16 * m + 8 * h + g) * 128 + k0 + 4 * t);
        out[m][h] = make_uint4(__float_as_uint(__int2float_rn((int)(v.x + i))),
                               __float_as_uint(__int2float_rn((int)(v.y + i))),
                               __float_as_uint(__int2float_rn((int)(v.z + i))),
                               __float_as_uint(__int2float_rn((int)(v.w + i))));
      }
  }
};

// bf16 (512, 128) row-major into bt, transposed (once a launch)
__device__ void stage_bt(const void* p, uint32_t* bt) {
  const uint16_t* src = (const uint16_t*)p;
  uint16_t* dst = (uint16_t*)bt;
  for (int e = threadIdx.x; e < 512 * 128; e += kThreads) {
    const int k = e & 511, n = e >> 9;
    dst[n * 2 * kBt + k] = src[k * 128 + n];
  }
}

// ---- the bodies: Work is the words of shared memory each takes ----

struct MxuBf16 {  // :115, (a * ((i & 1) + 1)) @ b, bf16
  using Sink = FSink;
  static constexpr int kWork = 128 * kBt;
  static __device__ void prologue(const void*, const void* p1, uint32_t* w) {
    stage_bt(p1, w);
  }
  static __device__ void iteration(int i, const void* p0, const void*,
                                   uint32_t* w, float* acc, Sink& sk) {
    const float f = (float)((i & 1) + 1);
    for (int tile = threadIdx.x >> 5; tile < 32; tile += kWarps) {
      const int row0 = (tile & 15) * 32, col0 = (tile >> 4) * 64;
      float c[2][8][4] = {};
      gemm_bf16(RowsBf16{(const uint16_t*)p0, row0}, w, col0, c);
      finish_tile(c, f, row0, col0, acc, sk);
    }
  }
};

struct CumsumMxuLane {  // :307, float32(a512 + i) @ triu, A in split TF32
  using Sink = FSink;
  static constexpr int kWork = 128 * kTriu;
  static __device__ void prologue(const void*, const void* p1, uint32_t* w) {
    const float* triu = (const float*)p1;
    for (int e = threadIdx.x; e < 128 * 128; e += kThreads)
      w[(e >> 7) * kTriu + (e & 127)] = tf32(triu[e]);
  }
  static __device__ void iteration(int i, const void* p0, const void*,
                                   uint32_t* w, float* acc, Sink& sk) {
    for (int tile = threadIdx.x >> 5; tile < 32; tile += kWarps) {
      const int row0 = (tile & 15) * 32, col0 = (tile >> 4) * 64;
      float c[2][8][4] = {};
      gemm_tf32<kTriu>(
          RowsInt{(const int*)p0, (uint32_t)i, row0}, 128, w, col0, c);
      finish_tile(c, 1.f, row0, col0, acc, sk);
    }
  }
};

template <class Body>
__global__ void __launch_bounds__(kThreads, 1)
    tc_kernel(const void* __restrict__ in0, const void* __restrict__ in1,
              int r, float* __restrict__ out, void* __restrict__ sink) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ double red[kWarps];
  float* acc = (float*)smem;
  uint32_t* work = smem + kAccWords;
  for (int q = threadIdx.x; q < kAccWords; q += kThreads) acc[q] = 0.f;
  Body::prologue(in0, in1, work);
  __syncthreads();
  typename Body::Sink sk;
  for (int i = 0; i < r; ++i) Body::iteration(i, in0, in1, work, acc, sk);
  __syncthreads();
  for (int q = threadIdx.x; q < kAccWords; q += kThreads) out[q] = acc[q];
  sk.store(sink, red);
}

template <class Body>
int launch(const void* in0, const void* in1, int r, void* out, void* sink,
           cudaStream_t stream) {
  const int bytes = (kAccWords + Body::kWork) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      tc_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  tc_kernel<Body><<<1, kThreads, bytes, stream>>>(in0, in1, r, (float*)out,
                                                  sink);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0 mxu_bf16, 1 cumsum_mxu_lane (the order of the bodies
// of this source in lz4_sgori_torch.probes.microbench2.BODIES); in0, in1:
// the body's inputs; out: (8, 128) float32; sink: one float64.
extern "C" int lz4t_probe_harness_tc(int body, const void* in0,
                                     const void* in1, int r, void* out,
                                     void* sink, void* stream) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case 0: return launch<MxuBf16>(in0, in1, r, out, sink, st);
    case 1: return launch<CumsumMxuLane>(in0, in1, r, out, sink, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

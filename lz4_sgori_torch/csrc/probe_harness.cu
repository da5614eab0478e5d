// T14a, the primitive-rate harness: from acc = 0 ((8, 128) float32, one
// cell a thread, in a register), each iteration i of 0 .. r-1 computes one
// body's whole result from the read-only inputs and adds its rows [:8]
// (or a row or column of it, broadcast) into acc, one float32 add an
// iteration in iteration order. sink is the wrapping 32-bit sum, over all
// iterations, of every element of the whole result (a float by its bit
// pattern), so that no part of the result can be left out. int32 arithmetic wraps
// (uint32_t: signed overflow is undefined in C++) and >> is arithmetic
// (int); lcg(x) = x * 1664525 + 1013904223.
//
// Replaces tools/microbench2.py:_harness.kernel (:40, the pallas_call of
// _harness.run at :60) with eleven of the bodies of its main() that run
// on the vector unit (:105-284); body_ohbuild (:144), body_red1 (:168),
// body_transpose (:318) and body_shiftsel (:327) run on every SM in
// probe_harness_wg.cu. Each body is a template argument of one kernel.
//
// What bounds it on the H100: the bodies' instructions at one SM's issue
// rate (4 schedulers, 32 lanes each a clock), L2 reads into one SM for
// the 256 KiB passes, and for the small bodies (fori, dynrow, statrow) the
// loop's own latency. The TPU runs the harness on one core with its
// inputs in VMEM (grid (1,)); here it is one block of 1024 threads on one
// SM, its inputs read through L1 and L2 every iteration: a512 (256 KiB)
// exceeds a block's 227 KiB of shared memory. The kernel computes the
// function, not the TPU's mechanism: a lane roll by a runtime amount is
// one indexed read, a one-hot select one read, the log-shift cumsum a
// prefix sum, eight chained rolls a cascade of eight adds over a sliding
// window of rows or lanes. Where acc's rows come from other threads than
// the cell's own, they pass through shared memory, double-buffered by
// iteration parity so that one barrier an iteration orders its writes and
// reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;   // one thread a cell of acc: row t >> 7, lane t & 127
constexpr int kShared = 2048;    // words of a parity's shared scratch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t lcg(uint32_t x) {
  return x * 1664525u + 1013904223u;
}

__device__ __forceinline__ float as_float(uint32_t x) {
  return __int2float_rn((int)x);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// Every body: step(i, t, in0, in1, s, sink) computes iteration i's whole
// result (thread t its share), adds its elements into sink and returns
// what enters acc's cell (t >> 7, t & 127). s is the iteration's shared
// scratch (kShared words).

// a512 tiles (512, 128): thread t holds lane c = t & 127 of rows r0 + 8k,
// r0 = t >> 7, k = 0..63, so its row k = 0 is its own cell of acc, and a
// warp reads 32 neighbouring words of a row.

struct Vpu {  // :105, x = a512 + i; 8x x = (x ^ (x + 1)) + (x >> 1)
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t*, uint32_t& sink) {
    const int* a = (const int*)p0;
    const int c = t & 127, r0 = t >> 7;
    float mine = 0.f;
#pragma unroll 4
    for (int k = 0; k < 64; ++k) {
      uint32_t x = (uint32_t)a[(r0 + 8 * k) * 128 + c] + (uint32_t)i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x = (x ^ (x + 1u)) + (uint32_t)((int)x >> 1);
      sink += x;
      if (k == 0) mine = as_float(x);
    }
    return mine;
  }
};

struct Extract {  // :155, g2048[r, lcg(ids[r] + i) & 127] for 2048 rows
  static __device__ float step(int i, int t, const void* p0, const void* p1,
                               uint32_t* s, uint32_t& sink) {
    const float* g = (const float*)p0;
    const int* ids = (const int*)p1;
    for (int q = t; q < 2048; q += kThreads) {
      const uint32_t col = lcg((uint32_t)ids[q] + (uint32_t)i) & 127;
      const uint32_t v = __float_as_uint(g[q * 128 + col]);
      sink += v;
      if (q < 8) s[q] = v;
    }
    __syncthreads();
    return __uint_as_float(s[t >> 7]);
  }
};

struct Red0 {  // :175, the 128 column sums of a512 + i
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t* s, uint32_t& sink) {
    const int* a = (const int*)p0;
    const int c = t & 127, r0 = t >> 7;
    uint32_t part = 0;
#pragma unroll 8
    for (int k = 0; k < 64; ++k)
      part += (uint32_t)a[(r0 + 8 * k) * 128 + c] + (uint32_t)i;
    s[t] = part;
    __syncthreads();
    uint32_t col = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) col += s[q * 128 + c];
    if (r0 == 0) sink += col;
    return as_float(col);
  }
};

struct Bitroll {  // :183, row r of a512 rolled left by lcg(amt[r] + i) & 127
  static __device__ float step(int i, int t, const void* p0, const void* p1,
                               uint32_t*, uint32_t& sink) {
    const int* a = (const int*)p0;
    const int* amt = (const int*)p1;
    const int c = t & 127, r0 = t >> 7;
    float mine = 0.f;
#pragma unroll 4
    for (int k = 0; k < 64; ++k) {
      const int row = r0 + 8 * k;
      const uint32_t sh = lcg((uint32_t)amt[row] + (uint32_t)i) & 127;
      const uint32_t x = (uint32_t)a[row * 128 + ((c + sh) & 127)];
      sink += x;
      if (k == 0) mine = as_float(x);
    }
    return mine;
  }
};

// :197, 8x x = x + roll(x, 1, 0) of a512 + i: row r takes row r - 1,
// cyclic. Thread t streams lane c = t & 127 of rows 64q .. 64q + 63, q =
// t >> 7, through a cascade of eight adds (stage j keeps its last input),
// starting 8 rows early so that every stage is warm.
struct Sroll {
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t* s, uint32_t& sink) {
    const int* a = (const int*)p0;
    const int c = t & 127, q = t >> 7;
    uint32_t prev[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < 72; ++k) {
      const int row = (64 * q - 8 + k) & 511;
      uint32_t y = (uint32_t)a[row * 128 + c] + (uint32_t)i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t next = y + prev[j];
        prev[j] = y;
        y = next;
      }
      if (k >= 8) {
        sink += y;
        if (q == 0 && k < 16) s[(k - 8) * 128 + c] = y;
      }
    }
    __syncthreads();
    return as_float(s[t]);
  }
};

// :206, 8x x = x + roll(x, 1, 1) of a512 + i: lane c takes lane c - 1,
// cyclic. A warp a row, 4 lanes a thread; the lane before a thread's first
// comes from the thread before it.
struct Lroll {
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t* s, uint32_t& sink) {
    const int4* a = (const int4*)p0;
    const int lane = t & 31, w = t >> 5;
    const uint32_t ui = (uint32_t)i;
    for (int k = 0; k < 16; ++k) {
      const int row = w + 32 * k;
      const int4 v = a[row * 32 + lane];
      uint32_t x0 = (uint32_t)v.x + ui, x1 = (uint32_t)v.y + ui;
      uint32_t x2 = (uint32_t)v.z + ui, x3 = (uint32_t)v.w + ui;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t left = __shfl_sync(kFull, x3, (lane + 31) & 31);
        x3 += x2;
        x2 += x1;
        x1 += x0;
        x0 += left;
      }
      sink += x0 + x1 + x2 + x3;
      if (row < 8) {
        uint32_t* o = s + row * 128 + 4 * lane;
        o[0] = x0;
        o[1] = x1;
        o[2] = x2;
        o[3] = x3;
      }
    }
    __syncthreads();
    return as_float(s[t]);
  }
};

struct Vlookup {  // :216, tbl[lcg(idx1[c] + i) & 127, c] for 512 columns
  static __device__ float step(int i, int t, const void* p0, const void* p1,
                               uint32_t* s, uint32_t& sink) {
    const int* tbl = (const int*)p0;
    const int* idx = (const int*)p1;
    if (t < 512) {
      const uint32_t row = lcg((uint32_t)idx[t] + (uint32_t)i) & 127;
      const uint32_t v = (uint32_t)tbl[row * 512 + t];
      sink += v;
      if (t < 128) s[t] = v;
    }
    __syncthreads();
    return as_float(s[t & 127]);
  }
};

struct Fori {  // :257, small
  static __device__ float step(int, int t, const void* p0, const void*,
                               uint32_t*, uint32_t& sink) {
    const uint32_t v = (uint32_t)((const int*)p0)[t];
    sink += v;
    return as_float(v);
  }
};

struct Dynrow {  // :265, a512[row:row + 8], row = (37 i) & 255
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t*, uint32_t& sink) {
    const int row = (int)(((uint32_t)i * 37u) & 255u);
    const uint32_t v = (uint32_t)((const int*)p0)[row * 128 + t];
    sink += v;
    return as_float(v);
  }
};

struct Statrow {  // :275, a512[8:16] + i
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t*, uint32_t& sink) {
    const uint32_t v = (uint32_t)((const int*)p0)[8 * 128 + t] + (uint32_t)i;
    sink += v;
    return as_float(v);
  }
};

// :284, the inclusive prefix sum down the rows of a512 + i. Thread t scans
// lane c = t & 127 of rows 64q .. 64q + 63, q = t >> 7: once for the
// chunk's total, then again from the totals of the chunks above it.
struct CumsumShift {
  static __device__ float step(int i, int t, const void* p0, const void*,
                               uint32_t* s, uint32_t& sink) {
    const int* a = (const int*)p0 + (64 * (t >> 7)) * 128 + (t & 127);
    const int c = t & 127, q = t >> 7;
    const uint32_t ui = (uint32_t)i;
    uint32_t run = 0;
#pragma unroll 8
    for (int k = 0; k < 64; ++k) run += (uint32_t)a[k * 128] + ui;
    s[t] = run;
    __syncthreads();
    run = 0;
    for (int p = 0; p < q; ++p) run += s[p * 128 + c];
#pragma unroll 8
    for (int k = 0; k < 64; ++k) {
      run += (uint32_t)a[k * 128] + ui;
      sink += run;
      if (q == 0 && k < 8) s[1024 + k * 128 + c] = run;
    }
    __syncthreads();
    return as_float(s[1024 + t]);
  }
};

template <class Body>
__global__ void __launch_bounds__(kThreads)
    harness_kernel(const void* __restrict__ in0, const void* __restrict__ in1,
                   int r, float* __restrict__ out, int* __restrict__ sink) {
  __shared__ uint32_t scratch[2][kShared];
  __shared__ uint32_t warp_sinks[kThreads / 32];
  const int t = threadIdx.x;
  float acc = 0.f;
  uint32_t sk = 0;
  for (int i = 0; i < r; ++i)
    acc = __fadd_rn(acc, Body::step(i, t, in0, in1, scratch[i & 1], sk));
  out[t] = acc;
  sk = warp_sum(sk);
  if ((t & 31) == 0) warp_sinks[t >> 5] = sk;
  __syncthreads();
  if (t < 32) {
    sk = warp_sum(warp_sinks[t]);
    if (t == 0) *sink = (int)sk;
  }
}

template <class Body>
int launch(const void* in0, const void* in1, int r, void* out, void* sink,
           cudaStream_t stream) {
  harness_kernel<Body><<<1, kThreads, 0, stream>>>(in0, in1, r, (float*)out,
                                                   (int*)sink);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0-10 in the order of this source's bodies in
// lz4_sgori_torch.probes.microbench2.BODIES;
// in0, in1: the body's inputs (in1 null for a body of one); out: (8, 128)
// float32; sink: one int32.
extern "C" int lz4t_probe_harness(int body, const void* in0, const void* in1,
                                  int r, void* out, void* sink,
                                  void* stream) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case 0: return launch<Vpu>(in0, in1, r, out, sink, st);
    case 1: return launch<Extract>(in0, in1, r, out, sink, st);
    case 2: return launch<Red0>(in0, in1, r, out, sink, st);
    case 3: return launch<Bitroll>(in0, in1, r, out, sink, st);
    case 4: return launch<Sroll>(in0, in1, r, out, sink, st);
    case 5: return launch<Lroll>(in0, in1, r, out, sink, st);
    case 6: return launch<Vlookup>(in0, in1, r, out, sink, st);
    case 7: return launch<Fori>(in0, in1, r, out, sink, st);
    case 8: return launch<Dynrow>(in0, in1, r, out, sink, st);
    case 9: return launch<Statrow>(in0, in1, r, out, sink, st);
    case 10: return launch<CumsumShift>(in0, in1, r, out, sink, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

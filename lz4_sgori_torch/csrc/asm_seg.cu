// Segment assembly: concatenate each block's 3*nseg pieces into one LZ4
// block, the row written in 16-byte words by CTAs over (block, chunk).
//
// Replaces lz4_sgori_tpu/ops/pallas/asm_seg.py:_asm_kernel, which steps
// 128 blocks in piece lockstep through a VMEM staging ring and needs the
// whole per-lane source column in VMEM (so the JAX engine keeps a
// dynamic_update_slice fallback for big blocks). Here one kernel serves
// every block size.
//
// Contract (golden.assemble_seg_parts, lz4_sgori_tpu/golden.py:587-607):
//   out = for k in 0..nseg-1: stream_k[:slen_k] + hdr_k[:hlen_k]
//                              + raw[tail_k : tail_k + tl_k]
//   out_len = total length (may exceed the output capacity: the caller
//   then folds the block to an error); bytes at or past out_len up to
//   the capacity are zero, as the decoder's input contract requires.
//   plan[b, k] = (slen_k, hlen_k, tail_k, tl_k), every length >= 0; the
//   plan's rows start 16-byte aligned (the wrapper's check).
//
// The grid. Row b starts at out + b * ocap, head = that address mod 16
// bytes past the 16-byte word it starts in (ocap = compress_bound + 8 is
// not a multiple of 16). Row byte o lies at x = head + o of the aligned
// run from that word, and CTA (b, c) writes x in [c * kChunk, (c + 1) *
// kChunk) of row b: 128 CTAs of 1 MiB blocks become some 16,500, which
// fill every SM many times over (8 KiB chunks: 1.02-1.07x faster than 16
// KiB over configs 1, 5 and 6, probes.encode_pace). Each CTA loads its block's plan (a
// 16-byte load a segment) and scans the 3 * nseg piece lengths with warp
// shuffles into shared memory (the pieces' start offsets, at most 385).
//
// The words. Each thread writes whole 16-byte words of its chunk; the
// row's unaligned first and last bytes are written a byte at a time, as
// K1's row write does (lz4_decode_ring.cuh). A word at or past the length
// is zeros and reads nothing. A word inside one piece finds it by a
// binary search over the offsets and takes its 16 bytes from two aligned
// 16-byte loads of the piece (funnel shifts); a word that spans pieces
// or the length gathers its bytes one by one, stepping from piece to
// piece. Bytes past ocap are dropped.
//
// What bounds it on the H100: byte movement, each piece read once and
// every row written whole (mostly zeros past the length: config 6's rows
// are some 30% pieces), so the bound is (pieces + nb * ocap) bytes over
// the memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace asm_seg {

constexpr int kMaxSeg = 128;
constexpr int kThreads = 256;
constexpr int kChunk = 8192;           // row bytes a CTA (a multiple of 16)

struct Block {
  const uint8_t* streams;              // this block's first stream row
  const uint8_t* hdr;                  // and header row
  const uint8_t* raw;                  // its raw bytes
  const int* offs;                     // 3 * nseg + 1 piece offsets
  const int* tail;                     // nseg raw tail starts
  int scap, hmax, total;

  // Piece p's first byte.
  __device__ __forceinline__ const uint8_t* src(int p) const {
    const int k = p / 3, j = p - 3 * k;
    return j == 0 ? streams + (size_t)k * scap
         : j == 1 ? hdr + (size_t)k * hmax : raw + tail[k];
  }

  // The piece that holds byte o (0 <= o < total): the last p with
  // offs[p] <= o, so an empty piece is never taken.
  __device__ __forceinline__ int find(int o, int np) const {
    int lo = 0, hi = np;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offs[mid] <= o) lo = mid; else hi = mid;
    }
    return lo;
  }

  // Row byte o, stepping p forward to its piece (o at or past p's start).
  __device__ __forceinline__ uint8_t byte(int o, int& p) const {
    if (o >= total) return 0;
    while (o >= offs[p + 1]) p++;
    return src(p)[o - offs[p]];
  }
};

// 16 bytes from p: the two aligned 16-byte words that hold them, shifted.
// Only words that hold one of the 16 bytes are read.
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  const uint4* a = (const uint4*)((uintptr_t)p & ~(uintptr_t)15);
  const int sh = (int)((uintptr_t)p & 15);
  const uint4 w0 = __ldg(a);
  if (sh == 0) return w0;
  const uint4 w1 = __ldg(a + 1);
  const uint32_t u[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int q = sh >> 2, r = 8 * (sh & 3);
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; i++)           // u[q + i], with no local memory
    v[i] = q == 0 ? u[i] : q == 1 ? u[i + 1] : q == 2 ? u[i + 2] : u[i + 3];
  return make_uint4(__funnelshift_r(v[0], v[1], r),
                    __funnelshift_r(v[1], v[2], r),
                    __funnelshift_r(v[2], v[3], r),
                    __funnelshift_r(v[3], v[4], r));
}

// The 16 row bytes from o (o >= 0, 16-byte aligned in memory).
__device__ __forceinline__ uint4 word(const Block& b, int o, int np) {
  if (o >= b.total) return make_uint4(0, 0, 0, 0);
  int p = b.find(o, np);
  if (o + 16 <= b.offs[p + 1]) return load16(b.src(p) + (o - b.offs[p]));
  union { uint4 v; uint8_t c[16]; } u;
#pragma unroll
  for (int i = 0; i < 16; i++) u.c[i] = b.byte(o + i, p);
  return u.v;
}

// The block's piece offsets and tail starts into shared memory: thread k
// < nseg loads segment k's plan row in one 16-byte load, the first four
// warps scan the segments' totals (shuffles in a warp, then the warps'
// sums), and thread k writes its three pieces' offsets.
__device__ void load_plan(const int* __restrict__ pl, int nseg, int* offs,
                          int* tail) {
  __shared__ int wsum[kMaxSeg / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int4 r = make_int4(0, 0, 0, 0);
  if (t < nseg) r = __ldg((const int4*)pl + t);
  const int v = r.x + r.y + r.w;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, d);
    incl += lane >= d ? n : 0;
  }
  if (lane == 31 && warp < kMaxSeg / 32) wsum[warp] = incl;
  __syncthreads();
  if (t < nseg) {
    int ex = incl - v;
    for (int w = 0; w < warp; w++) ex += wsum[w];
    offs[3 * t] = ex;
    offs[3 * t + 1] = ex + r.x;
    offs[3 * t + 2] = ex + r.x + r.y;
    tail[t] = r.z;
    if (t == nseg - 1) offs[3 * nseg] = ex + v;
  }
  if (nseg == 0 && t == 0) offs[0] = 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
asm_seg_kernel(const uint8_t* __restrict__ streams,
               const uint8_t* __restrict__ hdr,
               const uint8_t* __restrict__ raw,
               const int* __restrict__ plan, uint8_t* __restrict__ out,
               int* __restrict__ out_len, int nseg, int scap, int hmax,
               int bs, int ocap) {
  __shared__ int offs[3 * kMaxSeg + 1];
  __shared__ int tail[kMaxSeg];
  const int blk = blockIdx.x, chunk = blockIdx.y;
  uint8_t* dst = out + (size_t)blk * ocap;
  const int head = (int)((uintptr_t)dst & 15);
  const int x0 = max(chunk * kChunk, head);
  const int x1 = min((chunk + 1) * kChunk, head + ocap);
  if (x0 >= x1) return;                 // past the row (its last chunk)
  load_plan(plan + (size_t)blk * nseg * 4, nseg, offs, tail);
  const size_t row = (size_t)blk * nseg;
  const Block b{streams + row * scap, hdr + row * hmax,
                raw + (size_t)blk * bs, offs, tail, scap, hmax,
                offs[3 * nseg]};
  const int np = 3 * nseg;
  if (chunk == 0 && threadIdx.x == 0) out_len[blk] = b.total;
  uint8_t* g = dst - head;              // x is g's byte
  const int v0 = min((x0 + 15) & ~15, x1), v1 = max(x1 & ~15, v0);
  // the unaligned first and last bytes, then every word
  if (threadIdx.x < 32) {
    const int x = threadIdx.x < 16 ? x0 + threadIdx.x
                                   : v1 + threadIdx.x - 16;
    if (threadIdx.x < 16 ? x < v0 : x < x1) {
      int p = x - head < b.total ? b.find(x - head, np) : 0;
      g[x] = b.byte(x - head, p);
    }
  }
  for (int x = v0 + 16 * threadIdx.x; x < v1; x += 16 * kThreads)
    *(uint4*)(g + x) = word(b, x - head, np);
}

}  // namespace asm_seg

extern "C" int lz4t_asm_seg(const void* streams, const void* hdr,
                            const void* raw, const void* plan, void* out,
                            void* out_len, int nb, int nseg, int scap,
                            int hmax, int bs, int ocap, void* stream) {
  using namespace asm_seg;
  if (nseg > kMaxSeg || ((uintptr_t)plan & 15))
    return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    const dim3 grid(nb, (15 + ocap + kChunk - 1) / kChunk);
    asm_seg_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, (const uint8_t*)hdr, (const uint8_t*)raw,
        (const int*)plan, (uint8_t*)out, (int*)out_len, nseg, scap, hmax, bs,
        ocap);
  }
  return (int)cudaGetLastError();
}

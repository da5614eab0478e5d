// T2, the retired scalar LZ4 block decoder: one warp per block.
//
// Replaces tools/retired/decode_kernel.py:_decode_kernel (the pallas_call
// at :215), which walks one block per grid cell on the TPU's scalar core
// over SMEM mirrors of the stream and of a zeroed output.
//
// Contract: that kernel's (out, out_len, err), error rows included. err
// and out_len are golden.decompress's (out_len 0 on error), but an error
// row keeps what the walk wrote before the fault, where K1 zeroes it:
//   - bytes past slot read as 0 (the TPU's zero-padded mirror), and an
//     LSIC run may read on past clen;
//   - literals are copied clipped to min(clen - ip, out_size - op) even
//     when they fault (decode_kernel.py:130-139);
//   - when an LSIC run has carried ip past clen, that clip is negative;
//     the TPU's masked tail copy then takes an all-ones mask (a shift by
//     a negative count gives 0), so the 4 bytes at ip land at op;
//   - a match is copied only when no fault was seen;
//   - every other byte of the row is zero.
// A sequence whose literals end at clen ends the block; clen == 0 and a
// walk that ends without that sequence are errors.
//
// What bounds it on the H100: as K1 (lz4_decode.cuh), a serial chain of
// dependent byte loads per block, so a block is latency-bound and the
// kernel is bound by the warps in flight. The walk is uniform across the
// warp (broadcast loads); the lanes split the literal and match copies,
// and the output goes straight to global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int rb(const uint8_t* __restrict__ src, int p,
                                  int slot) {
  return p < slot ? src[p] : 0;
}

// An LSIC run from ip: adds bytes while they are 255. Returns the new ip.
__device__ __forceinline__ int read_lsic(const uint8_t* __restrict__ src,
                                         int ip, int slot, int* len) {
  int b;
  do {
    b = rb(src, ip++, slot);
    *len += b;
  } while (b == 255);
  return ip;
}

__global__ void retired_decode_kernel(const uint8_t* __restrict__ comp,
                                      const int* __restrict__ clen,
                                      uint8_t* out, int* __restrict__ out_len,
                                      uint8_t* __restrict__ err, int nb,
                                      int slot, int n) {
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= nb) return;
  const uint8_t* src = comp + (size_t)blk * slot;
  uint8_t* dst = out + (size_t)blk * n;
  const int cl = clen[blk];
  int ip = 0, op = 0, wend = 0;          // wend: end of the bytes written
  bool done = cl == 0, bad = cl == 0;
  while (!done && !bad && ip < cl) {
    const int token = rb(src, ip++, slot);
    int lit = token >> 4;
    if (lit == 15) ip = read_lsic(src, ip, slot, &lit);
    if (lit > cl - ip || lit > n - op) bad = true;
    const int lit_s = min(lit, min(cl - ip, n - op));
    if (lit_s >= 0) {
      for (int i = lane; i < lit_s; i += 32) dst[op + i] = rb(src, ip + i, slot);
      wend = max(wend, op + lit_s);
    } else {
      for (int i = lane; i < 4; i += 32)
        if (op + i < n) dst[op + i] = rb(src, ip + i, slot);
      wend = max(wend, min(op + 4, n));
    }
    ip += lit_s;
    op += lit_s;
    done = ip == cl;
    if (done) break;
    const int off = rb(src, ip, slot) | rb(src, ip + 1, slot) << 8;
    ip += 2;
    int ml = token & 15;
    if (ml == 15) ip = read_lsic(src, ip, slot, &ml);
    ml += 4;
    if (off == 0 || off > op || ip > cl || ml > n - op) bad = true;
    if (!bad) {
      __syncwarp();
      for (int i = lane; i < ml; i += 32)
        dst[op + i] = dst[op - off + (off >= ml ? i : i % off)];
      wend = op + ml;
    }
    op += ml;
  }
  if (!done) bad = true;
  __syncwarp();
  for (int o = wend + lane; o < n; o += 32) dst[o] = 0;
  if (lane == 0) {
    out_len[blk] = bad ? 0 : op;
    err[blk] = bad ? 1 : 0;
  }
}

}  // namespace

// One warp per block, four blocks per CTA.
extern "C" int lz4t_retired_decode(const void* comp, const void* clen,
                                   void* out, void* out_len, void* err, int nb,
                                   int slot, int out_size, void* stream) {
  if (nb > 0) {
    const int threads = 128;
    const int blocks = (nb + threads / 32 - 1) / (threads / 32);
    retired_decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)clen, (uint8_t*)out, (int*)out_len,
        (uint8_t*)err, nb, slot, out_size);
  }
  return (int)cudaGetLastError();
}

// The safe LZ4 block decode shared by K1 (decode_v7.cu), K5
// (decode_v6.cu), K6 (decode_v8.cu) and the chained T3 (decode_v9.cu): one
// warp per block (decode_block_warp; T3's warp walks several in turn).
//
// Contract (golden.decompress, lz4_sgori_tpu/golden.py:194-261):
//   err = 1 exactly when golden.decompress(comp[:clen], out_size) raises;
//   then out_len = 0 and the output row is all zero. Otherwise out_len is
//   the decoded length and bytes past it are zero. clen outside
//   [1, slot] is an error. The kernel never reads comp past clen.
//
// The walk is uniform across the warp (every lane parses the same bytes,
// a broadcast load, so no shuffles are needed) and the 32 lanes split the
// byte copies. An overlapping match (offset < length) copies in parallel
// through src(o) = m - d + (o - m) mod d, which always points before the
// match start m (lz4_sgori_tpu/ops/decode.py:20-27), so one __syncwarp
// before each match makes every source byte visible.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Decodes one block (src, ilen bytes of a slot-byte row) into dst with
// the calling warp, all 32 lanes together; lane is the caller's lane.
// Returns the decoded length, or -1 on error.
__device__ __forceinline__ int decode_block_warp(
    const uint8_t* __restrict__ src, int ilen, int slot, uint8_t* dst,
    int out_size, int lane) {
  bool bad = ilen <= 0 || ilen > slot;   // ilen == 0: golden "empty input"
  int ip = 0, op = 0;
  while (!bad) {
    if (ip >= ilen) { bad = true; break; }           // missing token
    const int token = src[ip++];
    int lit = token >> 4;
    if (lit == 15) {
      for (;;) {
        if (ip >= ilen) { bad = true; break; }       // truncated LSIC
        const int b = src[ip++];
        lit += b;
        if (b != 255) break;
      }
      if (bad) break;
    }
    if (lit > ilen - ip) { bad = true; break; }      // literals past input
    if (lit > out_size - op) { bad = true; break; }  // past capacity
    for (int i = lane; i < lit; i += 32) dst[op + i] = src[ip + i];
    ip += lit;
    op += lit;
    if (ip == ilen) break;                           // terminal sequence
    if (ip + 2 > ilen) { bad = true; break; }        // truncated offset
    const int off = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    if (off == 0 || off > op) { bad = true; break; } // outside output
    int ml = (token & 15) + 4;
    if ((token & 15) == 15) {
      for (;;) {
        if (ip >= ilen) { bad = true; break; }       // truncated LSIC
        const int b = src[ip++];
        ml += b;
        if (b != 255) break;
      }
      if (bad) break;
    }
    if (ml > out_size - op) { bad = true; break; }   // past capacity
    __syncwarp();
    for (int i = lane; i < ml; i += 32)
      dst[op + i] = dst[op - off + (off >= ml ? i : i % off)];
    op += ml;
  }
  __syncwarp();
  for (int o = bad ? lane : op + lane; o < out_size; o += 32) dst[o] = 0;
  return bad ? -1 : op;
}

__device__ __forceinline__ void store_result(int n, int blk, int lane,
                                             int* __restrict__ out_len,
                                             uint8_t* __restrict__ err) {
  if (lane == 0) {
    out_len[blk] = n < 0 ? 0 : n;
    err[blk] = n < 0 ? 1 : 0;
  }
}

__global__ void decode_warp_kernel(const uint8_t* __restrict__ comp,
                                   const int* __restrict__ clen,
                                   uint8_t* out, int* __restrict__ out_len,
                                   uint8_t* __restrict__ err, int nb,
                                   int slot, int out_size) {
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= nb) return;
  const int n = decode_block_warp(comp + (size_t)blk * slot, clen[blk], slot,
                                  out + (size_t)blk * out_size, out_size,
                                  lane);
  store_result(n, blk, lane, out_len, err);
}

// One warp per block, four blocks per CTA.
static inline int launch_decode_warp(const void* comp, const void* clen,
                                     void* out, void* out_len, void* err,
                                     int nb, int slot, int out_size,
                                     void* stream) {
  if (nb > 0) {
    const int threads = 128;
    const int blocks = (nb + threads / 32 - 1) / (threads / 32);
    decode_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)clen, (uint8_t*)out, (int*)out_len,
        (uint8_t*)err, nb, slot, out_size);
  }
  return (int)cudaGetLastError();
}

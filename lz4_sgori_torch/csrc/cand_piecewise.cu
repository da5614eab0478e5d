// Piecewise pass-1 candidates for blocks above 64 KiB (K9), one warp per
// (block, half-piece).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_piecewise_cand,
// which runs the bitonic-sort _cand_kernel once per 64 KiB piece and once
// more over half-piece-shifted straddle stretches (its sort keys hold
// 16-bit positions), then merges the two passes, nearer candidate first.
//
// Contract (golden.dense_candidates_piecewise(src, piece, hashlog=16)):
// with H = piece / 2 and p in half-piece h = p / H, that merge equals
//   cand[p] = p - q for the latest q in [max(0, (h-1)*H), p) with
//   hash16(read32(q)) == hash16(read32(p)), q and p in [0, n-4];
//   0 where there is none and for every p > n-4.
// (Half-piece h lies in one piece pass and one straddle pass; their
// windows are [(h-1)*H, p) and [h*H, p), in either order.) Distances stay
// below 2*H <= 65,536 by construction.
//
// So one CTA of one warp serves half-piece h: it clears the 2^16-entry
// hash table, inserts the positions of [(h-1)*H, h*H) without writing
// them, then writes cand[p] for p in [h*H, min((h+1)*H, bs)), all with
// K2's warp step (hash_cand.cuh). It reads read32 straight from the
// block row: no padded piece copies, no straddle buffer, no merge pass.
// Table entries are positions relative to the CTA's first position
// (h-1)*H, so they run up to 2*H - 1 <= 65,535: the uint16 entry wraps to
// "empty" only at the CTA's last position, which no later position reads.
//
// What bounds it on the H100: as K2, the 128 KiB table gives one CTA per
// SM, and each CTA's insertions are sequential. A CTA steps 2*H positions
// and clears the table once, so 1 MiB blocks take 32 CTAs each, about 31
// waves of 132 for 128 MiB. A half-piece past the last full read32 only
// writes zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_cand.cuh"

__global__ void cand_piecewise_kernel(const uint8_t* __restrict__ raw,
                                      const int* __restrict__ raw_len,
                                      int* __restrict__ cand, int bs,
                                      int half, int nhalf) {
  extern __shared__ uint16_t table[];
  const int blk = blockIdx.x / nhalf;
  const int h = blockIdx.x - blk * nhalf;
  const int lane = threadIdx.x;
  const uint8_t* src = raw + (size_t)blk * bs;
  int* out = cand + (size_t)blk * bs;
  const int n = min(max(raw_len[blk], 0), bs);
  const int npos = n - 3;                 // positions with a full read32
  const int mid = h * half;
  const int end = min(mid + half, bs);
  if (mid >= npos) {
    for (int p = mid + lane; p < end; p += 32) out[p] = 0;
    return;
  }
  const int origin = max(mid - half, 0);
  clear_cand_table(table, lane);
  for (int base = origin; base < mid; base += 32)       // warm, no writes
    hash_cand_step(src, base + lane, npos, origin, table, lane);
  for (int base = mid; base < end; base += 32) {
    const int p = base + lane;
    const int d = hash_cand_step(src, p, npos, origin, table, lane);
    if (p < end) out[p] = d;
  }
}

extern "C" int lz4t_cand_piecewise(const void* raw, const void* raw_len,
                                   void* cand, int nb, int bs, int half,
                                   void* stream) {
  if (half <= 0 || half % 32 || half > 32768)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cand_piecewise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kCandTableBytes);
  if (e != cudaSuccess) return (int)e;
  const int nhalf = (bs + half - 1) / half;
  if (nb > 0 && nhalf > 0)
    cand_piecewise_kernel<<<nb * nhalf, 32, kCandTableBytes,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (int*)cand, bs, half,
        nhalf);
  return (int)cudaGetLastError();
}

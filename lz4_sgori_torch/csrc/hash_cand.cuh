// The warp step of pass-1 dense candidates of K9 (cand_piecewise.cu, one
// half-piece per CTA). K2 (cand.cu) splits the table over the CTA's warps
// (cand_part.cuh).
//
// One call takes the 32 positions p = base + lane of a warp. Positions
// p < npos (those with a full read32) are active. The table in shared
// memory holds, for each hash16 bucket, q - origin + 1 for the latest
// inserted position q (0 = empty), so a CTA that starts at `origin`
// stores positions relative to its first one. __match_any_sync finds the
// lanes with an equal hash: the nearest lower such lane is a lane's
// candidate, the lowest lane of a group reads the table, and the highest
// writes it. Returns p - q for the latest earlier active q of p's bucket
// since the table was cleared (0 for none and for inactive p).
//
// The uint16 entry q - origin + 1 wraps to 0 ("empty") at
// q = origin + 65535 only. A CTA that inserts at most 65,536 positions
// has that position last, so no later position reads the wrapped entry
// and the wrap never changes an output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kCandTableBytes = (1 << 16) * 2;

// Zero the 2^16-entry table with the warp.
__device__ __forceinline__ void clear_cand_table(uint16_t* table, int lane) {
  uint32_t* t32 = reinterpret_cast<uint32_t*>(table);
  for (int i = lane; i < (1 << 15); i += 32) t32[i] = 0;
  __syncwarp();
}

__device__ __forceinline__ int hash_cand_step(const uint8_t* __restrict__ src,
                                              int p, int npos, int origin,
                                              uint16_t* table, int lane) {
  const bool act = p < npos;
  uint32_t h = 0x10000u + lane;         // unique: matches no other lane
  if (act) {
    const uint32_t v = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8) |
                       ((uint32_t)src[p + 2] << 16) |
                       ((uint32_t)src[p + 3] << 24);
    h = (v * 2654435761u) >> 16;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, h);
  const unsigned lower = peers & ((1u << lane) - 1u);
  const unsigned higher = peers & ~((2u << lane) - 1u);
  const int r = p - origin;
  int d = 0;
  if (act) {
    if (lower) {
      d = lane - (31 - __clz(lower));
    } else {
      const int t = table[h];
      if (t) d = r - (t - 1);
    }
  }
  __syncwarp();
  if (act && !higher) table[h] = (uint16_t)(r + 1);
  __syncwarp();
  return d;
}

// Pass-1 dense candidates, one warp per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel in its
// greedy mode (with _sort_ref): the TPU has no fast hash-table scatter,
// so it bitonic-sorts (hash, position) keys per block. Here a real table
// lives in shared memory.
//
// Contract (golden.dense_candidates(src, hashlog=16, val16_filter=False)):
//   cand[p] = p - q for the latest q < p with
//   hash16(read32(q)) == hash16(read32(p)), q and p in [0, n-4];
//   0 where there is none and for every p > n-4. Blocks are at most
//   64 KiB, so positions fit the table's uint16 entries (p + 1, 0 = empty)
//   and the golden (p + 1) & 0xFFFF wrap cannot fire.
//
// What bounds it on the H100: the insertions are sequential by
// definition (the latest earlier position wins), and the 2^16-entry
// table takes 128 KiB of shared memory, so one CTA of one warp runs per
// SM. The warp takes 32 positions per step: __match_any_sync finds the
// lanes with an equal hash, the nearest lower such lane is a lane's
// candidate, the lowest lane of a group reads the table, and the highest
// writes it. Each step is a handful of shared-memory operations, so the
// kernel runs well ahead of the parse that consumes its output.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTableBytes = (1 << 16) * 2;

__global__ void cand_kernel(const uint8_t* __restrict__ raw,
                            const int* __restrict__ raw_len,
                            int* __restrict__ cand, int bs) {
  extern __shared__ uint16_t table[];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = raw + (size_t)blk * bs;
  int* out = cand + (size_t)blk * bs;
  const int n = min(max(raw_len[blk], 0), bs);
  uint32_t* t32 = reinterpret_cast<uint32_t*>(table);
  for (int i = lane; i < (1 << 15); i += 32) t32[i] = 0;
  __syncwarp();
  const int npos = n - 3;                 // positions with a full read32
  for (int base = 0; base < bs; base += 32) {
    const int p = base + lane;
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
    int d = 0;
    if (act) {
      if (lower) {
        d = lane - (31 - __clz(lower));
      } else {
        const int t = table[h];
        if (t) d = p - (t - 1);
      }
    }
    __syncwarp();
    if (act && !higher) table[h] = (uint16_t)(p + 1);
    __syncwarp();
    if (p < bs) out[p] = d;
  }
}

extern "C" int lz4t_cand(const void* raw, const void* raw_len, void* cand,
                         int nb, int bs, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (e != cudaSuccess) return (int)e;
  if (nb > 0)
    cand_kernel<<<nb, 32, kTableBytes, (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (int*)cand, bs);
  return (int)cudaGetLastError();
}

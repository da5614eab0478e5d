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
//   64 KiB, so positions fit the table's uint16 entries (p + 1, 0 = empty);
//   the entry of p = 65,535 wraps to empty, as golden's (p + 1) & 0xFFFF
//   does, and nothing reads it after (hash_cand.cuh).
//
// What bounds it on the H100: the insertions are sequential by
// definition (the latest earlier position wins), and the 2^16-entry
// table takes 128 KiB of shared memory, so one CTA of one warp runs per
// SM. The warp takes 32 positions per step (hash_cand.cuh, shared with
// K9). Each step is a handful of shared-memory operations, so the kernel
// runs well ahead of the parse that consumes its output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_cand.cuh"

__global__ void cand_kernel(const uint8_t* __restrict__ raw,
                            const int* __restrict__ raw_len,
                            int* __restrict__ cand, int bs) {
  extern __shared__ uint16_t table[];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = raw + (size_t)blk * bs;
  int* out = cand + (size_t)blk * bs;
  const int n = min(max(raw_len[blk], 0), bs);
  clear_cand_table(table, lane);
  const int npos = n - 3;                 // positions with a full read32
  for (int base = 0; base < bs; base += 32) {
    const int p = base + lane;
    const int d = hash_cand_step(src, p, npos, 0, table, lane);
    if (p < bs) out[p] = d;
  }
}

extern "C" int lz4t_cand(const void* raw, const void* raw_len, void* cand,
                         int nb, int bs, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kCandTableBytes);
  if (e != cudaSuccess) return (int)e;
  if (nb > 0)
    cand_kernel<<<nb, 32, kCandTableBytes, (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (int*)cand, bs);
  return (int)cudaGetLastError();
}

// Pass-1 dense candidates (K2): the block resident in shared memory, the
// hash table split by bucket over the CTA's warps (cand_part.cuh).
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
//   64 KiB, so positions fit the table's uint16 entries (p + 1, 0 =
//   empty), and every position of the row is written.
//
// What bounds it on the H100: the insertions are sequential within a
// bucket (the latest earlier position wins), and the 2^16-entry table
// takes 128 KiB of shared memory, so one CTA runs an SM. The first design
// gave that CTA one warp, reading the block a byte at a time from global
// memory and stepping the whole table: some 1,000 cycles a 32-position
// step, mostly the byte loads' latency and the table read behind them,
// one warp of the SM's 64. Here the block is copied into shared memory
// once, and the CTA's 8 warps each own an eighth of the buckets: every
// warp hashes the whole block from shared memory (16 tiles a round,
// their loads in flight together) but steps the table only for its own
// positions, so the dependent table steps a warp runs fall eightfold.
// What bounds it now is each warp's chain through a round (loads, hash,
// ballots, queue stores) and the steps of the warp that owns a long
// run's bucket; 16 warps issue twice the scan for too little gain, 4 too
// few rounds at once. Small blocks (config 3's 4 KiB) run one after
// another on a CTA, the next block's copy in flight, clearing only the
// buckets the last one used. K9 (cand_piecewise.cu) runs the same split
// table over runs of half-pieces.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cand_part.cuh"

extern "C" int lz4t_cand(const void* raw, const void* raw_len, void* cand,
                         int nb, int bs, void* stream) {
  using namespace cand_part;
  if (bs < 1 || bs > 65536) return (int)cudaErrorInvalidValue;
  const Layout L(bs);
  static int sized = 0, sms = 0;
  if (L.bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        cand_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.bytes);
    if (e != cudaSuccess) return (int)e;
    sized = L.bytes;
  }
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (nb > 0)
    cand_part_kernel<<<min(nb, sms), 32 * kWarps, L.bytes,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (int*)cand, nb, bs);
  return (int)cudaGetLastError();
}

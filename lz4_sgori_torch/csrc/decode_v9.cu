// T3, the chained safe LZ4 decode: one warp per chain of blocks.
//
// Replaces tools/retired/lockstep_v9.py:_kernel (the pallas_call in
// decompress_blocks_lockstep_v9 at :468). On the TPU each of 128 lockstep
// lanes decodes `chain` blocks laid back to back in its column, so that a
// group's cost becomes the lanes' balanced total rather than its slowest
// block; an offset may not reach before the current block's first byte.
// Here the wrapper deals the blocks (lz4_sgori_torch/retired/
// lockstep_v9.py) so that rows c * chain .. c * chain + chain - 1 form
// chain c, and warp c decodes them in turn with K1's walk
// (lz4_decode.cuh). Each block has its own output row, so an offset that
// reaches before it is the walk's own "outside output" error. Per block
// the result is K1's: golden.decompress, with an error row all zero.
//
// What bounds it on the H100: the serial walk, as K1. A chain is `chain`
// walks long and the batch gives nb / chain warps, so while the warps in
// flight are fewer than the card holds (512 blocks of 64 KiB are under
// 4 warps per SM), chaining lengthens the critical path; the deal only
// evens the chains out.

#include "lz4_decode.cuh"

__global__ void decode_chain_kernel(const uint8_t* __restrict__ comp,
                                    const int* __restrict__ clen,
                                    uint8_t* out, int* __restrict__ out_len,
                                    uint8_t* __restrict__ err, int ncols,
                                    int chain, int slot, int out_size) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (col >= ncols) return;
  for (int j = 0; j < chain; ++j) {
    const int blk = col * chain + j;
    const int n = decode_block_warp(comp + (size_t)blk * slot, clen[blk],
                                    slot, out + (size_t)blk * out_size,
                                    out_size, lane);
    store_result(n, blk, lane, out_len, err);
  }
}

// One warp per chain, four chains per CTA.
extern "C" int lz4t_decode_v9(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int ncols, int chain,
                              int slot, int out_size, void* stream) {
  if (ncols > 0) {
    const int threads = 128;
    const int blocks = (ncols + threads / 32 - 1) / (threads / 32);
    decode_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)clen, (uint8_t*)out, (int*)out_len,
        (uint8_t*)err, ncols, chain, slot, out_size);
  }
  return (int)cudaGetLastError();
}

// Safe LZ4 block decode for the v6 bands, one warp per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_v6.py:_kernel (the
// pallas_call at :482). The routing table sends two bands to v6: blocks
// below 16 KiB (the 4 KiB block-device path) and the 132-256 KiB band
// (lz4_sgori_tpu/ops/routing.py:77-84). On the TPU v6 differs from v7
// only in its staging geometry: a per-lane output ring with banded
// flushes (lockstep_v6.py:1-25, lockstep_v7.py:29-30). Both compute
// golden.decompress, so on the H100 both run the same one-warp-per-block
// loop (lz4_decode.cuh); this file gives K5 its own entry point, library
// and launch count.
//
// What bounds it on the H100: below 16 KiB a block is a short serial
// walk, so the kernel is bound by the number of warps in flight (8192
// blocks of 4 KiB for 32 MiB, about 62 warps per SM, enough to hide the
// load latency) and by launch overhead on small batches. In the
// 132-256 KiB band few long walks run, a warp each.

#include "lz4_decode.cuh"

extern "C" int lz4t_decode_v6(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  return launch_decode_warp(comp, clen, out, out_len, err, nb, slot,
                            out_size, stream);
}

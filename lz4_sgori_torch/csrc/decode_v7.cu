// Safe LZ4 block decode for the v7 band (16-128 KiB), one warp per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_v7.py:_kernel (with _round
// and transfer_frames): the TPU walks 128 blocks in lockstep lanes
// through VMEM staging rings because Mosaic has no per-lane scalar
// control flow. On the H100 each block gets its own warp instead; the
// decode loop and its contract are in lz4_decode.cuh, shared with K5.
//
// What bounds it on the H100: the sequence walk is a serial chain of
// dependent byte loads (token -> LSIC -> offset -> next token), so one
// block is latency-bound, and 512 blocks of 64 KiB give only 512 warps
// for 132 SMs (under 4 warps per SM).

#include "lz4_decode.cuh"

extern "C" int lz4t_decode_v7(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  return launch_decode_warp(comp, clen, out, out_len, err, nb, slot,
                            out_size, stream);
}

// Safe LZ4 block decode for the v8 band (blocks above 256 KiB: 512 KiB
// to 4 MiB on the fio envelope), one warp per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_v8.py:_kernel (the
// pallas_call at :353). v8 computes v7's function; on the TPU only the
// tapes' home changes: a comp ring and a history ring in HBM, because
// VMEM cannot hold 1-4 MiB per lane (lockstep_v8.py:1-24). The warp loop
// of lz4_decode.cuh already reads and writes global memory, so K6 runs it
// from its own library, with its own entry point and launch count.
//
// Range check at the band's top (out_size 4 MiB, slot compress_bound(4
// MiB) + 8 = 4,210,776): every offset in the loop (ip, op, op + i,
// op - off + i, lit and ml, whose LSIC sums stay below 255 * slot) is an
// int under 2^31, and row starts are size_t.
//
// What bounds it on the H100: one serial walk per block. 128 MiB of 1 MiB
// blocks give 128 warps for 132 SMs, and 4 MiB blocks 32 warps per 128
// MiB, so the time is one block's walk: the band is bound by the block
// count, not by bandwidth.

#include "lz4_decode.cuh"

extern "C" int lz4t_decode_v8(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  return launch_decode_warp(comp, clen, out, out_len, err, nb, slot,
                            out_size, stream);
}

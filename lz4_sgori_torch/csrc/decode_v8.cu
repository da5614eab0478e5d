// Safe LZ4 block decode for the v8 band (blocks above 256 KiB: 512 KiB
// to 4 MiB on the fio envelope), one CTA a block, through rings in
// shared memory (lz4_decode_ring.cuh).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_v8.py:_kernel (the
// pallas_call at :353). v8 computes v7's function; on the TPU the tapes
// live in a comp ring and a history ring in HBM, because VMEM cannot hold
// 1-4 MiB per lane (lockstep_v8.py:1-24). Here the rings are on chip: the
// history ring holds the last 128 KiB of output in shared memory (LZ4's
// offsets reach 65,535 bytes back), and the compressed stream is staged
// into a 32 KiB ring by cp.async.bulk ahead of the walk.
//
// Range check at the band's top (out_size 4 MiB, slot compress_bound(4
// MiB) + 8 = 4,210,776): every offset in the walk (ip, op, lit and ml,
// whose LSIC sums stay below 255 * slot, the staged run head + clen
// rounded up to 16) is an int under 2^31, and row starts are size_t.
//
// What bounds it on the H100: one walk a block, a warp alone on its SM,
// each sequence a chain of dependent steps (token, LSIC, offset, the
// match's source). The first design, a warp loop, ran that chain through
// global memory one sequence at a time, about 900 cycles a sequence on
// config 6. Here every byte the walk reads is in shared memory (the
// stream arrives in 8 KiB stages three ahead of the walk, the match
// sources come from the history ring, the output leaves in 16 KiB
// flushes of 16-byte stores), and the lanes take up to 32 sequences at
// once: the CTA's four warps parse a 256-byte window at every position
// and double the links, the walking warp finds the batch's tokens in 5
// lookups and copies literals and independent matches a lane a
// sequence, the rest in dependency waves. 128 MiB of 1
// MiB blocks is 128 CTAs on 132 SMs (169,536 bytes of shared memory
// each, one a SM), so the time is one block's walk: bound by the block
// count and the walk's instructions, not by bandwidth.

#include "lz4_decode_ring.cuh"

extern "C" int lz4t_decode_v8(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  return launch_decode_ring<ring::RingGeom>(comp, clen, out, out_len, err,
                                            nb, slot, out_size, stream);
}

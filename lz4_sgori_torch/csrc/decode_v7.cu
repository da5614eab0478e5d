// Safe LZ4 block decode for the v7 band (16-128 KiB), one CTA a block,
// the block's output held whole in shared memory
// (lz4_decode_ring.cuh, the geometry WholeGeom).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_v7.py:_kernel (with _round
// and transfer_frames; the pallas_call at :401): the TPU walks 128 blocks
// in lockstep lanes through VMEM staging rings because Mosaic has no
// per-lane scalar control flow. On the H100 each block gets a CTA of its
// own running K6's walk (decode_v8.cu): the compressed stream staged by
// cp.async.bulk in 8 KiB stages, up to 32 sequences a batch (the CTA's
// four warps parse a 256-byte window and double the links), the general
// walk where a batch cannot go. At out_size <= 64 KiB the whole output
// stays in 64 KiB of shared memory, never flushed during the walk, and
// the CTA writes the row once at the end in 16-byte stores; two CTAs fit
// an SM (104,000 bytes each). Blocks of 64-128 KiB take K6's kernel and
// its 128 KiB history ring as they stand.
//
// What bounds it on the H100: each block is one walk, a chain of
// dependent steps a sequence (token, LSIC, offset, the match's source),
// all in shared memory; config 1's 512 blocks of 64 KiB fill the 132 SMs'
// 264 CTA places in two waves, so the time is about two blocks' walks on
// an SM that two walks share, bound by the walk's instructions and the
// block count, not by bandwidth. The first design (a warp a block, four a
// CTA, a warp loop through global memory) ran some 900 cycles a
// sequence.

#include "lz4_decode_ring.cuh"

extern "C" int lz4t_decode_v7(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  if (out_size <= ring::kWholeMax)
    return launch_decode_ring<ring::WholeGeom>(comp, clen, out, out_len, err,
                                               nb, slot, out_size, stream);
  return launch_decode_ring<ring::RingGeom>(comp, clen, out, out_len, err,
                                            nb, slot, out_size, stream);
}

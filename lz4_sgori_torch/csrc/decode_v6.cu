// Safe LZ4 block decode for the v6 bands, one CTA a block, through K1's
// and K6's walk (lz4_decode_ring.cuh) in geometries sized to the block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_v6.py:_kernel (the
// pallas_call at :482). The routing table sends two bands to v6: blocks
// below 16 KiB (the 4 KiB block-device path) and the 132-256 KiB band
// (lz4_sgori_tpu/ops/routing.py:77-84). On the TPU v6 differs from v7
// only in its staging geometry: a per-lane output ring with banded
// flushes (lockstep_v6.py:1-25, lockstep_v7.py:29-30). Both compute
// golden.decompress, so on the H100 both run the same walk; this file
// gives K5 its own geometries, entry point, library and launch count.
//
// - Up to 16 KiB (ring::SmallGeom<L>, out_size at most 2^L, L = 12, 13,
//   14): K1's whole block, in a region of 2^L bytes, with the stream in
//   four stages of 2^(L-1) bytes, all issued at the start: a 4 KiB
//   block's CTA takes about 18 KB of shared memory, so 8 CTAs share an
//   SM (64 registers a thread at 128 threads), where K1's 64 KiB geometry
//   fits 2.
// - Above 16 KiB, K1's geometries: the whole block up to 64 KiB, K6's
//   128 KiB history ring above (the 132-256 KiB band).
//
// What bounds it on the H100: each block is one walk, a chain of
// dependent steps a sequence, all in shared memory, up to 32 sequences a
// batch. Config 3's 8192 blocks of 4 KiB fill the 132 SMs' CTA places in
// some 8 waves, each SM's walks sharing its issue slots; a lone block
// (a 4 KiB write's verify) is one walk. The first design (a warp a block
// through global memory) ran some 900 cycles a
// sequence and hid it only behind 64 warps an SM.

#include "lz4_decode_ring.cuh"

extern "C" int lz4t_decode_v6(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  if (out_size <= ring::kSmallMax) {
    if (out_size <= 4096)
      return launch_decode_ring<ring::SmallGeom<12>>(
          comp, clen, out, out_len, err, nb, slot, out_size, stream);
    if (out_size <= 8192)
      return launch_decode_ring<ring::SmallGeom<13>>(
          comp, clen, out, out_len, err, nb, slot, out_size, stream);
    return launch_decode_ring<ring::SmallGeom<14>>(
        comp, clen, out, out_len, err, nb, slot, out_size, stream);
  }
  if (out_size <= ring::kWholeMax)
    return launch_decode_ring<ring::WholeGeom>(comp, clen, out, out_len, err,
                                               nb, slot, out_size, stream);
  return launch_decode_ring<ring::RingGeom>(comp, clen, out, out_len, err,
                                            nb, slot, out_size, stream);
}

// Whole-block greedy parse (engine enc3), one warp a block, the block
// resident in shared memory (parse_enc3_warp.cuh at N = 1).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in
// block-per-lane mode (the pallas_call at :1692): the TPU steps 128 block
// lanes in lockstep through a mode machine (search, verify, catch-up,
// extension, header, literal and tail modes) with banded window walks and
// a staging ring, because Mosaic has no per-lane scalar loop. Here each
// block is one warp walking the serial loop of golden.compress_dense and
// then the terminal literal run, K8-enc3's walk (parse_enc3_deep.cu) at
// one candidate a probe with K3's hit test and no previews or lazy step.
//
// Contract, per block of n = clamp(raw_len, 0, bs) bytes:
// golden.compress_dense(block, acceleration, hashlog=16)
// (lz4_sgori_tpu/golden.py:1028-1141) over K2's candidates. That is K3's
// parse over one segment spanning the block (s0 = 0, mfl = n - 12,
// mlim = n - 5, no parse below 13 bytes) plus the terminal literal-only
// sequence. Outputs:
//   out     the whole block in a row of slot bytes; the wrapper zeroes the
//           row, so bytes past out_len stay zero;
//   out_len its length;
//   err     the block would pass cap = compress_bound(bs): an error,
//           never a truncation (the row is then not written, so it stays
//           zero, and out_len, tails and nseq are 0);
//   tails   the stream offset of the terminal sequence
//           (golden.tail_offset, the seg_splice engine's input);
//   nseq    sequences with a match (the decoder's cost hint).
//
// What bounds it on the H100: one block is one walk, a chain of dependent
// steps a sequence (search, catch-up, extension, emission), each spread
// over the 32 lanes: 32 probes a round, 32 bytes of catch-up and 128 of
// extension a step, every byte it reads in shared memory (the block by
// one cp.async.bulk, the cand tape through a cp.async ring) and the
// stream staged there and stored once. A block takes a CTA of its own
// at every size (12,640 bytes of shared memory at 4 KiB, 17 CTAs an SM;
// about 137 KiB at 64 KiB): a CTA lasts as long as its longest walk, and
// walks differ threefold in length, so an SM takes the next block as
// soon as any walk ends. On config 3, 2, 4, 8 and 16 blocks a CTA took
// some 1.10x, 1.31x, 1.55x and 1.67x the time of one. The first design
// (one thread a block from global memory) ran 8192 serial walks, some 2
// warps an SM. K10c (parse_enc3_mlen.cu) runs the same walk in the mlen
// mode.

#include "parse_enc3_warp.cuh"

extern "C" int lz4t_parse_enc3(const void* raw, const void* cand,
                               const void* raw_len, void* out, void* out_len,
                               void* err, void* tails, void* nseq, int nb,
                               int bs, int slot, int cap, int accel,
                               void* stream) {
  return launch_parse_warp<1>(raw, cand, nullptr, nullptr, raw_len, out,
                              out_len, err, tails, nseq, nb, bs, slot, cap,
                              accel, stream);
}

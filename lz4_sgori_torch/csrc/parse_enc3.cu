// Whole-block greedy parse (engine enc3), one thread per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in
// block-per-lane mode (the pallas_call at :1692): the TPU steps 128 block
// lanes in lockstep through a mode machine (search, verify, catch-up,
// extension, header, literal and tail modes) with banded window walks and
// a staging ring, because Mosaic has no per-lane scalar loop. Here each
// block is one thread running the scalar loop of golden.compress_dense
// (greedy_parse.cuh, shared with K10b) and then the terminal literal run.
// The kernel is parse_enc3.cuh's (K8-enc3, parse_enc3_deep.cu, walks a
// block with a warp at three and five candidates a probe).
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
//           never a truncation (the row is then zeroed again and out_len,
//           tails and nseq are 0);
//   tails   the stream offset of the terminal sequence
//           (golden.tail_offset, the seg_splice engine's input);
//   nseq    sequences with a match (the decoder's cost hint).
//
// What bounds it on the H100: one block is one serial chain of dependent
// byte loads, like K3's segment. At 4 KiB blocks the parse of 32 MiB is
// 8192 threads of one 4 KiB walk each (about 62 per SM, the same shape as
// K3 at 64 KiB); at 64 KiB (enc3 blocks and seg_splice segments) each
// thread walks 16 times further and few blocks give few threads, so one
// long serial walk bounds the kernel. Lane-parallel extension and literal
// copies (a warp per block) are left for later.

#include "parse_enc3.cuh"

extern "C" int lz4t_parse_enc3(const void* raw, const void* cand,
                               const void* raw_len, void* out, void* out_len,
                               void* err, void* tails, void* nseq, int nb,
                               int bs, int slot, int cap, int accel,
                               void* stream) {
  return launch_parse_enc3(raw, cand, nullptr, raw_len, out, out_len, err,
                           tails, nseq, nb, bs, slot, cap, accel, stream);
}

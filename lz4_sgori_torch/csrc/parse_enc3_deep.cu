// Whole-block deep parse of the enc3 engine (K8-enc3), one warp a block,
// the block resident in shared memory (parse_enc3_warp.cuh).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in
// block-per-lane mode at depth 3 and 5 (the pallas_call at :1692, with
// _parse_round). Contract, per block of n = clamp(raw_len, 0, bs) bytes:
// golden.compress_deep(block, acceleration, hashlog=16, depth)
// (lz4_sgori_tpu/golden.py:873-1025) over K2's candidates and the chain
// gaps (gaps.cu): depth 3 reads g2 | g3 << 8, depth 5 also g4 | g5 << 8.
// Each probe weighs up to `depth` chain candidates, scores each by a
// forward preview capped at min(n - 5 - p - 4, 64) (the matchlimit cap is
// the tie-break the TPU once got wrong), keeps the nearest on a tie and
// defers one step when p + 1 previews strictly longer (golden.compress_deep's
// best_at, the probe of K8-seg's warp walk too). Outputs are
// K7's (parse_enc3.cu): the whole block with its terminal literal run,
// its length, err, tails and nseq; the row must come in zeroed (the
// wrapper's block_outputs), as an err row is not written.
//
// What bounds it on the H100: the walk's chain of dependent steps a
// sequence (search, previews, catch-up, extension, emission), not bytes.
// The one-thread parse ran it from global memory a byte at a time, 32
// walks a warp on 4 SMs for config 5's 128 blocks of 64 KiB (12.29 ms for
// one block, 156.90 for 128). Here a block is one CTA of one warp (128
// SMs for those 128 blocks; at 4 KiB up to 8 warps a CTA, a block each):
// the block and the staged stream in shared memory (about 150 KiB at 64
// KiB), the tapes streamed ahead of the walk, and each step spread over
// the 32 lanes without divergent branches (32 probes a round, 32-byte
// previews, 32 bytes of catch-up a step, the extension from the
// preview's end), so a sequence costs a few shared-memory round trips,
// warp votes and some 2,200 cycles of instructions on config 5c.

#include "parse_enc3_warp.cuh"

extern "C" int lz4t_parse_enc3_deep(const void* raw, const void* cand,
                                    const void* gaps, const void* gaps2,
                                    const void* raw_len, void* out,
                                    void* out_len, void* err, void* tails,
                                    void* nseq, int nb, int bs, int slot,
                                    int cap, int accel, int depth,
                                    void* stream) {
  if (depth == 5)
    return launch_parse_warp<5>(raw, cand, gaps, gaps2, raw_len, out,
                                out_len, err, tails, nseq, nb, bs, slot, cap,
                                accel, stream);
  if (depth == 3)
    return launch_parse_warp<3>(raw, cand, gaps, nullptr, raw_len, out,
                                out_len, err, tails, nseq, nb, bs, slot, cap,
                                accel, stream);
  return (int)cudaErrorInvalidValue;
}

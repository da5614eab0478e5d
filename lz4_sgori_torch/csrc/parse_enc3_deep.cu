// Whole-block deep parse of the enc3 engine (K8-enc3), one thread per
// block.
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
// defers one step when p + 1 previews strictly longer (greedy_parse.cuh,
// best_of<N>). Outputs are K7's (parse_enc3.cu): the whole block with
// its terminal literal run, its length, err, tails and nseq.
//
// What bounds it on the H100: one serial walk per block, as K7, with up
// to `depth` candidate reads and 64-byte previews per probe, twice with
// the lazy step. Config 5's depth-5 slice (128 blocks of 64 KiB) runs
// 128 threads, so the longest walk is the kernel's time.

#include "parse_enc3.cuh"

extern "C" int lz4t_parse_enc3_deep(const void* raw, const void* cand,
                                    const void* gaps, const void* gaps2,
                                    const void* raw_len, void* out,
                                    void* out_len, void* err, void* tails,
                                    void* nseq, int nb, int bs, int slot,
                                    int cap, int accel, int depth,
                                    void* stream) {
  if (depth == 5)
    return launch_parse_enc3<5>(raw, cand, gaps, gaps2, nullptr, raw_len,
                                out, out_len, err, tails, nseq, nb, bs, slot,
                                cap, accel, stream);
  if (depth == 3)
    return launch_parse_enc3<3>(raw, cand, gaps, nullptr, nullptr, raw_len,
                                out, out_len, err, tails, nseq, nb, bs, slot,
                                cap, accel, stream);
  return (int)cudaErrorInvalidValue;
}

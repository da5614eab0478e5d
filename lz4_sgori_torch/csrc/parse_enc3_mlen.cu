// Whole-block greedy parse of the enc3 engine in the mlen mode (K10c),
// one thread per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel with
// mlen=True in block-per-lane mode (the pallas_call at :1692, reached by
// compress_blocks_lockstep_enc3(mlen=True), :1640-1644). Contract: K7's
// (parse_enc3.cu), per block golden.compress_dense(block, acceleration,
// hashlog=16) with its terminal sequence, tails and nseq, over mcode.cu's
// verified candidates and match codes (greedy_parse.cuh). Outputs
// as K7's.
//
// What bounds it on the H100: one serial walk per block, a thread each
// (K7's first design); the mode saves the same byte reads a match as K10b
// (parse_seg_mlen.cu).

#include "parse_enc3.cuh"

extern "C" int lz4t_parse_enc3_mlen(const void* raw, const void* cand_v,
                                    const void* mcode, const void* raw_len,
                                    void* out, void* out_len, void* err,
                                    void* tails, void* nseq, int nb, int bs,
                                    int slot, int cap, int accel,
                                    void* stream) {
  return launch_parse_enc3_mlen(raw, cand_v, mcode, raw_len, out, out_len,
                                err, tails, nseq, nb, bs, slot, cap, accel,
                                stream);
}

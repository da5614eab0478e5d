// Whole-block greedy parse of the enc3 engine in the mlen mode (K10c):
// K7's warp walk over the verified candidates and match codes
// (parse_enc3_warp.cuh, Walk<1, true>), a CTA a block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel with
// mlen=True in block-per-lane mode (the pallas_call at :1692, reached by
// compress_blocks_lockstep_enc3(mlen=True), :1640-1644). Contract: K7's
// (parse_enc3.cu), per block golden.compress_dense(block, acceleration,
// hashlog=16) with its terminal sequence, tails and nseq, over mcode.cu's
// verified candidates and match codes. Outputs as K7's.
//
// What bounds it on the H100: as K7, one walk a block, a chain of
// dependent steps a sequence. The first design ran it a thread a block
// from global memory, several times K7's time. Here it is K7's walk
// (the block in shared memory by one cp.async.bulk, the tapes through a
// cp.async ring, 32 probes a round, 32 bytes of catch-up and 128 of
// extension a step, the stream staged and stored once), with what the
// codes save: a probe reads no bytes, the catch-up's ballot runs only
// when cu is 4, the extension's first step only when lcp is 8. The codes
// come through the ring as a second tape: 4 KiB more shared memory a CTA
// at 4 KiB blocks, which timed faster than a load from global memory in
// every round of the search.

#include "parse_enc3_warp.cuh"

extern "C" int lz4t_parse_enc3_mlen(const void* raw, const void* cand_v,
                                    const void* mcode, const void* raw_len,
                                    void* out, void* out_len, void* err,
                                    void* tails, void* nseq, int nb, int bs,
                                    int slot, int cap, int accel,
                                    void* stream) {
  return launch_parse_warp<1, true>(raw, cand_v, mcode, nullptr, raw_len,
                                    out, out_len, err, tails, nseq, nb, bs,
                                    slot, cap, accel, stream);
}

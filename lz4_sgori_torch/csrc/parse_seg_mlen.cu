// Segment-parallel greedy parse in the mlen mode (K10b): K3's warp walk
// over the verified candidates and match codes (parse_seg_warp.cuh,
// Walk<1, true>).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel with
// mlen=True in seg mode (the pallas_call at :2098; the mlen parts of
// _parse_round at :920-926, :1085-1091, :1101-1106 and :1122-1130), the
// parse of the seg engine under LZ4J_ENC_MLEN=1 at depth 1 and blocks of
// at most 64 KiB. On the TPU the mode drops the lane's window reads for
// verify, catch-up and the first extension bytes. Contract: K3's
// (parse_seg.cu), per segment golden.compress_dense_seg_parts at depth 1,
// over mcode.cu's verified candidates (cand_v) and match codes (mcode,
// more_f | lcp << 1 | more_b << 5 | cu << 6): the mode reads the codes
// instead of the bytes where it can and writes the same stream. Outputs
// as K3's.
//
// What bounds it on the H100: as K3, each segment's walk is a serial
// chain of dependent steps, and a launch lasts as long as its longest
// segment. The first design ran it a thread a segment from global memory,
// the 32 walks of a warp diverging, several times K3's time. Here it
// is K3's walk (a warp a segment, the CTA's bytes in shared memory by one
// cp.async.bulk, 32 probes a round, 32 bytes of catch-up and 128 of
// extension a step), with what the codes save: a probe reads no bytes
// (the hit's code leaves its lane by a shuffle, each lane loading its
// probe's code beside its cand_v entry), the catch-up's ballot runs only
// when cu is 4, the extension's first step only when lcp is 8.

#include "parse_seg_warp.cuh"

extern "C" int lz4t_parse_seg_mlen(const void* raw, const void* cand_v,
                                   const void* mcode, const void* raw_len,
                                   void* streams, void* slen, void* serr,
                                   void* last_end, void* nseq, void* p1,
                                   void* m1h, int nb, int bs, int seg,
                                   int scap, int wlim, int accel,
                                   void* stream) {
  return launch_parse_seg_warp<1, true>(raw, cand_v, mcode, raw_len,
                                        streams, slen, serr, last_end, nseq,
                                        p1, m1h, nb, bs, seg, scap, wlim,
                                        accel, stream);
}

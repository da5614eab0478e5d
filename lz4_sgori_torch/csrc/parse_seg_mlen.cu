// Segment-parallel greedy parse in the mlen mode (K10b), one thread per
// segment.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel with
// mlen=True in seg mode (the pallas_call at :2098; the mlen parts of
// _parse_round at :920-926, :1085-1091, :1101-1106 and :1122-1130), the
// parse of the seg engine under LZ4J_ENC_MLEN=1 at depth 1 and blocks of
// at most 64 KiB. On the TPU the mode drops the lane's window reads for
// verify, catch-up and the first extension bytes. Contract: K3's
// (parse_seg.cu), per segment golden.compress_dense_seg_parts at depth 1,
// over mcode.cu's verified candidates and match codes: the mode reads the
// codes instead of the bytes where it can and writes the same stream
// (greedy_parse.cuh). Outputs as K3's.
//
// What bounds it on the H100: as K3, one serial walk per segment. The
// mode saves a probe's read32 pair, up to 4 catch-up byte pairs and up to
// 8 extension byte pairs a match, at one more int32 read a match; the
// rest of the walk is K3's.

#include "parse_seg.cuh"

extern "C" int lz4t_parse_seg_mlen(const void* raw, const void* cand_v,
                                   const void* mcode, const void* raw_len,
                                   void* streams, void* slen, void* serr,
                                   void* last_end, void* nseq, void* p1,
                                   void* m1h, int nb, int bs, int seg,
                                   int scap, int wlim, int accel,
                                   void* stream) {
  return launch_parse_seg(raw, cand_v, mcode, raw_len, streams, slen, serr,
                          last_end, nseq, p1, m1h, nb, bs, seg, scap, wlim,
                          accel, stream);
}

// Segment-parallel deep parse (K8-seg), one thread per segment.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in seg
// mode at depth 3 (the pallas_call at :2098, with _parse_round), the
// parse of the seg and seg_big engines at match depth 2-3. Contract, per
// segment: golden.compress_dense_seg_parts(..., depth=3)
// (lz4_sgori_tpu/golden.py:455-518), in global byte coordinates, with
// the same segment limits, headerless first sequence and outputs as K3
// (parse_seg.cu). Each probe weighs cand[p] and the chain through the
// gaps tape (gaps.cu, g2 | g3 << 8): the longest preview wins, capped at
// 64 bytes and at the segment's match limit, the nearest wins ties, and
// one-step lazy deferral moves the match to p + 1 when its preview is
// strictly longer (greedy_parse.cuh, best_of<3>).
//
// What bounds it on the H100: as K3, one serial walk per segment; each
// probe now reads up to three candidates and previews up to 64 bytes of
// each, twice with the lazy step, so a walk does several times K3's
// dependent loads. They stay inside the segment and its 64 KiB window,
// mostly in L1/L2.

#include "parse_seg.cuh"

extern "C" int lz4t_parse_seg_deep(const void* raw, const void* cand,
                                   const void* gaps, const void* raw_len,
                                   void* streams, void* slen, void* serr,
                                   void* last_end, void* nseq, void* p1,
                                   void* m1h, int nb, int bs, int seg,
                                   int scap, int wlim, int accel,
                                   void* stream) {
  return launch_parse_seg<3>(raw, cand, gaps, nullptr, raw_len, streams,
                             slen, serr, last_end, nseq, p1, m1h, nb, bs, seg,
                             scap, wlim, accel, stream);
}

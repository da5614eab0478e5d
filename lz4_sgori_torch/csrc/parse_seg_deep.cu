// Segment-parallel deep parse (K8-seg): K3's warp walk at three
// candidates a probe, with K8-enc3's previews (parse_seg_warp.cuh, N = 3).
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
// strictly longer (golden.compress_dense_seg_parts' preview).
//
// What bounds it on the H100: as K3, one serial walk a segment, and a
// launch lasts as long as its longest segment. The first design ran it a
// thread a segment, 64 threads a CTA, each probe reading
// up to three candidates and previewing up to 64 bytes of each, twice
// with the lazy step, a byte at a time through global memory, the 32
// walks of a warp diverging. Here a warp walks a segment over bytes
// copied into shared memory once a CTA (K3's geometry): 32 probes a round
// with every chain candidate's checks, the hit's and p + 1's candidates
// previewed together (two lanes a candidate, 32 bytes a lane) and the
// winner taken by one warp reduction, the extension going on from the
// winner's preview. Older match sources, and the previews' 64 bytes of
// them, are read from the row.

#include "parse_seg_warp.cuh"

extern "C" int lz4t_parse_seg_deep(const void* raw, const void* cand,
                                   const void* gaps, const void* raw_len,
                                   void* streams, void* slen, void* serr,
                                   void* last_end, void* nseq, void* p1,
                                   void* m1h, int nb, int bs, int seg,
                                   int scap, int wlim, int accel,
                                   void* stream) {
  return launch_parse_seg_warp<3>(raw, cand, gaps, raw_len, streams, slen,
                                  serr, last_end, nseq, p1, m1h, nb, bs, seg,
                                  scap, wlim, accel, stream);
}

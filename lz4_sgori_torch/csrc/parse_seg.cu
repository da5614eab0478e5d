// Segment-parallel greedy parse, one thread per segment.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in seg
// mode (seg_w, with _parse_round): the TPU steps 128 segment lanes in
// lockstep through a mode machine with banded window walks, because
// Mosaic has no per-lane scalar loop. Here each segment is one thread
// running the scalar parse of golden.compress_dense_seg_parts
// (lz4_sgori_tpu/golden.py:481-583) at depth 1. The kernel is
// parse_seg.cuh's, at one candidate a probe (K8-seg, parse_seg_deep.cu,
// runs it at three); its loop is greedy_parse.cuh, shared with K7
// (parse_enc3.cu).
//
// Per segment k of block b (global byte coordinates):
//   s0 = k*seg, s1 = s0 + clamp(n - s0, 0, seg),
//   mfl = min(s1 - 4, n - 12), mlim = min(s1, n - 5),
//   search starts at max(s0, 1), catch-up stops at the segment start,
//   a candidate d is used when 0 < d <= wlim and read32 agrees
//   (wlim = 65535 for window >= 65536, else window - 64),
//   and the first sequence of k > 0 is emitted headerless.
// Outputs per segment: the stream (bounded by compress_bound(seg):
// overflow sets err, never truncates silently), its length, err,
// last_end, nseq (sequences with a match), p1 and m1 | has_match << 16.
// Segments that start at or past n parse nothing.
//
// What bounds it on the H100: each segment is a serial chain of
// dependent byte loads, so the kernel is latency-bound; 512 blocks of
// 64 KiB give 8192 threads, about 62 per SM. The design keeps every
// thread inside its own 4 KiB segment plus the match window, so loads
// mostly hit L1/L2, and leaves lane-parallel match extension for later.

#include "parse_seg.cuh"

extern "C" int lz4t_parse_seg(const void* raw, const void* cand,
                              const void* raw_len, void* streams, void* slen,
                              void* serr, void* last_end, void* nseq,
                              void* p1, void* m1h, int nb, int bs, int seg,
                              int scap, int wlim, int accel, void* stream) {
  return launch_parse_seg<1>(raw, cand, nullptr, nullptr, raw_len, streams,
                             slen, serr, last_end, nseq, p1, m1h, nb, bs, seg,
                             scap, wlim, accel, stream);
}

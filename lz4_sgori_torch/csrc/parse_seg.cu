// Segment-parallel greedy parse (K3): one warp a segment, the bytes it
// reads resident in shared memory (parse_seg_warp.cuh).
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in seg
// mode (seg_w, with _parse_round): the TPU steps 128 segment lanes in
// lockstep through a mode machine with banded window walks, because
// Mosaic has no per-lane scalar loop. Here each segment runs the scalar
// parse of golden.compress_dense_seg_parts
// (lz4_sgori_tpu/golden.py:481-583) at depth 1, its greedy loop at one
// candidate a probe (K8-seg, parse_seg_deep.cu, runs the same warp walk
// at three; K10b, parse_seg_mlen.cu, at one in the mlen mode, over the
// match codes).
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
// What bounds it on the H100: each segment is a serial chain of dependent
// steps (search, catch-up, extension, emission), and a launch lasts at
// least as long as its longest segment. The first design ran it a thread
// a segment, 64 threads a CTA, a byte at a time through global memory,
// with the 32 walks of a warp diverging: config 1 put 2 warps on an SM.
// Here a warp walks a segment and its 32 lanes split each step (32
// probes a round, 32 bytes of catch-up and 128 of extension a step, the
// literals a byte a lane), over bytes copied into shared memory once per
// CTA; CTAs of 2 segments of 4 KiB (one of 8 KiB), with older match
// sources read from the row, fit 16 or 32 to an SM (32 warps, the
// registers' limit), so a short CTA's place is soon taken by the next.
// What is left is the walk's own chain, some 2,000 cycles a sequence
// (shared-memory round trips, warp votes, the emission's stores), over
// the longest segments' 600 and more sequences.

#include "parse_seg_warp.cuh"

extern "C" int lz4t_parse_seg(const void* raw, const void* cand,
                              const void* raw_len, void* streams, void* slen,
                              void* serr, void* last_end, void* nseq,
                              void* p1, void* m1h, int nb, int bs, int seg,
                              int scap, int wlim, int accel, void* stream) {
  return launch_parse_seg_warp<1>(raw, cand, nullptr, raw_len, streams,
                                  slen, serr, last_end, nseq, p1, m1h, nb,
                                  bs, seg, scap, wlim, accel, stream);
}

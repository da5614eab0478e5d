// Segment-parallel greedy parse, one thread per segment.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in seg
// mode (seg_w, with _parse_round): the TPU steps 128 segment lanes in
// lockstep through a mode machine with banded window walks, because
// Mosaic has no per-lane scalar loop. Here each segment is one thread
// running the scalar parse of golden.compress_dense_seg_parts
// (lz4_sgori_tpu/golden.py:481-583) at depth 1. The loop itself is
// greedy_parse.cuh, shared with K7 (parse_enc3.cu).
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "greedy_parse.cuh"

__global__ void parse_seg_kernel(
    const uint8_t* __restrict__ raw, const int* __restrict__ cand,
    const int* __restrict__ raw_len, uint8_t* __restrict__ streams,
    int* __restrict__ slen, int* __restrict__ serr,
    int* __restrict__ last_end, int* __restrict__ nseq,
    int* __restrict__ p1_out, int* __restrict__ m1h_out, int nb, int bs,
    int seg, int scap, int wlim, int accel) {
  const int nseg = bs / seg;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * nseg) return;
  const int blk = t / nseg;
  const int k = t - blk * nseg;
  const int n = min(max(raw_len[blk], 0), bs);
  const int s0 = k * seg;
  const int s1 = s0 + min(max(n - s0, 0), seg);
  const ParseState st = greedy_parse(
      raw + (size_t)blk * bs, cand + (size_t)blk * bs,
      streams + (size_t)t * scap, scap, s0, min(s1 - 4, n - 12),
      min(s1, n - 5), k > 0, wlim, accel);
  slen[t] = st.o;
  serr[t] = st.bad ? 1 : 0;
  last_end[t] = st.anchor;
  nseq[t] = st.nseq;
  p1_out[t] = st.p1;
  m1h_out[t] = st.m1 | (st.has_match ? 1 << 16 : 0);
}

extern "C" int lz4t_parse_seg(const void* raw, const void* cand,
                              const void* raw_len, void* streams, void* slen,
                              void* serr, void* last_end, void* nseq,
                              void* p1, void* m1h, int nb, int bs, int seg,
                              int scap, int wlim, int accel, void* stream) {
  const int total = nb * (bs / seg);
  if (total > 0) {
    const int threads = 64;
    parse_seg_kernel<<<(total + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)cand, (const int*)raw_len,
        (uint8_t*)streams, (int*)slen, (int*)serr, (int*)last_end,
        (int*)nseq, (int*)p1, (int*)m1h, nb, bs, seg, scap, wlim, accel);
  }
  return (int)cudaGetLastError();
}

// The segment-parallel parse kernel of the mlen mode (K10b,
// parse_seg_mlen.cu), one thread per segment (greedy_parse.cuh, over
// the mcode tape). K3 and K8-seg (parse_seg.cu, parse_seg_deep.cu) walk a
// segment with a warp (parse_seg_warp.cuh). See parse_seg.cu for the
// contract.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "greedy_parse.cuh"

__global__ void parse_seg_kernel(
    const uint8_t* __restrict__ raw, const int* __restrict__ cand,
    const int* __restrict__ mcode, const int* __restrict__ raw_len,
    uint8_t* __restrict__ streams, int* __restrict__ slen,
    int* __restrict__ serr, int* __restrict__ last_end,
    int* __restrict__ nseq, int* __restrict__ p1_out,
    int* __restrict__ m1h_out, int nb, int bs, int seg, int scap, int wlim,
    int accel) {
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
      mcode + (size_t)blk * bs, streams + (size_t)t * scap, scap, s0,
      min(s1 - 4, n - 12), min(s1, n - 5), k > 0, wlim, accel);
  slen[t] = st.o;
  serr[t] = st.bad ? 1 : 0;
  last_end[t] = st.anchor;
  nseq[t] = st.nseq;
  p1_out[t] = st.p1;
  m1h_out[t] = st.m1 | (st.has_match ? 1 << 16 : 0);
}

inline int launch_parse_seg(const void* raw, const void* cand,
                            const void* mcode, const void* raw_len,
                            void* streams, void* slen, void* serr,
                            void* last_end, void* nseq, void* p1, void* m1h,
                            int nb, int bs, int seg, int scap, int wlim,
                            int accel, void* stream) {
  const int total = nb * (bs / seg);
  if (total > 0) {
    const int threads = 64;
    parse_seg_kernel<<<(total + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)cand, (const int*)mcode,
        (const int*)raw_len, (uint8_t*)streams, (int*)slen, (int*)serr,
        (int*)last_end, (int*)nseq, (int*)p1, (int*)m1h, nb, bs, seg, scap,
        wlim, accel);
  }
  return (int)cudaGetLastError();
}

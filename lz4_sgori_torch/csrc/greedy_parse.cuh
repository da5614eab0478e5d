// The scalar parse of K10b (parse_seg.cuh, one segment per thread) and
// K10c (parse_enc3.cuh, one block per thread), in the mlen mode. K3's and
// K8-seg's parses are a warp a segment (parse_seg_warp.cuh), K7's and
// K8-enc3's a warp a block (parse_enc3_warp.cuh).
//
// It is the sequence loop of golden.compress_dense
// (lz4_sgori_tpu/golden.py:1054-1129) over precomputed dense candidates,
// restricted to one range of the block as golden.compress_dense_seg_parts
// (golden.py:481-583) does, at one candidate a probe (the greedy parse of
// K3's and K7's first designs):
//   the search starts at max(s0, 1) with a fresh skip schedule per
//   sequence and stops once a probe would pass mfl;
//   catch-up stops at the anchor (s0 for the first sequence);
//   forward extension stops at mlim;
//   with frag set, the first sequence is emitted headerless (its literal
//   run belongs to the previous segment's owner header) and its match
//   start and code are returned as p1 and m1.
// It reads the verified candidates and match codes of mcode.cu
// (golden.dense_mcode) instead of the bytes where it can, and gives the
// stream of the byte-reading loop (0 < d <= wlim, d <= pos and read32
// equal):
//   a probe hits when 0 < d <= wlim and d <= pos, with no read32: pass 1
//   verified it, and zeroed a candidate that failed, so the search goes
//   on past it as past a failed verify;
//   catch-up takes delta = min(cu, pos - anchor, mpos) from the code and
//   goes on byte by byte only when delta == 4 (the code's cap);
//   the bytes from the caught-up pos through p0 + 4 + lcp (p0 the probe
//   position) are known equal, so the extension starts with that run,
//   cut at the match limit; it reads on byte by byte from p0 + 12 only
//   when lcp == 8 (the code's cap). With lcp < 8 the byte at
//   p0 + 4 + lcp differs, or is a zero pad that the limit excludes.
// Every byte goes to dst, bounded by cap: a stream that would pass cap
// sets bad and stops, it is never truncated silently.

#pragma once

#include <stdint.h>

struct ParseState {
  int o;           // bytes written to dst
  int anchor;      // end of the last match: start of the pending literals
  int nseq;        // sequences with a match
  int p1, m1;      // first sequence's match start and code (frag only)
  bool has_match;
  bool bad;        // the stream would pass cap
};

__device__ __forceinline__ ParseState greedy_parse(
    const uint8_t* __restrict__ src, const int* __restrict__ cd,
    const int* __restrict__ mcd,
    uint8_t* __restrict__ dst, int cap, int s0, int mfl, int mlim, bool frag,
    int wlim, int accel) {
  ParseState st = {0, s0, 0, 0, 0, false, false};
  int pos = max(s0, 1);

#define EMIT(byte)                                 \
  do {                                             \
    if (st.o >= cap) { st.bad = true; }            \
    else { dst[st.o++] = (uint8_t)(byte); }        \
  } while (0)

  while (!st.bad) {
    // skip-accelerated search, fresh schedule per sequence
    int fpos = pos, step = 1, smn = accel << 6, mpos = 0;
    bool found = false;
    while (fpos + step <= mfl + 1) {
      pos = fpos;
      fpos += step;
      step = smn >> 6;
      smn++;
      const int d = cd[pos];
      if (d > 0 && d <= wlim && d <= pos) {
        mpos = pos - d;
        found = true;
        break;
      }
    }
    if (!found) break;
    // catch-up, capped at the anchor: from the probe's code first
    const int p0 = pos, code = mcd[pos];
    const int delta = min(min((code >> 6) & 7, pos - st.anchor), mpos);
    pos -= delta;
    mpos -= delta;
    if (delta == 4) {
      while (pos > st.anchor && mpos > 0 && src[pos - 1] == src[mpos - 1]) {
        pos--;
        mpos--;
      }
    }
    const int lit = pos - st.anchor;
    int token_at = -1, token = 0;
    if (!frag) {
      token_at = st.o;
      EMIT(0);
      if (lit >= 15) {
        token = 15 << 4;
        int rem = lit - 15;
        for (; rem >= 255; rem -= 255) EMIT(255);
        EMIT(rem);
      } else {
        token = lit << 4;
      }
    }
    if (st.bad || lit > cap - st.o) { st.bad = true; break; }
    for (int i = st.anchor; i < pos; i++) dst[st.o++] = src[i];
    const int off = pos - mpos;
    EMIT(off & 255);
    EMIT(off >> 8);
    const int p = pos + 4, m = mpos + 4;
    const int lim = mlim - p;
    // the known run: the catch-up, then lcp bytes
    const int lcp = (code >> 1) & 15;
    int mc = min(p0 - (p - 4) + lcp, lim);
    if (lcp == 8)
      while (mc < lim && src[p + mc] == src[m + mc]) mc++;
    pos = p + mc;
    if (mc >= 15) {
      if (!frag) token += 15;
      int rem = mc - 15;
      for (; rem >= 255; rem -= 255) EMIT(255);
      EMIT(rem);
    } else if (!frag) {
      token += mc;
    }
    if (st.bad) break;
    if (frag) {
      st.p1 = p - 4;
      st.m1 = mc;
      frag = false;
    } else {
      dst[token_at] = (uint8_t)token;
    }
    st.has_match = true;
    st.nseq++;
    st.anchor = pos;
    if (pos > mfl) break;
  }
#undef EMIT
  return st;
}

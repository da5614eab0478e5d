// The scalar greedy parse shared by K3 (parse_seg.cu, one segment per
// thread) and K7 (parse_enc3.cu, one block per thread).
//
// It is the sequence loop of golden.compress_dense
// (lz4_sgori_tpu/golden.py:1054-1129) over precomputed dense candidates,
// restricted to one range of the block as golden.compress_dense_seg_parts
// (golden.py:481-583) does at depth 1:
//   the search starts at max(s0, 1) with a fresh skip schedule per
//   sequence and stops once a probe would pass mfl;
//   a candidate d is used when 0 < d <= wlim, d <= pos and read32 agrees;
//   catch-up stops at the anchor (s0 for the first sequence);
//   forward extension stops at mlim;
//   with frag set, the first sequence is emitted headerless (its literal
//   run belongs to the previous segment's owner header) and its match
//   start and code are returned as p1 and m1.
// Every byte goes to dst, bounded by cap: a stream that would pass cap
// sets bad and stops, it is never truncated silently.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t rd32(const uint8_t* s, int i) {
  return (uint32_t)s[i] | ((uint32_t)s[i + 1] << 8) |
         ((uint32_t)s[i + 2] << 16) | ((uint32_t)s[i + 3] << 24);
}

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
    uint8_t* __restrict__ dst, int cap, int s0, int mfl, int mlim,
    bool frag, int wlim, int accel) {
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
      if (d > 0 && d <= wlim && d <= pos &&
          rd32(src, pos - d) == rd32(src, pos)) {
        mpos = pos - d;
        found = true;
        break;
      }
    }
    if (!found) break;
    // catch-up, capped at the anchor
    while (pos > st.anchor && mpos > 0 && src[pos - 1] == src[mpos - 1]) {
      pos--;
      mpos--;
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
    int mc = 0;
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

// K3's, K8-seg's and K10b's kernel (parse_seg.cu, parse_seg_deep.cu,
// parse_seg_mlen.cu): the segment-parallel parse, one warp a segment, the
// bytes it reads resident in shared memory. It computes the serial parse
// of golden.compress_dense_seg_parts at N candidates a probe (N = 1 for
// K3, its greedy loop; N = 3 for K8-seg, its best-of-3 probe preview and
// one-step lazy deferral; N = 1 in the mlen mode for K10b, over the
// verified candidates and match codes of mcode.cu, as the first designs
// ran them a thread a segment), bit for bit, with the 32 lanes splitting
// each step of the walk:
//
// - The CTA. A warp a segment. A CTA takes kGroup consecutive segments of
//   one block at seg 4 KiB and less (2: 8 KiB), one above (1 MiB blocks'
//   8 KiB), or whole small blocks with at most that many segments,
//   several to a CTA (16 blocks of 4 KiB at seg 4 KiB). Small CTAs keep
//   the SM full: a CTA lasts as long as its longest segment, the
//   segments' sequence counts differ threefold, and a finished CTA's
//   place goes to the next.
// - The bytes. Every byte the parse of segment [s0, s1) reads lies in
//   [s0 - 65536, s1 + 72): a probe reads read32 at pos - d with d <= wlim
//   <= 65535, the catch-up reads back to mpos - 1 >= s0 - 65536, a preview
//   64 bytes and a word past a candidate. The bytes at or past s0 (the
//   probe's own word, the previews', catch-up's and extension's near side,
//   the literals), the CTA's segments, are copied into shared memory, one
//   cp.async.bulk a block (from the address rounded down to 16), before
//   any warp walks; a match source before them is read from the row in
//   global memory, two aligned words a read32 (through L1 and L2: most
//   sources are near). Holding the bytes before them too (kBack) cost
//   more in CTAs an SM than it saved. Word reads run past a segment's end
//   by at most 140 bytes, into bytes (the next segment's, or slack) that
//   only ever meet a cap (cl, lim) that excludes them.
// - The tapes (cand; N = 3 also gaps, g2 | g3 << 8; the mlen mode cand_v
//   and mcode, more_f | lcp << 1 | more_b << 5 | cu << 6) are read from
//   global memory at increasing positions: a round's 32 probes lie within
//   a few cache lines. The next sequence's first round is loaded as soon
//   as this sequence's match ends, so the load is in flight while the
//   sequence is written.
// - The search. The skip schedule is fixed from a sequence's start: with
//   A = accel << 6 and S(x) = sum_{y < x} (y >> 6), probe k sits at p_0 =
//   start, p_k = start + 1 + S(A + k - 1) - S(A) for k >= 1, and runs only
//   if p_{k+1} <= mfl + 1. Lane j takes probe K0 + j of a round. At N = 1
//   a probe at p hits when d = cand[p] has 0 < d <= wlim, d <= p and
//   read32 at p - d equals read32 at p. At N = 3 it hits when one of its
//   chain candidates d1 = cand[p], d1 + g2, + g3 passes preview's checks
//   (d1 in (0, wlim], each link while the gaps before it are non-zero, p
//   - d >= 0, d <= wlim, read32 equal). In the mlen mode it hits when d =
//   cand_v[p] has 0 < d <= wlim and d <= p, with no read32: pass 1
//   verified the candidate and zeroed one that failed. The ballot's first
//   hit is the probe the serial loop stops at; in the mlen mode its code
//   leaves the hit lane with it.
// - The previews (N = 3, parse_enc3_warp.cuh's). The hit probe p's
//   candidates and p + 1's (when p + 1 <= mfl) are previewed together,
//   two lanes a candidate, 32 bytes a lane as 8 words of XOR, capped at
//   cl = min(mlim - p - 4, 64); the longest wins, the nearest on a tie:
//   the largest key (mc + 1) << 4 | (15 - i) over the lanes. The lazy step
//   is taken when p + 1's best is strictly longer. A lane reads its
//   candidate's check word and its 8 preview words together, from shared
//   memory or, for a source before the CTA's bytes, from the row in one
//   round trip.
// - Catch-up compares 32 bytes back a step, to the anchor (s0 for the
//   first sequence). In the mlen mode it first goes back delta = min(cu,
//   pos - anchor, mpos) bytes from the code, and compares on only when
//   delta is the code's cap, 4. The extension starts from what is known
//   equal (the catch-up's bytes, read32's 4, at N = 3 the winner's
//   preview and in the mlen mode the code's lcp: a preview or an lcp that
//   stopped short of its cap ends the match) and goes on 128 bytes a step
//   (a word a lane) to mlim.
// - The stream. A sequence's length is known before it is written, so a
//   stream that would pass cap sets err and stops, as the serial loop's
//   first byte past cap would. The bytes go straight to the segment's row:
//   the token and the offset from lane 0, LSIC runs of 255 and literals a
//   byte a lane. The first sequence of a segment k > 0 has no header (its
//   literal run belongs to the previous segment's owner); its match start
//   and code are p1 and m1. No terminal literal run: last_end is the
//   anchor.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "parse_enc3_warp.cuh"  // bar_init, bar_wait, smem_u32, skip_sum

namespace seg_warp {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kGroup = 2;           // segments of 4 KiB or less a CTA
constexpr int kBack = 0;            // bytes before them held on chip
constexpr int kMaxWarps = 16;       // warps a CTA of whole small blocks
constexpr int kSpan = 131072;       // segment bytes a CTA at most
constexpr int kSlack = 256;         // bytes past a segment reads may touch

// The CTA's shape, the same on host and device: `rows` blocks of `segs`
// segments each (rows > 1 only for whole small blocks), `cpr` CTAs a
// block, `slot` bytes of shared memory a block.
struct Geometry {
  int rows, segs, cpr, slot, bytes, ctas;
  __host__ __device__ Geometry(int nb, int bs, int seg) {
    const int nseg = bs / seg;
    // longer segments one a CTA: the SM holds fewer of them, and a CTA
    // lasts as long as its longest
    const int group = seg > 4096 ? 1 : kGroup;
    if (bs <= 65536 && nseg <= group) {
      segs = nseg;
      rows = max(1, min(kMaxWarps / nseg, 65536 / bs));
      cpr = 1;
      ctas = (nb + rows - 1) / rows;
    } else {
      segs = max(1, min(min(group, nseg), kSpan / seg));
      rows = 1;
      cpr = (nseg + segs - 1) / segs;
      ctas = nb * cpr;
    }
    const int span = min(bs, kBack + segs * seg);
    slot = (16 + span + kSlack + 15) & ~15;
    bytes = rows * slot + 16;
  }
};

// One segment's walk by one warp, at N candidates a probe (1 or 3); Mlen:
// the mlen mode (N = 1) over cand_v and mcode.
template <int N, bool Mlen = false>
struct Walk {
  static_assert(N == 1 || N == 3, "1 or 3 candidates");
  static_assert(!Mlen || N == 1, "the mlen mode at one candidate");
  const uint32_t* w;  // the slot: byte i of the block at byte off + i of w
  int off;            // (words indexed off w, no integer casts, so that
                      // the compiler keeps the loads in shared memory)
  int lo;             // the first byte held on chip
  const uint8_t* g;   // the block's row in global memory
  const int* cd;      // the block's cand row
  const int* gp;      // the block's gaps row (N = 3) or mcode row (Mlen)
  uint8_t* d;         // the segment's stream row
  int cap, wlim, accel, lane;

  // Bytes at or past s0 (lo <= s0): on chip.
  __device__ __forceinline__ uint8_t at(int i) const {
    return ((const uint8_t*)w)[off + i];
  }

  __device__ __forceinline__ uint32_t rd32(int i) const {
    // an unaligned word from two aligned ones
    const int a = off + i;
    return __funnelshift_r(w[a >> 2], w[(a >> 2) + 1], (uint32_t)(a & 3) * 8);
  }

  // A match source's bytes, which may lie before lo: from the row then
  // (two aligned words, which lie in the row: i + 7 < lo + 7 <= s1).
  __device__ __forceinline__ uint8_t atm(int i) const {
    if (i >= lo) return at(i);
    return __ldg(g + i);
  }

  // read32 at i of the row in global memory: K words at i, i + 4, ...
  // from K + 1 aligned ones, their loads in flight together (they read
  // up to i + 4K + 4)
  template <int K>
  __device__ __forceinline__ void rd32g(int i, uint32_t* out) const {
    const uintptr_t a = (uintptr_t)(g + i);
    const uint32_t* q = (const uint32_t*)(a & ~(uintptr_t)3);
    const uint32_t sh = (uint32_t)(a & 3) * 8;
    uint32_t w[K + 1];
#pragma unroll
    for (int k = 0; k <= K; k++) w[k] = __ldg(q + k);
#pragma unroll
    for (int k = 0; k < K; k++) out[k] = __funnelshift_r(w[k], w[k + 1], sh);
  }

  __device__ __forceinline__ uint32_t rd32m(int i) const {
    if (i >= lo) return rd32(i);
    uint32_t v;
    rd32g<1>(i, &v);
    return v;
  }

  // The tapes' entries at p: cand, and at N = 3 gaps (Mlen: the code).
  __device__ __forceinline__ int tape_c(int p) const { return __ldg(cd + p); }
  __device__ __forceinline__ int tape_g(int p) const {
    return N > 1 || Mlen ? __ldg(gp + p) : 0;
  }

  // The chain at p from its entries (d1 = cand[p], g = gaps[p]): its
  // distances and live bits (preview's links).
  __device__ __forceinline__ int chain(int d1, int g, int* ds) const {
    ds[0] = d1;
    ds[1] = d1 + (g & 255);
    ds[2] = ds[1] + (g >> 8);
    int live = (d1 > 0 && d1 <= wlim) ? 1 : 0;
    live |= (live & 1) && (g & 255) ? 2 : 0;
    live |= (live & 2) && (g >> 8) ? 4 : 0;
    return live;
  }

  // The probe at p with its entries dd, gg (the greedy loop's, and at N
  // = 3 preview's checks): read32 at a candidate only where it passes the
  // cheaper ones (0 < d <= wlim, d <= p, its links live), and at N = 3
  // only until one passes (reading the three together cost 6-12% more:
  // the older links' sources lie in the row more often). Mlen: no read32.
  __device__ __forceinline__ bool probe_hits(int p, int dd, int gg) const {
    if constexpr (N == 1) {
      const bool ok = (dd > 0) & (dd <= wlim) & (dd <= p);
      if constexpr (Mlen) return ok;
      return ok && rd32m(p - dd) == rd32(p);
    } else {
      int ds[3];
      const int live = chain(dd, gg, ds);
      if (!live) return false;
      const uint32_t v = rd32(p);
      bool hit = false;
#pragma unroll
      for (int i = 0; i < 3; i++)
        hit = hit || (((live >> i) & 1) && ds[i] <= p && ds[i] <= wlim &&
                      rd32m(p - ds[i]) == v);
      return hit;
    }
  }

  // A preview's source words at m: read32 at m (preview's check) and the 8
  // at m + b0, m + b0 + 4, ... into x; from shared memory, from the row
  // when they all lie before lo (one round trip), else word by word.
  __device__ __forceinline__ uint32_t source(int m, int b0,
                                             uint32_t* x) const {
    uint32_t v0;
    if (m >= lo) {
      v0 = rd32(m);
#pragma unroll
      for (int k = 0; k < 8; k++) x[k] = rd32(m + b0 + 4 * k);
    } else if (m + b0 + 36 <= lo) {
      rd32g<1>(m, &v0);
      rd32g<8>(m + b0, x);
    } else {
      v0 = rd32m(m);
#pragma unroll
      for (int k = 0; k < 8; k++) x[k] = rd32m(m + b0 + 4 * k);
    }
    return v0;
  }

  // Previews at p and (lazy) p + 1, two lanes a candidate: slots 0-7 for
  // p's chain, 8-15 for p + 1's (parse_enc3_warp.cuh's, with the window's
  // wlim and sources before lo from the row). Returns the best preview at
  // p (>= 0) and its match position, and p + 1's (-1 for none) in *mb /
  // *mposb.
  __device__ int previews(int p, bool lazy, int mlim, int* mpos, int* mb,
                          int* mposb) const {
    const int slot = lane >> 1, half = lane & 1;
    const int q = p + (slot >> 3);
    const int ci = slot & 7;
    // every lane reads its chain's entries; the key drops the lanes past
    // the chain, p + 1's when not lazy, and the unusable
    int ds[3];
    const int live = chain(tape_c(q), tape_g(q), ds);
    const int dd = ci == 1 ? ds[1] : (ci == 2 ? ds[2] : ds[0]);
    const int m = q - dd;
    const bool cand = (ci < 3) && ((slot < 8) || lazy) &&
                      ((live >> ci) & 1) && m >= 0 && dd <= wlim;
    // preview's check and the first mismatch of this lane's 32 bytes (32
    // for none), their source words read together, for a candidate only:
    // its source may lie in the row
    const int b0 = 4 + 32 * half;
    bool ok = false;
    int mm = 32;
    if (cand) {
      uint32_t x[8];
      ok = source(m, b0, x) == rd32(q);
#pragma unroll
      for (int k = 7; k >= 0; k--) {
        const uint32_t y = rd32(q + b0 + 4 * k) ^ x[k];
        mm = y ? 4 * k + ((__ffs(y) - 1) >> 3) : mm;
      }
    }
    const unsigned key = ok ? (unsigned)(32 * half + mm) : 0xffffu;
    // the pair's first mismatch: the low half's, unless it saw none
    const unsigned other = __shfl_xor_sync(kAll, key, 1);
    unsigned pm = half ? key : (key < 32 ? key : other);
    if (key == 0xffffu) pm = 0xffffu;
    unsigned k = 0;
    if (pm != 0xffffu) {
      const int cl = min(mlim - q - 4, 64);
      const int mc = min((int)pm, cl);
      k = ((unsigned)(mc + 1) << 4) | (unsigned)(15 - ci);
    }
    if (half) k = 0;                      // one key a pair
    const unsigned ka = __reduce_max_sync(kAll, slot < 8 ? k : 0u);
    const unsigned kb = __reduce_max_sync(kAll, slot < 8 ? 0u : k);
    *mpos = __shfl_sync(kAll, m, 2 * (15 - (int)(ka & 15)));
    *mposb = __shfl_sync(kAll, m, 16 + 2 * (15 - (int)(kb & 15)));
    *mb = kb ? (int)(kb >> 4) - 1 : -1;
    return (int)(ka >> 4) - 1;
  }

  // LSIC bytes for rem at d[o]: rem / 255 bytes of 255, then rem % 255.
  __device__ __forceinline__ void lsic(int o, int rem) const {
    const int nff = rem / 255;
    for (int i = lane; i < nff; i += 32) d[o + i] = 255;
    if (lane == 0) d[o + nff] = (uint8_t)(rem - 255 * nff);
  }

  // Parses [s0, s1) of a block of n bytes; frag: the first sequence has
  // no header. Fills the six per-segment outputs; false for err.
  __device__ bool run(int s0, int s1, int n, bool frag, int* o_out,
                      int* anchor_out, int* nseq_out, int* p1_out,
                      int* m1h_out) const {
    const int mfl = min(s1 - 4, n - 12), mlim = min(s1, n - 5);
    const long long A = (long long)accel << 6;
    const long long SA = warp_parse::skip_sum(A);
    // the first round's offsets from a sequence's start, the same for
    // every sequence: lane j's probe (p_j - start) and the next (p_{j+1})
    const int d0 = lane == 0 ? 0
                             : (int)min(1 + warp_parse::skip_sum(A + lane - 1)
                                            - SA, (long long)1 << 30);
    const int d1 = (int)min(1 + warp_parse::skip_sum(A + lane) - SA,
                            (long long)1 << 30);
    int o = 0, anchor = s0, nseq = 0, pos = max(s0, 1), p1 = 0, m1 = 0;
    bool has_match = false, bad = false;
    // the next search's first candidates (every valid probe lies at or
    // before mfl)
    int at0 = max(min(pos + d0, mfl), 0);
    int pre = tape_c(at0), preg = tape_g(at0);
    for (;;) {
      // ---- the search, 32 probes a round ----
      const int start = pos;
      long long k0 = 0;
      int hp = -1, hd = 0, hg = 0;
      for (;;) {
        long long pk = start + d0, pn = start + d1;
        if (k0) {
          const long long k = k0 + lane;
          pk = start + 1 + warp_parse::skip_sum(A + k - 1) - SA;
          pn = start + 1 + warp_parse::skip_sum(A + k) - SA;
        }
        const bool valid = pn <= mfl + 1;
        const unsigned vals = __ballot_sync(kAll, valid);
        if (!(vals & 1)) break;
        int dd = 0, gg = 0;
        if (valid) {
          dd = k0 ? tape_c((int)pk) : pre;
          gg = k0 ? tape_g((int)pk) : preg;
        }
        const bool hit = valid && probe_hits((int)pk, dd, gg);
        const unsigned hits = __ballot_sync(kAll, hit);
        if (hits) {
          hp = __shfl_sync(kAll, (int)pk, __ffs(hits) - 1);
          hd = __shfl_sync(kAll, dd, __ffs(hits) - 1);
          if constexpr (Mlen) hg = __shfl_sync(kAll, gg, __ffs(hits) - 1);
          break;
        }
        if (vals != kAll) break;       // the schedule ends in this round
        k0 += 32;
      }
      if (hp < 0) break;
      // ---- the match: the hit's candidate, or the best of the previews
      // at hp and the lazy step's at hp + 1 (pmc: the winner's preview,
      // pcl its cap; Mlen: the code's lcp, capped at 8) ----
      int pos1 = hp, mpos = hp - hd, pmc = 0, pcl = 0;
      if constexpr (Mlen) {
        pmc = (hg >> 1) & 15;
        pcl = 8;
      }
      if constexpr (N > 1) {
        int mb, mposb;
        const bool lazy = hp + 1 <= mfl;
        pmc = previews(hp, lazy, mlim, &mpos, &mb, &mposb);
        if (lazy && mb > pmc) {
          pos1 = hp + 1;
          mpos = mposb;
          pmc = mb;
        }
        pcl = min(mlim - pos1 - 4, 64);
      }
      // ---- catch-up, 32 bytes a step, capped at the anchor ----
      // (Mlen: the code's cu bytes first, then the steps only where they
      // reached its cap)
      int back = 0;
      bool steps = true;
      if constexpr (Mlen) {
        back = min(min((hg >> 6) & 7, pos1 - anchor), mpos);
        pos1 -= back;
        mpos -= back;
        steps = back == 4;
      }
      while (steps) {
        const bool ok = lane < pos1 - anchor && lane < mpos &&
                        at(pos1 - 1 - lane) == atm(mpos - 1 - lane);
        const unsigned stop = __ballot_sync(kAll, !ok);
        const int c = stop ? __ffs(stop) - 1 : 32;
        pos1 -= c;
        mpos -= c;
        back += c;
        if (c < 32) break;
      }
      // ---- forward extension, 128 bytes a step, capped at mlim ----
      // The bytes from pos1 through the probe's 4 (and a preview, or the
      // code's lcp) are known equal; a preview that stopped before its cap
      // (or at mlim's) ends the match there, one that ran its 64 bytes (an
      // lcp of 8) goes on.
      const int p = pos1 + 4, m = mpos + 4, lim = mlim - p;
      int mc = back + pmc;
      for (bool more = pmc == pcl && mc < lim; more;) {
        const uint32_t x = rd32(p + mc + 4 * lane) ^ rd32m(m + mc + 4 * lane);
        const unsigned diff = __ballot_sync(kAll, x != 0);
        if (diff) {
          const int l = __ffs(diff) - 1;
          const uint32_t xl = __shfl_sync(kAll, x, l);
          mc += 4 * l + ((__ffs(xl) - 1) >> 3);
          break;
        }
        mc += 128;
        more = mc < lim;
      }
      mc = min(mc, lim);
      // the next search's first candidates, in flight while this
      // sequence is written
      at0 = max(min(p + mc + d0, mfl), 0);
      pre = tape_c(at0);
      preg = tape_g(at0);
      // ---- the sequence: [token, literal LSIC] literals offset [LSIC] ----
      const int lit = pos1 - anchor;
      const int hl = frag ? 0 : 1 + (lit >= 15 ? (lit - 15) / 255 + 1 : 0);
      const int ml = mc >= 15 ? (mc - 15) / 255 + 1 : 0;
      if (hl + lit + 2 + ml > cap - o) {
        bad = true;
        break;
      }
      if (!frag) {
        if (lane == 0)
          d[o] = (uint8_t)((min(lit, 15) << 4) | min(mc, 15));
        if (lit >= 15) lsic(o + 1, lit - 15);
      }
      o += hl;
      for (int i = lane; i < lit; i += 32) d[o + i] = at(anchor + i);
      o += lit;
      const int off = pos1 - mpos;
      if (lane == 0) {
        d[o] = (uint8_t)(off & 255);
        d[o + 1] = (uint8_t)(off >> 8);
      }
      o += 2;
      if (mc >= 15) lsic(o, mc - 15);
      o += ml;
      if (frag) {
        p1 = pos1;
        m1 = mc;
        frag = false;
      }
      has_match = true;
      nseq++;
      anchor = p + mc;
      pos = anchor;
      if (pos > mfl) break;
    }
    *o_out = o;
    *anchor_out = anchor;
    *nseq_out = nseq;
    *p1_out = p1;
    *m1h_out = m1 | (has_match ? 1 << 16 : 0);
    return !bad;
  }
};

__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(warp_parse::smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(warp_parse::smem_u32(dst)), "l"(src), "r"(bytes),
         "r"(warp_parse::smem_u32(bar))
      : "memory");
}

// The bytes of row r of this CTA that its walks read: block b, its range
// [lo, hi) and the 16-aligned copy of it (src, bytes; 0 for none).
struct Range {
  int b, lo, hi, rhead;
  uint32_t bytes;
  const uint8_t* src;
  __device__ Range(const Geometry& G, const uint8_t* raw, const int* raw_len,
                   int nb, int bs, int seg, int r) {
    int g0 = 0;
    if (G.cpr == 1) {
      b = blockIdx.x * G.rows + r;
    } else {
      b = blockIdx.x / G.cpr;
      g0 = (blockIdx.x % G.cpr) * G.segs;
    }
    const int n = b < nb ? min(max(raw_len[b], 0), bs) : 0;
    lo = max(0, g0 * seg - kBack);
    hi = min(n, (g0 + G.segs) * seg);
    const uint8_t* row = raw + (size_t)min(b, nb - 1) * bs + lo;
    rhead = (int)((uintptr_t)row & 15);
    src = row - rhead;
    bytes = hi > lo ? (uint32_t)((rhead + hi - lo + 15) & ~15) : 0u;
  }
};

template <int N, bool Mlen>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    parse_seg_warp_kernel(const uint8_t* __restrict__ raw,
                          const int* __restrict__ cand,
                          const int* __restrict__ gaps,
                          const int* __restrict__ raw_len,
                          uint8_t* __restrict__ streams,
                          int* __restrict__ slen, int* __restrict__ serr,
                          int* __restrict__ last_end,
                          int* __restrict__ nseq, int* __restrict__ p1_out,
                          int* __restrict__ m1h_out, int nb, int bs,
                          int seg, int scap, int wlim, int accel) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Geometry G(nb, bs, seg);
  const int nseg = bs / seg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* bar = (uint64_t*)(smem + G.rows * G.slot);
  if (threadIdx.x == 0) {
    warp_parse::bar_init(bar);
    uint32_t total = 0;
    for (int r = 0; r < G.rows; r++)
      total += Range(G, raw, raw_len, nb, bs, seg, r).bytes;
    if (total) {
      expect_tx(bar, total);
      for (int r = 0; r < G.rows; r++) {
        const Range R(G, raw, raw_len, nb, bs, seg, r);
        if (R.bytes)
          bulk_copy(smem + r * G.slot, R.src, R.bytes, bar);
      }
    }
  }
  __syncthreads();

  const int r = warp / G.segs;
  const Range R(G, raw, raw_len, nb, bs, seg, r);
  const int k = (G.cpr == 1 ? 0 : (blockIdx.x % G.cpr) * G.segs) +
                warp % G.segs;
  if (R.b >= nb || k >= nseg) return;
  if (R.bytes) warp_parse::bar_wait(bar, 0);
  const int n = min(max(raw_len[R.b], 0), bs);
  const int s0 = k * seg;
  const int s1 = s0 + min(max(n - s0, 0), seg);
  const int t = R.b * nseg + k;

  Walk<N, Mlen> w;
  w.w = (const uint32_t*)(smem + r * G.slot);
  w.off = R.rhead - R.lo;
  w.lo = R.lo;
  w.g = raw + (size_t)R.b * bs;
  w.cd = cand + (size_t)R.b * bs;
  w.gp = N > 1 || Mlen ? gaps + (size_t)R.b * bs : nullptr;
  w.d = streams + (size_t)t * scap;
  w.cap = scap;
  w.wlim = wlim;
  w.accel = accel;
  w.lane = lane;
  int o, anchor, ns, p1, m1h;
  const bool ok = w.run(s0, s1, n, k > 0, &o, &anchor, &ns, &p1, &m1h);
  if (lane == 0) {
    slen[t] = o;
    serr[t] = ok ? 0 : 1;
    last_end[t] = anchor;
    nseq[t] = ns;
    p1_out[t] = p1;
    m1h_out[t] = m1h;
  }
}

}  // namespace seg_warp

// One warp a segment at N candidates a probe (gaps: the second tape, the
// gaps at N = 3, the codes in the mlen mode); the CTA's shape from
// Geometry. A shared-memory size the card refuses is returned as the
// launch's error. Internal linkage, so that `sized` is this library's own
// beside another build of this header in the same process.
template <int N, bool Mlen = false>
static int launch_parse_seg_warp(const void* raw, const void* cand,
                                 const void* gaps, const void* raw_len,
                                 void* streams, void* slen, void* serr,
                                 void* last_end, void* nseq, void* p1,
                                 void* m1h, int nb, int bs, int seg,
                                 int scap, int wlim, int accel,
                                 void* stream) {
  using namespace seg_warp;
  if (seg < 1 || bs % seg) return (int)cudaErrorInvalidValue;
  const Geometry G(nb, bs, seg);
  static int sized = 0;
  if (G.bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        parse_seg_warp_kernel<N, Mlen>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G.bytes);
    if (e != cudaSuccess) return (int)e;
    sized = G.bytes;
  }
  if (nb > 0)
    parse_seg_warp_kernel<N, Mlen><<<G.ctas, 32 * G.rows * G.segs, G.bytes,
                                     (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)cand, (const int*)gaps,
        (const int*)raw_len, (uint8_t*)streams, (int*)slen, (int*)serr,
        (int*)last_end, (int*)nseq, (int*)p1, (int*)m1h, nb, bs, seg, scap,
        wlim, accel);
  return (int)cudaGetLastError();
}

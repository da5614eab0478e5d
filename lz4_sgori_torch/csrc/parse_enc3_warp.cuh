// The whole-block parses of K7 (parse_enc3.cu), K8-enc3
// (parse_enc3_deep.cu) and K10c (parse_enc3_mlen.cu), one warp a block,
// the block resident in shared memory. At N = 3 and 5 candidates a probe
// it computes the serial parse of golden.compress_deep (its loop and
// best-of-N probe, best_at, as the first design's one-thread kernel ran
// it over the whole block, then the terminal literal run); at N = 1 that
// of golden.compress_dense (its greedy loop over one segment spanning the
// block, then the terminal literal run), and in the mlen mode (Mlen, N =
// 1, K10c) the same over the verified candidates and match codes of
// mcode.cu (golden.dense_mcode). Bit for bit, with the 32 lanes splitting
// each step of the walk:
//
// - The block. Its n bytes go into shared memory by one cp.async.bulk
//   (from the row's address rounded down to 16: raw byte i lies at rhead
//   + i). Reads run past n by at most 132 bytes, into slack whose bytes
//   only ever meet a cap (cl, lim) that excludes them.
// - The tapes. cand, at N = 3 and 5 gaps, at N = 5 gaps2, and in the
//   mlen mode cand_v and mcode, an int32 a position, stream through a
//   ring of kChunks chunks of kChunk positions a tape, one cp.async group
//   a chunk (empty past the block). The walk reads them at increasing positions only; a round waits for
//   every chunk but the last one issued, so kChunk x (kChunks - 1)
//   positions from the round's first chunk are resident.
// - The search. The skip schedule is fixed from a sequence's start: with
//   A = accel << 6 and S(x) = sum_{y < x} (y >> 6), probe k sits at p_0 =
//   start, p_k = start + 1 + S(A + k - 1) - S(A) for k >= 1, and runs only
//   if p_{k+1} <= mfl + 1. Lane j takes probe K0 + j of a round (the
//   first round's offsets, the same for every sequence, computed once).
//   At N = 1 a probe at p hits when d = cand[p] has 0 < d <= 65535, d <=
//   p and read32 at p - d equals read32 at p (K3's test,
//   parse_seg_warp.cuh); in the mlen mode with no read32 (pass 1 verified
//   the candidate and zeroed one that failed). At N = 3 and 5 it hits
//   when one of its chain candidates passes best_at's checks (d1 in (0,
//   wlim], each link while the gaps before it are non-zero, m >= 0, d <=
//   wlim, read32 equal; every candidate's word is read and masked after,
//   so the lanes do not diverge). The ballot's first hit is the probe the
//   serial loop stops at.
// - The previews (N = 3 and 5). The hit probe p's candidates and p + 1's
//   (when p + 1 <= mfl) are previewed together, two lanes a candidate, 32
//   bytes a lane as 8 words of XOR (the first set bit of the first
//   non-zero word is the first mismatch), capped at cl = min(mlim - p - 4,
//   64). The longest wins, the nearest (first in chain order) on a tie:
//   the largest key (mc + 1) << 4 | (15 - i) over the lanes
//   (__reduce_max_sync). The lazy step is taken when p + 1's best is
//   strictly longer.
// - Catch-up compares 32 bytes back a step; in the mlen mode it first
//   goes back delta = min(cu, pos - anchor, mpos) bytes from the hit's
//   code and compares on only when delta is the code's cap, 4. The
//   extension starts from what is known equal: the catch-up's bytes,
//   read32's 4 and (N > 1) the winner's preview or (mlen) the code's lcp;
//   a preview that stopped short of its 64 bytes (or at mlim's cap), or an
//   lcp short of 8, ends the match, else (and at N = 1 outside the mlen
//   mode always) it goes on 128 bytes a step (a word a lane) to mlim.
//   Literals copy a byte a lane;
//   LSIC runs of 255 are written a lane each. The token and the header
//   bytes are lane 0's.
// - The output. The stream is staged in shared memory (out byte o at
//   ohead + o, ohead the row's address mod 16) and leaves once, at the
//   end: the row's unaligned head and tail a byte a lane, 16-byte stores
//   between. A stream that would pass cap sets err and writes nothing: the
//   wrapper's row is zero already, and out_len, tails and nseq are 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_parse {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunks = 4;          // ring chunks a tape (a power of two)
constexpr int kSlack = 256;         // raw bytes past n that reads may touch
constexpr int kMaxWarps = 8;        // blocks a CTA (small blocks)
constexpr int kMaxWarps1 = 1;       // at N = 1 (K7): a CTA a block
constexpr int kSmemLimit = 232448;  // the H100's opt-in shared memory

// The ring tapes a walk at N candidates reads: cand; gaps; gaps2 (the mlen
// mode: cand_v; mcode).
__host__ __device__ constexpr int tapes(int N, bool mlen = false) {
  return N == 1 ? (mlen ? 2 : 1) : N > 3 ? 3 : 2;
}
__host__ __device__ constexpr int max_warps(int N) {
  return N == 1 ? kMaxWarps1 : kMaxWarps;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(K) : "memory");
}

// S(x) = sum_{y < x} (y >> 6), the skip schedule's running sum.
__device__ __forceinline__ long long skip_sum(long long x) {
  const long long q = x >> 6, r = x & 63;
  return 32 * q * (q - 1) + r * q;
}

// The per-warp layout in shared memory, the same on host and device.
struct Layout {
  int raw, out, tape, chunk_log, bytes;
  __host__ __device__ Layout(int bs, int cap, int ntapes) {
    raw = (16 + bs + kSlack + 15) & ~15;
    out = (16 + cap + 16 + 15) & ~15;
    chunk_log = bs > 8192 ? 9 : 8;      // 512 or 256 positions a chunk
    tape = (kChunks << chunk_log) * 4;
    bytes = raw + out + ntapes * tape + 16;
  }
};

// One block's walk by one warp. Returns {o, tail offset, nseq} through
// the references; false when the stream would pass cap. Mlen: the mlen
// mode (N = 1), tape 1 the codes.
template <int N, bool Mlen = false>
struct Walk {
  static_assert(!Mlen || N == 1, "the mlen mode at one candidate");
  const uint8_t* s;          // raw, shifted so that s[i] is byte i
  uint8_t* d;                // staged stream, d[o] is output byte o
  int* ring[3];              // tape rings: cand, gaps, gaps2 (or mcode)
  const int* tape[3];        // the block's rows of the tapes
  int chunk_log, wmask;      // positions a chunk (log), ring positions - 1
  int wbase, whi;            // the resident window's first chunk, issued
  int n, bs, cap, accel, lane;
  bool vec16;

  __device__ __forceinline__ uint32_t rd32(int i) const {
    // an unaligned word from two aligned ones
    const uintptr_t a = (uintptr_t)(s + i);
    const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
    return __funnelshift_r(w[0], w[1], (uint32_t)(a & 3) * 8);
  }

  __device__ __forceinline__ int tp(int t, int p) const {
    return ring[t][p & wmask];
  }

  __device__ void issue(int c) {
    const int C = 1 << chunk_log;
    const int lo = c << chunk_log;
    if (lo < bs) {
      const int hi = min(lo + C, bs);
      for (int t = 0; t < tapes(N, Mlen); t++) {
        if (vec16 && hi - lo == C) {
          for (int i = 4 * lane; i < C; i += 128)
            cp_async16(&ring[t][(lo + i) & wmask], tape[t] + lo + i);
        } else {
          for (int i = lo + lane; i < hi; i += 32)
            cp_async4(&ring[t][i & wmask], tape[t] + i);
        }
      }
    }
    cp_commit();
  }

  // Make chunks [c0, c0 + kChunks - 1) resident (c0 never decreases).
  __device__ void window(int p0) {
    const int c0 = p0 >> chunk_log;
    if (c0 == wbase) return;
    const int first = max(whi, c0);
    if (c0 + kChunks - first > 1) cp_wait<0>();  // a slot's old chunk lands
    __syncwarp();
    for (int c = first; c < c0 + kChunks; c++) issue(c);
    whi = c0 + kChunks;
    wbase = c0;
    cp_wait<1>();
    __syncwarp();
  }

  __device__ __forceinline__ int resident_end() const {
    return (wbase + kChunks - 1) << chunk_log;
  }

  // The chain candidates at p: distances ds[0..N), live bits.
  __device__ __forceinline__ int chain(int p, int* ds) const {
    const int d1 = tp(0, p);
    const int g = tp(1, p);
    const int g2 = N > 3 ? tp(2, p) : 0;
    int live = (d1 != 0 && d1 <= 65535) ? 1 : 0;
    ds[0] = d1;
    ds[1] = ds[0] + (g & 255);
    live |= (live & 1) && (g & 255) ? 2 : 0;
    ds[2] = ds[1] + (g >> 8);
    live |= (live & 2) && (g >> 8) ? 4 : 0;
    if constexpr (N > 3) {
      ds[3] = ds[2] + (g2 & 255);
      live |= (live & 4) && (g2 & 255) ? 8 : 0;
      ds[4] = ds[3] + (g2 >> 8);
      live |= (live & 8) && (g2 >> 8) ? 16 : 0;
    }
    return live;
  }

  // best_at's check of candidate dd at p (v = read32 at p), without a
  // branch: the word is read at m clamped into [0, p], and the check
  // drops it where m < 0.
  __device__ __forceinline__ bool usable(int p, int dd, uint32_t v) const {
    const int m = p - dd;
    return (m >= 0) & (dd <= 65535) & (rd32(min(max(m, 0), p)) == v);
  }

  // Whether the probe at p hits: at N = 1 K3's test (Mlen: without
  // read32); else whether some chain candidate passes best_at's checks.
  // Every candidate's word is read, live or not, so that the lanes do not
  // diverge.
  __device__ bool probe_hits(int p) const {
    if constexpr (N == 1) {
      const int d = tp(0, p);
      const bool ok = (d > 0) & (d <= 65535) & (d <= p);
      if constexpr (Mlen) return ok;
      return ok & (rd32(ok ? p - d : p) == rd32(p));
    }
    int ds[5];
    const int live = chain(p, ds);
    const uint32_t v = rd32(p);
    int ok = 0;
#pragma unroll
    for (int i = 0; i < N; i++) ok |= (int)usable(p, ds[i], v) << i;
    return (ok & live) != 0;
  }

  // Previews at p and (lazy) p + 1, two lanes a candidate: slots 0-7 for
  // p's chain, 8-15 for p + 1's. Returns the best preview at p (>= 0) and
  // its match position, and p + 1's (-1 for none) in *mb / *mposb.
  __device__ int previews(int p, bool lazy, int mlim, int* mpos, int* mb,
                          int* mposb) const {
    const int slot = lane >> 1, half = lane & 1;
    const int q = p + (slot >> 3);
    const int ci = slot & 7;
    // every lane reads, wanted or not (no divergence); the key drops the
    // lanes past the chain, p + 1's when not lazy, and the unusable
    int ds[5];
    const int live = chain(q, ds);
    int dd = ds[0];
#pragma unroll
    for (int i = 1; i < N; i++) dd = ci == i ? ds[i] : dd;
    const int m = q - dd, mr = min(max(m, 0), q);
    const bool ok = (ci < N) & ((slot < 8) | lazy) &
                    (((live >> ci) & 1) != 0) & usable(q, dd, rd32(q));
    // the first mismatch of this lane's 32 bytes (32 for none)
    const int b0 = 4 + 32 * half;
    int mm = 32;
#pragma unroll
    for (int w = 7; w >= 0; w--) {
      const uint32_t x = rd32(q + b0 + 4 * w) ^ rd32(mr + b0 + 4 * w);
      mm = x ? 4 * w + ((__ffs(x) - 1) >> 3) : mm;
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

  // LSIC bytes for rem: rem / 255 bytes of 255 and rem % 255, if cap
  // allows (else false: the stream would pass cap).
  __device__ __forceinline__ bool lsic(int& o, int rem) {
    const int nff = rem / 255;
    if (nff + 1 > cap - o) return false;
    for (int i = lane; i < nff; i += 32) d[o + i] = 255;
    if (lane == 0) d[o + nff] = (uint8_t)(rem - 255 * nff);
    o += nff + 1;
    return true;
  }

  // The whole parse: the serial loop at s0 = 0, window 65535, then the
  // terminal literals. Returns false for err.
  __device__ bool run(int& o_out, int& tpos, int& nseq_out) {
    const int mfl = n - 12, mlim = n - 5;
    const long long A = (long long)accel << 6;
    const long long SA = skip_sum(A);
    // the first round's offsets from a sequence's start, the same for
    // every sequence: lane j's probe (p_j - start) and the next (p_{j+1})
    const int d0 = lane == 0 ? 0 : (int)min(1 + skip_sum(A + lane - 1) - SA,
                                            (long long)1 << 30);
    const int d1 = (int)min(1 + skip_sum(A + lane) - SA, (long long)1 << 30);
    int o = 0, anchor = 0, nseq = 0, pos = 1;
    bool bad = false;
    for (;;) {
      // ---- the search, 32 probes a round ----
      const int start = pos;
      long long k0 = 0;
      int hp = -1;
      for (;;) {
        long long pk = start + d0, pn = start + d1;
        if (k0) {
          const long long k = k0 + lane;
          pk = start + 1 + skip_sum(A + k - 1) - SA;
          pn = start + 1 + skip_sum(A + k) - SA;
        }
        const bool valid = pn <= mfl + 1;
        // lane 0's probe (start, and start + 1 next, in a first round)
        const int p0 = k0 ? __shfl_sync(kAll, (int)min(pk, (long long)n), 0)
                          : start;
        if (k0 ? !__shfl_sync(kAll, valid, 0) : start > mfl) break;
        window(p0);
        const bool act = valid && pk + 1 < resident_end();
        const bool hit = probe_hits(act ? (int)pk : p0) & act;
        const unsigned hits = __ballot_sync(kAll, hit);
        if (hits) {
          hp = __shfl_sync(kAll, (int)pk, __ffs(hits) - 1);
          break;
        }
        const unsigned acts = __ballot_sync(kAll, act);
        const unsigned vals = __ballot_sync(kAll, valid);
        if (vals != kAll && (acts | ~vals) == kAll) break;  // schedule ends
        k0 += __popc(acts);
      }
      if (hp < 0) break;
      // ---- the match: hp's candidate (N = 1), or the best at hp and the
      // lazy step at hp + 1 (pmc: the winner's preview, pcl its cap; Mlen:
      // the code's lcp, capped at 8) ----
      int mpos, pmc = 0, pcl = 0, code = 0;
      pos = hp;
      if constexpr (N == 1) {
        mpos = hp - tp(0, hp);
        if constexpr (Mlen) {
          code = tp(1, hp);
          pmc = (code >> 1) & 15;
          pcl = 8;
        }
      } else {
        int mb, mposb;
        const bool lazy = hp + 1 <= mfl;
        pmc = previews(hp, lazy, mlim, &mpos, &mb, &mposb);
        if (lazy && mb > pmc) {
          pos = hp + 1;
          mpos = mposb;
          pmc = mb;
        }
        pcl = min(mlim - pos - 4, 64);
      }
      int back = 0;                    // bytes the catch-up goes back
      // ---- catch-up, 32 bytes a step, capped at the anchor ----
      // (Mlen: the code's cu bytes first, then the steps only where they
      // reached its cap)
      bool steps = true;
      if constexpr (Mlen) {
        back = min(min((code >> 6) & 7, pos - anchor), mpos);
        pos -= back;
        mpos -= back;
        steps = back == 4;
      }
      while (steps) {
        const bool ok = lane < pos - anchor && lane < mpos &&
                        s[pos - 1 - lane] == s[mpos - 1 - lane];
        const unsigned stop = __ballot_sync(kAll, !ok);
        const int c = stop ? __ffs(stop) - 1 : 32;
        pos -= c;
        mpos -= c;
        back += c;
        if (c < 32) break;
      }
      // ---- the sequence: token, literal LSIC, literals, offset ----
      const int lit = pos - anchor;
      const int token_at = o;
      int token;
      if (o >= cap) { bad = true; break; }
      o++;
      if (lit >= 15) {
        token = 15 << 4;
        if (!lsic(o, lit - 15)) { bad = true; break; }
      } else {
        token = lit << 4;
      }
      if (lit > cap - o) { bad = true; break; }
      for (int i = lane; i < lit; i += 32) d[o + i] = s[anchor + i];
      o += lit;
      const int off = pos - mpos;
      if (2 > cap - o) { bad = true; break; }
      if (lane == 0) {
        d[o] = (uint8_t)(off & 255);
        d[o + 1] = (uint8_t)(off >> 8);
      }
      o += 2;
      // ---- forward extension, 128 bytes a step, capped at mlim ----
      // The bytes from pos through the probe's 4 and its preview are
      // known equal: the catch-up's, read32's and the preview's. A preview
      // that stopped before its cap (or at mlim's) ends the match there;
      // one that ran the 64 bytes goes on from its end. At N = 1 there is
      // no preview (pmc = pcl = 0): the extension goes on from read32's 4;
      // in the mlen mode from the code's lcp bytes, when they are its cap.
      const int p = pos + 4, m = mpos + 4, lim = mlim - p;
      int mc = back + pmc;
      for (bool more = pmc == pcl && mc < lim; more;) {
        const uint32_t x = rd32(p + mc + 4 * lane) ^ rd32(m + mc + 4 * lane);
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
      pos = p + mc;
      if (mc >= 15) {
        token += 15;
        if (!lsic(o, mc - 15)) { bad = true; break; }
      } else {
        token += mc;
      }
      if (lane == 0) d[token_at] = (uint8_t)token;
      nseq++;
      anchor = pos;
      if (pos > mfl) break;
    }
    tpos = o;
    if (!bad) {
      // the terminal literal-only sequence: token, LSIC, literals
      const int lit = n - anchor;
      const int hlen = lit >= 15 ? 2 + (lit - 15) / 255 : 1;
      if (hlen + lit > cap - o) {
        bad = true;
      } else {
        if (lane == 0) d[o] = (uint8_t)(min(lit, 15) << 4);
        o++;
        if (lit >= 15) lsic(o, lit - 15);
        for (int i = lane; i < lit; i += 32) d[o + i] = s[anchor + i];
        o += lit;
      }
    }
    o_out = o;
    nseq_out = nseq;
    return !bad;
  }
};

template <int N, bool Mlen>
__global__ void parse_warp_kernel(const uint8_t* __restrict__ raw,
                                  const int* __restrict__ cand,
                                  const int* __restrict__ gaps,
                                  const int* __restrict__ gaps2,
                                  const int* __restrict__ raw_len,
                                  uint8_t* __restrict__ out,
                                  int* __restrict__ out_len,
                                  uint8_t* __restrict__ err,
                                  int* __restrict__ tails,
                                  int* __restrict__ nseq, int nb, int bs,
                                  int slot, int cap, int accel) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= nb) return;
  const Layout L(bs, cap, tapes(N, Mlen));
  uint8_t* base = smem + (size_t)warp * L.bytes;
  uint8_t* raw_s = base;
  uint8_t* out_s = base + L.raw;
  int* ring0 = (int*)(base + L.raw + L.out);
  uint64_t* bar = (uint64_t*)(base + L.bytes - 16);

  const uint8_t* src = raw + (size_t)t * bs;
  uint8_t* dst = out + (size_t)t * slot;
  const int n = min(max(raw_len[t], 0), bs);
  const int rhead = (int)((uintptr_t)src & 15);
  const int ohead = (int)((uintptr_t)dst & 15);

  Walk<N, Mlen> w;
  w.s = raw_s + rhead;
  w.d = out_s + ohead;
  const int W = kChunks << L.chunk_log;
  for (int i = 0; i < 3; i++) w.ring[i] = ring0 + i * W;
  w.tape[0] = cand + (size_t)t * bs;
  w.tape[1] = N > 1 || Mlen ? gaps + (size_t)t * bs : nullptr;
  w.tape[2] = N > 3 ? gaps2 + (size_t)t * bs : nullptr;
  w.chunk_log = L.chunk_log;
  w.wmask = W - 1;
  w.wbase = -1;
  w.whi = 0;
  w.n = n;
  w.bs = bs;
  w.cap = cap;
  w.accel = accel;
  w.lane = lane;
  w.vec16 = ((uintptr_t)w.tape[0] & 15) == 0 &&
            (tapes(N, Mlen) == 1 || ((uintptr_t)w.tape[1] & 15) == 0) &&
            (N <= 3 || ((uintptr_t)w.tape[2] & 15) == 0);

  // the block by one bulk copy: every 16 bytes of it hold a byte of src
  const int total = n > 0 ? (rhead + n + 15) & ~15 : 0;
  if (lane == 0) {
    bar_init(bar);
    if (total)
      bulk_load(raw_s, (const uint8_t*)((uintptr_t)src & ~(uintptr_t)15),
                total, bar);
  }
  __syncwarp();
  if (total) bar_wait(bar, 0);

  int o = 0, tpos = 0, ns = 0;
  const bool ok = w.run(o, tpos, ns);
  cp_wait<0>();                 // no tape copy may land after the warp
  __syncwarp();
  if (ok) {
    // the stream to the row: the unaligned head and tail a byte a lane,
    // 16-byte stores between (ohead + o is the staged end)
    uint8_t* g = (uint8_t*)((uintptr_t)dst & ~(uintptr_t)15);
    const int xe = ohead + o;
    const int v0 = min((ohead + 15) & ~15, xe), v1 = max(xe & ~15, v0);
    for (int x = ohead + lane; x < v0; x += 32) g[x] = out_s[x];
    for (int x = v0 + 16 * lane; x < v1; x += 512)
      *(uint4*)(g + x) = *(const uint4*)(out_s + x);
    for (int x = v1 + lane; x < xe; x += 32) g[x] = out_s[x];
  }
  if (lane == 0) {
    out_len[t] = ok ? o : 0;
    err[t] = ok ? 0 : 1;
    tails[t] = ok ? tpos : 0;
    nseq[t] = ok ? ns : 0;
  }
}

}  // namespace warp_parse

// One warp a block; blocks a CTA as shared memory allows (one at 64 KiB,
// up to max_warps(N) for small blocks). gaps: the second tape (the mlen
// mode's codes). A shared-memory size the card refuses is returned as the
// launch's error. Internal linkage: the static below must be this
// library's own, not one that another build of this header loaded in the
// same process (a parent tree's) would share.
template <int N, bool Mlen = false>
static int launch_parse_warp(const void* raw, const void* cand, const void* gaps,
                      const void* gaps2, const void* raw_len, void* out,
                      void* out_len, void* err, void* tails, void* nseq,
                      int nb, int bs, int slot, int cap, int accel,
                      void* stream) {
  using namespace warp_parse;
  const Layout L(bs, cap, tapes(N, Mlen));
  const int wpc = max(1, min(max_warps(N), kSmemLimit / L.bytes));
  const int bytes = wpc * L.bytes;
  static int sized = 0;
  if (bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        parse_warp_kernel<N, Mlen>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = bytes;
  }
  if (nb > 0)
    parse_warp_kernel<N, Mlen><<<(nb + wpc - 1) / wpc, 32 * wpc, bytes,
                                 (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)cand, (const int*)gaps,
        (const int*)gaps2, (const int*)raw_len, (uint8_t*)out, (int*)out_len,
        (uint8_t*)err, (int*)tails, (int*)nseq, nb, bs, slot, cap, accel);
  return (int)cudaGetLastError();
}

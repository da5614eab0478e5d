// Verified candidates and match codes of the mlen mode (K10a): each CTA
// holds its blocks' bytes in shared memory and reads them in words.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel with
// mlen_mode (VMEM payloads, call :764) and mlen_hbm (HBM payloads, call
// :719), with _sort_ref_p (:186) and _sort_ref_hbm (:254). The TPU carries
// four payload words (v32, w+4, w+8, w-4) through its bitonic sort beside
// the keys, because Mosaic has no scatter or hash table. Here the values
// are a pointwise function of K2's candidate tape and the bytes, so no
// sort is needed: for p with d = cand[p] in [1, p] and q = p - d,
//   vr  = read32(p) == read32(q);
//   lcp = equal bytes of [p+4, p+12) against [q+4, q+12), up to 8;
//   cu  = trailing equal bytes of [p-4, p) against [q-4, q), up to 4;
// where every byte outside [0, n), n = clamp(raw_len, 0, bs), reads 0 on
// both sides (golden.dense_mcode's bytes(4) + src + bytes(12),
// lz4_sgori_tpu/golden.py:735-792). Outputs, int32 [B, bs] each:
//   cand_v = d where vr holds, else 0;
//   mcode  = more_f | lcp << 1 | more_b << 5 | cu << 6 (more_f: lcp == 8,
//            more_b: cu == 4), 0 where cand_v is 0.
//
// The design. A CTA takes `rows` consecutive blocks (16 KiB of them, one
// at 64 KiB, the mode's largest), the block index in gridDim.x; where
// that gives fewer than four CTAs an SM (config 1's 512 blocks of 64 KiB;
// a few blocks: a store's write, a subset), a CTA takes a run of one
// block's quads instead (at least 1024 positions), so the CTAs fill the
// card in even waves and one block spreads over many SMs. It copies each row,
// up to the last word its quads read, into its own segment of shared
// memory in 16-byte words that keep the row's alignment in global memory
// (row byte x at segment byte 16 + a + x, a = the row's address mod 16),
// zeroing every byte outside [0, n): the 4 bytes before the row and the
// 12 after it are golden's pads, and the bytes past n, which the caller
// need not have zeroed, read 0. kUnroll loads are in flight a thread.
// Each thread then takes 4 consecutive positions (an aligned quad of the
// outputs), loads their candidates as one int4 (the next kUnroll quads'
// before this step's compares), and builds every 32-bit word it compares
// from two aligned shared-memory words by a funnel shift: six words (one
// a lane, conflict-free) and five shifts give the words at p-4, p, p+4
// and p+8 of all four positions; two words at q give the verify check,
// three more the rest. lcp is the trailing zero bytes of the XOR of the
// words at p+4 and q+4 (then p+8 and q+8), cu the leading zero bytes of
// the XOR of the words ending at p-1 and q-1. cand_v and mcode leave as
// int4 stores; a quad that straddles the row's ends (any block size is
// allowed) goes element by element.
//
// What bounds it on the H100: memory, 13 bytes a position (the candidate
// read, the byte read, two int32 words written), with no 64-bit division
// and 16-byte accesses throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;         // loads a thread issues together
constexpr int kRowBytes = 16384;   // shared bytes of whole rows a CTA
constexpr int kWaveCtas = 4;       // CTAs an SM below which rows are split
constexpr int kMinTile = 1024;     // the fewest positions a split CTA owns
constexpr int kMaxBlock = 65536;   // the mlen mode's largest block

// A row's segment: 16 bytes before the row's first aligned word, the row,
// and its tail, so every word the quads read lies inside it.
__host__ __device__ __forceinline__ int seg_stride(int bs) {
  return (bs + 50 + 15) & ~15;
}

// The row positions x .. x+3 of a little-endian word that lie in [0, n).
__device__ __forceinline__ uint32_t live_mask(int x, int n) {
  const int hi = min(max(n - x, 0), 4);
  const int lo = min(max(-x, 0), 4);
  const uint32_t m = hi == 4 ? 0xffffffffu : (1u << (8 * hi)) - 1u;
  return lo == 4 ? 0u : m & (0xffffffffu << (8 * lo));
}

// Items r * q + k visited in steps of `step` with one division a thread.
struct Items {
  int r, k, dr, dk, q;
  __device__ Items(int start, int step, int q_)
      : r(start / q_), k(start % q_), dr(step / q_), dk(step % q_), q(q_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    k += dk;
    if (k >= q) {
      k -= q;
      r++;
    }
  }
};

__device__ __forceinline__ int code_of(uint32_t pm4, uint32_t p4,
                                       uint32_t p8, uint32_t qm4,
                                       uint32_t q4, uint32_t q8) {
  const uint32_t x = p4 ^ q4, y = p8 ^ q8, z = pm4 ^ qm4;
  const int lcp = x ? (__ffs(x) - 1) >> 3
                    : y ? 4 + ((__ffs(y) - 1) >> 3) : 8;
  const int cu = z ? __clz(z) >> 3 : 4;
  return (lcp == 8) | (lcp << 1) | ((cu == 4) << 5) | (cu << 6);
}

// The launch's geometry: CTAs of `rows` whole rows (as many as fill
// kRowBytes, one at 64 KiB); where that gives fewer than kWaveCtas CTAs
// an SM, CTAs of one of `tiles`
// runs of a row's quads instead, at least kMinTile positions each, each
// CTA staging the row up to its last quad. ceil(nb / rows) * tiles CTAs.
struct Geom {
  int rows, tiles, S;
  __host__ Geom(int nb, int bs, int sms) : S(seg_stride(bs)) {
    rows = kRowBytes / S > 1 ? kRowBytes / S : 1;
    tiles = 1;
    const int want = kWaveCtas * sms;
    if ((nb + rows - 1) / rows < want) {
      rows = 1;
      tiles = min((want + nb - 1) / nb, (bs + kMinTile - 1) / kMinTile);
    }
  }
};

__global__ void __launch_bounds__(kThreads)
mcode_kernel(const int* __restrict__ cand, const uint8_t* __restrict__ raw,
             const int* __restrict__ raw_len, int* __restrict__ cand_v,
             int* __restrict__ mcode, int nb, int bs, Geom G,
             bool cand_quads) {
  extern __shared__ uint4 smem[];
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(smem);
  const int S = G.S;
  const int t = blockIdx.x % G.tiles;
  const int b0 = (blockIdx.x / G.tiles) * G.rows;
  const int nr = min(G.rows, nb - b0);
  const int Q = (bs + 6) >> 2;              // quads a row, any alignment
  const int Qt = (Q + G.tiles - 1) / G.tiles;
  const int kbeg = t * Qt, kend = min(Q, kbeg + Qt);
  if (kbeg >= kend) return;

  // ---- the rows' words this tile reads, kUnroll loads in flight ----
  {
    const int words = min(S >> 4, (46 + 4 * kend) / 16 + 1);
    Items it(threadIdx.x, kThreads, words);
    while (it.r < nr) {
      uint4 w[kUnroll];
      int r[kUnroll], k[kUnroll], x0[kUnroll], n[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; u++, it.next()) {
        r[u] = it.r;
        k[u] = it.k;
        w[u] = make_uint4(0, 0, 0, 0);
        x0[u] = n[u] = 0;
        if (it.r >= nr) continue;
        const uint8_t* g = raw + (size_t)(b0 + it.r) * bs;
        const int a = (int)((uintptr_t)g & 15);
        n[u] = min(max(raw_len[b0 + it.r], 0), bs);
        x0[u] = 16 * (it.k - 1) - a;         // row position of byte 0
        if (x0[u] + 16 > 0 && x0[u] < n[u])
          w[u] = __ldg(reinterpret_cast<const uint4*>(g - a) + (it.k - 1));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        if (r[u] >= nr) continue;
        if (x0[u] < 0 || x0[u] + 16 > n[u]) {
          w[u].x &= live_mask(x0[u], n[u]);
          w[u].y &= live_mask(x0[u] + 4, n[u]);
          w[u].z &= live_mask(x0[u] + 8, n[u]);
          w[u].w &= live_mask(x0[u] + 12, n[u]);
        }
        smem[r[u] * (S >> 4) + k[u]] = w[u];
      }
    }
  }
  __syncthreads();

  // ---- the quads, kUnroll a thread a step, the next step's candidates
  // loaded before this step's compares ----
  const int items = nr * (kend - kbeg);
  const int steps = (items + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  Items it(threadIdx.x, kThreads, kend - kbeg);
  int cr[kUnroll], ck[kUnroll], cd[kUnroll][4];
  auto fetch = [&](int (&r)[kUnroll], int (&k)[kUnroll],
                   int (&d)[kUnroll][4]) {
#pragma unroll
    for (int u = 0; u < kUnroll; u++, it.next()) {
      r[u] = it.r;
      k[u] = kbeg + it.k;
      d[u][0] = d[u][1] = d[u][2] = d[u][3] = 0;
      if (it.r >= nr) continue;
      const size_t base = (size_t)(b0 + it.r) * bs;
      const int p0 = 4 * k[u] - (int)(((uintptr_t)(cand_v + base) >> 2) & 3);
      if (p0 >= 0 && p0 + 4 <= bs && cand_quads) {
        const int4 c =
            __ldg(reinterpret_cast<const int4*>(cand + base + p0));
        d[u][0] = c.x; d[u][1] = c.y; d[u][2] = c.z; d[u][3] = c.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; i++)
          if (p0 + i >= 0 && p0 + i < bs) d[u][i] = __ldg(cand + base + p0 + i);
      }
    }
  };
  fetch(cr, ck, cd);
  for (int step = 0; step < steps; step++) {
    int nr_[kUnroll], nk[kUnroll], nd[kUnroll][4];
    if (step + 1 < steps) fetch(nr_, nk, nd);
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      if (cr[u] >= nr) continue;
      const size_t base = (size_t)(b0 + cr[u]) * bs;
      const int p0 = 4 * ck[u] - (int)(((uintptr_t)(cand_v + base) >> 2) & 3);
      if (p0 >= bs) continue;
      const int a = (int)((uintptr_t)(raw + base) & 15);
      const int o = cr[u] * S + 16 + a;        // row position 0's byte
      const int A = o + p0 - 4;
      const int sh = 8 * (A & 3);
      uint32_t W[6], V[5];
#pragma unroll
      for (int m = 0; m < 6; m++) W[m] = s32[(A >> 2) + m];
#pragma unroll
      for (int m = 0; m < 5; m++)
        V[m] = __funnelshift_r(W[m], W[m + 1], sh);
      int cv[4], mc[4];
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const int p = p0 + i, d = cd[u][i];
        cv[i] = mc[i] = 0;
        if (d <= 0 || d > p) continue;
        const int B = o + p - d - 4;           // q - 4
        const int bw = B >> 2, shq = 8 * (B & 3);
        const uint32_t X1 = s32[bw + 1], X2 = s32[bw + 2];
        if (__funnelshift_r(V[1], V[2], 8 * i) !=
            __funnelshift_r(X1, X2, shq))
          continue;
        const uint32_t X0 = s32[bw], X3 = s32[bw + 3], X4 = s32[bw + 4];
        cv[i] = d;
        mc[i] = code_of(__funnelshift_r(V[0], V[1], 8 * i),
                        __funnelshift_r(V[2], V[3], 8 * i),
                        __funnelshift_r(V[3], V[4], 8 * i),
                        __funnelshift_r(X0, X1, shq),
                        __funnelshift_r(X2, X3, shq),
                        __funnelshift_r(X3, X4, shq));
      }
      if (p0 >= 0 && p0 + 4 <= bs) {
        *reinterpret_cast<int4*>(cand_v + base + p0) =
            make_int4(cv[0], cv[1], cv[2], cv[3]);
        *reinterpret_cast<int4*>(mcode + base + p0) =
            make_int4(mc[0], mc[1], mc[2], mc[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; i++) {
          const int p = p0 + i;
          if (p >= 0 && p < bs) {
            cand_v[base + p] = cv[i];
            mcode[base + p] = mc[i];
          }
        }
      }
    }
    if (step + 1 < steps) {
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        cr[u] = nr_[u];
        ck[u] = nk[u];
#pragma unroll
        for (int i = 0; i < 4; i++) cd[u][i] = nd[u][i];
      }
    }
  }
}

}  // namespace

static int card_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
  }
  return sms;
}

extern "C" int lz4t_mcode(const void* cand, const void* raw,
                          const void* raw_len, void* cand_v, void* mcode,
                          int nb, int bs, void* stream) {
  if (nb <= 0 || bs <= 0) return 0;
  if (bs > kMaxBlock || ((uintptr_t)cand_v & 15) || ((uintptr_t)mcode & 15))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;   // the most any geometry takes
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        mcode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        seg_stride(kMaxBlock) > kRowBytes ? seg_stride(kMaxBlock)
                                          : kRowBytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int sms = card_sms();
  if (!sms) return (int)cudaGetLastError();
  const Geom G(nb, bs, sms);
  const bool quads = ((uintptr_t)cand & 15) == 0;
  const unsigned ctas = (unsigned)((nb + G.rows - 1) / G.rows) * G.tiles;
  mcode_kernel<<<ctas, kThreads, (size_t)G.rows * G.S,
                 (cudaStream_t)stream>>>(
      (const int*)cand, (const uint8_t*)raw, (const int*)raw_len,
      (int*)cand_v, (int*)mcode, nb, bs, G, quads);
  return (int)cudaGetLastError();
}

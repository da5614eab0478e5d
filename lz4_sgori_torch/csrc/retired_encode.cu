// T1, the retired greedy level-1 LZ4 encoder: one warp a block, the block
// in shared memory, 32 probes a round of the skip search.
//
// Replaces tools/retired/encode_kernel.py:_encode_kernel (the pallas_call
// at :415), which walks one block per grid cell on the TPU's scalar core
// with the source, the output and the hash table mirrored in SMEM.
//
// Contract (golden.compress(block, acceleration), lz4_sgori_tpu/golden.py
// :36-195): the reference's greedy match finder with a single-probe
// 13-bit table of 4-byte hashes, the skip search started at
// acceleration << SKIPTRIGGER, catch-up, the match with immediate rematch
// and the two-byte-back refill, and literal-only output below 13 bytes.
// Blocks are at most 64 KiB, where golden uses this same table, so the
// stream is LZ4_compress_default's (LZ4_compress_fast's) byte for byte.
// n = raw_len clamped to [0, bs]; no decision reads a byte at or past n
// (the search stops at n - MFLIMIT, the match count at n - LASTLITERALS),
// so bytes past raw_len never matter. comp is zero from comp_len to cb.
//
// Design. One CTA of one warp a block. Its shared memory holds the 16 KiB
// table (uint16 positions, as LZ4's own byU16 table) and the block's n
// bytes, staged by one cp.async.bulk from the row's address rounded down
// to 16 (source byte i at head + i) while the warp zeroes the table:
// about 81 KiB at 64 KiB (two CTAs an SM) and 21 KiB at 4 KiB (ten). A
// 32-bit read at any position is two aligned shared loads and a funnel
// shift. A lone warp issues each dependent instruction some cycles after
// the last, so the walk is written without branches where it can be.
// - The skip search (golden.py:87-107). Its probe positions do not depend
//   on the data until a probe matches: from (fpos, step, smn) the next 32
//   are fpos plus the prefix sums of the steps step, smn >> 6, (smn + 1)
//   >> 6, ..., which each lane computes in closed form. So each lane takes
//   one probe of a round: it is valid while the probe after it stays at
//   or before mflimit + 1 (the reference's bound, tested before its table
//   swap); it hashes its 4 bytes and reads the table as the round found
//   it, unless a lower lane of the round has its hash, when the latest
//   such lane's position (and word) is what the reference's table would
//   hold (__match_any_sync); a ballot finds the first lane k whose
//   candidate matches. Lanes 0..k (every valid lane when none matches)
//   then write the table, the highest lane of each hash last in the
//   reference's order and so the only one that writes.
// - Catch-up compares 32 bytes back a step; the match count 128 bytes on,
//   a lane a word (the first differing byte from the XOR), and each lane
//   takes the immediate rematch at its own end meanwhile (the refill at
//   end - 2, the swap at end, the candidate's compare), so that once the
//   ballot has found the match's end its rematch is known: the chain
//   from one sequence to the next is one step of the warp.
// - Literals leave shared memory a byte a lane up to 32 bytes, longer
//   runs as 16-byte stores aligned in the output row (each word two to
//   five shared words funnel-shifted) between unaligned ends; the zero
//   tail likewise. Lane 0 writes each token with its match's offset.
//
// What bounds it on the H100: the walk is one dependent chain a block
// (match end, hash, table, candidate), some hundreds of cycles a
// sequence at a warp an SM, so a block is latency-bound and the kernel is
// bound by the walks in flight: 512 blocks of 64 KiB take two waves of
// 264 (two CTAs on each of 132 SMs), 8192 of 4 KiB some six of 1320.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHashLog = 13;
constexpr int kTableEntries = 1 << kHashLog;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kMinLength = kMfLimit + 1;
constexpr int kSkipTrigger = 6;
constexpr int kMask = 15;               // RUN_MASK and ML_MASK

// Shared memory: the barrier, the table, then the staged run (its head,
// the block, and room for the match count's last step, up to 128 bytes
// and a word past limit, whose bytes past n it ignores).
constexpr int kTabAt = 16;
constexpr int kSrcAt = kTabAt + 2 * kTableEntries;
constexpr int kPad = 160;

constexpr int smem_bytes(int bs) {
  return kSrcAt + 16 + ((bs + 15) & ~15) + kPad;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes on `bar`, initialised here for it.
__device__ __forceinline__ void stage(void* dst, const void* src,
                                      uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
}

// The block in shared memory: source byte p at b[head + p].
struct Src {
  const uint8_t* b;
  int head;

  __device__ __forceinline__ int byte(int p) const { return b[head + p]; }

  __device__ __forceinline__ uint32_t read32(int p) const {
    const int a = head + p;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(b) + (a >> 2);
    return __funnelshift_r(w[0], w[1], (a & 3) * 8);
  }

  __device__ __forceinline__ uint4 read128(int p) const {
    const int a = head + p, sh = (a & 3) * 8;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(b) + (a >> 2);
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
    return make_uint4(
        __funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
        __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
  }
};

__device__ __forceinline__ int hash4(uint32_t v) {
  return (int)((v * 2654435761u) >> (32 - kHashLog));
}

// The skip search from fpos, 32 probes a round (see the note at the top).
// Returns true with pos and mpos the first match's, or false once the
// bound ends the search; the table as the reference leaves it either way.
__device__ __forceinline__ bool search(const Src& s, uint16_t* table,
                                       int fpos, int acceleration,
                                       int mflimit, int lane, int& pos,
                                       int& mpos) {
  const unsigned below = (1u << lane) - 1;
  int step = 1, smn = acceleration << kSkipTrigger;
  __syncwarp();                          // the last table writes seen
  for (;;) {
    // Probe i >= 1 lies step + sum_{j < i - 1} (smn + j) >> 6 past fpos:
    // the terms are q = smn >> 6, and q + 1 from j = 64 - (smn & 63) on.
    const int q = smn >> kSkipTrigger, r = smn & 63;
    const auto past = [&](int i) {
      return i == 0 ? 0 : step + (i - 1) * q + max(0, i - 65 + r);
    };
    const int p = fpos + past(lane);
    const bool valid = fpos + past(lane + 1) <= mflimit + 1;
    const unsigned vmask = __ballot_sync(kFull, valid);
    const uint32_t v = s.read32(valid ? p : 0);   // no branch: every lane
    const int h = hash4(v);
    const unsigned same =
        __match_any_sync(kFull, valid ? h : kTableEntries + lane);
    const int tv = table[h];
    const bool thit = s.read32(tv) == v;
    // a lower lane of the round with this hash: its position, and its
    // word as the candidate's
    const unsigned prior = same & below;
    const int j = prior ? 31 - __clz(prior) : lane;
    const int pj = __shfl_sync(kFull, p, j);
    const uint32_t vj = __shfl_sync(kFull, v, j);
    const unsigned hits =
        __ballot_sync(kFull, valid && (prior ? vj == v : thit));
    // 2u << 31 wraps to 0: a hit at lane 31 commits every lane
    const unsigned commit =
        hits ? vmask & ((2u << (__ffs(hits) - 1)) - 1) : vmask;
    __syncwarp();                        // every read before any write
    if (((commit >> lane) & 1) && !(((same & commit) >> lane) >> 1))
      table[h] = (uint16_t)p;
    __syncwarp();
    if (hits) {
      const int k = __ffs(hits) - 1;
      pos = __shfl_sync(kFull, p, k);
      mpos = __shfl_sync(kFull, prior ? pj : tv, k);
      return true;
    }
    if (vmask != kFull) return false;
    fpos += past(32);
    step = (smn + 31) >> kSkipTrigger;
    smn += 32;
  }
}

// How many bytes before pos and mpos agree, at most limit.
__device__ __forceinline__ int catch_up(const Src& s, int pos, int mpos,
                                        int limit, int lane) {
  for (int c = 0;; c += 32) {
    const int i = c + lane, j = max(min(i, limit - 1), 0);   // reads in range
    const unsigned d = __ballot_sync(
        kFull, i >= limit || s.byte(pos - 1 - j) != s.byte(mpos - 1 - j));
    if (d) return c + __ffs(d) - 1;
  }
}

// One match's length, and the immediate rematch at its end. The common
// prefix of positions p and m (m < p), at most limit > 0, a lane a word,
// 128 bytes a step. Each lane also
// takes the rematch at its own end, so that it overlaps the ballot: the
// table as the refill at end - 2 leaves it, the candidate of end, and
// whether its 4 bytes match. The lane that ends the match then writes
// the refill and the swap (lz4: pos - 2, then pos), where end is at
// most mflimit. Returns (mc, mpos, hit) for that end.
struct Step {
  int mc, mpos;
  bool hit;
};

__device__ __forceinline__ Step match_step(const Src& s, uint16_t* table,
                                           int p, int m, int limit,
                                           int mflimit, int lane) {
  __syncwarp();                          // the last table writes seen
  for (int mc = 0;; mc += 128) {
    // the word at k (past limit it may hold bytes past n: e is capped);
    // b: its first differing byte, 4 for none
    const int k = mc + 4 * lane;
    const uint32_t x = s.read32(p + k) ^ s.read32(m + k);
    const int b = __clz(__brev(x)) >> 3;
    const int e = min(k + b, limit);
    const bool stop = b < 4 || k + 4 >= limit;
    const int end = p + e;               // at most n - 5: reads stay below n
    const int h2 = hash4(s.read32(end - 2)), h = hash4(s.read32(end));
    const int cand = h == h2 ? end - 2 : table[h];
    const bool hit = s.read32(cand) == s.read32(end);
    const unsigned d = __ballot_sync(kFull, stop);
    if (d) {
      const int q = __ffs(d) - 1;
      __syncwarp();                      // every read before the writes
      if (lane == q && end <= mflimit) {
        table[h2] = (uint16_t)(end - 2);
        table[h] = (uint16_t)end;
      }
      const int v = __shfl_sync(kFull, e << 1 | (hit ? 1 : 0), q);
      return {v >> 1, __shfl_sync(kFull, cand, q), (v & 1) != 0};
    }
  }
}

// LSIC extension of rem: rem / 255 bytes of 255, then rem % 255.
__device__ __forceinline__ int put_lsic(uint8_t* d, int op, int rem,
                                        int lane) {
  const int k = rem / 255;
  for (int i = lane; i < k; i += 32) d[op + i] = 255;
  if (lane == 0) d[op + k] = (uint8_t)(rem - 255 * k);
  return op + k + 1;
}

// Row bytes [op, op + len): source bytes from ip (src) or zeros (no
// src); 16-byte stores where the row is aligned, its ends a byte a lane.
__device__ __forceinline__ void put_bytes(uint8_t* d, int op, const Src* src,
                                          int ip, int len, int lane) {
  uint8_t* g = d + op;
  if (len <= 32) {                       // most literal runs: a byte a lane
    if (lane < len) g[lane] = src ? (uint8_t)src->byte(ip + lane) : 0;
    return;
  }
  const int lead = min((int)((16 - ((uintptr_t)g & 15)) & 15), len);
  const int words = (len - lead) >> 4;
  for (int i = lane; i < lead; i += 32)
    g[i] = src ? (uint8_t)src->byte(ip + i) : 0;
  for (int w = lane; w < words; w += 32) {
    const int i = lead + 16 * w;
    *(uint4*)(g + i) = src ? src->read128(ip + i) : make_uint4(0, 0, 0, 0);
  }
  for (int i = lead + 16 * words + lane; i < len; i += 32)
    g[i] = src ? (uint8_t)src->byte(ip + i) : 0;
}

__global__ void __launch_bounds__(32)
retired_encode_kernel(const uint8_t* __restrict__ raw,
                      const int* __restrict__ raw_len,
                      uint8_t* __restrict__ comp, int* __restrict__ comp_len,
                      int bs, int cb, int acceleration) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + kTabAt);
  const int lane = threadIdx.x;
  const uint8_t* row = raw + (size_t)blockIdx.x * bs;
  uint8_t* d = comp + (size_t)blockIdx.x * cb;
  const int n = min(max(raw_len[blockIdx.x], 0), bs);
  const Src s{smem + kSrcAt, (int)((uintptr_t)row & 15)};
  const int total = n > 0 ? (s.head + n + 15) & ~15 : 0;
  if (lane == 0 && total > 0)
    stage(smem + kSrcAt, row - s.head, total, bar);
  for (int i = lane; i < kTableEntries / 8; i += 32)
    reinterpret_cast<uint4*>(table)[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  if (total > 0) bar_wait(bar);

  int anchor = 0, op = 0;
  if (n >= kMinLength) {
    const int mflimit = n - kMfLimit;
    const int matchlimit = n - kLastLiterals;
    // the reference first puts position 0, every entry's value already
    int pos = 1, mpos = 0;
    while (search(s, table, pos, acceleration, mflimit, lane, pos, mpos)) {
      const int back = catch_up(s, pos, mpos, min(pos - anchor, mpos), lane);
      pos -= back;
      mpos -= back;

      // literals, behind a token written with its match's offset once the
      // match length is known
      const int lit = pos - anchor;
      int token_at = op++;
      int token = min(lit, kMask) << 4;
      if (lit >= kMask) op = put_lsic(d, op, lit - kMask, lane);
      put_bytes(d, op, &s, anchor, lit, lane);
      op += lit;

      // match(es), with the immediate rematch
      for (;;) {
        const int off = pos - mpos, off_at = op;
        op += 2;
        const int p = pos + kMinMatch;
        const Step r = match_step(s, table, p, mpos + kMinMatch,
                                  matchlimit - p, mflimit, lane);
        pos = p + r.mc;
        if (r.mc >= kMask) op = put_lsic(d, op, r.mc - kMask, lane);
        if (lane == 0) {
          d[token_at] = (uint8_t)(token + min(r.mc, kMask));
          d[off_at] = (uint8_t)off;
          d[off_at + 1] = (uint8_t)(off >> 8);
        }
        anchor = pos;
        if (pos > mflimit || !r.hit) break;
        mpos = r.mpos;
        token = 0;
        token_at = op++;
      }
      if (pos > mflimit) break;
      pos++;
    }
  }

  // last literals
  const int last = n - anchor;
  if (last >= kMask) {
    if (lane == 0) d[op] = kMask << 4;
    op = put_lsic(d, op + 1, last - kMask, lane);
  } else {
    if (lane == 0) d[op] = (uint8_t)(last << 4);
    op++;
  }
  put_bytes(d, op, &s, anchor, last, lane);
  op += last;
  put_bytes(d, op, nullptr, 0, cb - op, lane);
  if (lane == 0) comp_len[blockIdx.x] = op;
}

}  // namespace

// One CTA a block, its shared memory sized to bs. A size the card refuses
// is returned as the launch's error.
extern "C" int lz4t_retired_encode(const void* raw, const void* raw_len,
                                   void* comp, void* comp_len, int nb, int bs,
                                   int cb, int acceleration, void* stream) {
  static int sized = 0;
  const int smem = smem_bytes(bs);
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(
        retired_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(retired_encode_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  if (nb > 0)
    retired_encode_kernel<<<nb, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (uint8_t*)comp,
        (int*)comp_len, bs, cb, acceleration);
  return (int)cudaGetLastError();
}

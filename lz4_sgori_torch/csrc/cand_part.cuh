// The split table of K2 (cand.cu) and K9 (cand_piecewise.cu): pass-1
// dense candidates with the bytes resident in shared memory and the hash
// table's buckets split over the CTA's warps. K2's kernel computes, bit
// for bit,
//
//   cand[p] = p - q for the latest q < p in [0, n-4] with
//   hash16(read32(q)) == hash16(read32(p)); 0 where there is none and
//   for every p > n-4;
//
// K9's the same with q limited to [max(0, (h-1)H), p) for p in
// half-piece h = p / H (below, "K9's runs").
//
// - The block. Its n bytes (at most 64 KiB) go into shared memory by one
//   cp.async.bulk (from the row's address rounded down to 16: byte i lies
//   at rhead + i), read as aligned words. Blocks of 32 KiB and less have
//   two buffers, so the next block's copy lands while this one is
//   scanned.
// - The split. The CTA's W warps share one table of 2^16 uint16 entries
//   (r + 1 for the latest inserted position of a bucket, r relative to
//   an origin; 0 = empty). Warp w owns
//   the buckets h with h & (W - 1) == w. A position's candidate depends
//   only on earlier positions of its own bucket, so each warp runs the
//   serial insertion order over its buckets alone and no two warps touch
//   one entry.
// - The scan. Every warp reads the whole range, 32 positions a tile (a
//   word a lane from shared memory, kUnroll tiles a round, their loads
//   in flight together); a ballot picks the lanes whose bucket it owns,
//   and those positions join the warp's queue (a ring of kQueue entries,
//   hash << 16 | r) in increasing order.
// - The match step runs after each round on every 32 queued positions,
//   as the first design's one-warp step ran it on 32 consecutive ones:
//   __match_any_sync groups equal hashes; a lane's candidate is its
//   nearest lower peer (its position by shuffle), else the table's entry
//   read by the group's lowest lane; the group's highest lane writes its
//   own. So a warp runs about (n / 32) / W table steps, not n / 32, and
//   the scan's tiles do not wait on the table. A bucket that holds a long
//   run (a run of zero bytes is one bucket) still falls to one warp, step
//   by step.
// - The output. Each position below n - 3 is written once, by the warp
//   that owns its bucket (4-byte stores, scattered within a few KiB); the
//   rest of the row is zeroed by the whole CTA.
// - K2's table between blocks. A CTA takes blocks blockIdx.x, +
//   gridDim.x, ... (one CTA an SM: the table, the queues and a 64 KiB
//   block take about 225 KiB of the 227 a block may have).
//   After a block of kSmallBlock bytes or less, the warps hash its
//   positions again and zero only those buckets; after a larger one they
//   zero the whole table, which costs less than the rescan there. K2's
//   origin is 0: entries are p + 1 with p < n - 3 <= 65,533, so they
//   never wrap.
// - K9's runs. A CTA walks a run of R consecutive half-pieces [h0, h0 +
//   R) of one block (cand_piecewise.cu's Runs: R from the grid's waves
//   on the host), each
//   half-piece's H + 3 bytes staged by cp.async.bulk into two buffers in
//   turn, and hashes each position once: the latest equal-hash q < p
//   overall is the answer when q >= (h-1)H, and no q of the window
//   exists when it is older. So one table walked forward gives the
//   contract if it holds no entry below the floor (h-1)H:
//   - before h0 it takes half-piece h0 - 1's positions without writing
//     them (the warm half), at h0's origin (h0 - 1)H;
//   - half-piece h's entries are r + 1 with r = p - (h-1)H in [0, 2H);
//   - between h and h + 1 a sweep of the table rebases every entry by H
//     and empties those below the new floor hH (e <= H);
//   - the entry of h's last position, r = 2H - 1, is 2H: at H = 32768
//     it wraps to 0 (empty) in uint16, where no later position of h reads
//     it; after the sweep it is written again as H (its rebased value),
//     so the wrap never changes an output.
//   Each half-piece's queues are drained (a last partial step) before
//   the sweep, so no step mixes two half-pieces. Hashing falls from 2H a
//   half-piece (the first design's one CTA a half-piece) to (R + 1) / R.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "parse_enc3_warp.cuh"  // bar_init, bar_wait, bulk_load, smem_u32

namespace cand_part {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kTableBytes = 1 << 17;       // 2^16 uint16 entries
constexpr int kWarps = 8;                  // a power of two
constexpr int kUnroll = 16;                // scan tiles a round
constexpr int kQueue = 64 * kUnroll;       // queued positions a warp (a ring)
constexpr int kSlack = 32 * kUnroll + 16;  // bytes a round reads past n
constexpr int kSmallBlock = 16384;         // blocks up to this clear by rescan
constexpr int kMaxHalf = 32768;            // K9's largest half-piece

static_assert((kWarps & (kWarps - 1)) == 0 && kWarps <= 32, "warps");

// The shared-memory layout, the same on host and device: the table, the
// queues, two barriers, then two buffers of `buf` bytes each (K9; K2 one
// above 32 KiB). K2's buffer holds a block of bs bytes, K9's a
// half-piece of `half` and the 3 bytes after it.
struct Layout {
  int buf, nbuf, bytes;
  __host__ __device__ Layout(int bs, bool piecewise = false) {
    buf = (16 + bs + (piecewise ? 3 : 0) + kSlack + 15) & ~15;
    nbuf = piecewise || bs <= 32768 ? 2 : 1;
    bytes = kTableBytes + kWarps * kQueue * 4 + 16 + nbuf * buf;
  }
};

// The bytes in a buffer: byte i at word-aligned w plus off + i.
// Words are indexed off w (no integer casts), so that the compiler keeps
// the loads in shared memory.
struct Bytes {
  const uint32_t* w;
  int off;
  __device__ __forceinline__ uint32_t rd32(int i) const {
    // an unaligned word from two aligned ones
    const int a = off + i;
    return __funnelshift_r(w[a >> 2], w[(a >> 2) + 1], (uint32_t)(a & 3) * 8);
  }
};

__device__ __forceinline__ uint32_t hash16(uint32_t v) {
  return (v * 2654435761u) >> 16;
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(warp_parse::smem_u32(bar)) : "memory");
}

// Bytes [lo, hi) of a row into dst from the row's address rounded down
// to 16 (thread 0); none only arrives, so that every use of a buffer
// completes one phase of its barrier. Returns the head (byte lo lies at
// dst + head).
__device__ __forceinline__ int stage(const uint8_t* row, int lo, int hi,
                                     uint8_t* dst, uint64_t* bar) {
  const uint8_t* src = row + lo;
  const int rhead = (int)((uintptr_t)src & 15);
  const int total = hi > lo ? (rhead + hi - lo + 15) & ~15 : 0;
  if (total)
    warp_parse::bulk_load(dst, src - rhead, (uint32_t)total, bar);
  else
    arrive(bar);
  return rhead;
}

// Block b's bytes into dst (K2).
__device__ __forceinline__ void issue(const uint8_t* raw, const int* raw_len,
                                      int b, int bs, uint8_t* dst,
                                      uint64_t* bar) {
  stage(raw + (size_t)b * bs, 0, min(max(raw_len[b], 0), bs), dst, bar);
}

// The match step on queue entry e (hash << 16 | r, position origin + r)
// of each active lane; with kEmit its candidate goes to out.
template <bool kEmit>
__device__ __forceinline__ void match_step(uint32_t e, bool act,
                                           uint16_t* table, int* out,
                                           int origin, int lane) {
  const int r = (int)(e & 0xffffu);
  const uint32_t h = e >> 16;
  const unsigned peers = __match_any_sync(kAll, act ? h : 0x10000u + lane);
  const unsigned lower = peers & ((1u << lane) - 1u);
  const unsigned higher = peers & ~((2u << lane) - 1u);
  const int q = __shfl_sync(kAll, r, lower ? 31 - __clz(lower) : lane);
  int d = 0;
  if (act) {
    if (lower) {
      d = r - q;
    } else {
      const int t = table[h];
      if (t) d = r - (t - 1);
    }
  }
  __syncwarp();
  if (act && !higher) table[h] = (uint16_t)(r + 1);
  __syncwarp();
  if (kEmit && act) out[origin + r] = d;
}

// One warp's buckets over positions [p0, p1) (their read32 in s, at
// most 65,536 past origin): the scan, the queue, the steps, and the last
// partial step, so that the queue is empty after. The scan runs over r =
// p - origin (the origin folded into the bytes' offset), so that a tile's
// queue entry is hash << 16 | r with nothing to compute: the 16 tiles'
// ballots and stores then interleave, predicated, where the origin's
// arithmetic in each had made every store a branch of its own.
template <bool kEmit>
__device__ __forceinline__ void scan_range(Bytes s, int p0, int p1,
                                           int origin, uint32_t* queue,
                                           uint16_t* table, int* out,
                                           int warp, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  const Bytes sr = {s.w, s.off + origin};
  const int r1 = p1 - origin;
  int head = 0, tail = 0;
  for (int base = p0 - origin; base < r1; base += 32 * kUnroll) {
    uint32_t h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u++)
      h[u] = hash16(sr.rd32(base + 32 * u + lane));
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const int r = base + 32 * u + lane;
      const bool mine = r < r1 && (int)(h[u] & (kWarps - 1)) == warp;
      const unsigned m = __ballot_sync(kAll, mine);
      if (mine)
        queue[(tail + __popc(m & lt)) & (kQueue - 1)] = h[u] << 16 | r;
      tail += __popc(m);
    }
    while (tail - head >= 32) {
      __syncwarp();
      match_step<kEmit>(queue[(head + lane) & (kQueue - 1)], true, table,
                        out, origin, lane);
      head += 32;
    }
  }
  __syncwarp();
  if (tail > head)
    match_step<kEmit>(queue[(head + lane) & (kQueue - 1)], lane < tail - head,
                      table, out, origin, lane);
}

__global__ void __launch_bounds__(32 * kWarps, 1)
    cand_part_kernel(const uint8_t* __restrict__ raw,
                     const int* __restrict__ raw_len,
                     int* __restrict__ cand, int nb, int bs) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout L(bs);
  uint16_t* table = (uint16_t*)smem;
  uint32_t* queue = (uint32_t*)(smem + kTableBytes) + warp * kQueue;
  uint64_t* bar = (uint64_t*)(smem + kTableBytes + kWarps * kQueue * 4);
  uint8_t* buf0 = (uint8_t*)(bar + 2);
  uint4* t4 = (uint4*)table;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  if (blockIdx.x >= nb) return;
  if (tid == 0) {
    warp_parse::bar_init(&bar[0]);
    warp_parse::bar_init(&bar[1]);
    issue(raw, raw_len, blockIdx.x, bs, buf0, &bar[0]);
  }
  for (int i = tid; i < kTableBytes / 16; i += 32 * kWarps) t4[i] = zero;
  __syncthreads();

  int it = 0;
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x, it++) {
    const int b = L.nbuf == 2 ? (it & 1) : 0;
    const int parity = L.nbuf == 2 ? (it >> 1) & 1 : it & 1;
    const int next = blk + gridDim.x;
    if (tid == 0 && L.nbuf == 2 && next < nb)
      issue(raw, raw_len, next, bs, buf0 + (b ^ 1) * L.buf, &bar[b ^ 1]);
    const uint8_t* src = raw + (size_t)blk * bs;
    const int n = min(max(raw_len[blk], 0), bs);
    const Bytes s = {(const uint32_t*)(buf0 + b * L.buf),
                     (int)((uintptr_t)src & 15)};
    const int npos = n - 3;  // positions with a full read32
    int* out = cand + (size_t)blk * bs;
    warp_parse::bar_wait(&bar[b], parity);

    scan_range<true>(s, 0, npos, 0, queue, table, out, warp, lane);
    for (int p = max(npos, 0) + tid; p < bs; p += 32 * kWarps) out[p] = 0;
    if (next >= nb) break;
    __syncthreads();
    if (n <= kSmallBlock) {
      for (int p = tid; p < npos; p += 32 * kWarps)
        table[hash16(s.rd32(p))] = 0;
    } else {
      for (int i = tid; i < kTableBytes / 16; i += 32 * kWarps) t4[i] = zero;
    }
    __syncthreads();
    if (tid == 0 && L.nbuf == 1)
      issue(raw, raw_len, next, bs, buf0, &bar[0]);
  }
}

}  // namespace cand_part

// T1, the retired greedy level-1 LZ4 encoder: one warp per block.
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
// n = raw_len clamped to [0, bs]; every read stays below n (the search
// stops at n - MFLIMIT, the match count at n - LASTLITERALS), so bytes
// past raw_len never matter. comp is zero from comp_len to cb.
//
// What bounds it on the H100: the walk is one serial chain of dependent
// loads (hash, table, candidate bytes), so a block is latency-bound and
// the kernel is bound by the number of walks in flight. Design: the whole
// warp runs the walk in step (every lane computes the same scalars from
// broadcast loads), so the 32 lanes can share the long parts: the match
// count compares 32 bytes a step (ballot), and literal runs and LSIC runs
// are copied 32 bytes a step. One walk per warp, not one per thread:
// 32 walks in a warp cost 11.1x one walk (K8-enc3, PERF.md section 6).
// Lane 0 alone owns the table (16 KiB of uint16 positions, as LZ4's own
// byU16 table; about 13 CTAs fit an SM) and broadcasts what it reads with
// a shuffle, so no lane ever sees the table out of order.

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

__device__ __forceinline__ uint32_t read32(const uint8_t* __restrict__ s,
                                          int p) {
  // byte loads: p is any byte position, and an unaligned word load faults
  return (uint32_t)s[p] | (uint32_t)s[p + 1] << 8 |
         (uint32_t)s[p + 2] << 16 | (uint32_t)s[p + 3] << 24;
}

__device__ __forceinline__ int hash4(uint32_t v) {
  return (int)((v * 2654435761u) >> (32 - kHashLog));
}

// table[h] = pos; returns the old entry to every lane.
__device__ __forceinline__ int table_swap(uint16_t* table, int h, int pos,
                                          int lane) {
  int old = 0;
  if (lane == 0) {
    old = table[h];
    table[h] = (uint16_t)pos;
  }
  return __shfl_sync(kFull, old, 0);
}

__device__ __forceinline__ void table_put(uint16_t* table, int h, int pos,
                                          int lane) {
  if (lane == 0) table[h] = (uint16_t)pos;
}

// Common-prefix length of positions p and m, capped at limit.
__device__ __forceinline__ int match_count(const uint8_t* __restrict__ s,
                                           int p, int m, int limit,
                                           int lane) {
  for (int mc = 0;; mc += 32) {
    const int k = mc + lane;
    const unsigned d = __ballot_sync(kFull, k >= limit || s[p + k] != s[m + k]);
    if (d) return mc + __ffs(d) - 1;
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

__device__ __forceinline__ void copy_bytes(uint8_t* d, int op,
                                           const uint8_t* __restrict__ s,
                                           int ip, int len, int lane) {
  for (int i = lane; i < len; i += 32) d[op + i] = s[ip + i];
}

__global__ void retired_encode_kernel(const uint8_t* __restrict__ raw,
                                      const int* __restrict__ raw_len,
                                      uint8_t* __restrict__ comp,
                                      int* __restrict__ comp_len, int bs,
                                      int cb, int acceleration) {
  __shared__ uint16_t table[kTableEntries];
  const int lane = threadIdx.x;
  const uint8_t* s = raw + (size_t)blockIdx.x * bs;
  uint8_t* d = comp + (size_t)blockIdx.x * cb;
  const int n = min(max(raw_len[blockIdx.x], 0), bs);
  for (int i = lane; i < kTableEntries / 2; i += 32)
    reinterpret_cast<uint32_t*>(table)[i] = 0;
  __syncwarp();

  int anchor = 0, op = 0;
  if (n >= kMinLength) {
    const int mflimit = n - kMfLimit;
    const int matchlimit = n - kLastLiterals;
    table_put(table, hash4(read32(s, 0)), 0, lane);
    int pos = 1;
    int fh = hash4(read32(s, 1));
    for (;;) {
      // skip-accelerated search (golden.py:87-107)
      int fpos = pos, step = 1, smn = acceleration << kSkipTrigger, mpos = 0;
      bool found = false;
      for (;;) {
        const int h = fh;
        if (fpos + step > mflimit + 1) break;
        pos = fpos;
        fpos += step;
        step = smn >> kSkipTrigger;
        smn++;
        mpos = table_swap(table, h, pos, lane);
        fh = hash4(read32(s, fpos));
        if (read32(s, mpos) == read32(s, pos)) {
          found = true;
          break;
        }
      }
      if (!found) break;

      // catch up
      while (pos > anchor && mpos > 0 && s[pos - 1] == s[mpos - 1]) {
        pos--;
        mpos--;
      }

      // literals, behind a token written once its match length is known
      const int lit = pos - anchor;
      int token_at = op++;
      int token;
      if (lit >= kMask) {
        token = kMask << 4;
        op = put_lsic(d, op, lit - kMask, lane);
      } else {
        token = lit << 4;
      }
      copy_bytes(d, op, s, anchor, lit, lane);
      op += lit;

      // match(es), with the immediate rematch
      for (;;) {
        const int off = pos - mpos;
        if (lane == 0) {
          d[op] = (uint8_t)off;
          d[op + 1] = (uint8_t)(off >> 8);
        }
        op += 2;
        const int p = pos + kMinMatch;
        const int mc = match_count(s, p, mpos + kMinMatch, matchlimit - p,
                                   lane);
        pos = p + mc;
        if (mc >= kMask) {
          token += kMask;
          op = put_lsic(d, op, mc - kMask, lane);
        } else {
          token += mc;
        }
        if (lane == 0) d[token_at] = (uint8_t)token;
        anchor = pos;
        if (pos > mflimit) break;
        table_put(table, hash4(read32(s, pos - 2)), pos - 2, lane);
        mpos = table_swap(table, hash4(read32(s, pos)), pos, lane);
        if (read32(s, mpos) != read32(s, pos)) break;
        token = 0;
        token_at = op++;
      }
      if (pos > mflimit) break;
      pos++;
      fh = hash4(read32(s, pos));
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
  copy_bytes(d, op, s, anchor, last, lane);
  op += last;
  for (int o = op + lane; o < cb; o += 32) d[o] = 0;
  if (lane == 0) comp_len[blockIdx.x] = op;
}

}  // namespace

extern "C" int lz4t_retired_encode(const void* raw, const void* raw_len,
                                   void* comp, void* comp_len, int nb, int bs,
                                   int cb, int acceleration, void* stream) {
  if (nb > 0)
    retired_encode_kernel<<<nb, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (uint8_t*)comp,
        (int*)comp_len, bs, cb, acceleration);
  return (int)cudaGetLastError();
}

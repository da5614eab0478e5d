// Piecewise pass-1 candidates for blocks above 64 KiB (K9): K2's split
// table (cand_part.cuh) over runs of half-pieces, each position hashed
// once a run.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_piecewise_cand,
// which runs the bitonic-sort _cand_kernel once per 64 KiB piece and once
// more over half-piece-shifted straddle stretches (its sort keys hold
// 16-bit positions), then merges the two passes, nearer candidate first.
//
// Contract (golden.dense_candidates_piecewise(src, piece, hashlog=16)):
// with H = piece / 2 and p in half-piece h = p / H, that merge equals
//   cand[p] = p - q for the latest q in [max(0, (h-1)*H), p) with
//   hash16(read32(q)) == hash16(read32(p)), q and p in [0, n-4];
//   0 where there is none and for every p > n-4.
// (Half-piece h lies in one piece pass and one straddle pass; their
// windows are [(h-1)*H, p) and [h*H, p), in either order.) Distances stay
// below 2*H <= 65,536 by construction.
//
// What bounds it on the H100: as K2, the 128 KiB table gives one CTA an
// SM, the hashing of every position by each of its warps, and each
// bucket's serial insertions. The first design gave each (block,
// half-piece) a CTA of one warp stepping the whole table, 2H positions
// (the window's warm half, then its own) read from global memory: 4,096
// CTAs of 32 threads an SM for config 6. Here a CTA of 8 warps walks a
// run of R half-pieces (cand_part.cuh, "K9's runs"), their bytes staged
// in shared memory by bulk copies, the table rebased by a sweep at each
// half-piece boundary; R is chosen on the host from the grid's waves
// (cand_part::Runs): a CTA a block for config 6, a CTA a half-piece for
// one or four blocks, so that a single request still spreads over the
// card. A half-piece past the last full read32 only writes zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cand_part.cuh"

namespace cand_part {

// K9's runs, chosen on the host: `len` consecutive half-pieces a CTA,
// `per_block` CTAs a block. One CTA fits an SM, so a launch of `ctas`
// takes ceil(ctas / sms) waves, each as long as a CTA's half-pieces
// hashed: its len, and the warm one before them past a block's first
// run. The run length with the fewest such half-pieces over all waves
// wins, the shortest on a tie (a single 1 MiB block: 32 CTAs of one
// half-piece; 128 of them: a CTA a block).
struct Runs {
  int nhalf, len, per_block, ctas;
  Runs(int nb, int bs, int half, int sms) {
    nhalf = (bs + half - 1) / half;
    len = 1;
    long long best = -1;
    for (int r = 1; r <= nhalf; r++) {
      const long long c = (long long)nb * ((nhalf + r - 1) / r);
      const long long cost = (c + sms - 1) / sms * (r + (r < nhalf ? 1 : 0));
      if (best < 0 || cost < best) {
        best = cost;
        len = r;
      }
    }
    per_block = (nhalf + len - 1) / len;
    ctas = nb * per_block;
  }
};

// uint16 entries e of two halves: e - H where e > H, else 0 (hh = H | H
// << 16).
__device__ __forceinline__ uint32_t rebase2(uint32_t x, uint32_t hh) {
  return __vsub2(x, hh) & __vcmpgtu2(x, hh);
}

__global__ void __launch_bounds__(32 * kWarps, 1)
    cand_piecewise_kernel(const uint8_t* __restrict__ raw,
                          const int* __restrict__ raw_len,
                          int* __restrict__ cand, int bs, int half,
                          int len, int per_block) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout L(half, true);
  uint16_t* table = (uint16_t*)smem;
  uint32_t* queue = (uint32_t*)(smem + kTableBytes) + warp * kQueue;
  uint64_t* bar = (uint64_t*)(smem + kTableBytes + kWarps * kQueue * 4);
  uint8_t* buf0 = (uint8_t*)(bar + 2);
  uint4* t4 = (uint4*)table;

  const int blk = blockIdx.x / per_block;
  const int h0 = (blockIdx.x - blk * per_block) * len;
  const int nhalf = (bs + half - 1) / half;
  const int h1 = min(h0 + len, nhalf);
  const uint8_t* row = raw + (size_t)blk * bs;
  int* out = cand + (size_t)blk * bs;
  const int n = min(max(raw_len[blk], 0), bs);
  const int npos = n - 3;                 // positions with a full read32
  for (int p = max(npos, h0 * half) + tid; p < min(h1 * half, bs);
       p += 32 * kWarps)
    out[p] = 0;
  // the half-pieces with a position below npos; the first walked is the
  // warm one before h0
  const int he = min(h1, npos > 0 ? (npos + half - 1) / half : 0);
  if (he <= h0) return;
  const int hs = max(h0 - 1, 0);
  if (tid == 0) {
    warp_parse::bar_init(&bar[0]);
    warp_parse::bar_init(&bar[1]);
    for (int i = 0; i < 2 && hs + i < he; i++) {
      const int lo = (hs + i) * half;
      stage(row, lo, min(lo + half + 3, n), buf0 + i * L.buf, &bar[i]);
    }
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kTableBytes / 16; i += 32 * kWarps) t4[i] = zero;
  __syncthreads();

  const uint32_t hh = (uint32_t)half * 0x10001u;
  for (int h = hs; h < he; h++) {
    const int it = h - hs, b = it & 1;
    const int lo = h * half;
    const Bytes s = {(const uint32_t*)(buf0 + b * L.buf),
                     (int)((uintptr_t)(row + lo) & 15) - lo};
    const int origin = (max(h, h0) - 1) * half;
    warp_parse::bar_wait(&bar[b], (it >> 1) & 1);
    if (h < h0)
      scan_range<false>(s, lo, min(lo + half, npos), origin, queue, table,
                        out, warp, lane);
    else
      scan_range<true>(s, lo, min(lo + half, npos), origin, queue, table,
                       out, warp, lane);
    if (h + 1 == he) break;
    // h's last position lies below npos (h + 1 < he): its bucket
    const uint32_t hb = hash16(s.rd32(lo + half - 1));
    __syncthreads();            // the table and this buffer are done with
    if (tid == 0 && h + 2 < he) {
      const int lo2 = (h + 2) * half;
      stage(row, lo2, min(lo2 + half + 3, n), buf0 + b * L.buf, &bar[b]);
    }
    if (h >= h0) {              // the warm half shares h0's origin
      for (int i = tid; i < kTableBytes / 16; i += 32 * kWarps) {
        uint4 v = t4[i];
        v.x = rebase2(v.x, hh);
        v.y = rebase2(v.y, hh);
        v.z = rebase2(v.z, hh);
        v.w = rebase2(v.w, hh);
        t4[i] = v;
      }
      __syncthreads();
      if (tid == 0) table[hb] = (uint16_t)half;
    }
    __syncthreads();
  }
}

}  // namespace cand_part

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

// The run length the launch takes for nb blocks of bs bytes at this
// half-piece (negative: a CUDA error).
extern "C" int lz4t_cand_piecewise_run(int nb, int bs, int half) {
  const int sms = card_sms();
  if (!sms) return -(int)cudaGetLastError();
  return cand_part::Runs(nb, bs, half, sms).len;
}

extern "C" int lz4t_cand_piecewise(const void* raw, const void* raw_len,
                                   void* cand, int nb, int bs, int half,
                                   void* stream) {
  using namespace cand_part;
  if (half <= 0 || half % 32 || half > kMaxHalf || bs < 1)
    return (int)cudaErrorInvalidValue;
  const Layout L(half, true);
  static int sized = 0;
  if (L.bytes > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        cand_piecewise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.bytes);
    if (e != cudaSuccess) return (int)e;
    sized = L.bytes;
  }
  const int sms = card_sms();
  if (!sms) return (int)cudaGetLastError();
  const Runs R(nb, bs, half, sms);
  if (nb > 0)
    cand_piecewise_kernel<<<R.ctas, 32 * kWarps, L.bytes,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)raw_len, (int*)cand, bs, half,
        R.len, R.per_block);
  return (int)cudaGetLastError();
}

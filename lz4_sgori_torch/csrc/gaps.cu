// Chain gaps of the deep modes (K8's pass 1): four positions a thread,
// their chains followed through the candidate tape in global memory.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel with
// depth > 1 (the gaps tape g2 | g3 << 8, call :764) and with gaps2_only
// (g4 | g5 << 8, call :1649), and the gaps of _piecewise_cand (:1790) at
// depth > 1. The TPU sorts (hash, position) keys and reads the 2nd-5th
// most recent same-hash positions as rolled rows of the sorted tape. On
// one hash chain those positions are reached by following the candidate
// tape itself (K2's or K9's output), so no sort is needed here:
//   q1 = p - cand[p], g2 = cand[q1], q2 = q1 - g2, g3 = cand[q2], ...
// A link is kept only while every link so far lies in [1, 254] (the 8-bit
// packing) and its position stays at or above the floor F of the pass
// that supplied cand[p] (golden.dense_gaps, dense_gaps2 and
// dense_candidates_piecewise(with_gaps=True), lz4_sgori_tpu/golden.py:
// 663-732, 795-851). For K2's tape F = 0. For K9's tape (half > 0), with
// p in half-piece h = p / half:
//   F = 0 for h = 0; (h-1)*half for odd h;
//   for even h >= 2: h*half when q1 >= h*half (the piece pass wins the
//   tie), else (h-1)*half (the straddle pass).
// This holds because every q_k's own K9 window starts at or below F, and
// a q1 below F keeps no link (q2 = q1 - g2 < F), so its chain ends unread.
//
// The design. CTAs over (block, run of kThreads aligned quads of the
// outputs), the block index in gridDim.x: one division a CTA, and one a
// quad for K9's half-piece (none for K2's tape). Each thread loads its
// quad's four candidates as one int4, then follows the four chains
// together: each link step issues the four gathers (through the
// read-only path: the links lie within 64 KiB behind p, mostly in L1 and
// L2) before any is used, so a thread keeps four dependent loads in
// flight where a thread a position kept one; gaps and gaps2 leave as
// int4 stores. A quad that straddles a row's ends (any block size is
// allowed) goes element by element. Measured in turns on the card, this
// beat a CTA walking its block's chains through a byte tape of the links
// in shared memory (one byte a position, whole 64 KiB rows a CTA): that
// design holds few bytes in flight for the many it moves, and one block
// takes one SM.
//
// What bounds it on the H100: memory, 8 bytes a position at 2 links (the
// candidate read once, gaps written), 12 at 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int link_of(int v) {
  return (unsigned)(v - 1) < 254u ? v : 0;
}

__global__ void __launch_bounds__(kThreads)
gaps_kernel(const int* __restrict__ cand, int* __restrict__ gaps,
            int* __restrict__ gaps2, int bs, int half, int per_row) {
  const int row = blockIdx.x / per_row;
  const int k = (blockIdx.x - row * per_row) * kThreads + threadIdx.x;
  const size_t base = (size_t)row * bs;
  const int e = (int)(((uintptr_t)(gaps + base) >> 2) & 3);
  const int j0 = 4 * k - e;          // the quad's first position
  if (j0 >= bs) return;
  const int* crow = cand + base;
  const bool whole = j0 >= 0 && j0 + 4 <= bs;
  int v[4];
  if (whole && ((uintptr_t)(crow + j0) & 15) == 0) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(crow + j0));
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; i++)
      v[i] = j0 + i >= 0 && j0 + i < bs ? __ldg(crow + j0 + i) : 0;
  }
  // the floor: K9's half-piece of the quad's first position, one division
  const int hq = half > 0 ? max(j0, 0) / half : 0;
  int q[4], lo[4];
  bool alive[4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int p = j0 + i;
    q[i] = p - v[i];
    lo[i] = 0;
    if (half > 0) {
      int h = hq;
      while (p - h * half >= half) h++;   // at most once unless half < 4
      lo[i] = (h & 1) ? (h - 1) * half
                      : (q[i] >= h * half ? h * half : max(h - 1, 0) * half);
    }
    alive[i] = p >= 0 && p < bs && v[i] > 0 && q[i] >= lo[i];
  }
  int g[4] = {0, 0, 0, 0}, g2[4] = {0, 0, 0, 0};
  const int links = gaps2 != nullptr ? 4 : 2;
  for (int l = 0; l < links; l++) {
    int t[4];
#pragma unroll
    for (int i = 0; i < 4; i++) t[i] = alive[i] ? __ldg(crow + q[i]) : 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int gk = link_of(t[i]);
      const int qn = q[i] - gk;
      alive[i] = alive[i] && gk != 0 && qn >= lo[i];
      if (alive[i]) {
        if (l < 2) g[i] |= gk << (8 * l);
        else g2[i] |= gk << (8 * (l - 2));
        q[i] = qn;
      }
    }
  }
  if (whole) {
    *reinterpret_cast<int4*>(gaps + base + j0) =
        make_int4(g[0], g[1], g[2], g[3]);
    if (gaps2 != nullptr)
      *reinterpret_cast<int4*>(gaps2 + base + j0) =
          make_int4(g2[0], g2[1], g2[2], g2[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int p = j0 + i;
      if (p < 0 || p >= bs) continue;
      gaps[base + p] = g[i];
      if (gaps2 != nullptr) gaps2[base + p] = g2[i];
    }
  }
}

}  // namespace

extern "C" int lz4t_gaps(const void* cand, void* gaps, void* gaps2, int nb,
                         int bs, int half, void* stream) {
  if (nb <= 0 || bs <= 0) return 0;
  if (((uintptr_t)gaps & 15) ||
      (gaps2 != nullptr && ((uintptr_t)gaps2 & 15)))
    return (int)cudaErrorInvalidValue;
  // quads a row: bs / 4 when every row starts on a quad (bs % 4 == 0),
  // else up to (bs + 6) / 4 with the row's first element anywhere in one
  const int quads = bs % 4 == 0 ? bs / 4 : (bs + 6) / 4;
  const int per_row = (quads + kThreads - 1) / kThreads;
  gaps_kernel<<<(unsigned)nb * (unsigned)per_row, kThreads, 0,
                (cudaStream_t)stream>>>((const int*)cand, (int*)gaps,
                                        (int*)gaps2, bs, half, per_row);
  return (int)cudaGetLastError();
}

// Chain gaps of the deep modes (K8's pass 1), one thread per position.
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
// This holds because every q_k's own K9 window starts at or below F.
//
// What bounds it on the H100: memory. Each thread reads its own cand
// entry (coalesced), up to four gathers that land near p (mostly in L1
// and L2), and writes one or two int32 words: 8-12 bytes of device
// traffic a position.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gaps_kernel(const int* __restrict__ cand,
                            int* __restrict__ gaps, int* __restrict__ gaps2,
                            long long total, int bs, int half) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int p = (int)(t % bs);
  const int* c = cand + (t - p);
  const int d1 = c[p];
  int q = p - d1;
  int lo = 0;  // the floor F: no link may reach below it
  if (half > 0) {
    const int h = p / half;
    lo = (h & 1) ? (h - 1) * half
                 : (q >= h * half ? h * half : max(h - 1, 0) * half);
  }
  int g[4] = {0, 0, 0, 0};
  const int links = gaps2 != nullptr ? 4 : 2;
  bool alive = d1 > 0 && q >= 0;
  for (int k = 0; k < links && alive; k++) {
    const int gk = c[q];
    const int qn = q - gk;
    alive = gk >= 1 && gk <= 254 && qn >= lo;
    if (alive) {
      g[k] = gk;
      q = qn;
    }
  }
  gaps[t] = g[0] | (g[1] << 8);
  if (gaps2 != nullptr) gaps2[t] = g[2] | (g[3] << 8);
}

extern "C" int lz4t_gaps(const void* cand, void* gaps, void* gaps2, int nb,
                         int bs, int half, void* stream) {
  const long long total = (long long)nb * bs;
  if (total > 0) {
    const int threads = 256;
    gaps_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                  (cudaStream_t)stream>>>((const int*)cand, (int*)gaps,
                                          (int*)gaps2, total, bs, half);
  }
  return (int)cudaGetLastError();
}

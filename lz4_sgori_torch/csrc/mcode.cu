// Verified candidates and match codes of the mlen mode (K10a), one thread
// per position.
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
// What bounds it on the H100: memory. A thread reads its candidate (4
// bytes, coalesced) and 16 bytes around p and around q (p's neighbours
// share them in L1; q lies inside the block's 64 KiB, mostly in L1/L2),
// and writes two int32 words: 13 bytes of device traffic a position.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int byte_at(const uint8_t* __restrict__ s, int i,
                                       int n) {
  return (i >= 0 && i < n) ? (int)s[i] : 0;
}

__global__ void mcode_kernel(const int* __restrict__ cand,
                             const uint8_t* __restrict__ raw,
                             const int* __restrict__ raw_len,
                             int* __restrict__ cand_v,
                             int* __restrict__ mcode, long long total,
                             int bs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int p = (int)(t % bs);
  const uint8_t* s = raw + (t - p);
  const int n = min(max(raw_len[t / bs], 0), bs);
  const int d = cand[t];
  int cv = 0, code = 0;
  if (d > 0 && d <= p) {
    const int q = p - d;
    bool vr = true;
    for (int i = 0; i < 4; i++)
      vr &= byte_at(s, p + i, n) == byte_at(s, q + i, n);
    if (vr) {
      int lcp = 0;
      while (lcp < 8 &&
             byte_at(s, p + 4 + lcp, n) == byte_at(s, q + 4 + lcp, n))
        lcp++;
      int cu = 0;
      while (cu < 4 &&
             byte_at(s, p - 1 - cu, n) == byte_at(s, q - 1 - cu, n))
        cu++;
      cv = d;
      code = (lcp == 8) | (lcp << 1) | ((cu == 4) << 5) | (cu << 6);
    }
  }
  cand_v[t] = cv;
  mcode[t] = code;
}

extern "C" int lz4t_mcode(const void* cand, const void* raw,
                          const void* raw_len, void* cand_v, void* mcode,
                          int nb, int bs, void* stream) {
  const long long total = (long long)nb * bs;
  if (total > 0) {
    const int threads = 256;
    mcode_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(
        (const int*)cand, (const uint8_t*)raw, (const int*)raw_len,
        (int*)cand_v, (int*)mcode, total, bs);
  }
  return (int)cudaGetLastError();
}

// The whole-block greedy parse kernel of the enc3 engine in the mlen
// mode, one thread per block (greedy_parse.cuh with the mcode tape): K10c
// (parse_enc3_mlen.cu). See parse_enc3.cu for the contract. K7's default
// parse and K8-enc3's deep parse are a warp a block
// (parse_enc3_warp.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "greedy_parse.cuh"

__global__ void parse_enc3_mlen_kernel(const uint8_t* __restrict__ raw,
                                  const int* __restrict__ cand,
                                  const int* __restrict__ mcode,
                                  const int* __restrict__ raw_len,
                                  uint8_t* __restrict__ out,
                                  int* __restrict__ out_len,
                                  uint8_t* __restrict__ err,
                                  int* __restrict__ tails,
                                  int* __restrict__ nseq, int nb, int bs,
                                  int slot, int cap, int accel) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const uint8_t* src = raw + (size_t)t * bs;
  uint8_t* dst = out + (size_t)t * slot;
  const int n = min(max(raw_len[t], 0), bs);
  const ParseState st = greedy_parse(
      src, cand + (size_t)t * bs, mcode + (size_t)t * bs,
      dst, cap, 0, n - 12, n - 5, false, 65535, accel);
  int o = st.o;
  bool bad = st.bad;
  const int tpos = o;
  if (!bad) {
    // terminal literal-only sequence: token, literal LSIC, literals
    const int lit = n - st.anchor;
    const int hlen = lit >= 15 ? 2 + (lit - 15) / 255 : 1;
    if (hlen + lit > cap - o) {
      bad = true;
    } else {
      dst[o++] = (uint8_t)(min(lit, 15) << 4);
      if (lit >= 15) {
        int rem = lit - 15;
        for (; rem >= 255; rem -= 255) dst[o++] = 255;
        dst[o++] = (uint8_t)rem;
      }
      for (int i = st.anchor; i < n; i++) dst[o++] = src[i];
    }
  }
  if (bad)
    for (int i = 0; i < o; i++) dst[i] = 0;
  out_len[t] = bad ? 0 : o;
  err[t] = bad ? 1 : 0;
  tails[t] = bad ? 0 : tpos;
  nseq[t] = bad ? 0 : st.nseq;
}

static int launch_parse_enc3_mlen(const void* raw, const void* cand,
                                  const void* mcode, const void* raw_len,
                                  void* out, void* out_len, void* err,
                                  void* tails, void* nseq, int nb, int bs,
                                  int slot, int cap, int accel,
                                  void* stream) {
  if (nb > 0) {
    const int threads = 32;
    parse_enc3_mlen_kernel<<<(nb + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)cand, (const int*)mcode,
        (const int*)raw_len, (uint8_t*)out, (int*)out_len, (uint8_t*)err,
        (int*)tails, (int*)nseq, nb, bs, slot, cap, accel);
  }
  return (int)cudaGetLastError();
}

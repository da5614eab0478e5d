// Whole-block greedy parse (engine enc3), one thread per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel in
// block-per-lane mode (the pallas_call at :1692): the TPU steps 128 block
// lanes in lockstep through a mode machine (search, verify, catch-up,
// extension, header, literal and tail modes) with banded window walks and
// a staging ring, because Mosaic has no per-lane scalar loop. Here each
// block is one thread running the scalar loop of golden.compress_dense
// (greedy_parse.cuh, shared with K3) and then the terminal literal run.
//
// Contract, per block of n = clamp(raw_len, 0, bs) bytes:
// golden.compress_dense(block, acceleration, hashlog=16)
// (lz4_sgori_tpu/golden.py:1028-1141) over K2's candidates. That is K3's
// parse over one segment spanning the block (s0 = 0, mfl = n - 12,
// mlim = n - 5, no parse below 13 bytes) plus the terminal literal-only
// sequence. Outputs:
//   out     the whole block in a row of slot bytes; the wrapper zeroes the
//           row, so bytes past out_len stay zero;
//   out_len its length;
//   err     the block would pass cap = compress_bound(bs): an error,
//           never a truncation (the row is then zeroed again and out_len,
//           tails and nseq are 0);
//   tails   the stream offset of the terminal sequence
//           (golden.tail_offset, the seg_splice engine's input);
//   nseq    sequences with a match (the decoder's cost hint).
//
// What bounds it on the H100: one block is one serial chain of dependent
// byte loads, like K3's segment. At 4 KiB blocks the parse of 32 MiB is
// 8192 threads of one 4 KiB walk each (about 62 per SM, the same shape as
// K3 at 64 KiB); at 64 KiB (enc3 blocks and seg_splice segments) each
// thread walks 16 times further and few blocks give few threads, so one
// long serial walk bounds the kernel. Lane-parallel extension and literal
// copies (a warp per block) are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "greedy_parse.cuh"

__global__ void parse_enc3_kernel(const uint8_t* __restrict__ raw,
                                  const int* __restrict__ cand,
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
  const ParseState st = greedy_parse(src, cand + (size_t)t * bs, dst, cap, 0,
                                     n - 12, n - 5, false, 65535, accel);
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

extern "C" int lz4t_parse_enc3(const void* raw, const void* cand,
                               const void* raw_len, void* out, void* out_len,
                               void* err, void* tails, void* nseq, int nb,
                               int bs, int slot, int cap, int accel,
                               void* stream) {
  if (nb > 0) {
    const int threads = 32;
    parse_enc3_kernel<<<(nb + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)cand, (const int*)raw_len,
        (uint8_t*)out, (int*)out_len, (uint8_t*)err, (int*)tails,
        (int*)nseq, nb, bs, slot, cap, accel);
  }
  return (int)cudaGetLastError();
}

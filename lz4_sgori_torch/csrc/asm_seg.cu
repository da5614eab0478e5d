// Segment assembly: concatenate each block's 3*nseg pieces into one LZ4
// block, one CTA per block.
//
// Replaces lz4_sgori_tpu/ops/pallas/asm_seg.py:_asm_kernel, which steps
// 128 blocks in piece lockstep through a VMEM staging ring and needs the
// whole per-lane source column in VMEM (so the JAX engine keeps a
// dynamic_update_slice fallback for big blocks). Here one kernel serves
// every block size.
//
// Contract (golden.assemble_seg_parts, lz4_sgori_tpu/golden.py:587-607):
//   out = for k in 0..nseg-1: stream_k[:slen_k] + hdr_k[:hlen_k]
//                              + raw[tail_k : tail_k + tl_k]
//   out_len = total length (may exceed the output capacity: the caller
//   then folds the block to an error); bytes at or past out_len up to
//   the capacity are zero, as the decoder's input contract requires.
//   plan[b, k] = (slen_k, hlen_k, tail_k, tl_k).
//
// What bounds it on the H100: pure byte movement, about 2x the block's
// compressed size in global traffic, plus a serial scan of 3*nseg piece
// lengths. Thread 0 scans the lengths into shared memory, then the CTA
// copies each piece with consecutive threads on consecutive bytes.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxSeg = 128;

__global__ void asm_seg_kernel(const uint8_t* __restrict__ streams,
                               const uint8_t* __restrict__ hdr,
                               const uint8_t* __restrict__ raw,
                               const int* __restrict__ plan,
                               uint8_t* __restrict__ out,
                               int* __restrict__ out_len, int nseg, int scap,
                               int hmax, int bs, int ocap) {
  __shared__ int offs[3 * kMaxSeg + 1];
  const int blk = blockIdx.x;
  const int* pl = plan + (size_t)blk * nseg * 4;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < nseg; k++) {
      offs[3 * k] = acc;
      acc += pl[4 * k];
      offs[3 * k + 1] = acc;
      acc += pl[4 * k + 1];
      offs[3 * k + 2] = acc;
      acc += pl[4 * k + 3];
    }
    offs[3 * nseg] = acc;
  }
  __syncthreads();
  uint8_t* dst = out + (size_t)blk * ocap;
  for (int k = 0; k < nseg; k++) {
    const size_t row = (size_t)blk * nseg + k;
    const uint8_t* pieces[3] = {streams + row * scap, hdr + row * hmax,
                                raw + (size_t)blk * bs + pl[4 * k + 2]};
    for (int j = 0; j < 3; j++) {
      const int o0 = offs[3 * k + j];
      const int len = min(offs[3 * k + j + 1], ocap) - o0;
      for (int i = threadIdx.x; i < len; i += blockDim.x)
        dst[o0 + i] = pieces[j][i];
    }
  }
  for (int o = offs[3 * nseg] + threadIdx.x; o < ocap; o += blockDim.x)
    dst[o] = 0;
  if (threadIdx.x == 0) out_len[blk] = offs[3 * nseg];
}

extern "C" int lz4t_asm_seg(const void* streams, const void* hdr,
                            const void* raw, const void* plan, void* out,
                            void* out_len, int nb, int nseg, int scap,
                            int hmax, int bs, int ocap, void* stream) {
  if (nseg > kMaxSeg) return (int)cudaErrorInvalidValue;
  if (nb > 0)
    asm_seg_kernel<<<nb, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, (const uint8_t*)hdr, (const uint8_t*)raw,
        (const int*)plan, (uint8_t*)out, (int*)out_len, nseg, scap, hmax, bs,
        ocap);
  return (int)cudaGetLastError();
}

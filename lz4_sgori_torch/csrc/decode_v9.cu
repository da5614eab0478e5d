// T3, the chained safe LZ4 decode: one CTA a chain of blocks, each block
// decoded in turn by K1's walk (lz4_decode_ring.cuh).
//
// Replaces tools/retired/lockstep_v9.py:_kernel (the pallas_call in
// decompress_blocks_lockstep_v9 at :468). On the TPU each of 128 lockstep
// lanes decodes `chain` blocks laid back to back in its column, so that a
// group's cost becomes the lanes' balanced total rather than its slowest
// block; an offset may not reach before the current block's first byte.
// Here the wrapper deals the blocks (lz4_sgori_torch/retired/
// lockstep_v9.py) so that rows c * chain .. c * chain + chain - 1 form
// chain c, and CTA c decodes them in turn. Each block has its own output
// row, so an offset that reaches before it is the walk's own "outside
// output" error. Per block the result is K1's: golden.decompress, with an
// error row all zero.
//
// Design: each block runs the walk of K1 and K5 in the geometry their
// dispatch picks for out_size (K5's SmallGeom<L> up to 16 KiB, 8 CTAs an
// SM at 4 KiB; K1's WholeGeom up to 64 KiB, two CTAs an SM; K6's
// RingGeom above): the stream staged by cp.async.bulk, the block's output
// in shared memory, up to 32 sequences a batch with the CTA's four warps
// parsing the window. Between two blocks of a chain, once the walk has
// drained the stream ring, lane 0 issues the next block's first stages,
// which land while the CTA writes the current row in 16-byte stores; the
// difference table is built once a CTA.
//
// What bounds it on the H100: the serial walk of each block. A chain is
// `chain` walks long and the batch gives nb / chain CTAs, so while the
// CTAs are fewer than the card's places (512 blocks of 64 KiB at chain 4
// give 128 CTAs for 264 places), chaining lengthens the critical path;
// the deal only evens the chains out.

#include "lz4_decode_ring.cuh"

namespace {

template <class G>
__global__ void __launch_bounds__(G::kThreads, G::kCtas)
decode_chain_kernel(const uint8_t* __restrict__ comp,
                    const int* __restrict__ clen, uint8_t* out,
                    int* __restrict__ out_len, uint8_t* __restrict__ err,
                    int chain, int slot, int out_size) {
  constexpr int kThreads = G::kThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_n;
  __shared__ int s_cmd[4];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * chain;
  uint8_t* tab = smem + G::kTabAt;
  int2* fld = (int2*)(smem + G::kFld);
  uint16_t* nxt = (uint16_t*)(smem + G::kNxt);
  for (int i = threadIdx.x; i < ring::kTab; i += kThreads)
    tab[i] = (uint8_t)((i & 31) % max(i >> 5, 1));
  ring::Stream<G> in;                    // warp 0's
  if (threadIdx.x < 32) {
    in = ring::stream_of<G>(smem, comp + (size_t)first * slot, clen[first],
                            slot);
    if (lane == 0) ring::start_stream(in, false);
  }
  __syncthreads();
  for (int j = 0; j < chain; j++) {
    const int blk = first + j;
    uint8_t* dst = out + (size_t)blk * out_size;
    if (threadIdx.x < 32) {
      __syncwarp();
      if (in.nst > 0) ring::bar_wait(&in.full[0], 0);
      ring::Out<G> o = ring::out_of<G>(smem, dst);
      const int n = ring::decode_block_ring(in, o, tab, fld, nxt, s_cmd,
                                            clen[blk], slot, out_size, lane);
      if (j + 1 < chain) {
        // the walk has drained the ring: the next block's stages go now
        in = ring::stream_of<G>(smem, comp + (size_t)(blk + 1) * slot,
                                clen[blk + 1], slot);
        __syncwarp();
        if (lane == 0) ring::start_stream(in, true);
      }
      if (lane == 0) {
        s_n = n;
        out_len[blk] = n < 0 ? 0 : n;
        err[blk] = n < 0 ? 1 : 0;
        s_cmd[0] = -1;                   // the other warps' last command
      }
      ring::named_sync<kThreads>(1);
    } else {
      ring::window_helper<G>(smem + G::kOutRing,
                             (uint64_t*)(smem + G::kOutRing + G::kCompRing),
                             fld, nxt, s_cmd);
    }
    __syncthreads();
    ring::write_row<G>(smem, dst, s_n, out_size);
    __syncthreads();                     // the region is the next walk's
  }
}

template <class G>
int launch_chain(const void* comp, const void* clen, void* out,
                 void* out_len, void* err, int ncols, int chain, int slot,
                 int out_size, void* stream) {
  const cudaError_t e = size_ring_kernel<G>(decode_chain_kernel<G>);
  if (e != cudaSuccess) return (int)e;
  if (ncols > 0)
    decode_chain_kernel<G><<<ncols, G::kThreads, G::kSmem,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)clen, (uint8_t*)out,
        (int*)out_len, (uint8_t*)err, chain, slot, out_size);
  return (int)cudaGetLastError();
}

}  // namespace

// One CTA a chain, in K5's and K1's geometry for out_size.
extern "C" int lz4t_decode_v9(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int ncols, int chain,
                              int slot, int out_size, void* stream) {
  if (out_size <= 4096)
    return launch_chain<ring::SmallGeom<12>>(comp, clen, out, out_len, err,
                                             ncols, chain, slot, out_size,
                                             stream);
  if (out_size <= 8192)
    return launch_chain<ring::SmallGeom<13>>(comp, clen, out, out_len, err,
                                             ncols, chain, slot, out_size,
                                             stream);
  if (out_size <= ring::kSmallMax)
    return launch_chain<ring::SmallGeom<14>>(comp, clen, out, out_len, err,
                                             ncols, chain, slot, out_size,
                                             stream);
  if (out_size <= ring::kWholeMax)
    return launch_chain<ring::WholeGeom>(comp, clen, out, out_len, err, ncols,
                                         chain, slot, out_size, stream);
  return launch_chain<ring::RingGeom>(comp, clen, out, out_len, err, ncols,
                                      chain, slot, out_size, stream);
}

// T5, the per-lane async copy probe: `reps` rounds in which each of `nl`
// lanes copies `w` int32 words of its row of a (128, tape) int32 array,
// from word idx[lane] + 128 * r, into its row of a staging block, then
// waits for every copy. The result is the wrapping int32 sum over the
// rounds of stage[0][0], that is of hbm[0][idx[0] + 128 * r].
//
// Replaces tools/dma_probe.py:_kernel (the pallas_call at :66), which
// issues one pltpu.make_async_copy a lane from HBM into a (128, 1024)
// VMEM block, each on its own DMA semaphore, then waits on all of them.
//
// What bounds it on the H100: the copies are the work. Each is one 1-D
// bulk copy (cp.async.bulk, the TMA engine, issued by one thread)
// completed on its own mbarrier, so no copy can be dropped or merged:
// the thread of lane l issues lane l's copy of a round, then every
// thread waits for its own barrier's phase, and the block synchronises
// before lane 0's word is read. The staging block (512 KiB at w = 1024)
// does not fit one block's shared memory, so a block takes 32 lanes
// (w * 128 bytes; 64 KiB at w = 512) and the lanes' blocks run on
// separate SMs; the block that holds lane 0 writes the sum. A bulk copy
// moves multiples of 16 bytes between 16-byte aligned addresses, so w,
// the tape's row length and every idx are multiples of 4 words (the
// wrapper checks; the tool's idx are multiples of 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerBlock = 32;
constexpr int kRoundStride = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One bulk copy of `bytes` from global src to shared dst, completing on
// `bar`, whose phase expects exactly these bytes and this one arrival.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void dma_kernel(const int* __restrict__ hbm,
                           const int* __restrict__ idx, int* __restrict__ out,
                           int tape, int w, int nl, int reps) {
  extern __shared__ __align__(128) int stage[];
  __shared__ __align__(8) uint64_t bar[kLanesPerBlock];
  const int t = threadIdx.x;
  const int lane = blockIdx.x * kLanesPerBlock + t;
  const bool mine = lane < nl;
  if (mine) mbar_init(&bar[t]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const int* row = hbm + (size_t)lane * tape + (mine ? idx[lane] : 0);
  int* dst = stage + t * w;
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    if (mine) {
      bulk_copy(dst, row + r * kRoundStride, (uint32_t)w * 4, &bar[t]);
      mbar_wait(&bar[t], r & 1);
    }
    __syncthreads();
    if (lane == 0) acc += (uint32_t)stage[0];
    __syncthreads();
  }
  if (lane == 0) out[0] = (int)acc;
}

}  // namespace

// hbm: (128, tape) int32; idx: (128,) int32; out: one int32.
extern "C" int lz4t_probe_dma(const void* hbm, const void* idx, void* out,
                              int tape, int w, int nl, int reps,
                              void* stream) {
  if (nl < 1 || nl > 128 || w < 4 || w % 4 || tape % 4 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = kLanesPerBlock * w * 4;
  cudaError_t e = cudaFuncSetAttribute(
      dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (nl + kLanesPerBlock - 1) / kLanesPerBlock;
  dma_kernel<<<blocks, kLanesPerBlock, smem, (cudaStream_t)stream>>>(
      (const int*)hbm, (const int*)idx, (int*)out, tape, w, nl, reps);
  return (int)cudaGetLastError();
}

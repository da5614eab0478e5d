// T13, the scratch capacity probe: does a scratch of (rows, 128) and
// (ring, 128) int32 fit one block? It replaces
// tools/microbench3.py:probe_vmem's kernel (:235, the pallas_call at :241),
// which asks the TPU's VMEM for the two scratches; here they are the
// block's dynamic shared memory, at most the card's opt-in limit
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232448 bytes, 227 KiB, on the
// H100). A size that fits sets cudaFuncAttributeMaxDynamicSharedMemorySize,
// launches, writes ones into rows 0-7 of each scratch and returns their
// sum: out (8, 128) is all 2s. A size above the limit is refused with
// cudaErrorInvalidValue before any launch (the caller checks first, and
// reads the limit with lz4t_smem_optin).
//
// What bounds it on the H100: one launch; it moves 12 KiB. The shared
// memory is volatile, so the reads come from the scratch, not from the
// registers the ones were stored from. 128 threads, one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

__global__ void smem_kernel(int* __restrict__ out, int rows) {
  extern __shared__ int scratch[];
  volatile int* big = scratch;
  volatile int* ring = scratch + (size_t)rows * kLanes;
  const int lane = threadIdx.x;
  for (int r = 0; r < 8; ++r) {
    big[r * kLanes + lane] = 1;
    ring[r * kLanes + lane] = 1;
  }
  __syncthreads();
  for (int r = 0; r < 8; ++r)
    out[r * kLanes + lane] = big[r * kLanes + lane] + ring[r * kLanes + lane];
}

}  // namespace

// The opt-in shared memory a block may use on card `device`, in bytes, or
// minus the CUDA error code.
extern "C" int lz4t_smem_optin(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -(int)e;
}

// out: (8, 128) int32 on card `device`, which must be the current one.
extern "C" int lz4t_probe_smem(void* out, int rows, int ring, int device,
                               void* stream) {
  if (rows < 8 || ring < 8) return (int)cudaErrorInvalidValue;
  const size_t bytes = ((size_t)rows + (size_t)ring) * kLanes * sizeof(int);
  const int limit = lz4t_smem_optin(device);
  if (limit < 0) return -limit;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  smem_kernel<<<1, kLanes, bytes, (cudaStream_t)stream>>>((int*)out, rows);
  return (int)cudaGetLastError();
}

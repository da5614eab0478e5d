// Nine readings of the primitive-rate harness written for the whole
// H100: from acc = 0 ((8, 128) float32), each iteration i of 0 .. r-1
// computes the body's whole result and adds its rows [:8] into acc; sink
// sums every element of every iteration's whole result (ohbuild: the
// wrapping 32-bit sum of the flat index 512 row + col of each one;
// gather: of the float32 bit patterns; transpose, shiftsel, red1: of the
// int32 elements; the other products: a float64 sum of the product).
//
// Replaces tools/microbench2.py:_harness.kernel (:40, the pallas_call of
// _harness.run at :60) around body_ohbuild (:144), body_mxu in bf16 and
// f32 (:115), body_gather (:130), body_cumsum_mxu (:296),
// body_cumsum_mxu_lane (:307), body_transpose (:318), body_shiftsel
// (:327) and body_red1 (:168). The other eleven vector-unit bodies stay
// in probe_harness.cu, on one SM.
//
// What bounds it on the H100: the integer and half-precision pipes of
// every SM (ohbuild: a compare of two bf16 columns a word, 128 lanes a
// clock an SM), the tensor cores of every SM (2mnk a product at 4096
// dense bf16 FLOP a clock an SM, 2048 TF32; the split TF32 of the two
// cumsums doubles their tensor work) and the shared memory of every SM
// (transpose, shiftsel, red1: 256 KiB an iteration at 128 bytes a clock
// an SM). The TPU runs the harness
// sequentially on one core (grid (1,)) with its inputs in VMEM; here a
// persistent grid of one block an SM walks a static list of work items,
// so that a call's bits depend only on its inputs and the grid, and
// read-only operands stay in shared memory across a block's items, as the
// TPU keeps them in VMEM. Every item computes its whole share of its
// iteration's result: nothing is reused from another iteration.
//
// - ohbuild: the (2048, 512) one-hot of (lcg(ids + i) >> 7) & 511, items
//   (iteration, 64-row band) dealt w = blockIdx.x + k gridDim.x; a warp a
//   row, each lane 8 words of two columns, compared with the row's index
//   (computed in registers by every lane, ids held in shared memory) by
//   one f16x2 compare a word (set.eq.u32.f16x2, both columns' masks).
//   An integer below 1024 is compared as the f16 whose bits it is, a
//   subnormal (exact: set without .ftz keeps subnormals), so that no
//   conversion is needed.
//   The masks select each column plus a bias of 4096 into a packed sum
//   whose halves then give the count and the columns of the ones, so
//   that sink gets 512 row + col of each one. acc's rows 0-7, sums of
//   0s and 1s, are counted in integers (shared-memory atomics, exact in
//   any order) and summed over the blocks by the second kernel: exact
//   while R < 2^24, where the float32 running sum of 0s and 1s stops
//   being exact (it saturates at 2^24), so the wrapper and the entry
//   refuse R >= 2^24 for this body.
// - mxu_bf16 and mxu_f32: (mA (i & 1) + 1) @ mB, one kernel template
//   over the element type: m64n128k16 bf16 as it is, or m64n128k8 TF32
//   with the inputs rounded by cvt.rna (exact for the tool's inputs, bf16
//   values). A block holds one (64-row band, k-part) tile of mA (64 KiB)
//   and mB's k-part (128 KiB), both K-major ([n][k] for B: TF32 wgmma has
//   no transpose, and bf16 takes the same layout) with the 128-byte
//   swizzle: bf16 has one k-part of 512 (8 tiles), TF32 two k-halves of
//   256 (16 tiles); tile t on blocks t, t + tiles, ... (a grid of at
//   least the tiles), which take the iterations in turn; a block's four
//   warpgroups take its items in turn, so that one's epilogue runs under
//   the others' wgmmas. The factor, a power of two, scales the float32
//   product (exact). Each k-part's partial rows 0-7 of band 0 go to the
//   scratch, and the second kernel adds mxu_f32's two, then adds that
//   into acc.
// - gather: onehot((lcg(ids + i) >> 7) & 511, 512) @ data_bf, m64n128k16
//   bf16 -> f32, a 64-row band a warpgroup. The one-hot A is built in
//   registers from the band's indices, computed by the warpgroup that uses
//   them (no block-wide barrier); B (data_bf, 128 KiB) is transposed once a
//   block into shared memory, K-major with the 128-byte swizzle. Every
//   product and sum is exact (one non-zero term a row).
// - cumsum_mxu: tri @ float32(a512 + i), m64n128k8 TF32, a 128-row band a
//   block (two warpgroups of 64 rows). tri's band tiles (128 rows x 32 k)
//   arrive by TMA into a 4-stage ring with mbarriers (A from shared
//   memory). B is converted once an (item, 32-k chunk) by all 256 threads
//   into the other of two buffers while the last chunk's wgmmas run, from
//   a512 values loaded a chunk earlier (their L2 latency hidden); a
//   barrier a chunk. Each element x is split into hi = x
//   with its 13 low mantissa bits cleared and lo = x - hi rounded to TF32
//   (exact for |x| < 2^22, so rows 0-7, sums of at most 8 integers below
//   2^21, are exact), written K-major ([n][k], TF32 wgmma has no
//   transpose) with the 128-byte swizzle; two wgmmas a k step.
// - cumsum_mxu_lane: float32(a512 + i) @ triu, m64n128k8 TF32 with A in
//   registers, a (64-row band) of a512 held by each block in shared
//   memory (padded rows: no bank conflict) for all its items, 8 bands,
//   band b on blocks b, b + 8, ... (a grid of at least 8), which take the
//   iterations in turn, a block's three warpgroups its items in turn. triu
//   (0s and 1s, exact in TF32) is held once a block as B, K-major,
//   swizzled. Each thread forms its own A fragments of x = a + i from the
//   band and splits them as cumsum_mxu does (hi + lo, exact below 2^22,
//   so the wrapper and the entry refuse R >= 2^21): a 32-k chunk at a
//   time, two chunks in flight, two wgmmas (hi, lo) a k step with the
//   same B; nothing of A passes through shared memory. The sink takes
//   each thread's elements summed in float32 pairs, as mxu's.
// - transpose, (x128 + i) transposed, and shiftsel, row r of
//   a512[(r + (lcg(amt[r] + i) & 31)) & 511]: 8 bands of 64 rows of the
//   (512, 128) result, each block holding one band in shared memory for
//   all its items: x128[:, 64 b .. + 63] (32 KiB, rows padded to 65
//   words), or the 95 rows (64 b + k) & 511, k = 0 .. 94, of a512 that
//   the band's selects reach (47.5 KiB; the last band wraps to rows
//   0-30) with amt[64 b .. + 63]. An item (iteration, band) is 16 warp
//   tasks: transpose 16 columns of 32 rows of t, a lane a row of t, one
//   word a column (a warp reads 32 neighbouring words of a row of x128);
//   shiftsel 4 rows, a warp a row, d = lcg(amt[r] + i) & 31 once a row,
//   then 16 bytes a lane of the held row r + d. Every element is read
//   from shared memory in every item (ld.volatile: never hoisted into
//   registers across items) and added into the thread's wrapping sink;
//   each block adds its partial atomically into the sink, which the
//   entry zeroes. acc's 1024 chains run in the same kernel on blocks of
//   their own: 8 blocks (1, 2 or 4 on grids below 16) that hold band 0
//   and take no items, 128 cells each (one row of acc), a thread a cell
//   on 4 warps. Each chain reads its cell of rows 0-7 from the held band
//   (x128[c, row] + i; or a512[row + d, c], d from amt[row]) and adds
//   it, converted by __int2float_rn, with __fadd_rn in iteration order,
//   16 iterations' reads issued before their adds (shiftsel's amounts
//   before its values: each value waits on its amount, so a read a step
//   would cost two shared-memory latencies an iteration). A chain runs
//   at 5-9 ns an iteration alone and the items at 8-10 on the whole
//   card, but blocks that ran both set a pace of 10-14: so the chain
//   blocks take no items, the other blocks deal the bands (15 or 16 a
//   band on 132 SMs), and on a grid of 8 block 0 does both. No scratch
//   and no second kernel.
// - red1, the 512 row sums of a512 + i, in the same form (Deal, the same
//   chain blocks): a block holds a 64-row band of a512 (33 KiB: rows of
//   32 chunks of 16 bytes padded to 33, so that 8 neighbouring rows at
//   one chunk, or 8 neighbouring chunks of a row, fall in distinct
//   banks). An item (iteration, band) is 2 warp tasks of 32 rows, a lane
//   a row: its 128 words read anew (ld.volatile) and summed in the lane,
//   no shuffle, plus 128 i (the same wrapping value as the sum of a + i),
//   then added into the block's sink partial. acc's rows are the row
//   sums of rows 0-7, so acc has 8 chains, a warp a row on the chain
//   blocks (one row a block on 8 of them), which also hold those rows
//   twice over in a line: lane u reads the row's 128 words for
//   iteration i0 + u (its 32 chunks from chunk u on, so that no read
//   serves two iterations) and forms its sum; the warp adds the 32 sums,
//   passed through shared memory, in iteration order, reading the next
//   batch's chunks between the adds, and writes the row's 128 cells.
//
// Across blocks, for the other six: the band-0 items of iteration i
// write its rows 0-7 to scratch[i] (8 x 128 float32, one a k-half for
// mxu_f32; ohbuild: each block its counts); each block writes its sink
// partial (a float64, or a uint32); a second kernel (32 blocks, a thread
// a cell) adds scratch[0 .. r-1] into acc in iteration order with
// __fadd_rn (ohbuild's, of one block: sums the blocks' counts and
// converts them) and sums the partials in block order. r = 0 gives acc =
// 0 and sink = 0.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHi = 0xffffe000u;  // a float's sign, exponent, 10 mantissa bits
constexpr int kTile = 128 * 128;       // bytes: 128 rows of one 128-byte swizzle row

__device__ __forceinline__ uint32_t lcg(uint32_t x) {
  return x * 1664525u + 1013904223u;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// 0xffff in each 16-bit half where the f16 halves of a and b are equal
__device__ __forceinline__ uint32_t heq2_mask(uint32_t a, uint32_t b) {
  uint32_t m;
  asm("set.eq.u32.f16x2 %0, %1, %2;" : "=r"(m) : "r"(a), "r"(b));
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// dynamic shared memory rounded up to 1024 bytes (the swizzle's period)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// element (row, 16-byte chunk q) of a swizzled 128-byte-row tile
__device__ __forceinline__ int swz(int row, int q) {
  return row * 128 + ((q ^ (row & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators across a wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int q = 0; q < 64; ++q) asm volatile("" : "+f"(d[q])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D64                                                                \
  D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28), D4(32),     \
      D4(36), D4(40), D4(44), D4(48), D4(52), D4(56), D4(60)
#define R64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A (64 x 8, shared, K-major) B (8 x 128, shared, K-major), TF32
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", %64, %65, p, 1, 1;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 8, registers) B (8 x 128, shared, K-major), TF32; a
// thread holds A's rows 16 w + g and + 8 (w its warp in the warpgroup, g
// its lane / 4) at k t and t + 4 (t its lane % 4): a[0] (g, t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (+)= A (64 x 16, shared, K-major) B (16 x 128, shared, K-major), bf16
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16, registers) B (16 x 128, shared, K-major), bf16
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// TMA: the (32 k, 128 rows) float32 box at (k0, m0) of map into dst,
// completing on bar
__device__ __forceinline__ void tma_load(const CUtensorMap& map, void* dst,
                                         uint64_t* bar, int k0, int m0) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(kTile)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)&map), "r"(smem_u32(bar)), "r"(k0), "r"(m0)
      : "memory");
}

// rows 0-7 of a finished band-0 tile (warp 0 of its warpgroup), times f,
// to dst
__device__ __forceinline__ void store_rows(const float (&d)[64], float* dst,
                                           float f = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *(float2*)(dst + g * 128 + 8 * j + 2 * t) =
        make_float2(d[4 * j] * f, d[4 * j + 1] * f);
}

// ---- ohbuild: the one-hot, a warp a row, 64-row bands over every SM ----

namespace oh {
constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kRows = 64, kBands = 2048 / kRows;
constexpr uint32_t kBias = 4096;  // above 8 columns' sum: 8 x 511
}  // namespace oh

__global__ void __launch_bounds__(oh::kThreads, 1)
    ohbuild_kernel(const int* __restrict__ ids, int r,
                   uint32_t* __restrict__ counts, uint32_t* __restrict__ part) {
  __shared__ int sid[2048];
  __shared__ uint32_t cnt[8 * 128];  // acc's ones of this block's items
  __shared__ uint32_t red[oh::kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int q = tid; q < 2048; q += oh::kThreads) sid[q] = __ldg(ids + q);
  for (int q = tid; q < 8 * 128; q += oh::kThreads) cnt[q] = 0;
  // the lane's words j: columns (2k, 2k + 1), k = lane + 32 j, packed
  // (ch) and biased by kBias (cb)
  uint32_t ch[8], cb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t c = 2 * (lane + 32 * j);
    ch[j] = c | (c + 1u) << 16;
    cb[j] = ch[j] + (oh::kBias | oh::kBias << 16);
  }
  __syncthreads();
  uint32_t sink = 0;
  const int items = r * oh::kBands;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const uint32_t i = (uint32_t)(w / oh::kBands);
    const int row0 = (w % oh::kBands) * oh::kRows + warp;
#pragma unroll
    for (int q = 0; q < oh::kRows / oh::kWarps; ++q) {
      const int row = row0 + oh::kWarps * q;
      const uint32_t vh =
          (((int)lcg((uint32_t)sid[row] + i) >> 7) & 511) * 0x10001u;
      // every element of the row: s's halves sum col + kBias of each one
      uint32_t m[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = heq2_mask(ch[j], vh);
        s += m[j] & cb[j];
      }
      const uint32_t lo = s & 0xffffu, hi = s >> 16;
      // sum of (512 row + col) = lo + hi + (512 row - kBias) x the ones
      sink += lo + hi + ((uint32_t)row * 512u - oh::kBias) *
                            ((lo >> 12) + (hi >> 12));
      if (q == 0 && row0 < 8) {  // acc's rows: columns 0-127, words 0-1
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = row * 128 + 2 * (lane + 32 * j);
          if (m[j] & 0xffffu) atomicAdd(cnt + c, 1u);
          if (m[j] >> 16) atomicAdd(cnt + c + 1, 1u);
        }
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sink += __shfl_xor_sync(kFull, sink, d);
  if (lane == 0) red[warp] = sink;
  __syncthreads();
  for (int q = tid; q < 8 * 128; q += oh::kThreads)
    counts[(size_t)blockIdx.x * 1024 + q] = cnt[q];
  if (tid == 0) {
    uint32_t tot = 0;
    for (int q = 0; q < oh::kWarps; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// acc: each cell's count of ones summed over the blocks (exact below
// 2^24); sink: the blocks' partials in block order
__global__ void __launch_bounds__(1024)
    ohbuild_finish(const uint32_t* __restrict__ counts,
                   const uint32_t* __restrict__ part, int grid,
                   float* __restrict__ out, int* __restrict__ sink) {
  const int q = threadIdx.x;
  uint32_t n = 0;
  for (int b = 0; b < grid; ++b) n += counts[(size_t)b * 1024 + q];
  out[q] = __uint2float_rn(n);
  if (q == 0) {
    uint32_t tot = 0;
    for (int b = 0; b < grid; ++b) tot += part[b];
    *sink = (int)tot;
  }
}

// ---- mxu_bf16 and mxu_f32: a (64-row band, k-part) tile a block ----

// d[0] = the float32 sum of d[0 .. 2H) in pairs: d[q] += d[q + H], then H/2
template <int H>
__device__ __forceinline__ void pair_sum(float (&d)[64]) {
#pragma unroll
  for (int q = 0; q < H; ++q) d[q] += d[q + H];
  if constexpr (H > 1) pair_sum<H / 2>(d);
}

namespace mf {
constexpr int kThreads = 512, kWgs = kThreads / 128;
constexpr int kA = 64 * 128;       // bytes of a (64 m, 128-byte k) chunk of A
constexpr int kSmem = 1024 + 8 * kA + 8 * kTile + 8 * (kThreads / 32);
}  // namespace mf

// The element types of the product. A tile (band, part) is 64 rows of mA
// by kK of k and mB's kK rows of that part, each 8 chunks of 128 bytes of
// k: 16-byte pieces p = 0 .. 63 of a row (of A) or column (of B), piece p
// in chunk p / 8 at place p % 8 of the swizzled row.
struct F32 {   // TF32 by cvt.rna (exact on bf16 values), two k-halves
  static constexpr int kParts = 2, kK = 256;
  // piece p of row m: 4 float of k kK part + 4 p
  static __device__ uint4 a_piece(const void* a, int band, int part, int m,
                                  int p) {
    const float4 v = __ldg((const float4*)((const float*)a +
                                           (size_t)(64 * band + m) * 512 +
                                           kK * part) + p);
    return make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
  }
  // piece o of column n: 4 float of k kK part + 4 o
  static __device__ uint4 b_piece(const void* b, int part, int n, int o) {
    const float* src = (const float*)b + (size_t)(kK * part + 4 * o) * 128 + n;
    return make_uint4(tf32(__ldg(src)), tf32(__ldg(src + 128)),
                      tf32(__ldg(src + 256)), tf32(__ldg(src + 384)));
  }
  // one k step: 8 k, 32 bytes
  static __device__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                             int acc) {
    wgmma_tf32(d, da, db, acc);
  }
};

struct Bf16 {  // bf16 as it is, all 512 k in one part
  static constexpr int kParts = 1, kK = 512;
  // piece p of row m: 8 bf16 of k 8 p
  static __device__ uint4 a_piece(const void* a, int band, int, int m,
                                  int p) {
    return __ldg((const uint4*)((const uint16_t*)a +
                                (size_t)(64 * band + m) * 512) + p);
  }
  // piece o of column n: 8 bf16 of k 8 o, packed in pairs (k, k + 1)
  static __device__ uint4 b_piece(const void* b, int, int n, int o) {
    const uint16_t* src = (const uint16_t*)b + (size_t)8 * o * 128 + n;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)__ldg(src + 2 * j * 128) |
             (uint32_t)__ldg(src + (2 * j + 1) * 128) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  // one k step: 16 k, 32 bytes
  static __device__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                             int acc) {
    wgmma_bf16_ss(d, da, db, acc);
  }
};

template <class E>
__global__ void __launch_bounds__(mf::kThreads, 1)
    mxu_kernel(const void* __restrict__ a, const void* __restrict__ b, int r,
               float* __restrict__ scratch, double* __restrict__ part) {
  constexpr int kTiles = 8 * E::kParts;
  extern __shared__ uint8_t raw[];
  uint8_t* as = aligned_smem(raw);      // 8 chunks (64 m, 128 bytes of k)
  uint8_t* bs = as + 8 * mf::kA;        // 8 chunks (128 n, 128 bytes of k)
  double* red = (double*)(bs + 8 * kTile);
  const int tid = threadIdx.x, tile = blockIdx.x % kTiles;
  const int band = tile / E::kParts, kp = tile % E::kParts;
  // the tile's blocks, and this block's place among them
  const int blocks = ((int)gridDim.x - tile + kTiles - 1) / kTiles;
  const int first = blockIdx.x / kTiles;
  // mA's tile and mB's part, K-major, swizzled
  for (int e = tid; e < 64 * 64; e += mf::kThreads) {
    const int m = e >> 6, p = e & 63;
    *(uint4*)(as + (p >> 3) * mf::kA + swz(m, p & 7)) =
        E::a_piece(a, band, kp, m, p);
  }
  for (int e = tid; e < 128 * 64; e += mf::kThreads) {
    const int n = e & 127, o = e >> 7;
    *(uint4*)(bs + (o >> 3) * kTile + swz(n, o & 7)) = E::b_piece(b, kp, n, o);
  }
  fence_proxy_async();
  __syncthreads();
  const int wg = tid >> 7;
  double sink = 0.0;
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (int j = wg;; j += mf::kWgs) {
    const int i = first + blocks * j;
    if (i >= r) break;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const uint64_t da = desc(as + kc * mf::kA), db = desc(bs + kc * kTile);
#pragma unroll
      for (int s = 0; s < 4; ++s) E::mma(d, da + 2 * s, db + 2 * s, kc | s);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    // the product times f (exact): rows 0-7 to the scratch; the sink
    // gets the thread's 64 elements summed in pairs in float32 (within
    // E: 6 roundings of their magnitudes), times f
    const float f = (float)((i & 1) + 1);
    if (band == 0 && (tid & 127) < 32)
      store_rows(d, scratch + ((size_t)i * E::kParts + kp) * 1024, f);
    pair_sum<32>(d);
    sink += (double)(d[0] * f);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sink += __shfl_xor_sync(kFull, sink, m);
  if ((tid & 31) == 0) red[tid >> 5] = sink;
  __syncthreads();
  if (tid == 0) {
    double tot = 0.0;
    for (int q = 0; q < mf::kThreads / 32; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// ---- gather: a 64-row band a warpgroup, data_bf resident ----

namespace ga {
constexpr int kThreads = 256, kWgs = kThreads / 128;
constexpr int kBands = 2048 / 64;
constexpr int kSmem = 1024 + 8 * kTile + 32;  // B: 8 tiles of 64 k
}  // namespace ga

// a bf16 pair (k, k + 1) of the one-hot row of index v: 1.0 at column v
__device__ __forceinline__ uint32_t onehot(int v, int k) {
  const int d = v - k;
  return d == 0 ? 0x3f80u : d == 1 ? 0x3f800000u : 0u;
}

__global__ void __launch_bounds__(ga::kThreads, 1)
    gather_kernel(const int* __restrict__ ids,
                  const uint16_t* __restrict__ data, int r,
                  float* __restrict__ scratch, uint32_t* __restrict__ part) {
  extern __shared__ uint8_t raw[];
  uint8_t* bs = aligned_smem(raw);
  uint32_t* red = (uint32_t*)(bs + 8 * kTile);
  const int tid = threadIdx.x;
  // data_bf (512 k, 128 n) into 8 tiles (128 n, 64 k), K-major, swizzled
  for (int e = tid; e < 128 * 64; e += ga::kThreads) {
    const int n = e & 127, o = e >> 7;  // o: the k octet
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)__ldg(data + (8 * o + 2 * j) * 128 + n) |
             (uint32_t)__ldg(data + (8 * o + 2 * j + 1) * 128 + n) << 16;
    *(uint4*)(bs + (o >> 3) * kTile + swz(n, o & 7)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_proxy_async();
  __syncthreads();
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int items = r * ga::kBands, stride = gridDim.x * ga::kWgs;
  const uint64_t db = desc(bs);
  uint32_t sink = 0;
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (int w = blockIdx.x * ga::kWgs + (tid >> 7); w < items; w += stride) {
    const uint32_t i = (uint32_t)(w / ga::kBands);
    const int row = (w % ga::kBands) * 64 + 16 * warp + g;
    const int v0 = ((int)lcg((uint32_t)__ldg(ids + row) + i) >> 7) & 511;
    const int v1 = ((int)lcg((uint32_t)__ldg(ids + row + 8) + i) >> 7) & 511;
    uint32_t a[2][4][4];  // two chunks of 64 k in flight
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      uint32_t(&x)[4][4] = a[kc & 1];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 64 * kc + 16 * s + 2 * t;
        x[s][0] = onehot(v0, k);
        x[s][1] = onehot(v1, k);
        x[s][2] = onehot(v0, k + 8);
        x[s][3] = onehot(v1, k + 8);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_bf16(d, x[s], db + (kc * kTile >> 4) + 2 * s, kc | s);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(d);
#pragma unroll
    for (int q = 0; q < 64; ++q) sink += __float_as_uint(d[q]);
    if (w % ga::kBands == 0 && warp == 0)
      store_rows(d, scratch + (size_t)i * 1024);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sink += __shfl_xor_sync(kFull, sink, m);
  if (lane == 0) red[tid >> 5] = sink;
  __syncthreads();
  if (tid == 0) {
    uint32_t tot = 0;
    for (int q = 0; q < ga::kThreads / 32; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// ---- cumsum_mxu: a 128-row band a block, tri through a TMA ring ----

namespace cs {
constexpr int kThreads = 256, kStages = 4;
constexpr int kChunks = 512 / 32;  // 32-k chunks of a product
constexpr int kBands = 512 / 128;
constexpr int kSmem = 1024 + kStages * kTile + 4 * kTile + kStages * 8 + 64;
}  // namespace cs

// a thread's share of chunk kc of a: 4 k of one column, 4 times
__device__ __forceinline__ void fetch(const int* __restrict__ a, int kc,
                                      int (&v)[4][4]) {
  const int n = threadIdx.x & 127, q0 = threadIdx.x >> 7;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[u][e] = __ldg(a + (32 * kc + 4 * (q0 + 2 * u) + e) * 128 + n);
}

// that share of B = float32(a + i) as hi and lo, (128 n, 32 k) K-major,
// swizzled
__device__ __forceinline__ void convert(const int (&v)[4][4], uint32_t i,
                                        uint8_t* hi, uint8_t* lo) {
  const int n = threadIdx.x & 127, q0 = threadIdx.x >> 7;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __int2float_rn((int)((uint32_t)v[u][e] + i));
      h[e] = __float_as_uint(x) & kHi;
      l[e] = tf32(x - __uint_as_float(h[e]));
    }
    const int off = swz(n, q0 + 2 * u);
    *(uint4*)(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *(uint4*)(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__global__ void __launch_bounds__(cs::kThreads, 1)
    cumsum_kernel(const __grid_constant__ CUtensorMap tri,
                  const int* __restrict__ a, int r,
                  float* __restrict__ scratch, double* __restrict__ part) {
  extern __shared__ uint8_t raw[];
  uint8_t* ring = aligned_smem(raw);
  uint8_t* bb = ring + cs::kStages * kTile;  // 2 x (hi, lo)
  uint64_t* full = (uint64_t*)(bb + 4 * kTile);
  double* red = (double*)(full + cs::kStages);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int G = gridDim.x, items = r * cs::kBands;
  const int mine = (int)blockIdx.x < items
                       ? (items - 1 - (int)blockIdx.x) / G + 1 : 0;
  const int nc = mine * cs::kChunks;  // the block's chunks, in order
  auto item = [&](int c) { return (int)blockIdx.x + c / cs::kChunks * G; };
  auto load = [&](int c, int st) {
    tma_load(tri, ring + st * kTile, full + st, 32 * (c % cs::kChunks),
             128 * (item(c) % cs::kBands));
  };
  // B of chunk c from the a values fetched for it a chunk earlier
  int v[4][4];
  auto stage_b = [&](int c) {
    uint8_t* b = bb + (c & 1) * 2 * kTile;
    convert(v, (uint32_t)(item(c) / cs::kBands), b, b + kTile);
    if (c + 1 < nc) fetch(a, (c + 1) % cs::kChunks, v);
  };
  if (tid == 0) {
    for (int s = 0; s < cs::kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < cs::kStages && c < nc; ++c) load(c, c);
  }
  if (nc > 0) {
    fetch(a, 0, v);
    stage_b(0);
  }
  fence_proxy_async();
  __syncthreads();
  double sink = 0.0;
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int kc = c % cs::kChunks, st = c % cs::kStages;
    mbar_wait(full + st, (uint32_t)(c / cs::kStages) & 1);
    const uint8_t* b = bb + (c & 1) * 2 * kTile;
    const uint64_t da = desc(ring + st * kTile + wg * (kTile / 2));
    const uint64_t dh = desc(b), dl = desc(b + kTile);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32(d, da + 2 * s, dh + 2 * s, kc | s);
      wgmma_tf32(d, da + 2 * s, dl + 2 * s, 1);
    }
    wgmma_commit();
    if (c + 1 < nc) stage_b(c + 1);  // while the wgmmas run
    wgmma_wait<0>();
    fence_acc(d);
    fence_proxy_async();
    __syncthreads();  // B of c + 1 written; ring slot st and B of c free
    if (tid == 0 && c + cs::kStages < nc) load(c + cs::kStages, st);
    if (kc == cs::kChunks - 1) {
      const int w = item(c);
#pragma unroll
      for (int q = 0; q < 64; ++q) sink += (double)d[q];
      if (w % cs::kBands == 0 && tid < 32)
        store_rows(d, scratch + (size_t)(w / cs::kBands) * 1024);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sink += __shfl_xor_sync(kFull, sink, m);
  if ((tid & 31) == 0) red[tid >> 5] = sink;
  __syncthreads();
  if (tid == 0) {
    double tot = 0.0;
    for (int q = 0; q < cs::kThreads / 32; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// ---- cumsum_mxu_lane: a 64-row band of a512 a block, A in registers ----

namespace cl {
constexpr int kThreads = 384, kWgs = kThreads / 128;
constexpr int kBands = 512 / 64;
constexpr int kPitch = 132;        // words a row of the band: no bank conflict
constexpr int kSmem = 1024 + 4 * kTile + 64 * kPitch * 4 + 8 * (kThreads / 32);
}  // namespace cl

__global__ void __launch_bounds__(cl::kThreads, 1)
    cumsum_lane_kernel(const int* __restrict__ a, const float* __restrict__ triu,
                       int r, float* __restrict__ scratch,
                       double* __restrict__ part) {
  extern __shared__ uint8_t raw[];
  uint8_t* bs = aligned_smem(raw);             // 4 chunks (128 n, 32 k)
  int* rows = (int*)(bs + 4 * kTile);          // the band, 64 x kPitch
  double* red = (double*)(rows + 64 * cl::kPitch);
  const int tid = threadIdx.x, band = blockIdx.x % cl::kBands;
  // the band's blocks, and this block's place among them
  const int blocks =
      ((int)gridDim.x - band + cl::kBands - 1) / cl::kBands;
  const int first = blockIdx.x / cl::kBands;
  // triu (128 k, 128 n) as B, [n][k] K-major, swizzled (0 and 1: exact)
  for (int e = tid; e < 128 * 32; e += cl::kThreads) {
    const int n = e & 127, o = e >> 7;  // o: the k quad
    const float* src = triu + (size_t)4 * o * 128 + n;
    *(uint4*)(bs + (o >> 3) * kTile + swz(n, o & 7)) =
        make_uint4(tf32(__ldg(src)), tf32(__ldg(src + 128)),
                   tf32(__ldg(src + 256)), tf32(__ldg(src + 384)));
  }
  for (int e = tid; e < 64 * 32; e += cl::kThreads) {
    const int m = e >> 5, q = e & 31;
    *(int4*)(rows + m * cl::kPitch + 4 * q) =
        __ldg((const int4*)(a + (size_t)(64 * band + m) * 128) + q);
  }
  fence_proxy_async();
  __syncthreads();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the thread's A elements: rows 16 warp + g and + 8, k t and t + 4 of
  // each 8-k step
  const int* r0 = rows + (16 * warp + g) * cl::kPitch + t;
  const int* r1 = r0 + 8 * cl::kPitch;
  const uint64_t db = desc(bs);
  double sink = 0.0;
  float d[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) d[q] = 0.f;
  for (int j = wg;; j += cl::kWgs) {
    const int i = first + blocks * j;
    if (i >= r) break;
    // float32(a + i) as hi + lo in TF32, a 32-k chunk at a time, two
    // chunks in flight: hi + lo of a step, two wgmmas with its B
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t(&h)[4][4] = ah[kc & 1];
      uint32_t(&l)[4][4] = al[kc & 1];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 32 * kc + 8 * s;
        const int v[4] = {r0[k], r1[k], r0[k + 4], r1[k + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __int2float_rn((int)((uint32_t)v[e] + (uint32_t)i));
          h[s][e] = __float_as_uint(x) & kHi;
          l[s][e] = tf32(x - __uint_as_float(h[s][e]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint64_t b = db + (kc * kTile >> 4) + 2 * s;
        wgmma_tf32_rs(d, h[s], b, kc | s);
        wgmma_tf32_rs(d, l[s], b, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(d);
    // rows 0-7 to the scratch; the sink gets the thread's 64 elements
    // summed in pairs in float32 (within E: 6 roundings of their sum)
    if (band == 0 && warp == 0) store_rows(d, scratch + (size_t)i * 1024);
    pair_sum<32>(d);
    sink += (double)d[0];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sink += __shfl_xor_sync(kFull, sink, m);
  if (lane == 0) red[tid >> 5] = sink;
  __syncthreads();
  if (tid == 0) {
    double tot = 0.0;
    for (int q = 0; q < cl::kThreads / 32; ++q) tot += red[q];
    part[blockIdx.x] = tot;
  }
}

// ---- transpose, shiftsel, red1: a band resident a block, acc's chains ----

namespace rb {
constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kBands = 512 / 64;     // 64-row bands of the (512, 128) result
constexpr int kTasks = 16;           // warp tasks an item
constexpr int kChainWarps = 4;       // a chain block's warps that run chains
constexpr int kMaxChains = 8;        // chain blocks, one row of acc each
constexpr int kPitch = 65;           // transpose: words a held row of x128
constexpr int kSel = 64 + 31;        // shiftsel: rows a band's selects reach
constexpr int kBatch = 16;           // iterations a chain reads, then adds
constexpr int kRowTasks = 2;         // red1: warp tasks (32 rows) an item
constexpr int kRowPitch = 33;        // red1: 16-byte chunks a held row
}  // namespace rb

// A read of shared memory that the compiler may neither hoist out of a
// loop nor merge with another: every item reads its elements anew.
__device__ __forceinline__ uint32_t lds(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(smem_u32(p)));
  return v;
}
__device__ __forceinline__ uint4 lds4(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// The block's share of the static list: the band it holds, iterations
// lo .. hi - 1 of that band, and acc's cells cell0 .. cell0 + cells - 1
// to chain (cells 0: none). Blocks 0 .. chains - 1 (1, 2, 4 or 8: as
// many as the grid leaves beside one block a band) chain 1024 / chains
// cells each and hold band 0; the blocks from first on take the items,
// band b on blocks first + b, first + b + 8, ..., each a contiguous
// range of the iterations. first is chains, or 0 on a grid of 8, where
// block 0 also takes band 0's items.
struct Deal {
  int band, lo, hi, cell0, cells;
};

__device__ __forceinline__ Deal deal(int r) {
  const int grid = gridDim.x, blk = blockIdx.x;
  int chains = 1;
  while (2 * chains <= min(rb::kMaxChains, max(1, grid - rb::kBands)))
    chains *= 2;
  const int first = grid - chains >= rb::kBands ? chains : 0;
  Deal d;
  d.cells = blk < chains ? 1024 / chains : 0;
  d.cell0 = blk * d.cells;
  d.band = blk < first ? 0 : (blk - first) % rb::kBands;
  d.lo = d.hi = 0;
  if (blk >= first) {
    const int k = (blk - first) / rb::kBands;
    const int blocks = (grid - first - d.band + rb::kBands - 1) / rb::kBands;
    d.lo = (int)((long long)r * k / blocks);
    d.hi = (int)((long long)r * (k + 1) / blocks);
  }
  return d;
}

// the block's wrapping sink partial added into *sink (zeroed by the entry)
__device__ __forceinline__ void add_sink(uint32_t s, uint32_t* red,
                                         int* sink) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t tot = 0;
    for (int q = 0; q < rb::kWarps; ++q) tot += red[q];
    atomicAdd((unsigned*)sink, tot);
  }
}

// t = (x128 + i) transposed: t[row, c] = x128[c, row] + i
__global__ void __launch_bounds__(rb::kThreads, 1)
    transpose_kernel(const int* __restrict__ x128, int r,
                     float* __restrict__ out, int* __restrict__ sink) {
  // x128[c, 64 band + j] at xs[c kPitch + j]: a warp reads 32 neighbouring
  // j of one c (an item) or one j of 32 neighbouring c (a chain), both
  // without a bank conflict
  __shared__ uint32_t xs[128 * rb::kPitch];
  __shared__ uint32_t red[rb::kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Deal d = deal(r);
  for (int e = tid; e < 128 * 64; e += rb::kThreads)
    xs[(e >> 6) * rb::kPitch + (e & 63)] =
        (uint32_t)__ldg(x128 + (e >> 6) * 512 + 64 * d.band + (e & 63));
  __syncthreads();
  const int chain = d.cells ? rb::kChainWarps : 0;
  uint32_t sum = 0;
  if (warp < chain) {
    // cell q = 128 row + c of acc (band 0: row is t's row)
    for (int q = d.cell0 + tid; q < d.cell0 + d.cells;
         q += 32 * rb::kChainWarps) {
      const uint32_t* p = xs + (q & 127) * rb::kPitch + (q >> 7);
      float acc = 0.f;
      for (int i0 = 0; i0 < r; i0 += rb::kBatch) {
        uint32_t v[rb::kBatch];
#pragma unroll
        for (int u = 0; u < rb::kBatch; ++u)
          v[u] = lds(p) + (uint32_t)(i0 + u);
#pragma unroll
        for (int u = 0; u < rb::kBatch; ++u)
          if (i0 + u < r) acc = __fadd_rn(acc, __int2float_rn((int)v[u]));
      }
      out[q] = acc;
    }
  } else {
    // warp task f: item lo + f / 16; task f % 16 takes t's rows 32 (task
    // & 1) + lane of the band at columns 16 (task >> 1) .. + 15
    const int n = (d.hi - d.lo) * rb::kTasks, workers = rb::kWarps - chain;
    for (int f = warp - chain; f < n; f += workers) {
      const uint32_t i = (uint32_t)(d.lo + f / rb::kTasks);
      const int task = f % rb::kTasks;
      const uint32_t* p =
          xs + 16 * (task >> 1) * rb::kPitch + 32 * (task & 1) + lane;
#pragma unroll
      for (int c = 0; c < 16; ++c) sum += lds(p + c * rb::kPitch) + i;
    }
  }
  add_sink(sum, red, sink);
}

// row r of a512[(r + (lcg(amt[r] + i) & 31)) & 511]
__global__ void __launch_bounds__(rb::kThreads, 1)
    shiftsel_kernel(const int* __restrict__ a, const int* __restrict__ amt,
                    int r, float* __restrict__ out, int* __restrict__ sink) {
  // a512's row (64 band + k) & 511 at rows[32 k ..], k = 0 .. kSel - 1:
  // a warp reads one whole row (an item) or 32 neighbouring words of one
  // (a chain); amt[64 band + j] at sa[j]
  __shared__ uint4 rows[rb::kSel * 32];
  __shared__ __align__(16) uint32_t sa[64];
  __shared__ uint32_t red[rb::kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Deal d = deal(r);
  for (int e = tid; e < rb::kSel * 32; e += rb::kThreads) {
    const int row = (64 * d.band + (e >> 5)) & 511;
    const int4 v = __ldg((const int4*)(a + row * 128) + (e & 31));
    rows[e] = make_uint4(v.x, v.y, v.z, v.w);
  }
  if (tid < 64) sa[tid] = (uint32_t)__ldg(amt + 64 * d.band + tid);
  __syncthreads();
  const int chain = d.cells ? rb::kChainWarps : 0;
  uint32_t sum = 0;
  if (warp < chain) {
    // cell q = 128 row + c of acc (band 0: row is the band's row)
    for (int q = d.cell0 + tid; q < d.cell0 + d.cells;
         q += 32 * rb::kChainWarps) {
      const int row = q >> 7;
      const uint32_t* col = (const uint32_t*)rows + row * 128 + (q & 127);
      float acc = 0.f;
      // a batch's amounts, then its values, then its adds: a value's read
      // waits for its amount's, and volatile reads keep their order
      for (int i0 = 0; i0 < r; i0 += rb::kBatch) {
        uint32_t v[rb::kBatch];
#pragma unroll
        for (int u = 0; u < rb::kBatch; ++u)
          v[u] = lcg(lds(sa + row) + (uint32_t)(i0 + u)) & 31;
#pragma unroll
        for (int u = 0; u < rb::kBatch; ++u) v[u] = lds(col + v[u] * 128);
#pragma unroll
        for (int u = 0; u < rb::kBatch; ++u)
          if (i0 + u < r) acc = __fadd_rn(acc, __int2float_rn((int)v[u]));
      }
      out[q] = acc;
    }
  } else {
    // warp task f: item lo + f / 16; task f % 16 takes the band's rows
    // 4 task .. 4 task + 3, their amounts in one broadcast read
    const int n = (d.hi - d.lo) * rb::kTasks, workers = rb::kWarps - chain;
    for (int f = warp - chain; f < n; f += workers) {
      const uint32_t i = (uint32_t)(d.lo + f / rb::kTasks);
      const int j = 4 * (f % rb::kTasks);
      const uint4 am = lds4((const uint4*)sa + j / 4);
      const uint32_t s[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t sh = lcg(s[u] + i) & 31;
        const uint4 v = lds4(rows + (j + u + sh) * 32 + lane);
        sum += v.x + v.y + v.z + v.w;
      }
    }
  }
  add_sink(sum, red, sink);
}

// the 512 row sums of a512 + i, each formed as the sum of the row's 128
// words plus 128 i (the same wrapping value)
__global__ void __launch_bounds__(rb::kThreads, 1)
    red1_kernel(const int* __restrict__ a, int r, float* __restrict__ out,
                int* __restrict__ sink) {
  // a512's row 64 band + k at rows[kRowPitch k ..], 32 chunks of 16
  // bytes and one of padding: 8 neighbouring rows at one chunk (an item's
  // quarter warp) fall in distinct banks. A chain block also holds acc's
  // rows (rows 0-7 of band 0) twice over, 64 chunks a row, so that a
  // lane's 32 chunks from chunk lane on lie in a line
  __shared__ uint4 rows[64 * rb::kRowPitch];
  __shared__ uint4 twice[8 * 64];
  __shared__ __align__(16) float sums[rb::kChainWarps][32];
  __shared__ uint32_t red[rb::kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Deal d = deal(r);
  const int4* band = (const int4*)(a + 64 * d.band * 128);
  for (int e = tid; e < 64 * 32; e += rb::kThreads) {
    const int4 v = __ldg(band + e);
    rows[(e >> 5) * rb::kRowPitch + (e & 31)] = make_uint4(v.x, v.y, v.z, v.w);
  }
  if (d.cells)
    for (int e = tid; e < 8 * 64; e += rb::kThreads) {
      const int4 v = __ldg(band + (e >> 6) * 32 + (e & 31));
      twice[e] = make_uint4(v.x, v.y, v.z, v.w);
    }
  __syncthreads();
  const int chain = d.cells ? rb::kChainWarps : 0;
  uint32_t sum = 0;
  if (warp < chain) {
    // row q of acc, a warp a row: lane u forms the row sum of iteration
    // i0 + u from the row's 32 chunks, read from chunk u on (32 different
    // chunks a step: no read serves two lanes), in 4 parts; the warp adds
    // the 32 sums, passed through shared memory, in iteration order,
    // while it reads the next batch's chunks
    float* f = sums[warp];
    for (int q = d.cell0 / 128 + warp; q < (d.cell0 + d.cells) / 128;
         q += rb::kChainWarps) {
      const uint4* row = twice + q * 64 + lane;
      float acc = 0.f;
      uint32_t s[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint4 v = lds4(row + k);
        s[k & 3] += (v.x + v.y + v.z) + v.w;
      }
      for (int i0 = 0; i0 < r; i0 += 32) {
        const uint32_t all = (s[0] + s[1]) + (s[2] + s[3]);
        f[lane] = __int2float_rn((int)(all + 128u * (uint32_t)(i0 + lane)));
        __syncwarp();
        const float4* g = (const float4*)f;
        const int n = min(32, r - i0);
        s[0] = s[1] = s[2] = s[3] = 0;
        if (n == 32) {
#pragma unroll
          for (int u = 0; u < 32; u += 4) {
            const float4 h = g[u / 4];
            const float hs[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const uint4 v = lds4(row + u + w);
              s[w] += (v.x + v.y + v.z) + v.w;
              acc = __fadd_rn(acc, hs[w]);
            }
          }
        } else {
          for (int u = 0; u < n; ++u) acc = __fadd_rn(acc, f[u]);
        }
        __syncwarp();
      }
      for (int c = lane; c < 128; c += 32) out[q * 128 + c] = acc;
    }
  } else {
    // warp task f: item lo + f / 2; task f % 2 takes the band's rows
    // 32 (f % 2) .. + 31, a lane a row: its 128 words summed, plus 128 i
    const int n = (d.hi - d.lo) * rb::kRowTasks, workers = rb::kWarps - chain;
    for (int f = warp - chain; f < n; f += workers) {
      const uint32_t i = (uint32_t)(d.lo + f / rb::kRowTasks);
      const uint4* row =
          rows + (32 * (f % rb::kRowTasks) + lane) * rb::kRowPitch;
      uint32_t s = 0;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const uint4 v = lds4(row + k);
        s += v.x + v.y + v.z + v.w;
      }
      sum += s + 128u * i;
    }
  }
  add_sink(sum, red, sink);
}

// acc: scratch[0 .. r-1] added in iteration order, a thread a cell (with
// kParts 2, iteration i's two k-halves added first), on fk::kBlocks blocks
// of fk::kThreads cells; each block streams its cells' 128-byte column of
// the rows through a ring of fk::kStages stages in shared memory by
// cp.async, 8 KiB a stage, so that three stages are in flight while it
// adds a fourth; sink: block 0 sums the blocks' partials in block order
namespace fk {
constexpr int kThreads = 32, kBlocks = 1024 / kThreads, kStages = 4;
constexpr int kStage = 64 * kThreads;  // floats of a stage
}  // namespace fk

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <bool kF64, int kParts>
__global__ void __launch_bounds__(fk::kThreads)
    finish_kernel(const float* __restrict__ scratch, int r,
                  const void* __restrict__ part, int grid,
                  float* __restrict__ out, void* __restrict__ sink) {
  constexpr int kRows = fk::kStage / (kParts * fk::kThreads);  // a stage
  __shared__ __align__(16) float ring[fk::kStages][fk::kStage];
  const int t = threadIdx.x, col = blockIdx.x * fk::kThreads;
  const int stages = (r + kRows - 1) / kRows;
  // stage s: rows s kRows .. of each part, 16 bytes a copy, into the ring
  auto load = [&](int s) {
    float* buf = ring[s % fk::kStages];
    for (int c = t; c < fk::kStage / 4; c += fk::kThreads) {
      const int row = c / (kParts * fk::kThreads / 4);  // of the stage
      const int w = c % (kParts * fk::kThreads / 4);    // part, quad
      const int i = s * kRows + row;
      if (i < r)
        cp_async16(buf + 4 * c,
                   scratch + ((size_t)i * kParts + w / (fk::kThreads / 4)) *
                                 1024 + col + 4 * (w % (fk::kThreads / 4)));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int s = 0; s < fk::kStages - 1; ++s) load(s);
  float acc = 0.f;
  for (int s = 0; s < stages; ++s) {
    load(s + fk::kStages - 1);  // into the slot that stage s - 1 freed
    asm volatile("cp.async.wait_group %0;" ::"n"(fk::kStages - 1) : "memory");
    __syncwarp();
    const float* buf = ring[s % fk::kStages] + t;
    const int n = min(kRows, r - s * kRows);
#pragma unroll 8
    for (int row = 0; row < n; ++row) {
      const float* v = buf + row * kParts * fk::kThreads;
      acc = __fadd_rn(acc, kParts == 2 ? __fadd_rn(v[0], v[fk::kThreads])
                                       : v[0]);
    }
    __syncwarp();  // every lane done with the slot before it is refilled
  }
  out[col + t] = acc;
  if (blockIdx.x == 0 && t == 0) {
    if (kF64) {
      double tot = 0.0;
      for (int b = 0; b < grid; ++b) tot += ((const double*)part)[b];
      *(double*)sink = tot;
    } else {
      uint32_t tot = 0;
      for (int b = 0; b < grid; ++b) tot += ((const uint32_t*)part)[b];
      *(int*)sink = (int)tot;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (the library links no -lcuda)
EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &got);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                          cudaEnableDefault, &got);
#endif
  return e == cudaSuccess && got == cudaDriverEntryPointSuccess
             ? (EncodeTiled)fn : nullptr;
}

template <class K>
int shared_bytes(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// scratch: grid x 4 KiB of counts, then grid x 8 bytes of partials
int run_ohbuild(const void* ids, int r, void* out, void* sink,
                float* scratch, int grid, cudaStream_t st) {
  uint32_t* counts = (uint32_t*)scratch;
  uint32_t* part = counts + (size_t)grid * 1024;
  ohbuild_kernel<<<grid, oh::kThreads, 0, st>>>((const int*)ids, r, counts,
                                                part);
  int e;
  if ((e = (int)cudaGetLastError())) return e;
  ohbuild_finish<<<1, 1024, 0, st>>>(counts, part, grid, (float*)out,
                                     (int*)sink);
  return (int)cudaGetLastError();
}

// scratch: r x kParts x 4 KiB of rows (the k-parts of each iteration),
// then grid x 8 bytes of partials; a grid of at least the 8 x kParts tiles
template <class E>
int run_mxu(const void* a, const void* b, int r, void* out, void* sink,
            float* scratch, int grid, cudaStream_t st) {
  if (grid < 8 * E::kParts) return (int)cudaErrorInvalidValue;
  void* part = scratch + (size_t)r * E::kParts * 1024;
  int e;
  if ((e = shared_bytes(mxu_kernel<E>, mf::kSmem))) return e;
  mxu_kernel<E><<<grid, mf::kThreads, mf::kSmem, st>>>(a, b, r, scratch,
                                                        (double*)part);
  if ((e = (int)cudaGetLastError())) return e;
  finish_kernel<true, E::kParts><<<fk::kBlocks, fk::kThreads, 0, st>>>(
      scratch, r, part, grid,
                                                     (float*)out, sink);
  return (int)cudaGetLastError();
}

int run_mxu_bf16(const void* a, const void* b, int r, void* out, void* sink,
                 float* scratch, int grid, cudaStream_t st) {
  return run_mxu<Bf16>(a, b, r, out, sink, scratch, grid, st);
}

int run_mxu_f32(const void* a, const void* b, int r, void* out, void* sink,
                float* scratch, int grid, cudaStream_t st) {
  return run_mxu<F32>(a, b, r, out, sink, scratch, grid, st);
}

// scratch: r x 4 KiB of rows, then grid x 8 bytes of partials
int run_gather(const void* ids, const void* data, int r, void* out,
               void* sink, float* scratch, int grid, cudaStream_t st) {
  void* part = scratch + (size_t)r * 1024;
  int e;
  if ((e = shared_bytes(gather_kernel, ga::kSmem))) return e;
  gather_kernel<<<grid, ga::kThreads, ga::kSmem, st>>>(
      (const int*)ids, (const uint16_t*)data, r, scratch, (uint32_t*)part);
  if ((e = (int)cudaGetLastError())) return e;
  finish_kernel<false, 1><<<fk::kBlocks, fk::kThreads, 0, st>>>(
      scratch, r, part, grid,
                                           (float*)out, sink);
  return (int)cudaGetLastError();
}

int run_cumsum_mxu(const void* a512, const void* tri, int r, void* out,
                   void* sink, float* scratch, int grid, cudaStream_t st) {
  void* part = scratch + (size_t)r * 1024;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {512, 512}, strides[1] = {512 * 4};
  const cuuint32_t box[2] = {32, 128}, one[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)tri, dims,
             strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int e;
  if ((e = shared_bytes(cumsum_kernel, cs::kSmem))) return e;
  cumsum_kernel<<<grid, cs::kThreads, cs::kSmem, st>>>(
      map, (const int*)a512, r, scratch, (double*)part);
  if ((e = (int)cudaGetLastError())) return e;
  finish_kernel<true, 1><<<fk::kBlocks, fk::kThreads, 0, st>>>(
      scratch, r, part, grid,
                                          (float*)out, sink);
  return (int)cudaGetLastError();
}

// scratch: r x 4 KiB of rows, then grid x 8 bytes of partials; a grid
// of at least the 8 bands
int run_cumsum_mxu_lane(const void* a512, const void* triu, int r, void* out,
                        void* sink, float* scratch, int grid,
                        cudaStream_t st) {
  if (grid < cl::kBands) return (int)cudaErrorInvalidValue;
  void* part = scratch + (size_t)r * 1024;
  int e;
  if ((e = shared_bytes(cumsum_lane_kernel, cl::kSmem))) return e;
  cumsum_lane_kernel<<<grid, cl::kThreads, cl::kSmem, st>>>(
      (const int*)a512, (const float*)triu, r, scratch, (double*)part);
  if ((e = (int)cudaGetLastError())) return e;
  finish_kernel<true, 1><<<fk::kBlocks, fk::kThreads, 0, st>>>(
      scratch, r, part, grid,
                                          (float*)out, sink);
  return (int)cudaGetLastError();
}

// transpose, shiftsel and red1: no scratch; a grid of at least the 8 bands;
// the sink zeroed, then each block's partial added into it
int zero_sink(void* sink, int grid, cudaStream_t st) {
  if (grid < rb::kBands) return (int)cudaErrorInvalidValue;
  return (int)cudaMemsetAsync(sink, 0, sizeof(int), st);
}

int run_transpose(const void* x128, int r, void* out, void* sink, int grid,
                  cudaStream_t st) {
  int e;
  if ((e = zero_sink(sink, grid, st))) return e;
  transpose_kernel<<<grid, rb::kThreads, 0, st>>>((const int*)x128, r,
                                                  (float*)out, (int*)sink);
  return (int)cudaGetLastError();
}

int run_shiftsel(const void* a512, const void* amt, int r, void* out,
                 void* sink, int grid, cudaStream_t st) {
  int e;
  if ((e = zero_sink(sink, grid, st))) return e;
  shiftsel_kernel<<<grid, rb::kThreads, 0, st>>>(
      (const int*)a512, (const int*)amt, r, (float*)out, (int*)sink);
  return (int)cudaGetLastError();
}

int run_red1(const void* a512, int r, void* out, void* sink, int grid,
             cudaStream_t st) {
  int e;
  if ((e = zero_sink(sink, grid, st))) return e;
  red1_kernel<<<grid, rb::kThreads, 0, st>>>((const int*)a512, r,
                                             (float*)out, (int*)sink);
  return (int)cudaGetLastError();
}

// The scratch bytes of body's launch, as each run_ lays it out: r x 4
// KiB of rows (r x 8 KiB for mxu_f32's two k-halves; grid x 4 KiB of
// counts for ohbuild), then grid x 8 bytes of partials; none for
// transpose, shiftsel and red1.
size_t scratch_need(int body, int r, int grid) {
  if (body == 6 || body == 7 || body == 8) return 0;
  size_t rows = body == 0 ? (size_t)grid : (size_t)r * (body == 2 ? 2 : 1);
  return rows * 4096 + (size_t)grid * 8;
}

}  // namespace

// body: 0-8 in the order of the bodies of this source in
// lz4_sgori_torch.probes.microbench2.BODIES; in0, in1: the body's inputs
// (in1 null for ohbuild, transpose and red1); out: (8, 128) float32;
// sink: one int32 (ohbuild, gather, transpose, shiftsel, red1) or
// float64; scratch: scratch_bytes bytes, at least scratch_need's, else
// the launch is refused; grid: the blocks, one an SM (mxu_f32: at least
// 16; mxu_bf16, cumsum_mxu_lane, transpose, shiftsel, red1: at least 8).
// ohbuild refuses r >= 2^24, cumsum_mxu_lane r >= 2^21 (see their notes
// above).
extern "C" int lz4t_probe_harness_wg(int body, const void* in0,
                                     const void* in1, int r, void* out,
                                     void* sink, void* scratch,
                                     size_t scratch_bytes, int grid,
                                     void* stream) {
  if (r < 0 || r >= 1 << 26 || grid < 1 || (body == 0 && r >= 1 << 24) ||
      (body == 5 && r >= 1 << 21) ||
      scratch_bytes < scratch_need(body, r, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  switch (body) {
    case 0: return run_ohbuild(in0, r, out, sink, sc, grid, st);
    case 1: return run_mxu_bf16(in0, in1, r, out, sink, sc, grid, st);
    case 2: return run_mxu_f32(in0, in1, r, out, sink, sc, grid, st);
    case 3: return run_gather(in0, in1, r, out, sink, sc, grid, st);
    case 4: return run_cumsum_mxu(in0, in1, r, out, sink, sc, grid, st);
    case 5: return run_cumsum_mxu_lane(in0, in1, r, out, sink, sc, grid, st);
    case 6: return run_transpose(in0, r, out, sink, grid, st);
    case 7: return run_shiftsel(in0, in1, r, out, sink, grid, st);
    case 8: return run_red1(in0, r, out, sink, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

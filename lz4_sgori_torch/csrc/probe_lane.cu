// T9 and T10, the per-lane word gather and scatter of the lockstep
// design: lane L of 128 walks its own row index over an (R, 128) int32
// array (R a power of two of at least 8), touching only column L. idx
// starts at L mod R and steps idx = (idx + L mod s + 1) mod R each round.
// All arithmetic is wrapping 32-bit (uint32_t).
//
// lz4t_probe_gather replaces tools/microbench3.py:make_gather.kern (the
// pallas_call at :88), s = 7: each of `reps` rounds adds tape[idx][L] to a
// sum. out (8, 128), zeroed by the caller: row 0 the sums, rows 1-7 zero
// (the tool leaves them as the TPU's memory held them).
//
// lz4t_probe_scatter replaces make_scatter.kern (the pallas_call at :123),
// s = 5: round i writes idx + i at out[idx][L], the later write winning.
// Every cell of out is written: 0 where no round wrote it (the tool leaves
// it undefined).
//
// The design: the TPU holds the whole array in VMEM and serves every round
// from there; here the array is held on chip in row tiles, one a CTA in
// shared memory, over every SM. A tile is T = R / 128 rows within [8, 64]
// (128 CTAs, nearly one an SM; at R 16384, 256 CTAs of 64 rows, two an
// SM): T9 loads its tile coalesced, once; T10 zeroes its tile and writes
// it out coalesced, once. A strip is 8 rows of one lane's column, owned by
// one thread (16 T threads a CTA: thread t serves lane t mod 128 in strip
// t / 128), which serves every round of its lane whose row falls in the
// strip, in round order, with one shared-memory load (T9) or store (T10)
// of that round's cell, volatile so that none is hoisted or merged. In
// each wrap of the walk the rounds that land in a strip form one run;
// `StripWalk` finds the first in closed form and steps from run to run
// without dividing, to the strip's first 8 rounds first[j]. The walk is
// back on the same row every R rounds (i * s mod R), and any R rounds in
// a row put exactly 8 in the strip (the strip holds 8 / g rows of the
// lane's coset mod g = gcd(s, R), each visited g times), so the thread's
// rounds are first[j] + b for b = 0, R, 2R, ...: 8 independent accesses
// an R rounds, at cells held in registers (T10 runs whole periods without
// a compare, then the last in part). Each (lane, round) is served
// by exactly one thread, so T10's cell takes its writes in round order
// from one thread: the later write wins without atomics or a grid-wide
// barrier. T9 adds a CTA's strip sums by lane in shared memory, then into
// out's row 0 with one global atomicAdd a lane a CTA (integer addition,
// so the bits do not depend on the order).
//
// What bounds them on the H100: the tile's bytes from L2 or HBM (every row
// of T9's tape is loaded, visited or not: 8 MiB at R 16384) and the
// launch; then the issue of two or three instructions a round (T9 a
// compare, the load and an add; T10 an add and the store), spread over
// every SM's schedulers; 32 registers a thread, at R 16384 two CTAs of
// 1024 threads an SM (32 KiB of tile each), at R 1024 one of 128 threads
// (4 KiB). Lane L's word of row r is at r * 128 + L, bank L mod 32, so a
// warp's 32 lanes never share a bank. At small R a CTA has few warps (four at R 1024): the 8
// accesses of a period are independent, so they overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kStrip = 8;      // rows of a strip: at least every step, and
                               // a multiple of every gcd(s, R) (at most 4)
constexpr int kTileMax = 64;   // rows of a tile: 32 KiB, 1024 threads
constexpr int kThreadsMax = kTileMax / kStrip * kLanes;

// One thread's walk through its strip, rows [a, a + kStrip) of lane's
// column: its next round i in the strip, at row a + off.
struct StripWalk {
  uint32_t i, off;
  uint32_t s, gq, gr;          // the lane's step; R - kStrip = gq * s + gr

  // The strip's first round at or after i0. Rows are taken modulo R in
  // 32 bits: i0 * s passes 2^32 for i0 near 2^31.
  __device__ StripWalk(uint32_t lane, uint32_t a, uint32_t rows,
                       uint32_t stride, uint32_t i0) {
    const uint32_t mask = rows - 1;
    s = lane % stride + 1;
    gq = (rows - kStrip) / s;
    gr = (rows - kStrip) % s;
    const uint32_t r = (lane + (i0 & mask) * s) & mask;   // round i0's row
    const uint32_t past = (r - a) & mask;                  // rows from a to r
    if (past < kStrip) {
      i = i0;
      off = past;
    } else {    // ahead = R - past rows to the strip: ceil(ahead / s) rounds
      const uint32_t ahead = rows - past;
      const uint32_t n = (ahead + s - 1) / s;
      i = i0 + n;
      off = n * s - ahead;
    }
  }

  // The next round in the strip. Past its end (a + kStrip + e), the walk
  // needs R - kStrip - e more rows, ceil((R - kStrip - e) / s) rounds, to
  // enter the strip again in the next wrap.
  __device__ __forceinline__ void next() {
    ++i;
    off += s;
    if (off >= kStrip) {
      const uint32_t e = off - kStrip;
      if (e < gr) {
        i += gq + 1;
        off = e + s - gr;
      } else {
        i += gq;
        off = e - gr;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreadsMax, 2)
gather_kernel(const uint32_t* __restrict__ tape, uint32_t* __restrict__ out,
              int rows, int reps) {
  extern __shared__ uint32_t tile[];     // (T, 128), then 128 lane sums
  const int nt = blockDim.x, t = threadIdx.x;
  const int cells = nt * kStrip;         // T * 128
  const uint32_t r0 = blockIdx.x * (cells / kLanes);
  uint32_t* sums = tile + cells;
  const uint32_t* src = tape + (size_t)r0 * kLanes;
  uint32_t v[kStrip];
#pragma unroll
  for (int k = 0; k < kStrip; ++k) v[k] = __ldg(src + t + k * nt);
#pragma unroll
  for (int k = 0; k < kStrip; ++k) tile[t + k * nt] = v[k];
  if (t < kLanes) sums[t] = 0;
  __syncthreads();

  const uint32_t lane = t % kLanes, strip = t / kLanes;
  StripWalk w(lane, r0 + strip * kStrip, rows, 7, 0);
  // the strip's first 8 rounds and their cells' places in the tile
  uint32_t first[kStrip], cell[kStrip];
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    first[j] = w.i;
    cell[j] = w.off * kLanes;
    w.next();
  }
  const volatile uint32_t* col = tile + strip * kStrip * kLanes + lane;
  const uint32_t n = reps;
  uint32_t acc = 0;
  // rounds first[j] + b, R rounds a period, in round order
  for (uint32_t b = 0; first[0] + b < n; b += rows) {
    const uint32_t left = n - b;
#pragma unroll
    for (int j = 0; j < kStrip; ++j)
      if (first[j] < left) acc += col[cell[j]];
  }
  atomicAdd(sums + lane, acc);
  __syncthreads();
  if (t < kLanes) atomicAdd(out + t, sums[t]);
}

__global__ void __launch_bounds__(kThreadsMax, 2)
scatter_kernel(uint32_t* __restrict__ out, int rows, int reps) {
  extern __shared__ uint32_t tile[];     // (T, 128)
  const int nt = blockDim.x, t = threadIdx.x;
  const int cells = nt * kStrip;
  const uint32_t r0 = blockIdx.x * (cells / kLanes);
  // not unrolled, nor the write-out: their addresses held from one to the
  // other would push the walk's registers past 32 (ptxas: stack)
#pragma unroll 1
  for (int k = 0; k < kStrip; ++k) tile[t + k * nt] = 0;
  __syncthreads();

  const uint32_t lane = t % kLanes, strip = t / kLanes;
  const uint32_t a = r0 + strip * kStrip;
  StripWalk w(lane, a, rows, 5, 0);
  // the strip's first 8 rounds, each as its cell's place in the tile and
  // the value it writes, row + round: R rounds on, the same cell takes
  // that value + R. Round j's number is val[j] - row, row a + cell / 128.
  uint32_t cell[kStrip], val[kStrip];
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    cell[j] = w.off * kLanes;
    val[j] = a + w.off + w.i;
    w.next();
  }
  volatile uint32_t* col = tile + strip * kStrip * kLanes + lane;
  const uint32_t n = reps;
  const uint32_t last = val[kStrip - 1] - a - cell[kStrip - 1] / kLanes;
  uint32_t b = 0;
  // rounds first[j] + b, R rounds a period, in round order: whole periods
  // (the strip's 8th round is the latest of each), then the last, in part
  for (; last + b < n; b += rows) {
#pragma unroll
    for (int j = 0; j < kStrip; ++j) col[cell[j]] = val[j] + b;
  }
#pragma unroll
  for (int j = 0; j < kStrip; ++j)
    if (val[j] - a - cell[j] / kLanes + b < n) col[cell[j]] = val[j] + b;
  __syncthreads();
  uint32_t* dst = out + (size_t)r0 * kLanes;
#pragma unroll 1
  for (int k = 0; k < kStrip; ++k) dst[t + k * nt] = tile[t + k * nt];
}

bool bad_rows(int rows) { return rows < 8 || (rows & (rows - 1)) != 0; }

// The rows of a tile at R (microbench3.tile_rows).
int tile_rows(int rows) {
  const int t = rows / kLanes;
  return t < kStrip ? kStrip : t > kTileMax ? kTileMax : t;
}

}  // namespace

// tape: (rows, 128) int32; out: (8, 128) int32, zeroed by the caller.
extern "C" int lz4t_probe_gather(const void* tape, void* out, int rows,
                                 int reps, void* stream) {
  if (bad_rows(rows) || reps < 0) return (int)cudaErrorInvalidValue;
  const int T = tile_rows(rows);
  gather_kernel<<<rows / T, T / kStrip * kLanes,
                  (T + 1) * kLanes * sizeof(uint32_t),
                  (cudaStream_t)stream>>>(
      (const uint32_t*)tape, (uint32_t*)out, rows, reps);
  return (int)cudaGetLastError();
}

// out: (rows, 128) int32, every cell written.
extern "C" int lz4t_probe_scatter(void* out, int rows, int reps,
                                  void* stream) {
  if (bad_rows(rows) || reps < 0) return (int)cudaErrorInvalidValue;
  const int T = tile_rows(rows);
  scatter_kernel<<<rows / T, T / kStrip * kLanes,
                   T * kLanes * sizeof(uint32_t), (cudaStream_t)stream>>>(
      (uint32_t*)out, rows, reps);
  return (int)cudaGetLastError();
}

// The safe LZ4 block decode of K6 (decode_v8.cu), K1 (decode_v7.cu) and
// K5 (decode_v6.cu): one CTA a block, the block's output held in shared
// memory and its compressed stream staged into shared memory by bulk
// asynchronous copies; warp 0 walks, up to 32 sequences a batch, the
// CTA's other warps join it for each batch's window pass and write the
// row's tail (K6) or the whole row (K1, K5) at the end. The kernel is a
// template over its geometry (Geom): the output region, the stream's
// stage size and count, the CTA's threads and the CTAs an SM.
//
// - K6 (RingGeom, every out_size): the last 128 KiB of output in a
//   history ring, flushed to the row as the walk goes; a CTA an SM.
// - K1 (WholeGeom, out_size at most 64 KiB): the block's whole output
//   in 64 KiB of shared memory, never flushed during the walk; after it
//   the CTA's 128 threads write the row, decoded bytes and the zeros past
//   them, in 16-byte stores. About 104 KiB a CTA, so two CTAs share an
//   SM: while one walks a sequence's dependent steps, the other issues.
//   K1's blocks of 64-128 KiB take K6's geometry as it stands.
// - K5 (SmallGeom<L>, out_size at most 2^L, L = 12, 13, 14): K1's whole
//   block in a region of 2^L bytes, the stream in 4 stages of 2^(L-1)
//   bytes, which hold a whole block's slot and its head; at 4 KiB about
//   18 KB a CTA, so 8 CTAs share an SM (the walk's 64 registers a thread;
//   shared memory would hold 12). K5's blocks above 16 KiB take K1's
//   geometries.
//
// Contract (golden.decompress,
// lz4_sgori_tpu/golden.py:194-261): err = 1 exactly when
// golden.decompress(comp[:clen], out_size) raises, and then out_len = 0
// and the row is all zero; otherwise out_len is the decoded length and
// the bytes past it are zero; clen outside [1, slot] is an error. The
// walk makes golden's checks in golden's order, and no decision uses a
// byte of comp at or past clen.
//
// The stream. Stream byte i lies at head + i of the 16-byte-aligned run
// that starts at the row's address rounded down (head = that address mod
// 16, as row starts blk * slot are not 16-byte aligned in general). The
// run is cut into stages (8 KiB for K1 and K6); 4 of them live in a ring,
// each filled by one cp.async.bulk that completes a transaction barrier
// (mbarrier). The run ends at head + clen rounded up to 16: every 16
// bytes copied hold a byte of the row, and the bytes past clen that a
// copy brings are never used. The walking warp's lane 0 is the producer:
// when the walk leaves a stage, it refills that slot with the stage 4
// ahead, so up to three stages are in flight while the walk reads the
// fourth (K5's ring holds the whole run, so all of it is in flight from
// the start and nothing is refilled).
//
// The output. Output byte o lies at ohead + o (ohead: the output row's
// address mod 16) of the output region, taken mod its size. A match
// reads its sources from the region in steps of S bytes (32 in a batch's
// waves, kStep = 128 in the general walk, 4 bytes a lane): with an offset
// d >= S byte i of a step copies from o - d; with d < S from d - (i mod
// d) bytes before the step's start (the overlap rule src(o) = m - d + (o
// - m) mod d, rebased on each step, so that a match
// longer than the ring never reads a slot it has overwritten). Either way
// a step reads only bytes written before it.
// K6: every source lies at most 65,535 bytes back, so 128 KiB holds it
// and the pending bytes. Once 16 KiB are pending, they are flushed to the
// row with 16-byte stores (bytes at the row's unaligned head); no copy
// writes more than 4 KiB (a batch 16 KiB) between two flush checks. On
// an error found late, the whole row, the flushed part with it, is
// zeroed.
// K1 and K5: ohead + o < R + 16 for a region of R bytes (R >= out_size);
// the few bytes past R wrap onto [0, ohead), which no byte below R uses,
// so nothing is overwritten and every source is on chip.
//
// The walk. A warp alone on its SM issues each dependent instruction
// some cycles after the last, so a sequence walked one at a time costs
// hundreds of cycles whatever memory it reads. decode_batch takes up to
// 32 sequences at once (see there); the general walk (decode_block_ring,
// a sequence at a time) takes one sequence whenever a batch
// cannot: a length with two LSIC bytes or more, a sequence past the
// window or the stage after the current one, a terminal or faulty one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int kWholeMax = 1 << 16;              // K1's whole-block sizes
constexpr int kSmallMax = 1 << 14;              // K5's small geometries
constexpr int kFlush = 16384;                   // pending bytes to flush
constexpr int kPiece = 4096;                    // copy between checks
constexpr int kWide = 4;                        // general walk: bytes a lane
constexpr int kStep = 32 * kWide;               //   and a step
constexpr int kTab = 33 * 32;                   // lane mod d, d = 1..32
constexpr int kWindow = 256;                    // stream bytes a batch
constexpr int kBatchOut = 16384;                // output bytes a batch
constexpr int kInvalid = 0xFFFF;

// A geometry: the output region (2^OutLog bytes: K6's 128 KiB ring, or a
// whole block), Stages stream stages of 2^StageLog bytes (at least
// kWindow), the CTA's Threads (the walk is warp 0; a multiple of 32 that
// divides kWindow), the CTAs it fits an SM (the launch bound), and
// whether the region holds the whole block. Its shared memory: the
// region, the stream ring, the barriers, the batch's fields (int2) a
// window position and its links (uint16: 1, 2, 4, 8 and 16 steps), the
// table.
template <int OutLog, int StageLog, int Stages, int Threads, int Ctas,
          bool Whole>
struct Geom {
  static constexpr bool kWhole = Whole;
  static constexpr int kOutRing = 1 << OutLog;
  static constexpr int kStageLog = StageLog;
  static constexpr int kStage = 1 << StageLog;
  static constexpr int kStages = Stages;
  static constexpr int kCompRing = kStage * Stages;
  static constexpr int kThreads = Threads;
  static constexpr int kCtas = Ctas;
  static constexpr int kFld = kOutRing + kCompRing + 8 * kStages;
  static constexpr int kNxt = kFld + 8 * kWindow;
  static constexpr int kTabAt = kNxt + 5 * 2 * kWindow;
  static constexpr int kSmem = kTabAt + kTab;
  static_assert(kStage >= kWindow && kWindow % Threads == 0 &&
                Threads % 32 == 0, "a batch's window in two stages");
};

// K6's (and K1's above 64 KiB): a 128 KiB history ring, 32 KiB of stream.
using RingGeom = Geom<17, 13, 4, 128, 1, false>;
// K1's: the whole block in 64 KiB, 32 KiB of stream, two CTAs an SM.
using WholeGeom = Geom<16, 13, 4, 128, 2, true>;
// K5's up to 16 KiB: the whole block in 2^L bytes, 2^(L+1) of stream
// (a block's slot and head), as many CTAs an SM as the SM's 228 KiB of
// shared memory (1 KiB of it reserved a CTA) and the walk's 64 registers
// a thread allow. At 48 registers (10 CTAs at 4 KiB, 32 bytes spilled)
// config 3 ran 1.04-1.05x faster but a lone block's walk took 16% more
// cycles (probes.decode_pace), and a 4 KiB write verifies a lone block.
constexpr int kSmallThreads = 128;
constexpr int small_ctas(int L, int threads) {
  const int smem = (1 << L) + (1 << (L + 1)) + 8 * 4 + 18 * kWindow + kTab;
  const int by_smem = (228 << 10) / (smem + 1024);
  const int by_regs = 65536 / (64 * threads);
  return by_smem < by_regs ? by_smem : by_regs;
}
template <int L>
using SmallGeom = Geom<L, L - 1, 4, kSmallThreads,
                       small_ctas(L, kSmallThreads), true>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The stream side of one block: the stage ring and the walk's place in it.
template <class G>
struct Stream {
  static constexpr int kStageLog = G::kStageLog, kStage = G::kStage;
  static constexpr int kStages = G::kStages, kCompRing = G::kCompRing;
  uint8_t* buf;              // kCompRing bytes
  uint64_t* full;            // kStages barriers
  const uint8_t* gbase;      // the row's address rounded down to 16
  int head, total, nst;      // head, bytes to stage, stages
  int cur;                   // the stage the walk reads, waited for

  __device__ void issue(int s) const {
    const int bytes = min(kStage, total - s * kStage);
    bulk_load(buf + (s % kStages) * kStage, gbase + (size_t)s * kStage,
              bytes, &full[s % kStages]);
  }

  // Leave stage cur for stage s > cur: refill each slot left with the
  // stage kStages ahead (after every lane's reads of it), wait for s.
  __device__ void advance(int s, int lane) {
    while (cur < s) {
      __syncwarp();
      if (lane == 0 && cur + kStages < nst) issue(cur + kStages);
      cur++;
      bar_wait(&full[cur % kStages], (cur / kStages) & 1);
    }
  }

  __device__ __forceinline__ int at(int a) const {
    return buf[a & (kCompRing - 1)];
  }

  // Stream byte i, every lane together.
  __device__ __forceinline__ int byte(int i, int lane) {
    const int a = head + i;
    if ((a >> kStageLog) != cur) advance(a >> kStageLog, lane);
    return at(a);
  }

  // Wait for every stage still in flight: none may land after the CTA.
  __device__ void drain() {
    for (int s = cur + 1; s < min(cur + kStages, nst); s++)
      bar_wait(&full[s % kStages], (s / kStages) & 1);
  }
};

// The output side: the output region and (K6) the flushed prefix of
// the row.
template <class G>
struct Out {
  static constexpr int kOutRing = G::kOutRing;
  uint8_t* ring;             // kOutRing bytes
  uint8_t* gbase;            // the row's address rounded down to 16
  int ohead;                 // the row's address mod 16
  int fx;                    // ring bytes [ohead, fx) are in the row

  __device__ __forceinline__ uint8_t& at(int o) const {
    return ring[(ohead + o) & (kOutRing - 1)];
  }

  // Store ring bytes [fx, xe) to the row: the unaligned head and tail a
  // byte a lane, 16-byte vectors between.
  __device__ void flush_to(int xe, int lane) {
    __syncwarp();
    const int v0 = min((fx + 15) & ~15, xe), v1 = max(xe & ~15, v0);
    for (int x = fx + lane; x < v0; x += 32)
      gbase[x] = ring[x & (kOutRing - 1)];
    for (int x = v0 + 16 * lane; x < v1; x += 512)
      *(uint4*)(gbase + x) = *(const uint4*)(ring + (x & (kOutRing - 1)));
    for (int x = v1 + lane; x < xe; x += 32)
      gbase[x] = ring[x & (kOutRing - 1)];
    fx = xe;
  }

  // K6 flushes once kFlush bytes are pending; K1 and K5 hold the whole
  // block.
  __device__ __forceinline__ void check(int op, int lane) {
    if constexpr (!G::kWhole) {
      const int x = ohead + op;
      if (x - fx >= kFlush) flush_to(x & ~15, lane);
    }
  }
};

// How far back lane reads in a match step of offset off (see the note at
// the top): off for off >= 32, else off's multiple off + lane - lane % off
// (tab[min(off, 32) * 32 + lane] = lane % off, row 32 the identity).
__device__ __forceinline__ int step_back(const uint8_t* tab, int off,
                                         int lane) {
  return off + lane - tab[min(off, 32) * 32 + lane];
}

template <int Threads>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(Threads) : "memory");
}

// The window pass of a batch, by all the CTA's threads (tid 0 to T - 1,
// T = G::kThreads; warp 0 the walk's): thread tid parses the window
// positions tid + T k as if a token began there (its fields and the
// position after it, or kInvalid), then the links are doubled four times
// (2, 4, 8, 16 steps; a link to the window's end or past it ends the
// chain), a barrier after each level. Every load of a step comes before
// its stores: a store may alias a later load as far as the compiler
// knows, so interleaved they would run one round trip at a time.
template <class G>
__device__ void window_pass(const uint8_t* buf, int2* fld, uint16_t* nxt,
                            int a0, int rel, int tid) {
  constexpr int kThreads = G::kThreads, K = kWindow / kThreads;
  const auto at = [buf](int a) {
    return (int)buf[a & (G::kCompRing - 1)];
  };
  int t[K], b1[K], ao[K], o0[K], o1[K], b2[K], link[K];
#pragma unroll
  for (int k = 0; k < K; k++) {
    t[k] = at(a0 + tid + kThreads * k);
    b1[k] = at(a0 + tid + kThreads * k + 1);
  }
#pragma unroll
  for (int k = 0; k < K; k++) {
    ao[k] = a0 + tid + kThreads * k +
            ((t[k] >> 4) == 15 ? 17 + b1[k] : 1 + (t[k] >> 4));
    o0[k] = at(ao[k]);
    o1[k] = at(ao[k] + 1);
    b2[k] = at(ao[k] + 2);
  }
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int x = tid + kThreads * k;
    const int ln = t[k] >> 4, mn = t[k] & 15;
    const int lit = ln == 15 ? 15 + b1[k] : ln;
    const int ml = mn == 15 ? 19 + b2[k] : mn + 4;
    const int n = ao[k] - (a0 + x) + 2 + (mn == 15 ? 1 : 0);
    const bool simple = ((ln < 15) | (b1[k] < 255)) &
                        ((mn < 15) | (b2[k] < 255)) & (x + n <= rel);
    link[k] = simple ? x + n : kInvalid;
    nxt[x] = (uint16_t)link[k];
    fld[x] = make_int2(o0[k] | (o1[k] << 8) | (lit << 16), ml);
  }
  named_sync<kThreads>(2);
#pragma unroll
  for (int l = 1; l < 5; l++) {
    const uint16_t* from = nxt + (l - 1) * kWindow;
    int nx[K];
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int v = from[min(link[k], kWindow - 1)];
      nx[k] = link[k] >= kWindow ? kInvalid : v;
    }
#pragma unroll
    for (int k = 0; k < K; k++) {
      link[k] = nx[k];
      nxt[l * kWindow + tid + kThreads * k] = (uint16_t)nx[k];
    }
    named_sync<kThreads>(2);
  }
}

// The other warps' side of the window passes: each batch's command (cmd:
// a0, rel, the stage, whether the next is read too) comes through barrier
// 1; a0 < 0 ends the walk.
template <class G>
__device__ void window_helper(const uint8_t* buf, uint64_t* full,
                              int2* fld, uint16_t* nxt,
                              const volatile int* cmd) {
  constexpr int kStages = G::kStages;
  for (;;) {
    named_sync<G::kThreads>(1);
    const int a0 = cmd[0], rel = cmd[1], cur = cmd[2], next = cmd[3];
    if (a0 < 0) return;
    bar_wait(&full[cur % kStages], (cur / kStages) & 1);
    if (next) bar_wait(&full[(cur + 1) % kStages], ((cur + 1) / kStages) & 1);
    window_pass<G>(buf, fld, nxt, a0, rel, threadIdx.x);
  }
}

// A batch of up to 32 sequences from ip, each with at most one LSIC byte
// (< 255) a length, all inside the window of kWindow stream bytes at ip
// (in the current stage and the next, which is waited for) and before
// ilen, passing every check of the walk, writing at most kBatchOut bytes.
// The CTA's four warps parse the window at every position as if a token
// began there and double the links (window_pass); lane s then finds the
// start of sequence s from ip in 5 lookups. A scan of their lengths places their
// output, and the first sequence that fails a check ends the batch
// before it (the general walk then takes it). The copies, each step's
// loads before its stores: every literal run and every match whose
// source lies wholly before the batch, a lane a sequence, 16 bytes
// through registers and the rest of a longer one by the warp; then the
// other matches in waves (see there). Returns the sequences taken, 0 for
// none, with ip and op moved past them.
template <class G>
__device__ int decode_batch(Stream<G>& in, Out<G>& out, const uint8_t* tab,
                            int2* fld, uint16_t* nxt, volatile int* cmd,
                            int& ip, int& op, int ilen, int out_size,
                            int lane) {
  constexpr int kStageLog = G::kStageLog, kStages = G::kStages;
  const int a0 = in.head + ip;
  if ((a0 >> kStageLog) != in.cur || ip >= ilen) return 0;
  if (((a0 + kWindow - 1) >> kStageLog) != in.cur && in.cur + 1 < in.nst)
    bar_wait(&in.full[(in.cur + 1) % kStages],
             ((in.cur + 1) / kStages) & 1);
  const int rel = min(kWindow, ilen - ip);
  if (lane == 0) {
    cmd[0] = a0;
    cmd[1] = rel;
    cmd[2] = in.cur;
    cmd[3] = ((a0 + kWindow - 1) >> kStageLog) != in.cur && in.cur + 1 < in.nst;
  }
  named_sync<G::kThreads>(1);
  window_pass<G>(in.buf, fld, nxt, a0, rel, lane);
  int mine = 0;
#pragma unroll
  for (int l = 0; l < 5; l++)
    if ((lane >> l) & 1)
      mine = mine >= kWindow ? kInvalid : nxt[l * kWindow + mine];
  const bool live = mine < kWindow && nxt[mine] != kInvalid;
  int count = __popc(__ballot_sync(0xffffffffu, live));
  if (count == 0) return 0;
  const int2 f = fld[live ? mine : 0];
  const int lit = live ? f.x >> 16 : 0, ml = live ? f.y : 0;
  const int off = f.x & 0xFFFF;
  int incl = lit + ml;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    incl += lane >= d ? v : 0;
  }
  const int ops = op + incl - lit - ml;
  const bool ok = (lit + ml <= out_size - ops) & (off != 0) &
                  (off <= ops + lit) & (incl <= kBatchOut);
  const unsigned fail = __ballot_sync(0xffffffffu, live & !ok);
  if (fail) count = __ffs(fail) - 1;
  if (count == 0) return 0;
  const bool use = lane < count;
  const int lsrc = a0 + mine + (lit >= 15 ? 2 : 1);
  const int m = ops + lit, src = m - off;
  const bool indep = use & (src + ml <= op);
  // Literals, and the matches whose sources lie before the batch: a lane
  // a sequence, the first 16 bytes of each through registers (their
  // sources are staged stream or output before the batch: no store of
  // the batch meets them), the rest of a longer one by the warp.
  {
    uint8_t v[16], w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) {
      v[i] = (uint8_t)in.at(lsrc + i);
      w[i] = out.at(src + i);
    }
#pragma unroll
    for (int i = 0; i < 16; i++) {
      if (use & (i < lit)) out.at(ops + i) = v[i];
      if (indep & (i < ml)) out.at(m + i) = w[i];
    }
  }
  for (unsigned q = __ballot_sync(0xffffffffu,
                                  (use & (lit > 16)) | (indep & (ml > 16)));
       q; q &= q - 1) {
    const int s = __ffs(q) - 1;
    const int sl = __shfl_sync(0xffffffffu, use ? lit : 0, s);
    const int sa = __shfl_sync(0xffffffffu, lsrc, s);
    const int so = __shfl_sync(0xffffffffu, ops, s);
    for (int b = 16 + lane; b < sl; b += 32) out.at(so + b) = in.at(sa + b);
    const int sm = __shfl_sync(0xffffffffu, indep ? ml : 0, s);
    const int ss = __shfl_sync(0xffffffffu, src, s);
    const int sd = __shfl_sync(0xffffffffu, m, s);
    for (int b = 16 + lane; b < sm; b += 32) out.at(sd + b) = out.at(ss + b);
  }
  // The others in waves. A match waits for the earlier ones whose output
  // its source overlaps (deps); each wave takes every match left whose
  // deps are done: one of at most 20 bytes that does not overlap its own
  // output a lane a match through registers, the rest the warp a match
  // (the step rule).
  const unsigned dmask = __ballot_sync(0xffffffffu, use & !indep);
  if (dmask) {
    __syncwarp();                          // fld read, the stores above seen
    fld[lane] = make_int2(m, m + ml);
    __syncwarp();
    unsigned deps = 0;
#pragma unroll
    for (int i = 0; i < 32; i++) {
      const int2 e = fld[i];
      deps |= ((i < lane) & (e.x < src + ml) & (src < e.y)) ? 1u << i : 0u;
    }
    deps &= dmask;
    for (unsigned rem = dmask; rem;) {
      const bool ready = ((rem >> lane) & 1) & ((deps & rem) == 0);
      const unsigned rdy = __ballot_sync(0xffffffffu, ready);
      const bool par = ready & (ml <= 20) & (off >= ml);
      {
        uint8_t v[20];
#pragma unroll
        for (int i = 0; i < 20; i++) v[i] = out.at(src + i);
#pragma unroll
        for (int i = 0; i < 20; i++)
          if (par & (i < ml)) out.at(m + i) = v[i];
      }
      for (unsigned q = rdy & ~__ballot_sync(0xffffffffu, par); q;
           q &= q - 1) {
        const int s = __ffs(q) - 1;
        const int ms = __shfl_sync(0xffffffffu, m, s);
        const int offs = __shfl_sync(0xffffffffu, off, s);
        const int mls = __shfl_sync(0xffffffffu, ml, s);
        const int back = step_back(tab, offs, lane);
        for (int b = 0; b < mls; b += 32) {
          __syncwarp();
          const int o = ms + b + lane;
          if (b + lane < mls) out.at(o) = out.at(o - back);
        }
      }
      rem &= ~rdy;
      __syncwarp();
    }
  }
  const int last = count - 1;
  const int xe = nxt[__shfl_sync(0xffffffffu, mine, last)];
  op = __shfl_sync(0xffffffffu, m + ml, last);
  ip += xe;
  __syncwarp();
  out.check(op, lane);
  return count;
}

// The walk of one block by one warp (a sequence at a time, through the
// stream ring and the output region). Returns the decoded length, or -1
// on error.
template <class G>
__device__ int decode_block_ring(Stream<G>& in, Out<G>& out,
                                 const uint8_t* tab,
                                 int2* fld, uint16_t* nxt,
                                 volatile int* cmd, int ilen, int slot,
                                 int out_size, int lane) {
  constexpr int kStageLog = G::kStageLog;
  bool bad = ilen <= 0 || ilen > slot;   // ilen == 0: golden "empty input"
  int ip = 0, op = 0;
  while (!bad) {
    if (ip < ilen && ((in.head + ip) >> kStageLog) != in.cur)
      in.advance((in.head + ip) >> kStageLog, lane);
    if (decode_batch(in, out, tab, fld, nxt, cmd, ip, op, ilen, out_size,
                     lane))
      continue;
    if (ip >= ilen) { bad = true; break; }           // missing token
    const int token = in.byte(ip++, lane);
    int lit = token >> 4;
    if (lit == 15) {
      for (;;) {
        if (ip >= ilen) { bad = true; break; }       // truncated LSIC
        const int b = in.byte(ip++, lane);
        lit += b;
        if (b != 255) break;
      }
      if (bad) break;
    }
    if (lit > ilen - ip) { bad = true; break; }      // literals past input
    if (lit > out_size - op) { bad = true; break; }  // past capacity
    while (lit > 0) {                                // a stage at a time
      const int a = in.head + ip;
      if ((a >> kStageLog) != in.cur) in.advance(a >> kStageLog, lane);
      const int piece =
          min(min(lit, ((in.cur + 1) << kStageLog) - a), kPiece);
      for (int b = 0; b < piece; b += kStep) {       // loads, then stores
        uint8_t v[kWide];
#pragma unroll
        for (int k = 0; k < kWide; k++) {
          const int i = b + lane + 32 * k;
          v[k] = i < piece ? (uint8_t)in.at(a + i) : 0;
        }
#pragma unroll
        for (int k = 0; k < kWide; k++) {
          const int i = b + lane + 32 * k;
          if (i < piece) out.at(op + i) = v[k];
        }
      }
      ip += piece;
      op += piece;
      lit -= piece;
      out.check(op, lane);
    }
    if (ip == ilen) break;                           // terminal sequence
    if (ip + 2 > ilen) { bad = true; break; }        // truncated offset
    const int off = in.byte(ip, lane) | (in.byte(ip + 1, lane) << 8);
    ip += 2;
    if (off == 0 || off > op) { bad = true; break; } // outside output
    int ml = (token & 15) + 4;
    if ((token & 15) == 15) {
      for (;;) {
        if (ip >= ilen) { bad = true; break; }       // truncated LSIC
        const int b = in.byte(ip++, lane);
        ml += b;
        if (b != 255) break;
      }
      if (bad) break;
    }
    if (ml > out_size - op) { bad = true; break; }   // past capacity
    // kStep bytes a step, byte i of a step (lane + 32 k) read back[k]
    // bytes back: off from kStep on, else off's multiple off + i - i mod
    // off, which lands in the off bytes before the step (the step rule)
    int back[kWide];
#pragma unroll
    for (int k = 0; k < kWide; k++) {
      const int i = lane + 32 * k;
      back[k] = off >= kStep ? off : off + i - i % off;
    }
    while (ml > 0) {
      const int piece = min(ml, kPiece);
      for (int b = 0; b < piece; b += kStep) {
        __syncwarp();
        uint8_t v[kWide];
#pragma unroll
        for (int k = 0; k < kWide; k++)
          v[k] = out.at(op + b + lane + 32 * k - back[k]);
#pragma unroll
        for (int k = 0; k < kWide; k++)
          if (b + lane + 32 * k < piece) out.at(op + b + lane + 32 * k) = v[k];
      }
      op += piece;
      ml -= piece;
      out.check(op, lane);
    }
  }
  if constexpr (!G::kWhole)
    if (!bad) out.flush_to(out.ohead + op, lane);
  in.drain();
  return bad ? -1 : op;
}

// The stream of a block whose row starts at `row`: its run's stages,
// none issued yet (see the note at the top).
template <class G>
__device__ Stream<G> stream_of(uint8_t* smem, const uint8_t* row, int ilen,
                               int slot) {
  Stream<G> in;
  in.buf = smem + G::kOutRing;
  in.full = (uint64_t*)(smem + G::kOutRing + G::kCompRing);
  in.gbase = (const uint8_t*)((uintptr_t)row & ~(uintptr_t)15);
  in.head = (int)((uintptr_t)row & 15);
  in.total = ilen > 0 && ilen <= slot ? (in.head + ilen + 15) & ~15 : 0;
  in.nst = (in.total + G::kStage - 1) >> G::kStageLog;
  in.cur = 0;
  return in;
}

// Lane 0: the barriers initialised (once invalidated, when `again`: a
// CTA's later block, every phase of its last one complete) and the
// first kStages stages issued.
template <class G>
__device__ void start_stream(const Stream<G>& in, bool again) {
  if (again) {
    // the walk's reads of the ring (generic proxy) before the bulk copies
    // that overwrite it (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int s = 0; s < G::kStages; s++)
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];"
                   :: "r"(smem_u32(&in.full[s])) : "memory");
  }
  for (int s = 0; s < G::kStages; s++) bar_init(&in.full[s]);
  bar_init_fence();
  for (int s = 0; s < min(G::kStages, in.nst); s++) in.issue(s);
}

template <class G>
__device__ Out<G> out_of(uint8_t* smem, uint8_t* dst) {
  Out<G> o;
  o.ring = smem;
  o.gbase = (uint8_t*)((uintptr_t)dst & ~(uintptr_t)15);
  o.ohead = (int)((uintptr_t)dst & 15);
  o.fx = o.ohead;
  return o;
}

// The end of a block, by the CTA's threads, once its walk has returned n
// (-1 on an error). A whole geometry writes the whole row from the block
// held on chip; K6's ring (its flushes have filled the row) zeroes the
// row past the decoded bytes.
template <class G>
__device__ void write_row(const uint8_t* smem, uint8_t* dst, int n,
                          int out_size) {
  constexpr int kThreads = G::kThreads;
  const int head = (int)((uintptr_t)dst & 15);
  if constexpr (G::kWhole) {
    // the row: row byte o is region byte head + o (mod its size) below the
    // decoded length n, zero from n on (all of it on an error, n = -1);
    // the unaligned head and tail a byte a thread, 16-byte stores between
    uint8_t* g = dst - head;
    const int xe = head + out_size;
    const int v0 = min((head + 15) & ~15, xe), v1 = max(xe & ~15, v0);
    const auto at = [&](int x) -> uint8_t {
      return x - head < n ? smem[x & (G::kOutRing - 1)] : 0;
    };
    for (int x = head + threadIdx.x; x < v0; x += kThreads) g[x] = at(x);
    for (int x = v0 + 16 * threadIdx.x; x < v1; x += 16 * kThreads) {
      union { uint4 v; uint8_t b[16]; } u;
      if (x - head + 16 <= n) {
        u.v = *(const uint4*)(smem + (x & (G::kOutRing - 1)));
      } else {
#pragma unroll
        for (int i = 0; i < 16; i++) u.b[i] = at(x + i);
      }
      *(uint4*)(g + x) = u.v;
    }
    for (int x = v1 + threadIdx.x; x < xe; x += kThreads) g[x] = at(x);
  } else {
    // zero the row past the decoded bytes (all of it on an error)
    const int z0 = n < 0 ? 0 : n;
    const int v0 = min(z0 + ((16 - ((head + z0) & 15)) & 15), out_size);
    const int v1 = max(v0, ((head + out_size) & ~15) - head);
    for (int o = z0 + threadIdx.x; o < v0; o += kThreads) dst[o] = 0;
    for (int o = v0 + 16 * threadIdx.x; o < v1; o += 16 * kThreads)
      *(uint4*)(dst + o) = make_uint4(0, 0, 0, 0);
    for (int o = v1 + threadIdx.x; o < out_size; o += kThreads) dst[o] = 0;
  }
}

// One CTA a block.
template <class G>
__global__ void __launch_bounds__(G::kThreads, G::kCtas)
decode_ring_kernel(const uint8_t* __restrict__ comp,
                   const int* __restrict__ clen, uint8_t* out,
                   int* __restrict__ out_len, uint8_t* __restrict__ err,
                   int slot, int out_size) {
  constexpr int kThreads = G::kThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_n;
  __shared__ int s_cmd[4];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  uint8_t* dst = out + (size_t)blk * out_size;
  uint8_t* tab = smem + G::kTabAt;
  for (int i = threadIdx.x; i < kTab; i += kThreads)
    tab[i] = (uint8_t)((i & 31) % max(i >> 5, 1));
  __syncthreads();
  if (threadIdx.x < 32) {
    const int ilen = clen[blk];
    Stream<G> in = stream_of<G>(smem, comp + (size_t)blk * slot, ilen, slot);
    if (lane == 0) start_stream(in, false);
    __syncwarp();
    if (in.nst > 0) bar_wait(&in.full[0], 0);
    Out<G> o = out_of<G>(smem, dst);
    const int n = decode_block_ring(in, o, tab, (int2*)(smem + G::kFld),
                                    (uint16_t*)(smem + G::kNxt), s_cmd, ilen,
                                    slot, out_size, lane);
    if (lane == 0) {
      s_n = n;
      out_len[blk] = n < 0 ? 0 : n;
      err[blk] = n < 0 ? 1 : 0;
      s_cmd[0] = -1;                     // the other warps' last command
    }
    named_sync<kThreads>(1);
  } else {
    window_helper<G>(smem + G::kOutRing,
                  (uint64_t*)(smem + G::kOutRing + G::kCompRing),
                  (int2*)(smem + G::kFld), (uint16_t*)(smem + G::kNxt),
                  s_cmd);
  }
  __syncthreads();
  write_row<G>(smem, dst, s_n, out_size);
}

}  // namespace ring

// Size `kernel`'s dynamic shared memory to G's, once (a whole geometry
// also asks for the largest carveout). Internal linkage, so that `sized`
// is this library's own beside another build of this header in the same
// process.
template <class G, class Kernel>
static cudaError_t size_ring_kernel(Kernel kernel) {
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e == cudaSuccess && G::kWhole)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  return cudaSuccess;
}

// One CTA a block in geometry G (a whole geometry needs out_size at most
// its region). A shared-memory size the card refuses is returned as the
// launch's error.
template <class G>
static int launch_decode_ring(const void* comp, const void* clen, void* out,
                              void* out_len, void* err, int nb, int slot,
                              int out_size, void* stream) {
  if (G::kWhole && out_size > G::kOutRing) return (int)cudaErrorInvalidValue;
  const cudaError_t e = size_ring_kernel<G>(ring::decode_ring_kernel<G>);
  if (e != cudaSuccess) return (int)e;
  if (nb > 0)
    ring::decode_ring_kernel<G><<<nb, G::kThreads, G::kSmem,
                                  (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int*)clen, (uint8_t*)out,
        (int*)out_len, (uint8_t*)err, slot, out_size);
  return (int)cudaGetLastError();
}

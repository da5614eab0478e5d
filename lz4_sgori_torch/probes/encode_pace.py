"""What sets the pace of the split-table candidates, K2
(``csrc/cand.cu``) and K9 (``csrc/cand_piecewise.cu``), of the warp
segment parses, K3 (``csrc/parse_seg.cu``), K8-seg
(``csrc/parse_seg_deep.cu``, depth 3) and K10b (``csrc/parse_seg_mlen.cu``,
the mlen mode), and of the warp block parses, K7 (``csrc/parse_enc3.cu``)
and K10c (``csrc/parse_enc3_mlen.cu``), with the mlen mode's codes
(mcode, ``csrc/mcode.cu``), of the deep modes' chain gaps
(``csrc/gaps.cu``) and of the segment assembly, K4
(``csrc/asm_seg.cu``), on the card, on the main paths' cells
(``chip_smoke.py``'s corpora: config 1, 32 MiB of 64 KiB blocks, seed
42; config 3, the same bytes in 4 KiB blocks; config 5, 128 MiB of 64
KiB blocks, seed 1234; config 6, 128 MiB of 1 MiB blocks, seed 55, K9's
tape, seg 8192; one block of each size, one of 4 MiB at seg 32768,
config 1's bytes in 1 MiB blocks, and K7's 64 blocks of 64 KiB, config
1's first; K10b's on config 1 and one 64 KiB block, K10c's on config 3
and one 4 KiB block, ``MLEN_CELLS``, mcode's also on config 1's 32-block
subset; the gaps' on config 5 and its 32-block subset at 2 links, its
first 8 MiB at 4 and one 1 MiB block on K9's tape, ``gaps_runs``; K4's
on configs 1, 5 (depth 3) and 6 and one block of 1 and of 4 MiB,
``K4_CELLS``):

- each kernel's time a call (CUDA events), K9's run length, the
  sequences K3, K8-seg and K7 find a segment or block (their ``nseq``)
  and each cell's encode kernel path (depth 3 too where K8-seg runs);
  K10b and K10c in turns with K3 and K7 on the same blocks, mcode and
  the gaps with their bounds, and the mlen encode kernel paths in turns
  with the default ones (configs 1 and 3, one block of each size); K4
  with its bound (the pieces read, the whole rows written);
- ``--profile``: clock64 breakdowns from instrumented copies of this
  tree's sources (``PROFILE``: K2's cycles a block a warp in the scan and
  in the table steps, its steps a warp, the wait for the bytes and the
  clear; K9's the same a half-piece, with the wait for the other warps
  and the boundary's barriers and sweep; K3's and K8-seg's cycles a
  sequence in the search, the previews (K8-seg), the catch-up, the
  extension and the emission, their rounds a sequence, and the busiest
  warp; K10b's the same; K7's and K10c's the same a block, with the wait
  for the block's bytes), and
  of the first K2 design's one-warp step (``FIRST_STEP``: cycles a
  32-position step in the loads and hash, the match, the table read, the
  table write and the store);
- ``--variants NAME ...``: builds of the sources with other settings
  (``VARIANTS``: other warps or tiles a round in ``cand_part.cuh``, other
  segments a CTA or bytes held before them in ``parse_seg_warp.cuh``, for
  K3's source or K8-seg's, K8-seg's probe reading its three candidates
  together, K9 a window a CTA, K7 with other blocks a CTA, K4 over 4 or
  16 KiB chunks of a row in ``asm_seg.cu``; K10a's rows, splits, loads
  in flight and threads, the gaps' threads), each
  timed in turns with this tree's build (this, variant, variant, this)
  and its outputs held equal to it;
- ``--device-time``: K4's, mcode's and the gaps' times, the mlen
  paths' and every comparison in turns from calls captured in a CUDA
  graph (``graph_ms``: the card's time, without
  the host's dispatch, which sets a short call's time otherwise; a
  wrapper that waits on the card cannot be captured and raises);
- ``--parent DIR``: the same for DIR's sources of ``MODS`` (a ``git
  archive`` of an earlier commit; each with DIR's own headers), or of
  those ``--sources`` names;
- ``--store ROUNDS`` (with ``--parent``): the median latency of
  ``STORE_REQUESTS`` sequential 4 KiB ``ProxyStore`` writes of config 1's
  bytes with this tree's K2 and with DIR's, and with this tree's K7 and
  DIR's, and of ``BIG_STORES``' fio shapes (32 writes of 1 MiB, 8 of 4
  MiB, config 6's bytes) with this tree's K9 and DIR's and this tree's
  K4 and DIR's, each in turns (this, parent, parent, this) ROUNDS times.

    python -m lz4_sgori_torch.probes.encode_pace [--profile]
        [--variants NAME ...] [--parent DIR [--sources SRC ...]
        [--store ROUNDS]] [--device-time]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess

import torch

from .. import format as F
from ..blocks import resolve_device, split_blocks
from ..ops.enc3 import compress_blocks_enc3
from ..ops.encode import compress_blocks_device
from ..ops.seg import compress_blocks_seg
from ..ops import seg as S
from ..ops.kernels import _build
from ..ops.kernels import asm_seg as K4
from ..ops.kernels import cand as K2
from ..ops.kernels import cand_piecewise as K9
from ..ops.kernels import gaps as G
from ..ops.kernels import mcode as M
from ..ops.kernels import parse_enc3 as K7
from ..ops.kernels import parse_enc3_mlen as K10C
from ..ops.kernels import parse_seg as K3
from ..ops.kernels import parse_seg_deep as K8S
from ..ops.kernels import parse_seg_mlen as K10B
from . import device_name, parser, seconds

CALLS = 5             # calls in a timing
STORE_REQUESTS = 1024  # 4 KiB writes a store timing
BIG_STORES = ((1 << 20, 32), (4 << 20, 8))   # fio test_1m, test_4m
MODS = {"cand": K2, "parse_seg": K3, "cand_piecewise": K9,
        "parse_seg_deep": K8S, "parse_enc3": K7, "parse_seg_mlen": K10B,
        "parse_enc3_mlen": K10C, "mcode": M, "asm_seg": K4, "gaps": G}
# the mlen mode's cells: K10b's (64 KiB, seg 4096) and K10c's (4 KiB);
# mcode runs on both
MLEN_CELLS = {"parse_seg_mlen": ("config 1", "one block of 65536"),
              "parse_enc3_mlen": ("config 3", "one block of 4096")}
MLEN_CELLS["mcode"] = MLEN_CELLS["parse_seg_mlen"] + \
    MLEN_CELLS["parse_enc3_mlen"] + ("32 blocks of config 1",)
_TAPES: dict = {}     # cell name -> its mlen tapes (cand_v, mcode)
# K4's cells and the match depth of the parse before it
K4_CELLS = {"config 1": 1, "config 5": 3, "config 6": 1,
            "one block of 1048576": 1, "one block of 4194304": 1}
_K4IN: dict = {}      # cell name -> K4's arguments
# the gaps kernel's cells: (links, half); and the first 8 MiB of config 5
# at 4 links (the depth-5 slice)
GAPS_CELLS = {"config 5": (2, 0), "32 blocks of config 5": (2, 0),
              "one block of 1048576": (2, K9.PIECE // 2)}
GAPS5_BLOCKS = (8 << 20) // 65536
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM device memory rate (data sheet)

# variants: the source they build, the header they change and its
# (text, replacement) pairs, each text found in the header
_CAND = ("cand", "cand_part.cuh")
_SEG = ("parse_seg", "parse_seg_warp.cuh")
_DEEP = ("parse_seg_deep", "parse_seg_warp.cuh")
_ENC3 = ("parse_enc3", "parse_enc3_warp.cuh")
_W = "constexpr int kWarps = 8;"
_U = "constexpr int kUnroll = 16;"
_G = "constexpr int kGroup = 2;"
_B = "constexpr int kBack = 0;"
_K7 = "constexpr int kMaxWarps1 = 1;"
_MR = "constexpr int kRowBytes = 16384;"
_MW = "constexpr int kWaveCtas = 4;"
VARIANTS = {
    "cand_w1": (*_CAND, [(_W, _W.replace("8", "1"))]),
    "cand_w4": (*_CAND, [(_W, _W.replace("8", "4"))]),
    "cand_w16_u8": (*_CAND, [(_W, _W.replace("8", "16")),  # fits 227 KiB
                             (_U, _U.replace("16", "8"))]),
    "cand_u4": (*_CAND, [(_U, _U.replace("16", "4"))]),
    "cand_u8": (*_CAND, [(_U, _U.replace("16", "8"))]),
    "seg_g1": (*_SEG, [(_G, _G.replace("2", "1"))]),
    "seg_g4": (*_SEG, [(_G, _G.replace("2", "4"))]),
    "seg_g16_b65536": (*_SEG, [(_G, _G.replace("2", "16")),
                               (_B, _B.replace("0", "65536"))]),
    "seg_b4096": (*_SEG, [(_B, _B.replace("0", "4096"))]),
    "seg_b8192": (*_SEG, [(_B, _B.replace("0", "8192"))]),
    "deep_g1": (*_DEEP, [(_G, _G.replace("2", "1"))]),
    "deep_b4096": (*_DEEP, [(_B, _B.replace("0", "4096"))]),
    "deep_b8192": (*_DEEP, [(_B, _B.replace("0", "8192"))]),
    # a probe's three candidates' words read together, not until one
    # passes
    "deep_probe_batched": (*_DEEP, [(
        """      bool hit = false;
#pragma unroll
      for (int i = 0; i < 3; i++)
        hit = hit || (((live >> i) & 1) && ds[i] <= p && ds[i] <= wlim &&
                      rd32m(p - ds[i]) == v);
      return hit;""",
        """      uint32_t w[3];
#pragma unroll
      for (int i = 0; i < 3; i++) {
        const bool ok = ((live >> i) & 1) && ds[i] <= p && ds[i] <= wlim;
        w[i] = ok ? rd32m(p - ds[i]) : ~v;
      }
      return (w[0] == v) | (w[1] == v) | (w[2] == v);""")]),
    # K7 with more blocks a CTA at 4 KiB (at 16 one CTA an SM)
    "enc3_w2": (*_ENC3, [(_K7, _K7.replace("= 1", "= 2"))]),
    "enc3_w4": (*_ENC3, [(_K7, _K7.replace("= 1", "= 4"))]),
    "enc3_w8": (*_ENC3, [(_K7, _K7.replace("= 1", "= 8"))]),
    "enc3_w16": (*_ENC3, [(_K7, _K7.replace("= 1", "= 16"))]),
    # K4's words over 4 or 16 KiB chunks of a row a CTA (8 KiB)
    "asm_chunk4k": ("asm_seg", "asm_seg.cu", [(
        "constexpr int kChunk = 8192;", "constexpr int kChunk = 4096;")]),
    "asm_chunk16k": ("asm_seg", "asm_seg.cu", [(
        "constexpr int kChunk = 8192;", "constexpr int kChunk = 16384;")]),
    # K10a with 32 KiB of whole rows a CTA (16); never splitting rows, or
    # splitting them below 2 or 8 CTAs an SM (4); 8 loads in flight a
    # thread (4); 512 threads a CTA (256)
    "mcode_rows32k": ("mcode", "mcode.cu", [(_MR, _MR.replace("16384",
                                                              "32768"))]),
    "mcode_nosplit": ("mcode", "mcode.cu", [(_MW, _MW.replace("4", "0"))]),
    "mcode_wave2": ("mcode", "mcode.cu", [(_MW, _MW.replace("4", "2"))]),
    "mcode_wave8": ("mcode", "mcode.cu", [(_MW, _MW.replace("4", "8"))]),
    "mcode_u8": ("mcode", "mcode.cu", [(
        "constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    "mcode_t512": ("mcode", "mcode.cu", [(
        "constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
    # the gaps with 512 threads a CTA (256)
    "gaps_t512": ("gaps", "gaps.cu", [(
        "constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
    # K9 a window a CTA (runs of one half-piece, its warm half before it)
    "k9_r1": ("cand_piecewise", "cand_piecewise.cu", [(
        "  const Runs R(nb, bs, half, sms);\n",
        "  Runs R(nb, bs, half, sms);\n  R.len = 1;\n"
        "  R.per_block = R.nhalf;\n  R.ctas = nb * R.nhalf;\n")]),
}

CLK = """
__device__ __forceinline__ long long clk(long long dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "l"(dep) : "memory");
  return t;
}
"""

# instrumented copies: file -> (anchor, replacement) pairs, each anchor
# found in the source; acc[] a warp, written to prof at the end
PROFILE = {
    "cand_part.cuh": [
        ("namespace cand_part {", "namespace cand_part {\n" + CLK),
        ("int warp, int lane) {", "int warp, int lane, long long* acc) {"),
        ("      match_step<kEmit>(queue[(head + lane) & (kQueue - 1)], true, "
         "table,\n                        out, origin, lane);",
         "      const long long t0 = clk(tail);\n"
         "      match_step<kEmit>(queue[(head + lane) & (kQueue - 1)], true, "
         "table,\n                        out, origin, lane);\n"
         "      acc[1] += clk(head) - t0;\n      acc[2]++;"),
        ("int* __restrict__ cand, int nb, int bs) {",
         "int* __restrict__ cand, int nb, int bs, long long* prof) {\n"
         "  long long acc[6] = {0, 0, 0, 0, 0, 0};"),
        ("    warp_parse::bar_wait(&bar[b], parity);\n\n"
         "    scan_range<true>(s, 0, npos, 0, queue, table, out, warp, lane);",
         "    long long tw = clk(npos);\n"
         "    warp_parse::bar_wait(&bar[b], parity);\n"
         "    long long ts = clk(tw);\n    acc[3] += ts - tw;\n"
         "    scan_range<true>(s, 0, npos, 0, queue, table, out, warp, lane,\n"
         "                     acc);\n"
         "    acc[0] += clk(acc[1]) - ts;\n    acc[4]++;"),
        ("    if (next >= nb) break;",
         "    if (next >= nb) break;\n    long long tc = clk(next);"),
        ("    if (tid == 0 && L.nbuf == 1)\n"
         "      issue(raw, raw_len, next, bs, buf0, &bar[0]);\n  }",
         "    acc[5] += clk(tc) - tc;\n"
         "    if (tid == 0 && L.nbuf == 1)\n"
         "      issue(raw, raw_len, next, bs, buf0, &bar[0]);\n  }\n"
         "  if (lane == 0)\n    for (int i = 0; i < 6; i++)\n"
         "      prof[((size_t)blockIdx.x * kWarps + warp) * 6 + i] = "
         "acc[i];"),
    ],
    "cand.cu": [
        ('#include "cand_part.cuh"', '#include "cand_part_prof.cuh"'),
        ("lz4t_cand(", "lz4t_cand_prof("),
        ("int nb, int bs, void* stream) {",
         "int nb, int bs, void* prof, void* stream) {"),
        ("(int*)cand, nb, bs);", "(int*)cand, nb, bs, (long long*)prof);"),
    ],
    "cand_piecewise.cu": [
        ('#include "cand_part.cuh"', '#include "cand_part_prof.cuh"'),
        ("int len, int per_block) {",
         "int len, int per_block, long long* prof) {\n"
         "  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};"),
        ("    warp_parse::bar_wait(&bar[b], (it >> 1) & 1);",
         "    long long tw = clk(it);\n"
         "    warp_parse::bar_wait(&bar[b], (it >> 1) & 1);\n"
         "    long long ts = clk(tw);\n    acc[3] += ts - tw;"),
        ("origin, queue, table,\n                        out, warp, lane);",
         "origin, queue, table,\n                        out, warp, lane, "
         "acc);"),
        ("origin, queue, table,\n                       out, warp, lane);",
         "origin, queue, table,\n                       out, warp, lane, "
         "acc);"),
        ("    if (h + 1 == he) break;",
         "    const long long te = clk(acc[1]);\n    acc[0] += te - ts;\n"
         "    acc[4]++;\n    if (h + 1 == he) break;"),
        ("    __syncthreads();            // the table and this buffer are "
         "done with",
         "    __syncthreads();            // the table and this buffer are "
         "done with\n    acc[6] += clk(hb) - te;"),
        ("    __syncthreads();\n  }\n}\n\n}  // namespace cand_part",
         "    __syncthreads();\n    acc[5] += clk(hb) - te;\n  }\n"
         "  if (lane == 0)\n    for (int i = 0; i < 8; i++)\n"
         "      prof[((size_t)blockIdx.x * kWarps + warp) * 8 + i] = acc[i];"
         "\n}\n\n}  // namespace cand_part"),
        ("lz4t_cand_piecewise(", "lz4t_cand_piecewise_prof("),
        ("                                   void* stream) {\n"
         "  using namespace cand_part;",
         "                                   void* prof, void* stream) {\n"
         "  using namespace cand_part;"),
        ("        R.len, R.per_block);",
         "        R.len, R.per_block, (long long*)prof);"),
    ],
    "parse_seg_warp.cuh": [
        ("namespace seg_warp {", "namespace seg_warp {\n" + CLK),
        ("int* m1h_out) const {", "int* m1h_out, long long* acc) const {"),
        ("      // ---- the search, 32 probes a round ----\n"
         "      const int start = pos;",
         "      // ---- the search, 32 probes a round ----\n"
         "      long long t0 = clk(pos);\n      const int start = pos;"),
        ("        const bool hit = valid && probe_hits((int)pk, dd, gg);",
         "        acc[6]++;\n"
         "        const bool hit = valid && probe_hits((int)pk, dd, gg);"),
        ("      if (hp < 0) break;\n",
         "      long long t1 = clk(hp);\n      acc[0] += t1 - t0;\n"
         "      if (hp < 0) break;\n"),
        ("      // ---- catch-up, 32 bytes a step, capped at the anchor ----",
         "      long long tq = clk(pos1 + mpos + pmc);\n"
         "      acc[7] += tq - t1;\n"
         "      // ---- catch-up, 32 bytes a step, capped at the anchor ----"),
        ("      // ---- forward extension, 128 bytes a step, capped at "
         "mlim ----",
         "      long long t2 = clk(pos1 + mpos);\n      acc[1] += t2 - tq;\n"
         "      // ---- forward extension, 128 bytes a step, capped at "
         "mlim ----"),
        ("      mc = min(mc, lim);\n",
         "      mc = min(mc, lim);\n      long long t3 = clk(mc);\n"
         "      acc[2] += t3 - t2;\n"),
        ("      has_match = true;\n      nseq++;",
         "      acc[3] += clk(o) - t3;\n      acc[4]++;\n"
         "      has_match = true;\n      nseq++;"),
        ("int seg, int scap, int wlim, int accel) {",
         "int seg, int scap, int wlim, int accel, long long* prof) {\n"
         "  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};"),
        ("  if (R.bytes) warp_parse::bar_wait(bar, 0);",
         "  long long tw = clk(R.bytes);\n"
         "  if (R.bytes) warp_parse::bar_wait(bar, 0);\n"
         "  acc[5] = clk(tw) - tw;"),
        ("&ns, &p1, &m1h);",
         "&ns, &p1, &m1h, acc);\n  if (lane == 0)\n"
         "    for (int i = 0; i < 8; i++)\n"
         "      prof[(size_t)(R.b * nseg + k) * 8 + i] = acc[i];"),
        ("        wlim, accel);", "        wlim, accel, (long long*)prof);"),
        ("                                 void* stream) {\n"
         "  using namespace seg_warp;",
         "                                 void* prof, void* stream) {\n"
         "  using namespace seg_warp;"),
    ],
    "parse_seg.cu": [
        ('#include "parse_seg_warp.cuh"',
         '#include "parse_seg_warp_prof.cuh"'),
        ("lz4t_parse_seg(", "lz4t_parse_seg_prof("),
        ("int wlim, int accel, void* stream) {",
         "int wlim, int accel, void* prof, void* stream) {"),
        ("wlim, accel, stream);", "wlim, accel, prof, stream);"),
    ],
    "parse_seg_deep.cu": [
        ('#include "parse_seg_warp.cuh"',
         '#include "parse_seg_warp_prof.cuh"'),
        ("lz4t_parse_seg_deep(", "lz4t_parse_seg_deep_prof("),
        ("void* stream) {", "void* prof, void* stream) {"),
        ("wlim, accel, stream);", "wlim, accel, prof, stream);"),
    ],
    # K7's walk (N = 1): acc[] as K3's, acc[5] the wait for the block
    "parse_enc3_warp.cuh": [
        ("namespace warp_parse {", "namespace warp_parse {\n" + CLK),
        ("  __device__ bool run(int& o_out, int& tpos, int& nseq_out) {",
         "  __device__ bool run(int& o_out, int& tpos, int& nseq_out,\n"
         "                      long long* acc) {"),
        ("      // ---- the search, 32 probes a round ----\n"
         "      const int start = pos;",
         "      // ---- the search, 32 probes a round ----\n"
         "      long long t0 = clk(pos);\n      const int start = pos;"),
        ("        const bool hit = probe_hits(act ? (int)pk : p0) & act;",
         "        acc[6]++;\n"
         "        const bool hit = probe_hits(act ? (int)pk : p0) & act;"),
        ("      if (hp < 0) break;\n",
         "      long long t1 = clk(hp);\n      acc[0] += t1 - t0;\n"
         "      if (hp < 0) break;\n"),
        ("      // ---- catch-up, 32 bytes a step, capped at the anchor ----",
         "      long long tq = clk(pos + mpos + pmc);\n"
         "      acc[7] += tq - t1;\n"
         "      // ---- catch-up, 32 bytes a step, capped at the anchor ----"),
        ("      // ---- the sequence: token, literal LSIC, literals, offset "
         "----",
         "      long long t2 = clk(pos + mpos);\n      acc[1] += t2 - tq;\n"
         "      // ---- the sequence: token, literal LSIC, literals, offset "
         "----"),
        ("      // ---- forward extension, 128 bytes a step, capped at "
         "mlim ----",
         "      long long tx = clk(o);\n      acc[3] += tx - t2;\n"
         "      // ---- forward extension, 128 bytes a step, capped at "
         "mlim ----"),
        ("      mc = min(mc, lim);\n      pos = p + mc;",
         "      mc = min(mc, lim);\n      long long t3 = clk(mc);\n"
         "      acc[2] += t3 - tx;\n      pos = p + mc;"),
        ("      if (lane == 0) d[token_at] = (uint8_t)token;\n      nseq++;",
         "      if (lane == 0) d[token_at] = (uint8_t)token;\n"
         "      acc[3] += clk(o) - t3;\n      acc[4]++;\n      nseq++;"),
        ("                                  int slot, int cap, int accel) {\n"
         "  extern __shared__",
         "                                  int slot, int cap, int accel,\n"
         "                                  long long* prof) {\n"
         "  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  extern __shared__"),
        ("  if (total) bar_wait(bar, 0);\n",
         "  long long tw = clk(total);\n  if (total) bar_wait(bar, 0);\n"
         "  acc[5] = clk(tw) - tw;\n"),
        ("  const bool ok = w.run(o, tpos, ns);",
         "  const bool ok = w.run(o, tpos, ns, acc);\n  if (lane == 0)\n"
         "    for (int i = 0; i < 8; i++) prof[(size_t)t * 8 + i] = acc[i];"),
        ("                      int nb, int bs, int slot, int cap, int accel,"
         "\n                      void* stream) {",
         "                      int nb, int bs, int slot, int cap, int accel,"
         "\n                      void* prof, void* stream) {"),
        ("(int*)nseq, nb, bs, slot, cap, accel);",
         "(int*)nseq, nb, bs, slot, cap, accel,\n        (long long*)prof);"),
    ],
    "parse_enc3.cu": [
        ('#include "parse_enc3_warp.cuh"',
         '#include "parse_enc3_warp_prof.cuh"'),
        ("lz4t_parse_enc3(", "lz4t_parse_enc3_prof("),
        ("int accel,\n                               void* stream) {",
         "int accel,\n                               void* prof, "
         "void* stream) {"),
        ("accel, stream);", "accel, prof, stream);"),
    ],
    # K10b and K10c: K3's and K7's instrumented walks in the mlen mode
    "parse_seg_mlen.cu": [
        ('#include "parse_seg_warp.cuh"',
         '#include "parse_seg_warp_prof.cuh"'),
        ("lz4t_parse_seg_mlen(", "lz4t_parse_seg_mlen_prof("),
        ("void* stream) {", "void* prof, void* stream) {"),
        ("accel, stream);", "accel, prof, stream);"),
    ],
    "parse_enc3_mlen.cu": [
        ('#include "parse_enc3_warp.cuh"',
         '#include "parse_enc3_warp_prof.cuh"'),
        ("lz4t_parse_enc3_mlen(", "lz4t_parse_enc3_mlen_prof("),
        ("void* stream) {", "void* prof, void* stream) {"),
        ("accel, stream);", "accel, prof, stream);"),
    ],
}

# the first K2 design's warp step (as cand.cu ran it before the split
# table, a warp a block from global memory), lane 0's cycles a part
# summed
FIRST_STEP = CLK + r"""
#include <stdint.h>
__global__ void first_step(const uint8_t* __restrict__ raw,
                           const int* __restrict__ raw_len,
                           int* __restrict__ cand, long long* prof,
                           int bs) {
  extern __shared__ uint16_t table[];
  const int blk = blockIdx.x, lane = threadIdx.x;
  const uint8_t* src = raw + (size_t)blk * bs;
  int* out = cand + (size_t)blk * bs;
  const int n = min(max(raw_len[blk], 0), bs);
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  long long c0 = clk(0);
  uint32_t* t32 = reinterpret_cast<uint32_t*>(table);
  for (int i = lane; i < (1 << 15); i += 32) t32[i] = 0;
  __syncwarp();
  acc[5] += clk(t32[lane]) - c0;
  const int npos = n - 3;
  for (int base = 0; base < bs; base += 32) {
    const int p = base + lane;
    long long t0 = clk(p);
    const bool act = p < npos;
    uint32_t h = 0x10000u + lane;
    if (act) {
      const uint32_t v = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8) |
                         ((uint32_t)src[p + 2] << 16) |
                         ((uint32_t)src[p + 3] << 24);
      h = (v * 2654435761u) >> 16;
    }
    long long t1 = clk(h);
    const unsigned peers = __match_any_sync(0xffffffffu, h);
    const unsigned lower = peers & ((1u << lane) - 1u);
    const unsigned higher = peers & ~((2u << lane) - 1u);
    long long t2 = clk(peers);
    int d = 0;
    if (act) {
      if (lower) {
        d = lane - (31 - __clz(lower));
      } else {
        const int t = table[h];
        if (t) d = p - (t - 1);
      }
    }
    long long t3 = clk(d);
    __syncwarp();
    if (act && !higher) table[h] = (uint16_t)(p + 1);
    __syncwarp();
    long long t4 = clk(higher);
    if (p < bs) out[p] = d;
    long long t5 = clk(d);
    acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2;
    acc[3] += t4 - t3; acc[4] += t5 - t4;
  }
  if (lane == 0)
    for (int i = 0; i < 6; i++) prof[blk * 6 + i] = acc[i];
}
extern "C" int lz4t_first_step(const void* raw, const void* raw_len,
                               void* cand, void* prof, int nb, int bs,
                               void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      first_step, cudaFuncAttributeMaxDynamicSharedMemorySize, 1 << 17);
  if (e != cudaSuccess) return (int)e;
  first_step<<<nb, 32, 1 << 17, (cudaStream_t)stream>>>(
      (const uint8_t*)raw, (const int*)raw_len, (int*)cand,
      (long long*)prof, bs);
  return (int)cudaGetLastError();
}
"""


def instrumented(name: str, text: str, profile=None) -> str:
    """``text`` (csrc/``name``) with the edits of ``profile[name]``
    (default ``PROFILE``), each anchor replaced wherever it occurs;
    raises where an anchor is not found (the source has moved on)."""
    for old, new in (profile or PROFILE)[name]:
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def _load(name: str, srcs: dict[str, str], main: str,
          entries: dict) -> ctypes.CDLL:
    """Write ``srcs`` (file name -> text) into a directory of the build
    directory, build ``main`` among them with the port's flags (the
    port's headers after theirs), and load it with ``entries``'
    signatures."""
    digest = hashlib.sha1(repr(sorted(srcs.items())).encode())
    d = os.path.join(_build.BUILD_DIR,
                     f"pace_{name}_{digest.hexdigest()[:12]}")
    so = os.path.join(d, "lib.so")
    if not os.path.exists(so):
        os.makedirs(d, exist_ok=True)
        for f, text in srcs.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               "-I", _build.CSRC, "-o", so,
                               os.path.join(d, main)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        regs = [ln.split(":", 1)[-1].strip() for ln in
                proc.stderr.splitlines() if "registers" in ln]
        print(f"built {name}: {'; '.join(regs)}", flush=True)
    lib = ctypes.CDLL(so)
    for fn, sig in entries.items():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_int if c == "i" else ctypes.c_void_p
                      for c in sig]
        f.restype = ctypes.c_int
    return lib


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def variant_header(name: str) -> str:
    """The header of variant ``name`` with its replacements; raises where
    a text is not found (the source has moved on)."""
    _, header, edits = VARIANTS[name]
    text = _read(os.path.join(_build.CSRC, header))
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in {header}")
        text = text.replace(old, new)
    return text


def variant(name: str) -> ctypes.CDLL:
    src, header, _ = VARIANTS[name]
    return _load(name, {f"{src}.cu": _read(os.path.join(_build.CSRC,
                                                        f"{src}.cu")),
                        header: variant_header(name)},
                 f"{src}.cu", MODS[src].ENTRIES)


def parent(tree: str, src: str) -> ctypes.CDLL:
    """DIR's csrc/<src>.cu with its own headers."""
    csrc = os.path.join(tree, "lz4_sgori_torch", "csrc")
    texts = {f: _read(os.path.join(csrc, f)) for f in os.listdir(csrc)
             if f == f"{src}.cu" or f.endswith(".cuh")}
    return _load(f"parent_{src}", texts, f"{src}.cu", MODS[src].ENTRIES)


def with_lib(mod, lib, fn):
    """``fn`` with ``mod``'s kernel taken from ``lib``."""
    def call():
        own = mod.load_kernel
        mod.load_kernel = lambda: lib
        try:
            return fn()
        finally:
            mod.load_kernel = own
    return call


def same_segments(a, b) -> bool:
    """Two segment parses agree: err, and where it is 0 every output
    (the streams within their lengths)."""
    if not torch.equal(a[2], b[2]):
        return False
    ok = b[2] == 0
    sm = (torch.arange(b[0].shape[1], device=ok.device)[None, :]
          < b[1][:, None]) & ok[:, None]
    return all(torch.equal(x[ok], y[ok]) for x, y in zip(a[1:], b[1:])) \
        and torch.equal(a[0][sm], b[0][sm])


def same_blocks(a, b) -> bool:
    """Two whole-block parses agree on all five outputs."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def cells(dev):
    """name -> (raw, rlen, cand, seg or None, gaps or None) on ``dev``:
    the gaps (links 2, K9's with its floor) where K8-seg runs."""
    from __graft_entry__ import _synth_corpus

    def corpus(nbytes, seed, bs):
        r, n = split_blocks(_synth_corpus(nbytes, seed=seed), bs)
        return torch.from_numpy(r).to(dev), torch.from_numpy(n).to(dev)

    def cell(r, n, seg):
        big = r.shape[1] > 65536
        c = (K9.dense_candidates_piecewise(r, n) if big
             else K2.dense_candidates(r, n))
        g = None
        if seg is not None:
            g, _ = G.chain_gaps(c, 2, K9.PIECE // 2 if big else 0)
        return r, n, c, seg, g
    out = {}
    for name, nbytes, seed, bs, seg in (
            ("config 1", 32 << 20, 42, 65536, 4096),
            ("config 3", 32 << 20, 42, 4096, None),
            ("config 5", 128 << 20, 1234, 65536, 4096),
            ("config 6", 128 << 20, 55, 1 << 20, 8192)):
        r, n = corpus(nbytes, seed, bs)
        out[name] = cell(r, n, seg)
        if name != "config 5":
            out[f"one block of {bs}"] = cell(r[:1].contiguous(),
                                             n[:1].contiguous(), seg)
    r, n = out["config 6"][:2]
    out[f"one block of {4 << 20}"] = cell(
        r[:4].reshape(1, 4 << 20), n[:4].sum().reshape(1).int(), 32768)
    # K7's 64 KiB cell: config 1's first 64 blocks, parsed whole
    r, n = out["config 1"][:2]
    out["64 blocks of 65536"] = cell(r[:64].contiguous(),
                                     n[:64].contiguous(), None)
    # the smoke's subsets: every 16th block of config 1 (mcode's) and
    # every 64th of config 5 (the gaps')
    for src, k in (("config 1", 32), ("config 5", 32)):
        r, n = out[src][:2]
        sel = torch.arange(0, r.shape[0], r.shape[0] // k, device=dev)[:k]
        out[f"{k} blocks of {src}"] = cell(r[sel].contiguous(),
                                           n[sel].contiguous(), None)
    r, n = out["config 1"][:2]
    # config 1's bytes in 1 MiB blocks: K9 on the bytes K2 profiles
    out["config 1 in blocks of 1048576"] = cell(
        r.reshape(-1, 1 << 20), n.reshape(-1, 16).sum(1).int(), 8192)
    return out


def mlen_tapes(cs, name: str):
    """cand_v and mcode of cell ``name``: mcode.cu over its candidates,
    made once."""
    if name not in _TAPES:
        r, n, c = cs[name][:3]
        _TAPES[name] = M.dense_mcode(c, r, n)
    return _TAPES[name]


def k4_inputs(cs, name: str):
    """K4's arguments (streams, hdr, raw, plan, ocap) on cell ``name``:
    the seg engine's steps before it (``seg.assembly_inputs``), made
    once."""
    if name not in _K4IN:
        r, n, _, seg, _ = cs[name]
        _K4IN[name] = S.assembly_inputs(r, n, r.shape[1], seg=seg,
                                        depth=K4_CELLS[name])[:5]
    return _K4IN[name]


def k4_bound_ms(inputs) -> float:
    """K4's bound on ``inputs``: each piece's bytes and the plan read once,
    every row (``ocap`` bytes, zeros past the length) and the lengths
    written once, over the device memory rate."""
    plan, ocap = inputs[3], inputs[4]
    nb = plan.shape[0]
    pieces = int(plan[..., 0].sum()) + int(plan[..., 1].sum()) \
        + int(plan[..., 3].sum())
    return (pieces + plan.numel() * 4 + nb * ocap + nb * 4) \
        / HBM_BYTES_PER_MS


def ms(fn, dev) -> float:
    """Milliseconds a call of ``fn`` after a warm-up call."""
    fn()
    return seconds(fn, dev, CALLS) * 1e3


def in_turns(fa, fb, dev, timer=ms) -> tuple[float, float]:
    t = [timer(f, dev) for f in (fa, fb, fb, fa)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def graph_ms(fn, dev, calls: int = 20) -> float:
    """Milliseconds a call of ``fn`` takes on the card alone: ``calls``
    calls captured into one CUDA graph (after a warm-up on a side
    stream), replayed once, then CUDA events around three replays. No
    Python runs between the launches, so a call shorter than its dispatch
    reads as the card's time, not the host's."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(3):
        graph.replay()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / (3 * calls)



def profile(cs, dev, stream) -> None:
    """The clock64 breakdowns (see the module's note)."""
    lib = _load("first_step", {"first.cu": "#include <cuda_runtime.h>\n"
                               + FIRST_STEP}, "first.cu",
                {"lz4t_first_step": "ppppiip"})
    for name in ("config 1", "config 3"):
        r, n = (t[:4].contiguous() for t in cs[name][:2])
        nb, bs = r.shape
        out = torch.empty((nb, bs), dtype=torch.int32, device=dev)
        pr = torch.zeros((nb, 6), dtype=torch.int64, device=dev)
        _build.check(lib.lz4t_first_step(r.data_ptr(), n.data_ptr(),
                                         out.data_ptr(), pr.data_ptr(), nb,
                                         bs, stream), "first_step")
        torch.cuda.synchronize(dev)
        p = pr.double().mean(0) / (bs // 32)
        print(f"first K2 design, {name}'s first 4 blocks, lane 0's cycles "
              f"a step: loads and hash {p[0]:.1f}, match {p[1]:.1f}, table "
              f"read {p[2]:.1f}, table write {p[3]:.1f}, store {p[4]:.1f}; "
              f"the clear {float(pr[:, 5].double().mean()):.0f} a block; "
              f"equal {torch.equal(out, K2.dense_candidates(r, n))}",
              flush=True)
    texts = {f: _read(os.path.join(_build.CSRC, f)) for f in
             ("cand.cu", "cand_part.cuh", "cand_piecewise.cu", "parse_seg.cu",
              "parse_seg_deep.cu", "parse_seg_warp.cuh")}
    k2 = _load("cand_prof", {
        "cand.cu": instrumented("cand.cu", texts["cand.cu"]),
        "cand_part_prof.cuh": instrumented("cand_part.cuh",
                                           texts["cand_part.cuh"])},
        "cand.cu", {"lz4t_cand_prof": "pppiipp"})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = int(re.search(r"constexpr int kWarps = (\d+);",
                      texts["cand_part.cuh"])[1])      # the CTA's warps
    for name, (r, n, _, _, _) in cs.items():
        if r.shape[1] > 65536:
            continue
        nb, bs = r.shape
        out = torch.empty((nb, bs), dtype=torch.int32, device=dev)
        pr = torch.zeros((min(nb, sms), w, 6), dtype=torch.int64,
                         device=dev)
        _build.check(k2.lz4t_cand_prof(r.data_ptr(), n.data_ptr(),
                                       out.data_ptr(), nb, bs, pr.data_ptr(),
                                       stream), "cand_prof")
        torch.cuda.synchronize(dev)
        per = pr.double() / pr[:, :1, 4:5].double().clamp(min=1)
        scan, step, nst = per[..., 0], per[..., 1], per[..., 2]
        print(f"K2 {name} ({nb} blocks, {w} warps, equal "
              f"{torch.equal(out, K2.dense_candidates(r, n))}): a block, "
              f"cycles a warp: scan and steps {float(scan.mean()):.0f} "
              f"(busiest warp {float(scan.max(1).values.mean()):.0f}), of "
              f"which the steps {float(step.mean()):.0f} (busiest "
              f"{float(step.max(1).values.mean()):.0f}); steps "
              f"{float(nst.mean()):.1f} (busiest "
              f"{float(nst.max(1).values.mean()):.1f}), "
              f"{float(step.sum() / nst.sum().clamp(min=1)):.0f} cycles a "
              f"step; the wait {float(per[..., 3].mean()):.0f}; the clear "
              f"{float(per[..., 5].mean()):.0f}", flush=True)
    k9 = _load("cand_piecewise_prof", {
        "cand_piecewise.cu": instrumented("cand_piecewise.cu",
                                          texts["cand_piecewise.cu"]),
        "cand_part_prof.cuh": instrumented("cand_part.cuh",
                                           texts["cand_part.cuh"])},
        "cand_piecewise.cu", {"lz4t_cand_piecewise_prof": "pppiiipp"})
    for name, (r, n, _, _, _) in cs.items():
        nb, bs = r.shape
        if bs <= 65536:
            continue
        half = K9.PIECE // 2
        nhalf = -(-bs // half)
        ctas = nb * -(-nhalf // K9.run_length(nb, bs))
        out = torch.empty((nb, bs), dtype=torch.int32, device=dev)
        pr = torch.zeros((ctas, w, 8), dtype=torch.int64, device=dev)
        _build.check(k9.lz4t_cand_piecewise_prof(
            r.data_ptr(), n.data_ptr(), out.data_ptr(), nb, bs, half,
            pr.data_ptr(), stream), "cand_piecewise_prof")
        torch.cuda.synchronize(dev)
        per = pr.double() / pr[:, :1, 4:5].double().clamp(min=1)
        scan, step, nst = per[..., 0], per[..., 1], per[..., 2]
        print(f"K9 {name} ({ctas} CTAs, {w} warps, runs of "
              f"{K9.run_length(nb, bs)}, equal "
              f"{torch.equal(out, K9.dense_candidates_piecewise(r, n))}): a "
              f"half-piece, cycles a warp: scan and steps "
              f"{float(scan.mean()):.0f} (busiest warp "
              f"{float(scan.max(1).values.mean()):.0f}), of which the steps "
              f"{float(step.mean()):.0f} (busiest "
              f"{float(step.max(1).values.mean()):.0f}); steps "
              f"{float(nst.mean()):.1f} (busiest "
              f"{float(nst.max(1).values.mean()):.1f}); the wait for the "
              f"bytes {float(per[..., 3].mean()):.0f}; the wait for the "
              f"other warps {float(per[..., 6].mean()):.0f}; the boundary "
              f"(barriers and sweep) {float(per[..., 5].mean()):.0f}",
              flush=True)
    enc3_prof = instrumented("parse_enc3_warp.cuh", _read(
        os.path.join(_build.CSRC, "parse_enc3_warp.cuh")))
    for src, key in (("parse_enc3", "K7"), ("parse_enc3_mlen", "K10c")):
        lib = _load(f"{src}_prof", {
            f"{src}.cu": instrumented(f"{src}.cu", _read(
                os.path.join(_build.CSRC, f"{src}.cu"))),
            "parse_enc3_warp_prof.cuh": enc3_prof}, f"{src}.cu",
            {f"lz4t_{src}_prof": ("p" if src in MLEN_CELLS else "")
             + "ppppppppiiiiipp"})
        for name, (r, n, c, seg, _) in cs.items():
            nb, bs = r.shape
            if seg is not None or bs > 65536 or (
                    src in MLEN_CELLS and name not in MLEN_CELLS[src]):
                continue
            enc3_profile(lib, src, key, name, r, n, c, cs, dev, stream)
    warp_prof = instrumented("parse_seg_warp.cuh",
                             texts["parse_seg_warp.cuh"])
    for src, key in (("parse_seg", "K3"), ("parse_seg_deep", "K8-seg"),
                     ("parse_seg_mlen", "K10b")):
        texts[f"{src}.cu"] = _read(os.path.join(_build.CSRC, f"{src}.cu"))
        lib = _load(f"{src}_prof", {
            f"{src}.cu": instrumented(f"{src}.cu", texts[f"{src}.cu"]),
            "parse_seg_warp_prof.cuh": warp_prof}, f"{src}.cu",
            {f"lz4t_{src}_prof": ("p" if src != "parse_seg" else "")
             + "ppppppppppiiiiiipp"})
        deep, mlen = src == "parse_seg_deep", src in MLEN_CELLS
        for name, (r, n, c, seg, g) in cs.items():
            if seg is None or (deep and g is None) or (
                    mlen and name not in MLEN_CELLS[src]):
                continue
            nb, bs = r.shape
            ns = nb * (bs // seg)
            outs = K3.segment_outputs(ns, seg, dev)
            pr = torch.zeros((ns, 8), dtype=torch.int64, device=dev)
            tapes = (c, g) if deep else mlen_tapes(cs, name) if mlen \
                else (c,)
            _build.check(getattr(lib, f"lz4t_{src}_prof")(
                r.data_ptr(), *(t.data_ptr() for t in tapes), n.data_ptr(),
                *(t.data_ptr() for t in outs), nb, bs, seg,
                F.compress_bound(seg), K3.window_limit(65536), 1,
                pr.data_ptr(), stream), f"{src}_prof")
            torch.cuda.synchronize(dev)
            want = (K8S.parse_segments_deep(r, c, g, n, seg=seg) if deep
                    else K10B.parse_segments_mlen(r, *tapes, n, seg=seg)
                    if mlen else K3.parse_segments(r, c, n, seg=seg))
            tot = pr.double().sum(0)
            nq = tot[4].clamp(min=1)
            busy = pr[:, :4].double().sum(1) + pr[:, 7].double()
            print(f"{key} {name} ({ns} segments, equal "
                  f"{same_segments(outs, want)}): cycles a sequence: search "
                  f"{float(tot[0] / nq):.0f} ({float(tot[6] / nq):.2f} "
                  f"rounds), previews {float(tot[7] / nq):.0f}, catch-up "
                  f"{float(tot[1] / nq):.0f}, extension "
                  f"{float(tot[2] / nq):.0f}, emission "
                  f"{float(tot[3] / nq):.0f}; the wait for the bytes "
                  f"{float(tot[5] / ns):.0f} a warp; the busiest warp "
                  f"{float(busy.max()):.0f} cycles "
                  f"({int(pr[busy.argmax(), 4])} sequences), the mean "
                  f"{float(busy.mean()):.0f}", flush=True)


def enc3_profile(lib, src, key, name, r, n, c, cs, dev, stream) -> None:
    """K7's or K10c's clock64 breakdown on cell ``name``, printed."""
    nb, bs = r.shape
    cap = F.compress_bound(bs)
    outs = K7.block_outputs(nb, bs, dev)
    pr = torch.zeros((nb, 8), dtype=torch.int64, device=dev)
    tapes = mlen_tapes(cs, name) if src in MLEN_CELLS else (c,)
    _build.check(getattr(lib, f"lz4t_{src}_prof")(
        r.data_ptr(), *(t.data_ptr() for t in tapes), n.data_ptr(),
        *(t.data_ptr() for t in outs), nb, bs, cap + 8, cap, 1,
        pr.data_ptr(), stream), f"{src}_prof")
    torch.cuda.synchronize(dev)
    want = (K10C.parse_blocks_enc3_mlen(r, *tapes, n) if src in MLEN_CELLS
            else K7.parse_blocks_enc3(r, c, n))
    tot = pr.double().sum(0)
    nq = tot[4].clamp(min=1)
    busy = pr[:, :4].double().sum(1) + pr[:, 7].double()
    print(f"{key} {name} ({nb} blocks, equal {same_blocks(outs, want)}): "
          f"cycles a sequence: search {float(tot[0] / nq):.0f} "
          f"({float(tot[6] / nq):.2f} rounds), the match's pick "
          f"{float(tot[7] / nq):.0f}, catch-up {float(tot[1] / nq):.0f}, "
          f"extension {float(tot[2] / nq):.0f}, emission "
          f"{float(tot[3] / nq):.0f}; the wait for the bytes "
          f"{float(tot[5] / nb):.0f} a warp; the busiest warp "
          f"{float(busy.max()):.0f} cycles ({int(pr[busy.argmax(), 4])} "
          f"sequences), the mean {float(busy.mean()):.0f}", flush=True)


def store_median(data: bytes, dev, chunk: int = 4096,
                 nreq: int = STORE_REQUESTS,
                 match_depth: int | None = None) -> float:
    """Milliseconds, the median of ``nreq`` sequential ``ProxyStore``
    writes of ``chunk`` bytes of ``data`` (at ``match_depth``)."""
    import tempfile
    import time

    import numpy as np

    from ..store import ProxyStore
    lat = []
    with tempfile.TemporaryDirectory() as tmp:
        st = ProxyStore(os.path.join(tmp, "store.img"), chunk_size=chunk,
                        capacity=nreq * chunk, device=dev,
                        match_depth=match_depth)
        for i in range(nreq):
            t0 = time.perf_counter()
            st.write(i * chunk, data[i * chunk:(i + 1) * chunk])
            lat.append(time.perf_counter() - t0)
        st.close()
    return 1e3 * float(np.median(lat))


def same_gaps(a, b) -> bool:
    """Two gaps calls agree (gaps, and gaps2 where there is one)."""
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def gaps_bound_ms(cand, links: int) -> float:
    """The gaps kernel's bound: the tape read once, gaps (and gaps2)
    written once, over the device memory rate."""
    return cand.numel() * 4 * (3 if links == 4 else 2) / HBM_BYTES_PER_MS


def mcode_bound_ms(raw) -> float:
    """K10a's bound: the tape and the bytes read once, cand_v and mcode
    written once (13 bytes a position), and the lengths."""
    nb, bs = raw.shape
    return (nb * bs * 13 + nb * 4) / HBM_BYTES_PER_MS


def gaps_runs(cs) -> list:
    """(cell name, call, links, tape) of the gaps kernel: ``GAPS_CELLS``
    and the first 8 MiB of config 5 at 4 links."""
    out = []
    for name, (links, half) in GAPS_CELLS.items():
        if name in cs:
            c = cs[name][2]
            out.append((name, lambda c=c, k=links, h=half:
                        G.chain_gaps(c, k, h), links, c))
    if "config 5" in cs:
        c = cs["config 5"][2][:GAPS5_BLOCKS].contiguous()
        out.append((f"{GAPS5_BLOCKS} blocks of config 5 at 4 links",
                    lambda c=c: G.chain_gaps(c, 4), 4, c))
    return out


def runs_of(src: str, cs) -> list:
    """(cell name, call, comparison) of the cells a source's kernel runs
    on: K2 at 64 KiB and less, K9 above, K3 and K8-seg where a segment
    size (and for K8-seg the gaps) is given, K7 where none is, mcode, K10b
    and K10c on ``MLEN_CELLS``, the gaps on ``gaps_runs``."""
    if src == "gaps":
        return [(name, fn, same_gaps) for name, fn, _, _ in gaps_runs(cs)]
    out = []
    for name, (r, n, c, seg, g) in cs.items():
        bs = r.shape[1]
        if name in MLEN_CELLS.get(src, ()):
            t = mlen_tapes(cs, name)
            fn, same = {
                "mcode": (lambda r=r, n=n, c=c: M.dense_mcode(c, r, n),
                          same_blocks),
                "parse_seg_mlen": (lambda r=r, n=n, t=t, seg=seg:
                                   K10B.parse_segments_mlen(r, *t, n,
                                                            seg=seg),
                                   same_segments),
                "parse_enc3_mlen": (lambda r=r, n=n, t=t:
                                    K10C.parse_blocks_enc3_mlen(r, *t, n),
                                    same_blocks)}[src]
            out.append((name, fn, same))
        elif src == "asm_seg" and name in K4_CELLS:
            out.append((name, lambda i=k4_inputs(cs, name):
                        K4.assemble_segments(*i), same_blocks))
        elif src == "cand" and bs <= 65536:
            out.append((name, lambda r=r, n=n: K2.dense_candidates(r, n),
                        torch.equal))
        elif src == "cand_piecewise" and bs > 65536:
            out.append((name, lambda r=r, n=n:
                        K9.dense_candidates_piecewise(r, n), torch.equal))
        elif src == "parse_seg" and seg is not None:
            out.append((name, lambda r=r, n=n, c=c, seg=seg:
                        K3.parse_segments(r, c, n, seg=seg), same_segments))
        elif src == "parse_enc3" and seg is None and bs <= 65536:
            out.append((name, lambda r=r, n=n, c=c:
                        K7.parse_blocks_enc3(r, c, n), same_blocks))
        elif src == "parse_seg_deep" and g is not None:
            out.append((name, lambda r=r, n=n, c=c, seg=seg, g=g:
                        K8S.parse_segments_deep(r, c, g, n, seg=seg),
                        same_segments))
    return out


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--variants", nargs="*", default=[],
                   choices=sorted(VARIANTS))
    p.add_argument("--parent")
    p.add_argument("--store", type=int, default=0)
    p.add_argument("--device-time", action="store_true",
                   help="time K4, mcode, the gaps, the mlen paths and "
                        "the comparisons in turns from calls captured in a "
                        "CUDA graph (the card's time)")
    p.add_argument("--sources", nargs="*", choices=sorted(MODS),
                   help="compare only these sources' parents (default: "
                        "all)")
    a = p.parse_args(argv)
    if a.store and not a.parent:
        p.error("--store needs --parent")
    dev = resolve_device(a.device)
    if dev.type != "cuda":
        p.error("the kernels' times need a CUDA card")
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() or "no power limit read"
    print(f"devices: {device_name(dev)} ({limit})", flush=True)
    stream = _build.stream(dev)
    timer = graph_ms if a.device_time else ms
    cs = cells(dev)
    for name, (r, n, c, seg, g) in cs.items():
        nb, bs = r.shape
        line = [name]
        if bs <= 65536:
            t = ms(lambda: K2.dense_candidates(r, n), dev)
            line.append(f"K2 {t:.4f} ms")
        else:
            t = ms(lambda: K9.dense_candidates_piecewise(r, n), dev)
            line.append(f"K9 {t:.4f} ms (runs of "
                        f"{K9.run_length(nb, bs)} half-pieces)")
        for key, fn in (("K3", lambda: K3.parse_segments(r, c, n, seg=seg)),
                        ("K8-seg", lambda: K8S.parse_segments_deep(
                            r, c, g, n, seg=seg))):
            if seg is None or (key == "K8-seg" and g is None):
                continue
            ns = fn()[4].to(torch.int64)
            t = ms(fn, dev)
            line.append(f"{key} {t:.4f} ms; {int(ns.sum())} sequences in "
                        f"{ns.numel()} segments (mean "
                        f"{float(ns.double().mean()):.1f}, most "
                        f"{int(ns.max())})")
        if seg is None and bs <= 65536:
            def k7(r=r, c=c, n=n):
                return K7.parse_blocks_enc3(r, c, n)
            ns = k7()[4].to(torch.int64)
            t = ms(k7, dev)
            line.append(f"K7 {t:.4f} ms; {int(ns.sum())} sequences in "
                        f"{ns.numel()} blocks (mean "
                        f"{float(ns.double().mean()):.1f}, most "
                        f"{int(ns.max())})")
        if name in ("config 1", "config 3", "one block of 65536",
                    "one block of 4096"):
            # the mlen path in turns with the default path on these blocks
            def path(flag, r=r, n=n, bs=bs):
                if bs == 4096:
                    return lambda: compress_blocks_enc3(r, n, bs, mlen=flag)
                return lambda: compress_blocks_seg(r, n, bs, mlen=flag)
            d, m = in_turns(path(False), path(True), dev, timer)
            line.append(f"the encode kernel path {d:.4f} ms and with the "
                        f"mlen mode {m:.4f} ms in turns ({m / d:.4f}x)")
        for src, key, base in (
                ("parse_seg_mlen", "K10b", lambda r=r, c=c, n=n, seg=seg:
                 K3.parse_segments(r, c, n, seg=seg)),
                ("parse_enc3_mlen", "K10c", lambda r=r, c=c, n=n:
                 K7.parse_blocks_enc3(r, c, n))):
            if name not in MLEN_CELLS[src]:
                continue
            (_, fn, _), = runs_of(src, {name: cs[name]})
            (_, mc, _), = runs_of("mcode", {name: cs[name]})
            this, other = in_turns(fn, base, dev)
            line.append(f"mcode {timer(mc, dev):.4f} ms (bound "
                        f"{mcode_bound_ms(r):.6f}), {key} {this:.4f} ms "
                        f"in turns with {'K3' if key == 'K10b' else 'K7'} "
                        f"{other:.4f} ms ({this / other:.4f}x)")
        if name in K4_CELLS:
            i = k4_inputs(cs, name)
            t = timer(lambda i=i: K4.assemble_segments(*i), dev)
            line.append(f"K4 {t:.4f} ms after the depth-{K4_CELLS[name]} "
                        f"parse (bound {k4_bound_ms(i):.6f} ms)")
        for gname, fn, links, c5 in gaps_runs({name: cs[name]}):
            line.append(f"gaps at {links} links {timer(fn, dev):.4f} ms "
                        f"(bound {gaps_bound_ms(c5, links):.6f})")
        if "one" not in name and "64 blocks" not in name:
            t = ms(lambda: compress_blocks_device(r, n, bs), dev)
            line.append(f"the encode kernel path {t:.3f} ms")
            if g is not None:
                t = ms(lambda: compress_blocks_device(r, n, bs,
                                                      match_depth=3), dev)
                line.append(f"at depth 3 {t:.3f} ms")
        print(": ".join(line[:1]) + ": " + ", ".join(line[1:]), flush=True)
    if a.profile:
        profile(cs, dev, stream)
    others = [(v, VARIANTS[v][0], variant(v)) for v in a.variants]
    parents = {}
    if a.parent:
        parents = {s: parent(a.parent, s) for s in a.sources or MODS}
        others += [(f"parent {s}", s, lib) for s, lib in parents.items()]
    if a.store:
        from __graft_entry__ import _synth_corpus
        small = _synth_corpus(STORE_REQUESTS * 4096)
        shapes = [(src, MODS[src], 4096, STORE_REQUESTS, small)
                  for src in ("cand", "parse_enc3")]
        big = _synth_corpus(max(c * k for c, k in BIG_STORES), seed=55)
        shapes += [(src, MODS[src], c, k, big) for src in
                   ("cand_piecewise", "asm_seg") for c, k in BIG_STORES]
        for r in range(a.store):
            for src, mod, chunk, nreq, data in shapes:
                if src not in parents:
                    continue
                def own(data=data, chunk=chunk, nreq=nreq):
                    return store_median(data, dev, chunk, nreq)
                old = with_lib(mod, parents[src], own)
                t = [f() for f in (own, old, old, own)]
                print(f"ProxyStore.write of {chunk} bytes, the median of "
                      f"{nreq}, round {r + 1} in turns (this, parent, "
                      f"parent, this): this {t[0]:.4f} {t[3]:.4f} ms, with "
                      f"the parent's {src} {t[1]:.4f} {t[2]:.4f} ms",
                      flush=True)
    differ = []
    for label, src, lib in others:
        for name, fn, same in runs_of(src, cs):
            other = with_lib(MODS[src], lib, fn)
            ok = same(other(), fn())
            this, that = in_turns(fn, other, dev, timer)
            print(f"{label} on {name} in turns (this, variant, variant, "
                  f"this): this {this:.4f} ms, variant {that:.4f} ms "
                  f"({that / this:.4f}x); equal: {ok}", flush=True)
            if not ok:
                differ.append(f"{label} on {name}")
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())

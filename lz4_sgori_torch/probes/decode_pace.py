"""What sets the pace of K1, the v7 decode (``csrc/decode_v7.cu``), and
K5, the v6 decode (``csrc/decode_v6.cu``), both on
``csrc/lz4_decode_ring.cuh``, on the card, on their cells: K1's config 1
(32 MiB of 64 KiB blocks, seed 42, the seg engine's streams), config 5
(128 MiB of 64 KiB blocks, seed 1234, the depth-3 streams), one 64 KiB
block, and config 1's bytes in 128 KiB blocks (256 of them, and one);
K5's config 3 (config 1's bytes in 4 KiB blocks, the enc3 engine's
streams), one 4 KiB block, ``chip_smoke``'s subset of 64 of them, and
config 1's bytes in 256 KiB blocks (128 of them):

- each kernel's time a call (CUDA events) and the decode kernel path's
  (``decompress_blocks_device``) on each cell;
- ``--profile``: clock64 breakdowns from an instrumented copy of the
  header (``PROFILE``): the walking warp's cycles a block in batches, in
  the general walk and, for K6's ring, in the last flush; the batches and
  sequences a block; and the CTA's cycles writing the row (a whole
  block) or zeroing its tail (K6's ring);
- ``--variants NAME ...``: builds of the sources with other settings
  (``VARIANTS``: K1's blocks through K6's 128 KiB ring, K1 at one CTA an
  SM; K5's small geometry with CTAs of 64 threads or at 48 registers a
  thread, K5's 4 KiB blocks through K1's 64 KiB geometry), each timed in
  turns with this tree's build (this, variant, variant, this) on its
  kernel's cells and its outputs held equal to it;
- ``--parent DIR``: the same for DIR's ``decode_v7.cu`` and
  ``decode_v6.cu``, each with DIR's own headers (a ``git archive`` of an
  earlier commit);
- ``--device-time``: every time above from calls captured in a CUDA
  graph (``graph_ms``), the card's time without the host's dispatch,
  which sets a one-block call's time otherwise;
- ``--store ROUNDS`` (with ``--parent``): the median latency of
  ``STORE_REQUESTS`` sequential 64 KiB ``ProxyStore`` writes at match
  depth 3 (each decode-verified through K1) of config 5's bytes with this
  tree's K1 and with DIR's, and of ``STORE4_REQUESTS`` 4 KiB writes of
  config 1's bytes (each decode-verified through K5, whose launches a
  write are counted) with this tree's K5 and with DIR's, in turns (this,
  parent, parent, this) ROUNDS times.

    python -m lz4_sgori_torch.probes.decode_pace [--profile]
        [--variants NAME ...] [--parent DIR [--store ROUNDS]]
        [--device-time]
"""

from __future__ import annotations

import os
import subprocess

import torch

from ..blocks import resolve_device, split_blocks
from ..ops.decode import decompress_blocks_device
from ..ops.encode import compress_blocks_device
from ..ops.kernels import _build
from ..ops.kernels import lockstep_v6 as K5
from ..ops.kernels import lockstep_v7 as K1
from . import device_name, parser
from .encode_pace import (CLK, _load, _read, graph_ms, in_turns,
                          instrumented, ms, store_median, with_lib)

STORE_REQUESTS = 64   # 64 KiB writes a store timing
STORE4_REQUESTS = 1024  # 4 KiB writes a store timing
# the kernel sources and their wrappers
MODS = {"decode_v7": K1, "decode_v6": K5}
WRAPPERS = {"decode_v7": "decompress_blocks_v7", "decode_v6":
            "decompress_blocks_v6"}

# variants: a kernel source (decode_v7 or decode_v6) and its and the
# headers' (file, text, replacement) edits, each text found in its file
VARIANTS = {
    # K1's blocks of 64 KiB and less through K6's kernel unchanged
    "k6_ring": ("decode_v7", [("decode_v7.cu",
                               "if (out_size <= ring::kWholeMax)",
                               "if (false)")]),
    # the whole block at one CTA an SM (20,000 more bytes of shared
    # memory a CTA than two fit)
    "one_cta": ("decode_v7", [("lz4_decode_ring.cuh",
                               "static constexpr int kSmem = kTabAt + kTab;",
                               "static constexpr int kSmem = kTabAt + kTab "
                               "+ (Whole && OutLog == 16 ? 20000 : 0);")]),
    # K5's small geometries at CTAs of 64 threads: the walking warp and
    # one helper, four window positions a thread, 12 CTAs an SM at 4 KiB
    "k5_t64": ("decode_v6", [("lz4_decode_ring.cuh",
                              "constexpr int kSmallThreads = 128;",
                              "constexpr int kSmallThreads = 64;")]),
    # K5's small geometries at 48 registers a thread: 10 CTAs an SM at 4
    # KiB (the launch bound), where the walk's 64 registers give 8
    "k5_regs48": ("decode_v6", [("lz4_decode_ring.cuh",
                                 "const int by_regs = 65536 / (64 * threads);",
                                 "const int by_regs = 65536 / (48 * threads);"
                                 )]),
    # K5's blocks up to 16 KiB through K1's 64 KiB geometry, two CTAs an SM
    "k5_whole64": ("decode_v6", [("decode_v6.cu",
                                  "if (out_size <= ring::kSmallMax) {",
                                  "if (false) {")]),
}

# instrumented copies: file -> (anchor, replacement) pairs, each anchor
# found in the source; acc[] the walking warp's, written to prof at the
# end: 0 batch cycles, 1 batches, 2 sequences in batches, 3 general-walk
# cycles, 4 general sequences, 5 the last flush (K6), 6 the CTA's row
# write or tail zeroing, 7 the whole walk; inside the batch calls (the
# ones that take none too): 8 the command and the window pass, 9 the
# lookups, the scan and the checks, 10 the literals and the independent
# matches, 11 the dependency waves
NACC = 12
PROFILE = {
    "lz4_decode_ring.cuh": [
        ("namespace ring {", "namespace ring {\n" + CLK),
        ("                            int& ip, int& op, int ilen, "
         "int out_size,\n                            int lane) {\n"
         "  constexpr int kStageLog = G::kStageLog, kStages = G::kStages;\n"
         "  const int a0 = in.head + ip;",
         "                            int& ip, int& op, int ilen, "
         "int out_size,\n                            int lane, long long* acc)"
         " {\n  constexpr int kStageLog = G::kStageLog, kStages = "
         "G::kStages;\n  const long long b0 = clk(ip);\n"
         "  const int a0 = in.head + ip;"),
        ("  window_pass<G>(in.buf, fld, nxt, a0, rel, lane);\n"
         "  int mine = 0;",
         "  window_pass<G>(in.buf, fld, nxt, a0, rel, lane);\n"
         "  const long long b1 = clk(rel);\n  acc[8] += b1 - b0;\n"
         "  int mine = 0;"),
        ("  // Literals, and the matches whose sources lie before the batch:",
         "  const long long b2 = clk(count);\n  acc[9] += b2 - b1;\n"
         "  // Literals, and the matches whose sources lie before the batch:"),
        ("  // The others in waves. A match waits for the earlier ones whose",
         "  const long long b3 = clk(op);\n  acc[10] += b3 - b2;\n"
         "  // The others in waves. A match waits for the earlier ones whose"),
        ("  const int last = count - 1;",
         "  acc[11] += clk(op) - b3;\n  const int last = count - 1;"),
        ("                                 volatile int* cmd, int ilen, "
         "int slot,\n                                 int out_size, int lane)"
         " {",
         "                                 volatile int* cmd, int ilen, "
         "int slot,\n                                 int out_size, int lane,"
         " long long* acc) {"),
        ("  while (!bad) {\n    if (ip < ilen && ((in.head + ip) >> kStageLog)"
         " != in.cur)\n      in.advance((in.head + ip) >> kStageLog, lane);\n"
         "    if (decode_batch(in, out, tab, fld, nxt, cmd, ip, op, ilen, "
         "out_size,\n                     lane))\n      continue;",
         "  while (!bad) {\n    const long long t0 = clk(ip);\n"
         "    if (ip < ilen && ((in.head + ip) >> kStageLog)"
         " != in.cur)\n      in.advance((in.head + ip) >> kStageLog, lane);\n"
         "    const int got = decode_batch(in, out, tab, fld, nxt, cmd, ip, "
         "op, ilen,\n                                 out_size, lane, acc);\n"
         "    if (got) {\n      acc[0] += clk(op) - t0;\n      acc[1]++;\n"
         "      acc[2] += got;\n      continue;\n    }\n    acc[4]++;"),
        ("      out.check(op, lane);\n    }\n  }\n  if constexpr "
         "(!G::kWhole)\n    if (!bad) out.flush_to(out.ohead + op, lane);",
         "      out.check(op, lane);\n    }\n    acc[3] += clk(op) - t0;\n"
         "  }\n  const long long tf = clk(op);\n  if constexpr "
         "(!G::kWhole)\n"
         "    if (!bad) out.flush_to(out.ohead + op, lane);\n"
         "  acc[5] += clk(op) - tf;"),
        ("                   int slot, int out_size) {\n  constexpr int "
         "kThreads = G::kThreads;",
         "                   int slot, int out_size, long long* prof) {\n"
         "  constexpr int kThreads = G::kThreads;"),
        ("    const int n = decode_block_ring(in, o, tab, (int2*)(smem + "
         "G::kFld),\n                                    (uint16_t*)(smem + "
         "G::kNxt), s_cmd, ilen,\n                                    slot, "
         "out_size, lane);",
         "    long long acc[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
         "    const long long tw = clk(ilen);\n"
         "    const int n = decode_block_ring(in, o, tab, (int2*)(smem + "
         "G::kFld),\n                                    (uint16_t*)(smem + "
         "G::kNxt), s_cmd, ilen,\n                                    slot, "
         "out_size, lane, acc);\n    acc[7] = clk(n) - tw;\n"
         "    if (lane == 0)\n      for (int i = 0; i < 12; i++)\n"
         "        if (i != 6) prof[(size_t)blk * 12 + i] = acc[i];"),
        ("  __syncthreads();\n  write_row<G>(smem, dst, s_n, out_size);\n}",
         "  __syncthreads();\n  const long long te = clk(s_n);\n"
         "  write_row<G>(smem, dst, s_n, out_size);\n  __syncthreads();\n"
         "  if (threadIdx.x == 0) prof[(size_t)blk * 12 + 6] = clk(te) - te;"
         "\n}"),
        ("                              int out_size, void* stream) {\n"
         "  if (G::kWhole && out_size > G::kOutRing)",
         "                              int out_size, void* prof, "
         "void* stream) {\n  if (G::kWhole && out_size > G::kOutRing)"),
        ("        (int*)out_len, (uint8_t*)err, slot, out_size);",
         "        (int*)out_len, (uint8_t*)err, slot, out_size, "
         "(long long*)prof);"),
    ],
}
for _src in MODS:
    PROFILE[f"{_src}.cu"] = [
        ('#include "lz4_decode_ring.cuh"',
         '#include "lz4_decode_ring_prof.cuh"'),
        (f"lz4t_{_src}(", f"lz4t_{_src}_prof("),
        ("int out_size, void* stream) {",
         "int out_size, void* prof, void* stream) {"),
        ("out_size, stream);", "out_size, prof, stream);"),
    ]


def _sources(csrc: str, src: str = "decode_v7") -> dict[str, str]:
    return {f: _read(os.path.join(csrc, f)) for f in os.listdir(csrc)
            if f == f"{src}.cu" or f.endswith(".cuh")}


def variant_sources(name: str) -> dict[str, str]:
    """The variant's kernel source and the headers with its edits;
    raises where a text is not found (the source has moved on)."""
    src, edits = VARIANTS[name]
    texts = _sources(_build.CSRC, src)
    for f, old, new in edits:
        if old not in texts[f]:
            raise ValueError(f"variant {name}: {old!r} is not in {f}")
        texts[f] = texts[f].replace(old, new)
    return texts


def variant(name: str):
    src = VARIANTS[name][0]
    return _load(f"{src}_{name}", variant_sources(name), f"{src}.cu",
                 MODS[src].ENTRIES)


def parent(tree: str, src: str = "decode_v7"):
    """DIR's csrc/<src>.cu with its own headers."""
    return _load(f"parent_{src}",
                 _sources(os.path.join(tree, "lz4_sgori_torch", "csrc"), src),
                 f"{src}.cu", MODS[src].ENTRIES)


def cells(dev):
    """name -> (comp, comp_len, out_size, source) on ``dev``: each cell's
    streams from the port's encode path, and the kernel source that
    decodes it (K1's ``decode_v7`` or K5's ``decode_v6``)."""
    from __graft_entry__ import _synth_corpus

    def cell(data, bs, depth=None):
        r, n = split_blocks(data, bs)
        r, n = torch.from_numpy(r).to(dev), torch.from_numpy(n).to(dev)
        c, cl = compress_blocks_device(r, n, bs, match_depth=depth)
        return c, cl, bs, "decode_v7" if 16384 <= bs <= 131072 else \
            "decode_v6"
    d1 = _synth_corpus(32 << 20)
    out = {"config 1": cell(d1, 65536),
           "config 5": cell(_synth_corpus(128 << 20, seed=1234), 65536, 3),
           "config 1 in blocks of 131072": cell(d1, 131072),
           "config 3": cell(d1, 4096),
           "config 1 in blocks of 262144": cell(d1, 262144)}
    for name in ("config 1", "config 1 in blocks of 131072", "config 3"):
        c, cl, bs, src = out[name]
        out[f"one block of {bs}"] = (c[:1].contiguous(), cl[:1].contiguous(),
                                     bs, src)
    # chip_smoke's 64-block subset of config 3 (phases 6 and 12)
    c, cl, bs, src = out["config 3"]
    sub = torch.arange(0, c.shape[0], c.shape[0] // 64, device=dev)[:64]
    out["the 64-block subset of config 3"] = (c[sub].contiguous(),
                                              cl[sub].contiguous(), bs, src)
    return out


def decode(c, cl, bs, src="decode_v7"):
    call = getattr(MODS[src], WRAPPERS[src])
    return lambda: call(c, cl, bs)


def profile(cs, dev, stream) -> None:
    """The clock64 breakdowns (see the module's note)."""
    libs = {}
    for src in MODS:
        texts = _sources(_build.CSRC, src)
        libs[src] = _load(f"{src}_prof", {
            f"{src}.cu": instrumented(f"{src}.cu", texts[f"{src}.cu"],
                                      PROFILE),
            "lz4_decode_ring_prof.cuh": instrumented(
                "lz4_decode_ring.cuh", texts["lz4_decode_ring.cuh"],
                PROFILE)},
            f"{src}.cu", {f"lz4t_{src}_prof": "pppppiiipp"})
    for name, (c, cl, bs, src) in cs.items():
        nb, slot = c.shape
        out = torch.empty((nb, bs), dtype=torch.uint8, device=dev)
        out_len = torch.empty(nb, dtype=torch.int32, device=dev)
        err = torch.empty(nb, dtype=torch.bool, device=dev)
        pr = torch.zeros((nb, NACC), dtype=torch.int64, device=dev)
        _build.check(getattr(libs[src], f"lz4t_{src}_prof")(
            c.data_ptr(), cl.data_ptr(), out.data_ptr(), out_len.data_ptr(),
            err.data_ptr(), nb, slot, bs, pr.data_ptr(), stream),
            f"{src}_prof")
        torch.cuda.synchronize(dev)
        want = decode(c, cl, bs, src)()
        same = all(torch.equal(a, b) for a, b in zip((out, out_len, err),
                                                     want))
        p = pr.double().mean(0)
        seqs = p[2] + p[4]
        geom = "K6's ring" if bs > 65536 else (
            "K5's small whole block" if src == "decode_v6" and bs <= 16384
            else "whole block")
        key = "K1" if src == "decode_v7" else "K5"
        print(f"{key} {name} ({nb} blocks, {geom}, equal {same}): a block, "
              f"the walking warp's cycles: the walk {float(p[7]):.0f}; "
              f"batches {float(p[0]):.0f} ({float(p[1]):.1f} batches, "
              f"{float(p[2] / p[1].clamp(min=1)):.1f} sequences a batch, "
              f"{float(p[0] / p[2].clamp(min=1)):.1f} cycles a sequence); "
              f"the general walk {float(p[3]):.0f} ({float(p[4]):.1f} "
              f"sequences, {float(p[3] / p[4].clamp(min=1)):.0f} cycles "
              f"each); the last flush {float(p[5]):.0f}; the CTA's row "
              f"write {float(p[6]):.0f}; {float(seqs):.1f} sequences a "
              f"block, {float(p[7] / seqs.clamp(min=1)):.1f} cycles a "
              f"sequence; the longest walk {int(pr[:, 7].max())}; in the "
              f"batch calls: the command and window pass {float(p[8]):.0f}, "
              f"the lookups, scan and checks {float(p[9]):.0f}, literals and "
              f"independent matches {float(p[10]):.0f}, the waves "
              f"{float(p[11]):.0f}", flush=True)


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--variants", nargs="*", default=[],
                   choices=sorted(VARIANTS))
    p.add_argument("--parent")
    p.add_argument("--store", type=int, default=0)
    p.add_argument("--device-time", action="store_true",
                   help="time calls captured in a CUDA graph (the card's "
                        "time) instead of calls from Python")
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
    timer = graph_ms if a.device_time else ms
    cs = cells(dev)
    for name, (c, cl, bs, src) in cs.items():
        nbytes = c.shape[0] * bs
        t = timer(decode(c, cl, bs, src), dev)
        key = "K1" if src == "decode_v7" else "K5"
        line = f"{name}: {key} {t:.4f} ms ({nbytes / t / 1e6:.4f} GB/s)"
        if c.shape[0] > 1:
            t = timer(lambda: decompress_blocks_device(c, cl, bs), dev)
            line += f", the decode kernel path {t:.4f} ms"
        print(line, flush=True)
    if a.profile:
        profile(cs, dev, _build.stream(dev))
    others = [(v, VARIANTS[v][0], variant(v)) for v in a.variants]
    if a.parent:
        olds = {src: parent(a.parent, src) for src in MODS}
        others += [(f"parent {src}", src, lib) for src, lib in olds.items()]
    if a.store:
        from __graft_entry__ import _synth_corpus
        data = _synth_corpus(STORE_REQUESTS * 65536, seed=1234)
        data4 = _synth_corpus(STORE4_REQUESTS * 4096)

        def own():
            return store_median(data, dev, 65536, STORE_REQUESTS, 3)

        def own4():
            return store_median(data4, dev, 4096, STORE4_REQUESTS)
        K5.launches = 0
        own4()
        print(f"ProxyStore.write of 4096 bytes: {K5.launches} K5 launches "
              f"in {STORE4_REQUESTS} writes", flush=True)
        for r in range(a.store):
            for what, fn, key, src in (
                    ("65536 bytes at depth 3", own, "K1", "decode_v7"),
                    ("4096 bytes", own4, "K5", "decode_v6")):
                old = with_lib(MODS[src], olds[src], fn)
                t = [f() for f in (fn, old, old, fn)]
                n = STORE_REQUESTS if key == "K1" else STORE4_REQUESTS
                print(f"ProxyStore.write of {what}, the median of {n}, "
                      f"round {r + 1} in turns (this, parent, parent, "
                      f"this): this {t[0]:.4f} {t[3]:.4f} ms, with the "
                      f"parent's {key} {t[1]:.4f} {t[2]:.4f} ms",
                      flush=True)
    differ = []
    for label, vsrc, lib in others:
        for name, (c, cl, bs, src) in cs.items():
            if src != vsrc:
                continue
            fn = decode(c, cl, bs, src)
            other = with_lib(MODS[src], lib, fn)
            ok = all(torch.equal(x, y) for x, y in zip(other(), fn()))
            this, that = in_turns(fn, other, dev, timer)
            print(f"{label} on {name} in turns (this, variant, variant, "
                  f"this): this {this:.4f} ms, variant {that:.4f} ms "
                  f"({that / this:.4f}x); equal: {ok}", flush=True)
            if not ok:
                differ.append(f"{label} on {name}")
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())

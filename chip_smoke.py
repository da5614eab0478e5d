"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Builds the four CUDA kernels of the 64 KiB compress -> verify ->
decompress path from ``lz4_sgori_torch/csrc`` and then, on a 32 MiB
synthetic corpus (``__graft_entry__._synth_corpus``, seed 42, 512 blocks
of 64 KiB, held on the card):

1. compares each kernel with its plain PyTorch version on the same
   inputs (a 32-block subset, exactly: the outputs are bytes);
2. compares the port's bytes with the golden seg contract and its
   decode with golden.decompress on 16 blocks;
3. drives ``lz4_sgori_torch.compress`` / ``decompress`` over the corpus
   with every launch counter reset just before, and requires the round
   trip, zero host fallbacks, a launch of every kernel, and every block
   decoding under the native C++ decoder (and liblz4 where present);
4. decodes about 1024 corrupted blocks through the decode kernel and
   requires golden.decompress's verdict for each;
5. times the kernel path and each kernel against its plain version with
   CUDA events.

Any failure exits non-zero with no result line. It needs a CUDA card
and the repository beside it; it imports nothing of JAX. The last two
lines are the per-kernel JSON record and the device JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BLOCK = 65536
CORPUS_BYTES = 32 << 20
SUBSET = 32
GOLDEN_BLOCKS = 16
MUTANTS = 1024
# TPU record of the same bytes (BENCH_r05.json, engine seg): the bytes
# are device-independent, so the port should reproduce them
TPU_RECORD = {"ratio": 2.661, "size_vs_lz4": 0.9906}

KERNELS = [
    ("K1 decode_v7", "decode_v7",
     "lz4_sgori_tpu/ops/pallas/lockstep_v7.py:209"),
    ("K2 cand", "cand", "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:398"),
    ("K3 parse_seg", "parse_seg",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("K4 asm_seg", "asm_seg", "lz4_sgori_tpu/ops/pallas/asm_seg.py:56"),
]


def _mutate(b: bytearray, rng) -> bytes:
    mode = rng.integers(0, 6)
    if mode == 0 and len(b) > 2:              # flip a random byte
        i = int(rng.integers(0, len(b)))
        b[i] ^= int(rng.integers(1, 256))
    elif mode == 1 and len(b) > 1:             # truncate
        b = b[:int(rng.integers(1, len(b)))]
    elif mode == 2:                            # huge literal length chain
        b = bytearray([0xF0]) + b"\xff" * int(rng.integers(4, 64)) + b
    elif mode == 3 and len(b) > 4:             # zero an offset
        b[3] = b[4] = 0
    elif mode == 4 and len(b) > 4:             # offset beyond the output
        b[3] = b[4] = 0xFF
    else:                                      # garbage tail
        b = b + bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    return bytes(b)


def make_mutants(bases, rng, count: int, slot: int) -> list[bytes]:
    """``count`` corrupted streams made from ``bases`` (single-point
    mutations, bit flips, LSIC injection, splices, pure noise, offset
    surgery), each clipped to ``slot`` bytes and non-empty."""
    muts = []
    while len(muts) < count:
        base = bytearray(bases[int(rng.integers(0, len(bases)))])
        mode = int(rng.integers(0, 10))
        if mode < 5:
            m = _mutate(base, rng)
        elif mode == 5 and len(base) > 1:      # single bit flip
            i = int(rng.integers(0, len(base)))
            base[i] ^= 1 << int(rng.integers(0, 8))
            m = bytes(base)
        elif mode == 6 and len(base) > 8:      # mid-stream LSIC injection
            i = int(rng.integers(1, len(base) - 1))
            m = bytes(base[:i]) + b"\xff" * int(rng.integers(1, 32)) \
                + bytes(base[i:])
        elif mode == 7:                        # splice two streams
            other = bases[int(rng.integers(0, len(bases)))]
            i = int(rng.integers(0, len(base)))
            j = int(rng.integers(0, len(other)))
            m = bytes(base[:i]) + bytes(other[j:])
        elif mode == 8:                        # pure noise
            m = bytes(rng.integers(0, 256, size=int(rng.integers(1, 512)),
                                   dtype=np.uint8))
        else:                                  # offset surgery mid-stream
            i = int(rng.integers(0, max(1, len(base) - 2)))
            base[i:i + 2] = int(rng.integers(0, 65536)).to_bytes(2, "little")
            m = bytes(base)
        muts.append((m or b"\x00")[:slot])
    return muts


def _run(cmd) -> str:
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (p.stdout.strip() or p.stderr.strip()) or f"rc {p.returncode}"


class Failed(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "lz4_sgori_torch")):
        print("chip_smoke: the lz4_sgori_torch package is missing beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    try:
        return _smoke(torch)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def _smoke(torch) -> int:
    import lz4_sgori_torch
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch.ops import seg as S
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.ops.kernels import _build
    from lz4_sgori_torch.ops.kernels import asm_seg as K4
    from lz4_sgori_torch.ops.kernels import cand as K2
    from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
    from lz4_sgori_torch.ops.kernels import parse_seg as K3
    from lz4_sgori_tpu import format as F
    from lz4_sgori_tpu import golden, native
    from lz4_sgori_tpu.utils import oracle
    from lz4_sgori_tpu.utils.stats import Stats

    mods = {"decode_v7": K1, "cand": K2, "parse_seg": K3, "asm_seg": K4}
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton_v}")
    print(f"nvcc: {_run([_build.nvcc_path(), '--version']).splitlines()[-1]}")

    t0 = time.perf_counter()
    for m in mods.values():
        m.load_kernel()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          + ", ".join(f"{k} {v:.1f} s" for k, v in
                      _build.build_seconds.items()))
    for k, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"ptxas {k}: {line.strip()}")

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps):
        fn()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        sync()
        return a.elapsed_time(b) / reps

    def maxdiff(x, y):
        if x.numel() == 0:
            return 0
        return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())

    # ---- corpus, held on the card ----
    t0 = time.perf_counter()
    data = _synth_corpus(CORPUS_BYTES)
    raw_np, rlen_np = B.split_blocks(data, BLOCK)
    raw = torch.from_numpy(raw_np).to(dev)
    rlen = torch.from_numpy(rlen_np).to(dev)
    nb = raw.shape[0]
    print(f"corpus: {len(data)} bytes, {nb} blocks of {BLOCK} "
          f"({time.perf_counter() - t0:.1f} s to make)")

    # ---- phase 1: each kernel against its plain version (subset) ----
    t0 = time.perf_counter()
    sub = torch.arange(0, nb, nb // SUBSET, device=dev)[:SUBSET]
    rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
    c_k = K2.dense_candidates(rs, ls)
    c_p = K2.dense_candidates_plain(rs, ls)
    err2 = maxdiff(c_k, c_p)
    need(err2 == 0, f"K2 differs from its plain version by {err2}")

    pk = K3.parse_segments(rs, c_k, ls)
    pp = K3.parse_segments_plain(rs, c_k, ls)
    need(torch.equal(pk[2], pp[2]), "K3 err differs from its plain version")
    ok = pk[2] == 0
    err3 = max(maxdiff(a[ok], b[ok]) for a, b in zip(pk[1:], pp[1:]))
    scap = pk[0].shape[1]
    smask = (torch.arange(scap, device=dev)[None, :] < pk[1][:, None]) \
        & ok[:, None]
    err3 = max(err3, maxdiff(pk[0][smask], pp[0][smask]))
    need(err3 == 0, f"K3 differs from its plain version by {err3}")

    nseg = BLOCK // 4096
    shp = (SUBSET, nseg)
    le = pk[3].reshape(shp).to(torch.int64)
    hdr, hlen = S.run_headers(pk[5].reshape(shp), pk[6].reshape(shp), le,
                              ls, BLOCK)
    plan = S.assembly_plan(pk[1].reshape(shp), hlen, le, ls, 4096)
    ocap = F.compress_bound(BLOCK) + 8
    a_k = K4.assemble_segments(pk[0], hdr, rs, plan, ocap)
    a_p = K4.assemble_segments_plain(pk[0], hdr, rs, plan, ocap)
    err4 = max(maxdiff(a_k[0], a_p[0]), maxdiff(a_k[1], a_p[1]))
    need(err4 == 0, f"K4 differs from its plain version by {err4}")

    comp_s, clen_s = a_k[0], a_k[1]
    d_k = K1.decompress_blocks_v7(comp_s, clen_s, BLOCK)
    d_p = K1.decompress_blocks_plain(comp_s, clen_s, BLOCK)
    err1 = max(maxdiff(x, y) for x, y in zip(d_k, d_p))
    need(err1 == 0, f"K1 differs from its plain version by {err1}")
    need(not bool(d_k[2].any()), "K1 rejected a subset block")
    print(f"phase kernels == plain: ok on {SUBSET} blocks, plain versions "
          f"on the card ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 2: golden contract on 16 blocks ----
    t0 = time.perf_counter()
    gsel = np.linspace(0, nb - 1, GOLDEN_BLOCKS).astype(np.int64)
    gi = torch.from_numpy(gsel).to(dev)
    gcomp, gclen = compress_blocks_device(raw[gi], rlen[gi], BLOCK)
    gout, glen, gerr = decompress_blocks_device(gcomp, gclen, BLOCK)
    gcomp, gclen = gcomp.cpu().numpy(), gclen.cpu().numpy()
    gout, glen, gerr = gout.cpu().numpy(), glen.cpu().numpy(), \
        gerr.cpu().numpy()
    for j, b in enumerate(gsel):
        blk = raw_np[b, :rlen_np[b]].tobytes()
        got = gcomp[j, :gclen[j]].tobytes()
        need(got == golden.compress_dense_seg(blk, 4096, 65536, 16),
             f"block {b}: bytes differ from golden.compress_dense_seg")
        want = golden.decompress(got, BLOCK)
        need(not gerr[j] and glen[j] == len(want)
             and gout[j, :glen[j]].tobytes() == want,
             f"block {b}: decode differs from golden.decompress")
    print(f"phase golden: ok on {GOLDEN_BLOCKS} blocks "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3: the main path, counters reset just before ----
    for m in mods.values():
        m.launches = 0
    stats = Stats()
    sync()
    t0 = time.perf_counter()
    container = lz4_sgori_torch.compress(data, BLOCK, stats=stats,
                                         device="cuda")
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = lz4_sgori_torch.decompress(container, stats=stats, device="cuda")
    t_dec = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    need(back == data, "main path round trip differs")
    need(stats.encode_fallbacks == 0,
         f"{stats.encode_fallbacks} host fallbacks on the main path")
    for k, c in counts.items():
        need(c > 0, f"kernel {k} was not launched on the main path")
    cb = B.CompressedBlocks.from_container(container)
    need(native.available(), "the native codec did not build (g++?)")
    lz_native = 0
    for j in range(nb):
        blk = raw_np[j, :rlen_np[j]].tobytes()
        c = cb.comp[j, :cb.comp_len[j]].tobytes()
        need(native.decompress(c, BLOCK) == blk,
             f"block {j} fails the native decoder")
        if oracle.available():
            need(oracle.decompress(c, BLOCK) == blk,
                 f"block {j} fails liblz4")
        lz_native += len(native.compress(blk))
    ratio = len(data) / cb.compressed_size
    vs_lz4 = cb.compressed_size / lz_native
    print(f"main path: round trip ok, host fallbacks 0, launches {counts}")
    print(f"main path: native decode ok, liblz4 decode "
          f"{'ok' if oracle.available() else 'not run (liblz4 absent)'}")
    print(f"main path: ratio {ratio:.4f}, size {vs_lz4:.4f}x native "
          f"LZ4_compress_default (TPU record of the same bytes: ratio "
          f"{TPU_RECORD['ratio']}, {TPU_RECORD['size_vs_lz4']}x)")
    print(f"main path wall: compress {t_enc:.3f} s "
          f"({len(data) / t_enc / 1e9:.4f} GB/s), decompress {t_dec:.3f} s "
          f"({len(data) / t_dec / 1e9:.4f} GB/s), host framing included")

    # ---- phase 4: malformed decode, K1 against golden's verdict ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(1234)
    bases = [cb.comp[j, :cb.comp_len[j]].tobytes()
             for j in range(0, nb, nb // 32)]
    muts = make_mutants(bases, rng, MUTANTS, ocap - 8)
    mc = np.zeros((len(muts), ocap), np.uint8)
    ml = np.zeros(len(muts), np.int32)
    for j, m in enumerate(muts):
        mc[j, :len(m)] = np.frombuffer(m, np.uint8)
        ml[j] = len(m)
    mo, mlen, merr = K1.decompress_blocks_v7(
        torch.from_numpy(mc).to(dev), torch.from_numpy(ml).to(dev), BLOCK)
    mo, mlen, merr = mo.cpu().numpy(), mlen.cpu().numpy(), merr.cpu().numpy()
    n_err = 0
    for j, m in enumerate(muts):
        try:
            want = golden.decompress(m, BLOCK)
        except golden.DecodeError:
            want = None
        need(bool(merr[j]) == (want is None),
             f"mutant {j}: err {bool(merr[j])} vs golden {want is None}")
        if want is None:
            n_err += 1
        else:
            need(mlen[j] == len(want) and mo[j, :len(want)].tobytes() == want,
                 f"mutant {j}: bytes differ from golden")
    print(f"phase malformed: {len(muts)} mutants, {n_err} rejected, err == "
          f"golden for all ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 5: times ----
    ms_enc = time_ms(lambda: compress_blocks_device(raw, rlen, BLOCK), 5)
    fcomp, fclen = compress_blocks_device(raw, rlen, BLOCK)
    ms_dec = time_ms(lambda: decompress_blocks_device(fcomp, fclen, BLOCK),
                     5)
    print(f"[{card}] kernel path over the corpus: encode {ms_enc:.3f} ms "
          f"({len(data) / ms_enc / 1e6:.4f} GB/s), decode {ms_dec:.3f} ms "
          f"({len(data) / ms_dec / 1e6:.4f} GB/s)")
    fc = K2.dense_candidates(raw, rlen)
    full = {
        "cand": time_ms(lambda: K2.dense_candidates(raw, rlen), 5),
        "parse_seg": time_ms(lambda: K3.parse_segments(raw, fc, rlen), 5),
        "decode_v7": ms_dec,
    }
    print(f"[{card}] kernels over the corpus (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in full.items()))
    sub_times = {
        "cand": (time_ms(lambda: K2.dense_candidates(rs, ls), 10),
                 time_ms(lambda: K2.dense_candidates_plain(rs, ls), 3)),
        "parse_seg": (time_ms(lambda: K3.parse_segments(rs, c_k, ls), 10),
                      time_ms(lambda: K3.parse_segments_plain(rs, c_k, ls),
                              1)),
        "asm_seg": (time_ms(lambda: K4.assemble_segments(
            pk[0], hdr, rs, plan, ocap), 10),
            time_ms(lambda: K4.assemble_segments_plain(
                pk[0], hdr, rs, plan, ocap), 3)),
        "decode_v7": (time_ms(lambda: K1.decompress_blocks_v7(
            comp_s, clen_s, BLOCK), 10),
            time_ms(lambda: K1.decompress_blocks_plain(
                comp_s, clen_s, BLOCK), 1)),
    }
    for k, (a, b) in sub_times.items():
        print(f"[{card}] {k} on {SUBSET} blocks: kernel {a:.4f} ms, "
              f"plain {b:.4f} ms")
    errs = {"decode_v7": err1, "cand": err2, "parse_seg": err3,
            "asm_seg": err4}
    record = {"kernels": [
        {"name": label, "route": "cuda",
         "source": f"lz4_sgori_torch/csrc/{key}.cu", "replaces": where,
         "launches": counts[key], "max_abs_err": errs[key],
         "ms": sub_times[key][0], "plain_ms": sub_times[key][1]}
        for label, key, where in KERNELS]}
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

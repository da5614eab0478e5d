"""The kernels of the twenty-seven CUDA sources (K1-K7, K9, K8's gaps,
K8-seg and K8-enc3, K10's mcode, K10b and K10c, the retired engines
T1-T3, and the probes T4-T15, T6 and T7, T9 and T10, T11 and T12 sharing
a source each, T14a's 15 bodies and T14b's 5 readings two: 11 bodies
on ``probe_harness``; ``ohbuild``, the five tensor-core readings,
``transpose``, ``shiftsel`` and ``red1`` on ``probe_harness_wg``)
against their plain PyTorch versions and their golden oracles, on the
card; K6's rings on ``chip_smoke.crafted_streams`` and K8-enc3's warp
parse on the blocks of ``test_torch_warp_parse`` (``-k "ring or warp"``);
K2's split table at 4, 8 and 64 KiB and K3's warp walk at 16 and 64 KiB
and 1 MiB, acceleration 1 and 8 (``-k "k2 or k3"``); K9's runs of
half-pieces (a zero and a short block, a single block and 128, piece
4096, the run length) and K8-seg's warp walk at 16 and 64 KiB and 1 MiB,
acceleration 1 and 8, window 65536 and 4096 (``-k "k9 or k8_seg"``);
K1 at 16 and 64 KiB (the whole block in shared memory) and 128 KiB
(K6's ring) on mutants and the crafted streams, and K7's warp walk at 4
KiB, 5,000 bytes, 60,000 and 64 KiB, acceleration 1 and 8 (``-k "k1 or
k7"``); K5's small geometries at 4, 8 and 12 KiB and K6's ring at 256 KiB
on mutants and the crafted streams, a launch a block and 4,096 blocks,
and K4's words on random plans (nseg 1 and 128, totals past the
capacity) and the seg_big engine's pieces at 1 and 4 MiB (``-k "k4 or
k5"``); the gaps' four chains a thread and K10a's shared rows on
``chip_smoke``'s hand-made tapes at block sizes 1 to 4 MiB (K9's half
at 1 and 4 MiB), 70,000 blocks of 16 bytes and tapes off the 16-byte
grid (``-k "gaps or k10a"``); and the xla engine (PyTorch tensor ops,
no kernel of its own) on CUDA tensors against its CPU bytes, its decode
on the card against K1's (``-k xla``); and ``parallel``'s write pipeline
and assembly on a process group of one rank over NCCL against the
unsharded port (``-k parallel``). Marked ``cuda``; each test skips
itself when no card is present.
Run on a CUDA machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (crafted_streams, hand_gaps_tape, hand_mcode_case,
                        k5_stage, make_mutants)
from lz4_sgori_torch.ops import seg as S
from lz4_sgori_torch.ops.decode import decompress_blocks_device
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.ops.kernels import asm_seg as K4
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
from lz4_sgori_torch.ops.kernels import gaps as G
from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
from lz4_sgori_torch.ops.kernels import mcode as M
from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
from lz4_sgori_torch.ops.kernels import parse_enc3_deep as K8E
from lz4_sgori_torch.ops.kernels import parse_enc3_mlen as K10C
from lz4_sgori_torch.ops.kernels import parse_seg as K3
from lz4_sgori_torch.ops.kernels import parse_seg_deep as K8S
from lz4_sgori_torch.ops.kernels import parse_seg_mlen as K10B
from lz4_sgori_torch.probes import dma_probe as P5
from lz4_sgori_torch.probes import microbench2 as P15
from lz4_sgori_torch.probes import microbench3 as P3
from lz4_sgori_torch.probes import microbench4 as P78
from lz4_sgori_torch.probes import microbench6 as P6
from lz4_sgori_torch.probes import sort_probe as P4
from lz4_sgori_torch.retired import decode_kernel as T2
from lz4_sgori_torch.retired import encode_kernel as T1
from lz4_sgori_torch.retired import lockstep_v9 as T3
from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden, native
from lz4_sgori_tpu.utils import oracle
from test_torch_asm_words import random_case
from test_torch_seg_big import big_blocks
from test_torch_warp_parse import _inputs as warp_inputs

pytestmark = pytest.mark.cuda

LOREM = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed "
         b"do eiusmod tempor incididunt ut labore et dolore magna aliqua. ")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(bs, seed=42):
    rng = np.random.default_rng(seed)
    return [
        (LOREM * (bs // 64))[:bs],
        bytes(bs // 4) + rng.integers(0, 256, bs // 2,
                                      dtype=np.uint8).tobytes()
        + (b"ab" * bs)[:bs // 4],
        rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),
        (LOREM * 3)[:300], b"", b"abcabcabcabcabcabc", b"aaaaaaaaaaaa",
        bytes(bs), (b"x" * 4095 + b"Q") * (bs // 4096),
        (LOREM * (bs // 64))[:bs - 4096 - 77],
    ]


def _batch(blocks, bs, dev):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw).to(dev), torch.from_numpy(rlen).to(dev)


@pytest.mark.parametrize("bs", [4096, 8192, 65536])
def test_k2_candidates(dev, bs):
    """The split table at 4, 8 and 64 KiB, on the zero, random and short
    blocks of ``_blocks`` and a 5,000-byte one; at 4 KiB also 300 blocks,
    so that each CTA takes several in turn."""
    blocks = [b[:bs] for b in _blocks(bs) + [(LOREM * 100)[:5000]]]
    if bs == 4096:
        blocks = blocks * 30
    raw, rlen = _batch(blocks, bs, dev)
    got = K2.dense_candidates(raw, rlen)
    torch.cuda.synchronize()
    assert torch.equal(got, K2.dense_candidates_plain(raw, rlen))
    got = got.cpu().numpy()
    for j in (0, 1, 3, 5, 8):
        b = blocks[j]
        want = np.zeros(bs, np.int64)
        want[:len(b)] = golden.dense_candidates(b, 16, val16_filter=False)
        assert np.array_equal(got[j], want), j


@pytest.mark.parametrize("bs,seg,accel", [(16384, 4096, 1),
                                          (65536, 4096, 1),
                                          (65536, 4096, 8),
                                          (1 << 20, 8192, 1),
                                          (1 << 20, 8192, 8)])
def test_k3_parse(dev, bs, seg, accel):
    """The warp walk against its plain version (all seven outputs where
    err is 0) and, up to 64 KiB at acceleration 1, against golden."""
    blocks = _blocks(bs)
    if bs > 65536:
        blocks = blocks[:3] + blocks[7:]
    raw, rlen = _batch(blocks, bs, dev)
    cand = (K9.dense_candidates_piecewise(raw, rlen) if bs > 65536
            else K2.dense_candidates(raw, rlen))
    got = K3.parse_segments(raw, cand, rlen, seg=seg, accel=accel)
    want = K3.parse_segments_plain(raw, cand, rlen, seg=seg, accel=accel)
    torch.cuda.synchronize()
    assert not got[2].any() and not want[2].any()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    streams, slen = got[0].cpu().numpy(), got[1].cpu().numpy()
    wstreams = want[0].cpu().numpy()
    for r in range(len(slen)):
        assert np.array_equal(streams[r, :slen[r]], wstreams[r, :slen[r]]), r
    if bs > 65536 or accel != 1:
        return
    nseg = bs // seg
    for j, b in enumerate(blocks):
        for k, pt in enumerate(golden.compress_dense_seg_parts(b, seg)):
            r = j * nseg + k
            assert streams[r, :slen[r]].tobytes() == pt["stream"], (j, k)
            assert int(got[3][r]) == pt["last_end"], (j, k)


@pytest.mark.parametrize("nb,nseg,scap,hmax,bs,ocap", [
    (17, 1, 300, 20, 600, 401),          # nseg 1, every row alignment
    (5, 128, 40, 6, 4096, 6001),         # nseg 128, most words span pieces
    (3, 128, 600, 300, 65536, 40001),    # words inside long pieces
    (4, 16, 200, 30, 4096, 777),         # totals past ocap
])
def test_k4_words(dev, nb, nseg, scap, hmax, bs, ocap):
    """K4 on random plans against its plain version (all of ``out`` and
    ``out_len``): empty pieces, words fed by three pieces and more,
    pieces that cross an 8 KiB chunk, totals past ``ocap``, rows at every
    16-byte alignment."""
    t = [a.to(dev) for a in random_case(nb * 1000 + nseg, nb, nseg, scap,
                                        hmax, bs)]
    out, out_len = K4.assemble_segments(*t, ocap)
    pout, plen = K4.assemble_segments_plain(*t, ocap)
    torch.cuda.synchronize()
    assert torch.equal(out_len, plen) and torch.equal(out, pout)
    if ocap == 777:
        assert bool((plen > ocap).any())


@pytest.mark.parametrize("bs,seg", [(1 << 20, 8192), (4 << 20, 32768)])
def test_k4_big_blocks(dev, bs, seg):
    """K4 on the seg_big engine's pieces of corpus text and a random
    block (``seg.assembly_inputs``) at 1 MiB, seg 8192, and 4 MiB, seg
    32768, against its plain version; and the engine's blocks decode back
    (K6)."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
    blocks = [_synth_corpus(bs), np.random.default_rng(3).integers(
        0, 256, bs, dtype=np.uint8).tobytes()]
    raw, rlen = _batch(blocks, bs, dev)
    args = S.assembly_inputs(raw, rlen, bs, seg=seg)[:5]
    got = K4.assemble_segments(*args)
    want = K4.assemble_segments_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    comp, clen, err, _ = S.compress_blocks_seg(raw, rlen, bs, seg=seg)
    assert not err.any()
    out, out_len, derr = K6.decompress_blocks_v8(comp, clen, bs)
    assert not derr.any() and torch.equal(out, raw)


def test_k4_assembly_and_engine_bytes(dev):
    rng = np.random.default_rng(9)
    nb, nseg, scap, hmax, bs = 3, 4, 40, 12, 96
    args = [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((nb * nseg, scap), (nb * nseg, hmax), (nb, bs))]
    plan = np.stack([rng.integers(0, scap + 1, (nb, nseg)),
                     rng.integers(0, hmax + 1, (nb, nseg)),
                     rng.integers(0, bs // 2, (nb, nseg)),
                     rng.integers(0, bs // 2, (nb, nseg))],
                    axis=2).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (*args, plan)]
    out, out_len = K4.assemble_segments(*t, 200)
    pout, plen = K4.assemble_segments_plain(*t, 200)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(out_len, plen)

    bs = 65536
    blocks = _blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    comp, clen, err, _ = S.compress_blocks_seg(raw, rlen, bs)
    assert not err.any()
    comp, clen = comp.cpu().numpy(), clen.cpu().numpy()
    for j, b in enumerate(blocks):
        assert comp[j, :clen[j]].tobytes() == \
            golden.compress_dense_seg(b, 4096, 65536, 16), j
        assert not comp[j, clen[j]:].any(), j


@pytest.mark.parametrize("bs", [16384, 65536, 131072])
def test_k1_decode_and_mutants(dev, bs):
    """K1 at 16 and 64 KiB (the whole block in shared memory) and 128 KiB
    (K6's ring) on golden's streams of ``_blocks``, 256 mutants of them
    and the crafted streams (``crafted_streams``: stage bounds, far and
    overlapping offsets, each error late in a long stream, clen ==
    slot), against the plain decoder and golden.decompress."""
    bases = [golden.compress(b[:bs]) for b in _blocks(bs)]
    rng = np.random.default_rng(77)
    slot = F.compress_bound(bs) + 8
    payloads = bases + make_mutants(bases, rng, 256, slot - 8) + [
        s for _, s in crafted_streams(bs)]
    comp = np.zeros((len(payloads), slot), np.uint8)
    clen = np.zeros(len(payloads), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    ct, lt = torch.from_numpy(comp).to(dev), torch.from_numpy(clen).to(dev)
    out, out_len, err = K1.decompress_blocks_v7(ct, lt, bs)
    pout, plen, perr = K1.decompress_blocks_plain(ct, lt, bs)
    torch.cuda.synchronize()
    assert torch.equal(err, perr) and torch.equal(out_len, plen)
    assert torch.equal(out, pout)
    out, out_len, err = out.cpu().numpy(), out_len.cpu().numpy(), \
        err.cpu().numpy()
    for j, c in enumerate(payloads):
        try:
            want = golden.decompress(c, bs)
        except golden.DecodeError:
            want = None
        assert bool(err[j]) == (want is None), j
        if want is not None:
            assert out[j, :out_len[j]].tobytes() == want, j


def test_slice_runs_every_kernel(dev):
    import lz4_sgori_torch
    from lz4_sgori_torch.utils.stats import Stats
    data = b"".join(_blocks(65536)[:4]) * 2
    for m in (K1, K2, K3, K4):
        m.launches = 0
    stats = Stats()
    container = lz4_sgori_torch.compress(data, 65536, stats=stats)
    assert lz4_sgori_torch.decompress(container) == data
    assert stats.encode_fallbacks == 0
    assert min(m.launches for m in (K1, K2, K3, K4)) > 0


@pytest.mark.parametrize("bs,accel", [(4096, 1), (4096, 8), (5000, 1),
                                      (5000, 8), (60000, 1), (65536, 1),
                                      (65536, 8)])
def test_k7_parse(dev, bs, accel):
    """K7's warp walk on ``_blocks`` (text, zeros, random bytes, short
    blocks, blocks under 13 bytes) and 5,000-byte corpus text, against
    its plain version (all five outputs) and golden.compress_dense with
    its tail; at 4 KiB 308 blocks, many CTAs an SM."""
    blocks = [b[:bs] for b in _blocks(max(bs, 8192))] + [
        b"", b"a", b"x" * 13, (LOREM * 100)[:5000][:bs]]
    if bs == 4096:
        blocks = blocks * 22
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    got = K7.parse_blocks_enc3(raw, cand, rlen, accel)
    want = K7.parse_blocks_enc3_plain(raw, cand, rlen, accel)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, out_len, err, tails, _ = (t.cpu().numpy() for t in got)
    assert not err.any()
    for j, b in enumerate(blocks[:14]):
        w = golden.compress_dense(b, accel, hashlog=16)
        assert out[j, :out_len[j]].tobytes() == w, j
        assert not out[j, out_len[j]:].any(), j
        assert int(tails[j]) == golden.tail_offset(w), j


@pytest.mark.parametrize("bs", [4096, 8192, 12288, 262144])
def test_k5_decode_and_mutants(dev, bs):
    """K5 at 4, 8 and 12 KiB (the small whole-block geometries) and 256
    KiB (K6's ring) on golden's streams of ``_blocks``, 128 mutants of
    them and the crafted streams (LSIC runs over the geometry's stage
    bounds, overlapping and far offsets, each error late in a long
    stream, clen == slot), against the plain decoder and
    golden.decompress; then the first 24 streams again, a launch each."""
    bases = [golden.compress(b[:bs]) for b in _blocks(bs)]
    rng = np.random.default_rng(55)
    slot = F.compress_bound(bs) + 8
    payloads = bases + make_mutants(bases, rng, 128, slot - 8) + [
        s for _, s in crafted_streams(bs, stage=k5_stage(bs))]
    comp = np.zeros((len(payloads), slot), np.uint8)
    clen = np.zeros(len(payloads), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    ct, lt = torch.from_numpy(comp).to(dev), torch.from_numpy(clen).to(dev)
    out, out_len, err = K5.decompress_blocks_v6(ct, lt, bs)
    pout, plen, perr = K1.decompress_blocks_plain(ct, lt, bs)
    torch.cuda.synchronize()
    assert torch.equal(err, perr) and torch.equal(out_len, plen)
    assert torch.equal(out, pout)
    for j in range(24):
        one = K5.decompress_blocks_v6(ct[j:j + 1].contiguous(),
                                      lt[j:j + 1].contiguous(), bs)
        for a, b in zip(one, (pout, plen, perr)):
            assert torch.equal(a[0], b[j]), j
    out, out_len, err = out.cpu().numpy(), out_len.cpu().numpy(), \
        err.cpu().numpy()
    for j, c in enumerate(payloads):
        try:
            want = golden.decompress(c, bs)
        except golden.DecodeError:
            want = None
        assert bool(err[j]) == (want is None), j
        if want is not None:
            assert out[j, :out_len[j]].tobytes() == want, j


def test_k5_config3_blocks_many_ctas_an_sm(dev):
    """K5 on 4,096 blocks of 4 KiB (the enc3 engine's streams of corpus
    text, many CTAs an SM in turn) against the plain decoder."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch.blocks import split_blocks
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    r, n = split_blocks(_synth_corpus(16 << 20), 4096)
    r, n = torch.from_numpy(r).to(dev), torch.from_numpy(n).to(dev)
    c, cl = compress_blocks_device(r, n, 4096)
    got = K5.decompress_blocks_v6(c, cl, 4096)
    want = K1.decompress_blocks_plain(c, cl, 4096)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], r) and not got[2].any()


def test_block_device_path_runs_k2_k7_k5(dev):
    import lz4_sgori_torch
    from lz4_sgori_torch.utils.stats import Stats
    data = b"".join(b[:4096] for b in _blocks(4096)) * 3
    for m in (K1, K2, K3, K4, K5, K7):
        m.launches = 0
    stats = Stats()
    container = lz4_sgori_torch.compress(data, 4096, stats=stats)
    assert lz4_sgori_torch.decompress(container) == data
    assert stats.encode_fallbacks == 0
    assert min(m.launches for m in (K2, K5, K7)) > 0
    assert K1.launches == K3.launches == K4.launches == 0


@pytest.mark.parametrize("bs", [131072, 1 << 20])
def test_k9_candidates(dev, bs):
    """K9 against its plain version on every case of big_blocks (a zero and
    a short block among them), alone, 128 times over (a CTA a block) and at
    piece 4096, and against golden.dense_candidates_piecewise on the
    corpus block and the period-1,000 block (candidates at a piece's
    position 65,535 and the next half-piece's first positions)."""
    blocks = big_blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    got = K9.dense_candidates_piecewise(raw, rlen)
    torch.cuda.synchronize()
    assert torch.equal(got, K9.dense_candidates_piecewise_plain(raw, rlen))
    for r, l in ((raw[2:3], rlen[2:3]), (raw.repeat(22, 1)[:128],
                                         rlen.repeat(22)[:128])):
        r, l = r.contiguous(), l.contiguous()
        assert torch.equal(K9.dense_candidates_piecewise(r, l),
                           K9.dense_candidates_piecewise_plain(r, l))
    assert torch.equal(K9.dense_candidates_piecewise(raw, rlen, 4096),
                       K9.dense_candidates_piecewise_plain(raw, rlen, 4096))
    got = got.cpu().numpy()
    for j in (0, 4):
        want = np.zeros(bs, np.int64)
        want[:len(blocks[j])] = golden.dense_candidates_piecewise(blocks[j])
        assert np.array_equal(got[j], want), j
    assert got[4, 65535] == 1000


@pytest.mark.parametrize("nb,bs", [(1, 1 << 20), (4, 1 << 20),
                                   (128, 1 << 20), (1, 4 << 20),
                                   (10, 131072)])
def test_k9_run_length_is_the_emulations(dev, nb, bs):
    """The launcher's run length (``cand_part::Runs`` on this card's SMs)
    is the CPU emulation's (``test_torch_cand_piecewise_part.runs``)."""
    from test_torch_cand_piecewise_part import runs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert K9.run_length(nb, bs) == runs(nb, bs, K9.PIECE // 2, sms)[0]


@pytest.mark.parametrize("bs,nmut", [(524288, 64), (4 << 20, 16)])
def test_k6_decode_and_mutants(dev, bs, nmut):
    bases = [native.compress(b) for b in big_blocks(bs)]
    rng = np.random.default_rng(56)
    slot = F.compress_bound(bs) + 8
    payloads = bases + make_mutants(bases, rng, nmut, slot - 8)
    comp = np.zeros((len(payloads), slot), np.uint8)
    clen = np.zeros(len(payloads), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    ct, lt = torch.from_numpy(comp).to(dev), torch.from_numpy(clen).to(dev)
    out, out_len, err = K6.decompress_blocks_v8(ct, lt, bs)
    pout, plen, perr = K1.decompress_blocks_plain(ct, lt, bs)
    torch.cuda.synchronize()
    assert torch.equal(err, perr) and torch.equal(out_len, plen)
    assert torch.equal(out, pout)
    out, out_len, err = out.cpu().numpy(), out_len.cpu().numpy(), \
        err.cpu().numpy()
    for j, c in enumerate(payloads):
        try:
            want = golden.decompress(c, bs)
        except golden.DecodeError:
            want = None
        assert bool(err[j]) == (want is None), j
        if want is not None:
            assert out[j, :out_len[j]].tobytes() == want, j


@pytest.mark.parametrize("bs", [524288, 1 << 20, 4 << 20])
def test_k6_ring_on_crafted_streams(dev, bs):
    """The ring decode on the crafted streams (the rings' wraps, stage
    bounds, each error late in a long stream, clen == slot) and on clen
    0, past slot and negative, against the plain decoder and golden's
    verdicts; the rows start at every alignment when slot % 16 != 0."""
    named = crafted_streams(bs)
    slot = F.compress_bound(bs) + 8
    payloads = [b for _, b in named]
    comp = np.zeros((len(payloads) + 3, slot), np.uint8)
    clen = np.zeros(len(comp), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    comp[-3:] = comp[0]
    clen[-3:] = (0, slot + 1, -5)
    for off in (0, 3):            # a view whose rows start 3 bytes on
        flat = torch.zeros(comp.size + off, dtype=torch.uint8, device=dev)
        flat[off:] = torch.from_numpy(comp.reshape(-1)).to(dev)
        ct = flat[off:].view(comp.shape)
        lt = torch.from_numpy(clen).to(dev)
        got = K6.decompress_blocks_v8(ct, lt, bs)
        want = K1.decompress_blocks_plain(ct, lt, bs)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    err = got[2].cpu().numpy()
    for j, c in enumerate(payloads):
        try:
            golden.decompress(c, bs)
            ok = True
        except golden.DecodeError:
            ok = False
        assert bool(err[j]) != ok, named[j][0]
    assert err[-3:].all()


def test_big_block_path_runs_k9_k3_k4_k6(dev):
    import lz4_sgori_torch
    from lz4_sgori_torch.utils.stats import Stats
    bs = 1 << 20
    data = b"".join(big_blocks(bs)[:4])
    mods = (K1, K2, K3, K4, K5, K6, K7, K9)
    for m in mods:
        m.launches = 0
    stats = Stats()
    container = lz4_sgori_torch.compress(data, bs, stats=stats)
    assert lz4_sgori_torch.decompress(container) == data
    assert stats.encode_fallbacks == 0
    assert min(m.launches for m in (K3, K4, K6, K9)) > 0
    assert K1.launches == K2.launches == K5.launches == K7.launches == 0


@pytest.mark.parametrize("mode", ["gaps", "gaps2", "piecewise"])
def test_gaps_kernel(dev, mode):
    """gaps.cu in its three modes against its plain version, and against
    golden.dense_gaps / dense_gaps2 / dense_candidates_piecewise gaps."""
    bs = (1 << 20) if mode == "piecewise" else 65536
    blocks = big_blocks(bs) if mode == "piecewise" else _blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    if mode == "piecewise":
        cand = K9.dense_candidates_piecewise(raw, rlen)
        args = (2, K9.PIECE // 2)
    else:
        cand = K2.dense_candidates(raw, rlen)
        args = (4 if mode == "gaps2" else 2, 0)
    got = G.chain_gaps(cand, *args)
    want = G.chain_gaps_plain(cand, *args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    tape = (got[1] if mode == "gaps2" else got[0]).cpu().numpy()
    for j in (0, 1, 4):
        b = blocks[j]
        w = (golden.dense_candidates_piecewise(b, with_gaps=True)[1]
             if mode == "piecewise" else
             golden.dense_gaps2(b, 16) if mode == "gaps2" else
             golden.dense_gaps(b, 16))
        assert np.array_equal(tape[j, :len(b)], w) and \
            not tape[j, len(b):].any(), j
    # hand-made tapes of the mode's shape: links of 0, 254, 255, negative,
    # past bs and far, q1 at and below each even half-piece's start
    nb = 1 if mode == "piecewise" else 3
    hand = torch.from_numpy(hand_gaps_tape(nb, bs, args[1], seed=7)).to(dev)
    got = G.chain_gaps(hand, *args)
    want = G.chain_gaps_plain(hand, *args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def _offset_view(t, elems):
    """``t`` copied into a contiguous view that starts ``elems`` elements
    into its storage (rows off the 16-byte grid)."""
    flat = torch.zeros(t.numel() + elems, dtype=t.dtype, device=t.device)
    v = flat[elems:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("bs,nb,half", [
    (1, 9, 0), (5, 9, 0), (4096, 9, 0), (4097, 5, 0), (16384, 4, 0),
    (65536, 3, 0), (1 << 20, 2, 0), (1 << 20, 2, 32768), (4 << 20, 1, 0),
    (4 << 20, 1, 32768), (16, 70000, 0)])
@pytest.mark.parametrize("links", [2, 4])
def test_gaps_kernel_sizes(dev, bs, nb, half, links):
    """The four chains a thread on hand-made tapes: CTAs over (block, 256
    aligned quads) at block sizes 1 to 4 MiB, int4 loads of the quad's
    candidates, K9's floor from one division a quad (half 32768 at 1 and
    4 MiB), 70,000 blocks of 16 bytes (the grid's block index), and a
    tape off the 16-byte grid (element loads); bit for bit against the
    plain version."""
    cand = torch.from_numpy(hand_gaps_tape(nb, bs, half, seed=bs)).to(dev)
    for c in (cand, _offset_view(cand, 1)):
        got = G.chain_gaps(c, links, half)
        want = G.chain_gaps_plain(c, links, half)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (links == 2)
        if links == 4:
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("bs,seg,accel,window", [(16384, 4096, 1, 65536),
                                                (65536, 4096, 8, 4096),
                                                (1 << 20, 8192, 1, 65536),
                                                (1 << 20, 8192, 8, 4096)])
def test_k8_seg_parse(dev, bs, seg, accel, window):
    """The warp walk at three candidates against its plain version (all
    seven outputs where err is 0) and, at 16 KiB, against golden; at 1 MiB
    over K9's tape and its floored gaps."""
    blocks = _blocks(bs)
    if bs > 65536:
        blocks = blocks[:3] + blocks[7:]
    raw, rlen = _batch(blocks, bs, dev)
    big = bs > 65536
    cand = (K9.dense_candidates_piecewise(raw, rlen) if big
            else K2.dense_candidates(raw, rlen))
    gaps, _ = G.chain_gaps(cand, 2, K9.PIECE // 2 if big else 0)
    got = K8S.parse_segments_deep(raw, cand, gaps, rlen, seg, window, accel)
    want = K8S.parse_segments_deep_plain(raw, cand, gaps, rlen, seg, window,
                                         accel)
    torch.cuda.synchronize()
    assert not got[2].any() and not want[2].any()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    streams, slen = got[0].cpu().numpy(), got[1].cpu().numpy()
    wstreams = want[0].cpu().numpy()
    for r in range(len(slen)):
        assert np.array_equal(streams[r, :slen[r]], wstreams[r, :slen[r]]), r
    if bs != 16384:
        return
    nseg = bs // seg
    for j, b in enumerate(blocks):
        for k, pt in enumerate(golden.compress_dense_seg_parts(b, seg,
                                                               depth=3)):
            r = j * nseg + k
            assert streams[r, :slen[r]].tobytes() == pt["stream"], (j, k)


@pytest.mark.parametrize("bs,depth", [(4096, 3), (4096, 5), (16384, 5)])
def test_k8_enc3_parse(dev, bs, depth):
    blocks = [b[:bs] for b in _blocks(max(bs, 8192))] + [b"", b"x" * 13]
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    gaps, gaps2 = G.chain_gaps(cand, 4 if depth == 5 else 2)
    got = K8E.parse_blocks_enc3_deep(raw, cand, gaps, gaps2, rlen,
                                     depth=depth)
    want = K8E.parse_blocks_enc3_deep_plain(raw, cand, gaps, gaps2, rlen,
                                            depth=depth)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, out_len, err, tails, _ = (t.cpu().numpy() for t in got)
    assert not err.any()
    for j, b in enumerate(blocks):
        w = golden.compress_deep(b, depth=depth)
        assert out[j, :out_len[j]].tobytes() == w, j
        assert int(tails[j]) == golden.tail_offset(w), j


@pytest.mark.parametrize("bs,depth,accel", [
    (4096, 3, 8), (4096, 5, 1), (4096, 5, 8), (65536, 3, 1), (65536, 3, 8),
    (65536, 5, 8)])
def test_k8_enc3_warp_parse(dev, bs, depth, accel):
    """The warp parse on the emulation's blocks (corpus text, chains with
    long gaps, a motif, zeros, random bytes, a short block, the preview
    cap's block) against its plain version, all five outputs."""
    raw, cand, gaps, gaps2, rlen = (t.to(dev) if t is not None else None
                                    for t in warp_inputs(bs, depth))
    got = K8E.parse_blocks_enc3_deep(raw, cand, gaps, gaps2, rlen,
                                     accel=accel, depth=depth)
    want = K8E.parse_blocks_enc3_deep_plain(raw, cand, gaps, gaps2, rlen,
                                            accel=accel, depth=depth)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not got[2].any()


def test_deep_paths_run_gaps_and_k8(dev):
    """Depth 3 at 64 KiB runs K2, gaps, K8-seg and K4 (not K3); depth 5 at
    4 KiB runs K2, gaps and K8-enc3 (not K7)."""
    import lz4_sgori_torch
    from lz4_sgori_torch.utils.stats import Stats
    mods = (K1, K2, K3, K4, K5, K7, K9, G, K8S, K8E)
    for bs, depth, used, idle in [
            (65536, 3, (K2, G, K8S, K4, K1), (K3, K7, K8E, K9)),
            (4096, 5, (K2, G, K8E, K5), (K3, K4, K7, K8S, K9))]:
        data = b"".join(b[:bs] for b in _blocks(bs)) * 2
        for m in mods:
            m.launches = 0
        stats = Stats()
        container = lz4_sgori_torch.compress(data, bs, stats=stats,
                                             match_depth=depth)
        assert lz4_sgori_torch.decompress(container) == data
        assert stats.encode_fallbacks == 0
        assert min(m.launches for m in used) > 0, bs
        assert max(m.launches for m in idle) == 0, bs


def test_k10a_mcode(dev):
    """mcode.cu against its plain version on every case of _blocks at
    64 KiB (a short block and the empty one included), and against
    golden.dense_mcode on five of them."""
    bs = 65536
    blocks = _blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    got = M.dense_mcode(cand, raw, rlen)
    want = M.dense_mcode_plain(cand, raw, rlen)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cand_v, mcode = (t.cpu().numpy() for t in got)
    for j in (0, 1, 2, 5, 9):
        wd, wm = golden.dense_mcode(blocks[j])
        n = len(blocks[j])
        assert np.array_equal(cand_v[j, :n], wd), j
        assert np.array_equal(mcode[j, :n], wm), j
        assert not cand_v[j, n:].any() and not mcode[j, n:].any(), j
    # hand-made tapes: d <= 0, d = 1, d = p, d > p, d >= bs, nonzero bytes
    # past n, raw_len negative and past bs
    raw, rlen, c = (torch.from_numpy(a).to(dev)
                    for a in hand_mcode_case(5, bs, seed=3))
    for a, b in zip(M.dense_mcode(c, raw, rlen),
                    M.dense_mcode_plain(c, raw, rlen)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bs,nb", [(1, 9), (3, 9), (5, 9), (4096, 9),
                                   (4097, 5), (12345, 3), (16384, 4),
                                   (65536, 3), (4096, 1000), (65536, 300),
                                   (16, 70000)])
def test_k10a_mcode_sizes(dev, bs, nb):
    """The shared-memory rows read in words on hand-made tapes at odd
    block sizes (rows 0-15 bytes off the 16-byte grid): a few blocks split
    into runs of quads over the SMs, many in whole rows (several a CTA
    below 64 KiB), 70,000 blocks of 16 bytes (the grid's block index), and
    bytes and candidates off the grid in their storage (element loads);
    bit for bit against the plain version."""
    raw, rlen, c = (torch.from_numpy(a).to(dev)
                    for a in hand_mcode_case(nb, bs, seed=bs))
    for r, cc in ((raw, c), (_offset_view(raw, 5), _offset_view(c, 1))):
        got = M.dense_mcode(cc, r, rlen)
        want = M.dense_mcode_plain(cc, r, rlen)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _mlen_tapes(blocks, bs, dev):
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    return (raw, rlen, cand) + tuple(M.dense_mcode(cand, raw, rlen))


@pytest.mark.parametrize("bs,seg,window,copies,accel", [
    (16384, 4096, 65536, 1, 1), (4096, 512, 4096, 1, 1),
    (65536, 4096, 65536, 1, 1), (65536, 4096, 4096, 1, 8),
    (4096, 4096, 65536, 3, 1)])
def test_k10b_parse(dev, bs, seg, window, copies, accel):
    """K10b's warp walk against its plain version, against K3 on the
    unverified tape (the same outputs) and against golden's segment parts
    (on every distinct block): at 16 and 64 KiB, seg 4096 and 512,
    window 65536 and 4096, acceleration 1 and 8, and 30 blocks of 4 KiB,
    16 to a CTA."""
    blocks = [b[:bs] for b in _blocks(max(bs, 16384))] * copies
    raw, rlen, cand, cand_v, mcode = _mlen_tapes(blocks, bs, dev)
    got = K10B.parse_segments_mlen(raw, cand_v, mcode, rlen, seg=seg,
                                   window=window, accel=accel)
    want = K10B.parse_segments_mlen_plain(raw, cand_v, mcode, rlen, seg=seg,
                                          window=window, accel=accel)
    k3 = K3.parse_segments(raw, cand, rlen, seg=seg, window=window,
                           accel=accel)
    torch.cuda.synchronize()
    assert not got[2].any()
    for a, b, c in zip(got[1:], want[1:], k3[1:]):
        assert torch.equal(a, b) and torch.equal(a, c)
    inside = (torch.arange(got[0].shape[1], device=dev)[None, :]
              < got[1][:, None])
    assert torch.equal(got[0][inside], want[0].to(dev)[inside])
    assert torch.equal(got[0][inside], k3[0][inside])
    streams, slen = got[0].cpu().numpy(), got[1].cpu().numpy()
    nseg = bs // seg
    for j, b in enumerate(blocks[:len(blocks) // copies]):
        for k, pt in enumerate(golden.compress_dense_seg_parts(
                b, seg, window, acceleration=accel)):
            r = j * nseg + k
            assert streams[r, :slen[r]].tobytes() == pt["stream"], (j, k)


@pytest.mark.parametrize("bs,accel", [(4096, 1), (4096, 8), (60000, 1),
                                      (65536, 8)])
def test_k10c_parse(dev, bs, accel):
    """K10c's warp walk (the codes through the tape ring) against its
    plain version, K7 and golden.compress_dense, at 4 KiB, 60,000 bytes
    and 64 KiB, acceleration 1 and 8."""
    blocks = [b[:bs] for b in _blocks(max(bs, 8192))] + [
        b"", b"a", b"x" * 13]
    raw, rlen, cand, cand_v, mcode = _mlen_tapes(blocks, bs, dev)
    got = K10C.parse_blocks_enc3_mlen(raw, cand_v, mcode, rlen, accel)
    want = K10C.parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, rlen,
                                             accel)
    k7 = K7.parse_blocks_enc3(raw, cand, rlen, accel)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, k7):
        assert torch.equal(a, b) and torch.equal(a, c)
    out, out_len, err, tails, _ = (t.cpu().numpy() for t in got)
    assert not err.any()
    for j, b in enumerate(blocks):
        w = golden.compress_dense(b, accel, hashlog=16)
        assert out[j, :out_len[j]].tobytes() == w, j
        assert int(tails[j]) == golden.tail_offset(w), j


def test_k10b_k10c_past_the_cap(dev):
    """Both C entries at a cap the streams pass: K10b errs on exactly the
    segments whose plain stream is longer and agrees with K3 at the same
    cap elsewhere; K10c errs on exactly the blocks whose plain stream is
    longer, with a zero row and 0 in out_len, tails and nseq, and agrees
    with K7 at the same cap."""
    bs, seg = 4096, 1024
    blocks = [b[:bs] for b in _blocks(16384)]
    raw, rlen, cand, cand_v, mcode = _mlen_tapes(blocks, bs, dev)
    nb, stream = len(blocks), torch.cuda.current_stream().cuda_stream
    want = K10B.parse_segments_mlen_plain(raw, cand_v, mcode, rlen, seg)
    scap = int(want[1].float().median())
    segs, ns = [], nb * (bs // seg)
    for lib, fn, tapes in ((K10B.load_kernel(), "lz4t_parse_seg_mlen",
                            (cand_v, mcode)),
                           (K3.load_kernel(), "lz4t_parse_seg", (cand,))):
        outs = (torch.empty((ns, scap), dtype=torch.uint8, device=dev),
                *(torch.empty(ns, dtype=torch.int32, device=dev)
                  for _ in range(6)))
        assert getattr(lib, fn)(
            raw.data_ptr(), *(t.data_ptr() for t in tapes),
            rlen.data_ptr(), *(t.data_ptr() for t in outs), nb, bs, seg,
            scap, 65535, 1, stream) == 0
        segs.append(outs)
    torch.cuda.synchronize()
    over = want[1] > scap
    assert over.any() and (~over).any()
    for outs in segs:
        assert torch.equal(outs[2].bool(), over)
        for a, b in zip(outs[1:], want[1:]):
            assert torch.equal(a[~over], b[~over])
    ok = (~over).nonzero().flatten().tolist()
    for t in ok:
        n = int(want[1][t])
        assert torch.equal(segs[0][0][t, :n], want[0][t, :n]), t
    full = K10C.parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, rlen)
    cap = int(full[1].float().median())
    rows = []
    for lib, fn, tapes in ((K10C.load_kernel(), "lz4t_parse_enc3_mlen",
                            (cand_v, mcode)),
                           (K7.load_kernel(), "lz4t_parse_enc3", (cand,))):
        outs = K7.block_outputs(nb, bs, dev)
        assert getattr(lib, fn)(
            raw.data_ptr(), *(t.data_ptr() for t in tapes),
            rlen.data_ptr(), *(t.data_ptr() for t in outs), nb, bs,
            F.compress_bound(bs) + 8, cap, 1, stream) == 0
        rows.append(outs)
    torch.cuda.synchronize()
    over = full[1] > cap
    assert over.any() and (~over).any()
    out, out_len, err, tails, nseq = rows[0]
    assert torch.equal(err, over)
    assert not out[over].any() and not out_len[over].any()
    assert not tails[over].any() and not nseq[over].any()
    for a, b in zip(rows[0], full):
        assert torch.equal(a[~over], b[~over])
    for a, b in zip(rows[0], rows[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["k10b", "k10c"])
def test_mlen_failed_build_raises_and_never_falls_back(dev, monkeypatch,
                                                       kernel):
    """A build that fails raises from the wrapper: no plain version runs
    in its place and the launch count stays 0."""
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    raw, rlen, _, cand_v, mcode = _mlen_tapes(_blocks(4096)[:2], 4096, dev)
    monkeypatch.setattr(_build, "load", no_nvcc)
    mod = K10B if kernel == "k10b" else K10C
    plain = ("parse_segments_mlen_plain" if kernel == "k10b"
             else "parse_blocks_enc3_mlen_plain")

    def no_plain(*_a, **_k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(mod, plain, no_plain)
    mod.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        if kernel == "k10b":
            K10B.parse_segments_mlen(raw, cand_v, mcode, rlen)
        else:
            K10C.parse_blocks_enc3_mlen(raw, cand_v, mcode, rlen)
    assert mod.launches == 0


def test_mlen_path_runs_k2_mcode_k10b_k4(dev, monkeypatch):
    """LZ4J_ENC_MLEN=1 at 64 KiB runs K2, mcode, K10b and K4 (and K1 for
    the verify and the decode), not K3 or K7, and writes the default
    path's container."""
    import lz4_sgori_torch
    from lz4_sgori_torch.utils.stats import Stats
    data = b"".join(_blocks(65536)[:4]) * 2
    monkeypatch.delenv("LZ4J_ENC_MLEN", raising=False)
    want = lz4_sgori_torch.compress(data, 65536)
    mods = (K1, K2, K3, K4, K7, M, K10B, K10C, G, K8S, K8E)
    for m in mods:
        m.launches = 0
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    stats = Stats()
    container = lz4_sgori_torch.compress(data, 65536, stats=stats)
    assert container == want
    assert lz4_sgori_torch.decompress(container) == data
    assert stats.encode_fallbacks == 0
    assert min(m.launches for m in (K1, K2, M, K10B, K4)) > 0
    assert max(m.launches for m in (K3, K7, K10C, G, K8S, K8E)) == 0


@pytest.mark.parametrize("bs,acc", [(4096, 1), (65536, 1), (65536, 8)])
def test_t1_retired_encode(dev, bs, acc):
    """T1 against its plain version (golden.compress a row) on every case
    of _blocks, with random bytes past each short row's raw_len, and
    against liblz4's LZ4_compress_fast where it is present."""
    blocks = [b[:bs] for b in _blocks(bs)]
    raw, rlen = _batch(blocks, bs, dev)
    noise = torch.randint(0, 256, raw.shape, dtype=torch.uint8, device=dev)
    pos = torch.arange(bs, device=dev)[None, :]
    raw = torch.where(pos < rlen[:, None], raw, noise)
    T1.launches = 0
    got = T1.compress_blocks_retired(raw, rlen, bs, acc)
    want = T1.compress_blocks_retired_plain(raw, rlen, bs, acc)
    torch.cuda.synchronize()
    assert T1.launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if oracle.available():
        comp, clen = got[0].cpu().numpy(), got[1].cpu().numpy()
        for j, b in enumerate(blocks):
            assert comp[j, :clen[j]].tobytes() == oracle.compress_fast(
                b, acc), j


@pytest.mark.parametrize("bs,acc", [(16384, 1), (16384, 8), (16384, 65537),
                                    (65536, 1), (4096, 8)])
def test_t1_search_rows(dev, bs, acc):
    """T1 on the CPU search model's rows (``test_torch_retired_search``:
    random, text, zeros, short periods, hash4 collisions within a round)
    cut to 13, 14, 31, 4096 and 16384 bytes (at 64 KiB: the kinds at
    full length), random bytes past raw_len, the rows 3 bytes off the
    16-byte grid: equal to its plain version and to LZ4_compress_fast."""
    from test_torch_retired_search import LENGTHS, _rows
    kinds = _rows(7, n=bs).values()
    lens = [bs] if bs == 65536 else [n for n in LENGTHS if n <= bs]
    blocks = [r[:n] for r in kinds for n in lens]
    raw_np, rlen_np = (t.numpy() for t in _batch(blocks, bs, "cpu"))
    rng = np.random.default_rng(acc)
    noise = rng.integers(0, 256, raw_np.shape, dtype=np.uint8)
    raw_np = np.where(np.arange(bs)[None, :] < rlen_np[:, None], raw_np,
                      noise)
    flat = torch.zeros(raw_np.size + 16, dtype=torch.uint8, device=dev)
    raw = flat[3:3 + raw_np.size].view(raw_np.shape)     # head 3
    raw.copy_(torch.from_numpy(raw_np))
    rlen = torch.from_numpy(rlen_np).to(dev)
    assert raw.data_ptr() % 16 == 3
    T1.launches = 0
    got = T1.compress_blocks_retired(raw, rlen, bs, acc)
    want = T1.compress_blocks_retired_plain(raw.cpu(), rlen.cpu(), bs, acc)
    torch.cuda.synchronize()
    assert T1.launches == 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    if oracle.available():
        comp, clen = got[0].cpu().numpy(), got[1].cpu().numpy()
        for j, b in enumerate(blocks):
            assert comp[j, :clen[j]].tobytes() == oracle.compress_fast(
                b, acc), j


def _retired_payloads(bs, seed, dev):
    bases = [golden.compress(b[:bs]) for b in _blocks(bs)]
    rng = np.random.default_rng(seed)
    slot = F.compress_bound(bs) + 8
    payloads = bases + make_mutants(bases, rng, 256, slot - 8) + [
        b"\xf0", b"\xf0\xff"]
    comp = rng.integers(0, 256, (len(payloads), slot), dtype=np.uint8)
    clen = np.zeros(len(payloads), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    clen[3] = 0
    return (payloads, torch.from_numpy(comp).to(dev),
            torch.from_numpy(clen).to(dev))


@pytest.mark.parametrize("bs", [4096, 65536])
def test_t2_retired_decode_and_mutants(dev, bs):
    """T2 against its plain version, whole rows included (an error row
    keeps the bytes before its fault), on valid streams and mutants with
    random bytes past comp_len; err and out_len are K1's."""
    _, ct, lt = _retired_payloads(bs, 91, dev)
    T2.launches = 0
    got = T2.decompress_blocks_retired(ct, lt, bs)
    want = T2.decompress_blocks_retired_plain(ct, lt, bs)
    k1 = K1.decompress_blocks_v7(ct, lt, bs)
    torch.cuda.synchronize()
    assert T2.launches == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[1], k1[1]) and torch.equal(got[2], k1[2])
    assert bool(got[0][got[2]].any())


@pytest.mark.parametrize("bs", [4096, 8192, 65536, 131072])
@pytest.mark.parametrize("chain", [1, 2, 3, 4])
def test_t3_chained_decode(dev, chain, bs):
    """T3 against K1 on the card, whole rows (error rows all zero), with
    and without the sort and under a sort key, on valid streams and
    mutants with random bytes past comp_len, in each geometry of the
    walk (K5's at 4 and 8 KiB, K1's at 64 KiB, K6's ring at 128 KiB);
    with the sort also against its plain version."""
    _, ct, lt = _retired_payloads(bs, 92, dev)
    want = K1.decompress_blocks_v7(ct, lt, bs)
    keys = torch.randint(0, 100, lt.shape, dtype=torch.int32, device=dev)
    for sort, key in ((True, None), (False, None), (True, keys)):
        T3.launches = 0
        got = T3.decompress_blocks_lockstep_v9(ct, lt, bs, chain=chain,
                                               sort=sort, sort_key=key)
        torch.cuda.synchronize()
        assert T3.launches == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), sort
    plain = T3.decompress_blocks_lockstep_v9(ct.cpu(), lt.cpu(), bs,
                                             chain=chain)
    for a, b in zip(want, plain):
        assert torch.equal(a.cpu(), b)
    assert bool(want[2].any()) and not bool(want[0][want[2]].any())


@pytest.mark.parametrize("logn", [1, 4, 10, 12, 13, 16, 17])
def test_t4_probe_sort(dev, logn):
    """The tool's keys and random int32 with negatives, each column
    sorted: equal to torch.sort and to the plain network, one launch a
    call, in as many passes as ``plan`` lists (the kernel's own count)."""
    assert P4.passes(1 << logn) == len(P4.plan(logn))
    rng = np.random.default_rng(logn)
    for x_np in (P4.keys(logn), rng.integers(-(1 << 31), 1 << 31, (
            1 << logn, 128)).astype(np.int32)):
        x = torch.from_numpy(x_np).to(dev)
        P4.launches = 0
        got = P4.device_sort(x)
        want = P4.device_sort_plain(x)
        torch.cuda.synchronize()
        assert P4.launches == 1
        assert torch.equal(got, want)
        assert torch.equal(got, torch.sort(x, dim=0).values)


@pytest.mark.parametrize("nl", [1, 32, 33, 128])
@pytest.mark.parametrize("w", [4, 128, 512, 1024])
def test_t5_probe_dma(dev, nl, w):
    idx, hbm = (torch.from_numpy(a).to(dev) for a in P5.inputs())
    for reps in (0, 1, 16, 48):
        P5.launches = 0
        got = P5.run(idx, hbm, w, nl, reps)
        want = P5.run_plain(idx, hbm, w, nl, reps)
        torch.cuda.synchronize()
        assert P5.launches == 1
        assert torch.equal(got, want), reps
    with pytest.raises(ValueError, match="reads words up to"):
        P5.run(idx, hbm, w, 128, 70)


@pytest.mark.parametrize("body", P6.BODIES)
@pytest.mark.parametrize("R,K", [(8192, 8), (8, 3)])
def test_t6_probe_rounds(dev, body, R, K):
    x = torch.from_numpy(P6.carry(R)).to(dev)
    P6.launches = 0
    got = P6.rounds(body, x, 300, K)
    want = P6.rounds_plain(body, x, 300, K)
    torch.cuda.synchronize()
    assert P6.launches == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("K,puts", P78.KGET_CASES)
def test_t7_probe_kget(dev, K, puts):
    seed = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128)
    wide = torch.from_numpy(np.random.default_rng(K).integers(
        -(1 << 31), 1 << 31, (1, 128)).astype(np.int32)).to(dev)
    for s in (seed, wide):
        P78.kget_launches = 0
        got = P78.kget(s, 40, K, puts)
        want = P78.kget_plain(s, 40, K, puts)
        torch.cuda.synchronize()
        assert P78.kget_launches == 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("span", P78.BANDED_SPANS)
def test_t8_probe_banded(dev, span):
    """The tool's inputs at R = 16384, then unaligned positions (mask all
    ones), some below the tape and some across its end."""
    tape, pos = (torch.from_numpy(a).to(dev)
                 for a in P78.banded_inputs(16384, span * 64))
    edge = pos - 40
    edge[0, :8] = torch.tensor([65530, 65535, 65536 - 103, -1, -4, 1, 2, 3])
    for p, mask in ((pos, None), (pos + 1, -1), (edge, -1)):
        P78.banded_launches = 0
        got = P78.banded(tape, p, 64, mask)
        want = P78.banded_plain(tape, p, 64, mask)
        torch.cuda.synchronize()
        assert P78.banded_launches == 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("R", [8, 64, 1024, 16384])
def test_t9_t10_probe_lane(dev, R):
    """The tool's tape and a random one (negatives, so the sum wraps);
    every cell of the scatter's whole output, zeros where unwritten."""
    rng = np.random.default_rng(R)
    for t_np in (P3.tape(R), rng.integers(-(1 << 31), 1 << 31, (R, 128))
                 .astype(np.int32)):
        t = torch.from_numpy(t_np).to(dev)
        for reps in (0, 1, 15, 16, 17, 3000):
            P3.gather_launches = 0
            got = P3.gather(t, reps)
            want = P3.gather_plain(t, reps)
            torch.cuda.synchronize()
            assert P3.gather_launches == 1
            assert torch.equal(got, want), reps
    for reps in (0, 1, 700, 3000):
        P3.scatter_launches = 0
        got = P3.scatter(R, reps, dev, whole=True)
        want = P3.scatter_plain(R, reps, dev, whole=True)
        torch.cuda.synchronize()
        assert P3.scatter_launches == 1
        assert torch.equal(got, want), reps
        assert torch.equal(P3.scatter(R, reps, dev), want[:8])


@pytest.mark.parametrize("reps", [0, 1, 7, 8, 9, 1000])
def test_t11_t12_probe_step(dev, reps):
    """The tool's starts, then T12 from random int32 states, where the
    signed shifts and compares come in at once."""
    for fn, plain, counter in ((P3.fifo, P3.fifo_plain, "fifo_launches"),
                               (P3.state, P3.state_plain, "state_launches")):
        setattr(P3, counter, 0)
        got = fn(reps, dev)
        want = plain(reps, dev)
        torch.cuda.synchronize()
        assert getattr(P3, counter) == 1
        assert torch.equal(got, want), fn.__name__
    wide = torch.from_numpy(np.random.default_rng(reps).integers(
        -(1 << 31), 1 << 31, (4, 128)).astype(np.int32)).to(dev)
    assert torch.equal(P3.state(reps, start=wide),
                       P3.state_plain(reps, start=wide))


def test_t13_probe_smem_refuses_and_fits(dev):
    """Every size of the tool is refused without a launch; the largest
    rows at ring 128 that fits the opt-in limit launches and returns 2s;
    one row more is refused."""
    limit = P3.smem_limit(dev)
    assert limit >= 48 * 1024
    P3.vmem_launches = 0
    for rows in P3.VMEM_ROWS:
        assert P3.vmem(rows, P3.RING, dev) is None
        assert not P3.probe_vmem(rows, P3.RING, dev)
    assert P3.vmem_launches == 0
    fit = P3.fit_rows(limit, 128)
    assert P3.scratch_bytes(fit, 128) <= limit < P3.scratch_bytes(fit + 1,
                                                                  128)
    got = P3.vmem(fit, 128, dev)
    torch.cuda.synchronize()
    assert P3.vmem_launches == 1
    assert torch.equal(got, P3.vmem_plain(fit, 128, dev))
    assert P3.vmem(fit + 1, 128, dev) is None
    assert P3.probe_vmem(8, 8, dev)
    assert P3.vmem_launches == 2


def test_t15_probe_walk(dev):
    """The tool's table, and entries near 2^30 and below -2^30, so that
    the walk wraps within a few steps."""
    rng = np.random.default_rng(15)
    tables = [P15.walk_table(),
              rng.integers((1 << 30) - 4096, 1 << 30, 512).astype(np.int32),
              rng.integers(-(1 << 31), -(1 << 30), 512).astype(np.int32)]
    for t_np in tables:
        t = torch.from_numpy(t_np).to(dev)
        for r in (0, 1, 2, 3, 500, 2000):
            P15.launches = 0
            got = P15.walk(t, r)
            want = P15.walk_plain(t, r)
            torch.cuda.synchronize()
            assert P15.launches == 1
            assert torch.equal(got, want), r


@pytest.mark.parametrize("name", P15.T14A)
def test_t14a_probe_harness(dev, name):
    """Each body against its plain version, ``out`` bit for bit and
    ``sink`` exactly, one launch a call: the tool's inputs at R 0, 1, 3 and
    257, and inputs drawn over all of int32 (so that every sum wraps and
    every shift meets negative values) at R 3."""
    ins = P15.body_inputs(name, dev)
    rng = np.random.default_rng(14)
    wide = [torch.from_numpy(
        rng.normal(size=t.shape).astype(np.float32) if t.is_floating_point()
        else rng.integers(-(1 << 31), 1 << 31, t.shape).astype(np.int32)
    ).to(dev) for t in ins]
    for args, r in [(ins, 0), (ins, 1), (ins, 3), (ins, 257), (wide, 3)]:
        P15.harness_launches[name] = 0
        out, sink = P15.harness(name, r, *args)
        want_out, want_sink = P15.harness_plain(name, r, *args)
        torch.cuda.synchronize()
        assert P15.harness_launches[name] == 1
        assert torch.equal(out.view(torch.int32),
                           want_out.view(torch.int32)), r
        assert sink.shape == () and torch.equal(sink, want_sink), r


@pytest.mark.parametrize("name", [n for n, b in P15.BODIES.items()
                                  if b.source == P15.WG])
def test_t14b_probe_harness_wg_waves(dev, name):
    """The whole-card readings (``ohbuild``, the five tensor-core
    readings, ``transpose``, ``shiftsel`` and ``red1``) at R 0, 1, 3 and
    300, and over the grid's waves at R 33 (whole waves of items on 132
    SMs) and 301 (a partial last wave), against the plain version (the
    four T14a bodies', ``gather``'s out and sink and ``cumsum_mxu``'s out
    bit for bit; every other out within E of the float64 reference in
    each cell; float sinks within the summed bound), one launch a call,
    and two calls at each R that give the same out and sink bits; the
    T14a bodies also on inputs drawn over all of int32 at each R."""
    ins = P15.body_inputs(name, dev)
    cases = [(ins, r) for r in (0, 1, 3, 33, 300, 301)]
    if P15.BODIES[name].rate == P15.LANES:
        rng = np.random.default_rng(14)
        wide = [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, t.shape)
                                 .astype(np.int32)).to(dev) for t in ins]
        cases += [(wide, r) for r in (0, 1, 3, 33, 300, 301)]
    for args, r in cases:
        P15.harness_launches[name] = 0
        out, sink = P15.harness(name, r, *args)
        out2, sink2 = P15.harness(name, r, *args)
        want_out, want_sink = P15.harness_plain(name, r, *args)
        torch.cuda.synchronize()
        assert P15.harness_launches[name] == 2
        assert sink.shape == () and sink.dtype == want_sink.dtype
        assert torch.equal(out.view(torch.int32), out2.view(torch.int32)), r
        assert torch.equal(sink.reshape(1).view(torch.uint8),
                           sink2.reshape(1).view(torch.uint8)), r
        if P15.BODIES[name].exact:
            assert torch.equal(out.view(torch.int32),
                               want_out.view(torch.int32)), r
        if P15.BODIES[name].sink == torch.int32:
            assert torch.equal(sink, want_sink), r
        else:
            ref, e_out, ref_sink, e_sink = P15.harness_reference(name, r,
                                                                 *args)
            assert bool(((out.double() - ref).abs() <= e_out).all()), r
            assert abs(float(sink) - ref_sink) <= e_sink, r


def test_t9_t15_mains_launch_every_kernel(dev, capsys):
    """The two main()s at small round counts: each of the six wrappers and
    each of the 20 harness bodies launches, the capacity list stops at the
    tool's first size, and no reading is left unported."""
    for c in ("gather_launches", "scatter_launches", "fifo_launches",
              "state_launches", "vmem_launches"):
        setattr(P3, c, 0)
    P15.launches = 0
    P15.harness_launches.update(dict.fromkeys(P15.BODIES, 0))
    assert P3.main(["--div", "1000"]) == 0
    assert P15.main(["--div", "64", "--steps", "64", "4096"]) == 0
    out = capsys.readouterr().out
    assert all(getattr(P3, c) > 0 for c in (
        "gather_launches", "scatter_launches", "fifo_launches",
        "state_launches", "vmem_launches"))
    assert P15.launches > 0
    assert all(n > 0 for n in P15.harness_launches.values())
    assert out.count("not ported yet") == 0
    for body in P15.BODIES.values():
        assert f"{body.reading}: " in out and " us/iter" in out
    assert "rows=16384 (+4096 ring): FAIL" in out
    assert "rows=20480" not in out
    assert "the largest scratch that fits" in out and ": OK" in out


@pytest.mark.parametrize("bs,depth", [(4096, 5), (65536, 3)])
def test_xla_engine_card_bytes_equal_cpu(dev, bs, depth):
    """The xla engine on CUDA tensors (its sort, scans and gathers on the
    card) writes the bytes it writes on the CPU; ``impl="xla"`` decode on
    the card equals K1's on those streams, and the blocks come back."""
    blocks = [b[:bs] for b in _blocks(bs)]
    raw, rlen = _batch(blocks, bs, dev)
    comp, clen = compress_blocks_device(raw, rlen, bs, match_depth=depth,
                                        impl="xla")
    torch.cuda.synchronize()
    assert comp.device.type == "cuda"
    want = compress_blocks_device(raw.cpu(), rlen.cpu(), bs,
                                  match_depth=depth, impl="xla")
    assert torch.equal(clen.cpu(), want[1])
    assert torch.equal(comp.cpu(), want[0])
    before = K1.launches
    k1 = K1.decompress_blocks_v7(comp, clen, bs)
    assert K1.launches == before + 1
    got = decompress_blocks_device(comp, clen, bs, impl="xla")
    assert K1.launches == before + 1
    for a, b in zip(got, k1):
        assert a.device.type == "cuda" and torch.equal(a, b)
    out, out_len, err = (t.cpu().numpy() for t in got)
    for j, b in enumerate(blocks):
        assert not err[j] and out[j, :out_len[j]].tobytes() == b, j


@pytest.mark.parametrize("bs", [4096, 65536])
def test_parallel_nccl_world_one(dev, bs):
    """A process group of one rank on NCCL (one card, one rank): the
    sharded write pipeline's bytes are the unsharded port's, every block
    is ok, the all-reduced stats are the host's sums, and the assembly
    (all_gathers, ordered pack) is the host's concatenation of the rows."""
    import socket

    import torch.distributed as dist

    from lz4_sgori_torch.parallel import (make_mesh, stats_totals,
                                          write_pipeline_sharded)
    from lz4_sgori_torch.parallel.dist import (assemble_container_sharded,
                                               shard_rows)

    blocks = [b[:bs] for b in _blocks(bs)] * 4
    raw, rlen = _batch(blocks, bs, dev)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cuda")
        comp, clen, ok, stats = write_pipeline_sharded(
            shard_rows(raw, mesh), shard_rows(rlen, mesh), bs, mesh)
        payload, sizes, total = assemble_container_sharded(comp, clen, mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    want, wlen = compress_blocks_device(raw, rlen, bs)
    assert torch.equal(clen, wlen) and torch.equal(comp, want)
    assert bool(ok.all())
    assert stats_totals(stats) == (len(blocks), 0, int(rlen.sum()),
                                   int(wlen.sum()))
    ch, lh = want.cpu().numpy(), wlen.cpu().numpy()
    body = b"".join(ch[j, :lh[j]].tobytes() for j in range(len(blocks)))
    p = payload.cpu().numpy()
    assert torch.equal(sizes, wlen) and int(total) == len(body)
    assert p[:len(body)].tobytes() == body and not p[len(body):].any()

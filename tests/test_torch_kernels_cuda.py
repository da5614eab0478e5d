"""The kernels of the twenty-eight CUDA sources (K1-K7, K9, K8's gaps,
K8-seg and K8-enc3, K10's mcode, K10b and K10c, the retired engines
T1-T3, and the probes T4-T15, T6 and T7, T9 and T10, T11 and T12 sharing
a source each, T14a's 15 bodies and T14b's 5 readings three: 14 bodies
on ``probe_harness``, ``mxu_bf16`` and ``cumsum_mxu_lane`` on
``probe_harness_tc``, ``ohbuild``, ``mxu_f32``, ``gather`` and
``cumsum_mxu`` on ``probe_harness_wg``) against their
plain PyTorch versions and their golden oracles, on the card. Marked
``cuda``; each
test skips itself when no card is present. Run on a CUDA machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_mutants
from lz4_sgori_torch.ops import seg as S
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
from test_torch_seg_big import big_blocks

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


def test_k2_candidates(dev):
    bs = 65536
    blocks = _blocks(bs)
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


def test_k3_parse(dev):
    bs, seg = 16384, 4096
    blocks = _blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    got = K3.parse_segments(raw, cand, rlen, seg=seg)
    want = K3.parse_segments_plain(raw, cand, rlen, seg=seg)
    torch.cuda.synchronize()
    assert not got[2].any() and not want[2].any()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    streams, slen = got[0].cpu().numpy(), got[1].cpu().numpy()
    nseg = bs // seg
    for j, b in enumerate(blocks):
        for k, pt in enumerate(golden.compress_dense_seg_parts(b, seg)):
            r = j * nseg + k
            assert streams[r, :slen[r]].tobytes() == pt["stream"], (j, k)
            assert int(got[3][r]) == pt["last_end"], (j, k)


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


def test_k1_decode_and_mutants(dev):
    bs = 65536
    bases = [golden.compress(b) for b in _blocks(bs)]
    rng = np.random.default_rng(77)
    slot = F.compress_bound(bs) + 8
    payloads = bases + make_mutants(bases, rng, 256, slot - 8)
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


@pytest.mark.parametrize("bs", [4096, 60000])
def test_k7_parse(dev, bs):
    blocks = [b[:bs] for b in _blocks(max(bs, 8192))] + [
        b"", b"a", b"x" * 13]
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    got = K7.parse_blocks_enc3(raw, cand, rlen)
    want = K7.parse_blocks_enc3_plain(raw, cand, rlen)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, out_len, err, tails, _ = (t.cpu().numpy() for t in got)
    assert not err.any()
    for j, b in enumerate(blocks):
        w = golden.compress_dense(b, hashlog=16)
        assert out[j, :out_len[j]].tobytes() == w, j
        assert not out[j, out_len[j]:].any(), j
        assert int(tails[j]) == golden.tail_offset(w), j


@pytest.mark.parametrize("bs", [4096, 262144])
def test_k5_decode_and_mutants(dev, bs):
    bases = [golden.compress(b[:bs]) for b in _blocks(bs)]
    rng = np.random.default_rng(55)
    slot = F.compress_bound(bs) + 8
    payloads = bases + make_mutants(bases, rng, 128, slot - 8)
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
    """K9 against its plain version on every case of big_blocks, and
    against golden.dense_candidates_piecewise on the corpus block and the
    period-1,000 block (candidates at a piece's position 65,535 and the
    next half-piece's first positions)."""
    blocks = big_blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    got = K9.dense_candidates_piecewise(raw, rlen)
    torch.cuda.synchronize()
    assert torch.equal(got, K9.dense_candidates_piecewise_plain(raw, rlen))
    got = got.cpu().numpy()
    for j in (0, 4):
        want = np.zeros(bs, np.int64)
        want[:len(blocks[j])] = golden.dense_candidates_piecewise(blocks[j])
        assert np.array_equal(got[j], want), j
    assert got[4, 65535] == 1000


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


def test_k8_seg_parse(dev):
    bs, seg = 16384, 4096
    blocks = _blocks(bs)
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    gaps, _ = G.chain_gaps(cand)
    got = K8S.parse_segments_deep(raw, cand, gaps, rlen, seg=seg)
    want = K8S.parse_segments_deep_plain(raw, cand, gaps, rlen, seg=seg)
    torch.cuda.synchronize()
    assert not got[2].any() and not want[2].any()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    streams, slen = got[0].cpu().numpy(), got[1].cpu().numpy()
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


@pytest.mark.parametrize("bs,seg,window", [(16384, 4096, 65536),
                                           (4096, 512, 4096)])
def test_k10b_parse(dev, bs, seg, window):
    """K10b against its plain version, against K3 on the unverified tape
    (the same outputs) and against golden's segment parts."""
    blocks = [b[:bs] for b in _blocks(max(bs, 16384))]
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    cand_v, mcode = M.dense_mcode(cand, raw, rlen)
    got = K10B.parse_segments_mlen(raw, cand_v, mcode, rlen, seg=seg,
                                   window=window)
    want = K10B.parse_segments_mlen_plain(raw, cand_v, mcode, rlen, seg=seg,
                                          window=window)
    k3 = K3.parse_segments(raw, cand, rlen, seg=seg, window=window)
    torch.cuda.synchronize()
    assert not got[2].any()
    for a, b, c in zip(got[1:], want[1:], k3[1:]):
        assert torch.equal(a, b) and torch.equal(a, c)
    streams, slen = got[0].cpu().numpy(), got[1].cpu().numpy()
    nseg = bs // seg
    for j, b in enumerate(blocks):
        for k, pt in enumerate(golden.compress_dense_seg_parts(b, seg,
                                                               window)):
            r = j * nseg + k
            assert streams[r, :slen[r]].tobytes() == pt["stream"], (j, k)


@pytest.mark.parametrize("bs", [4096, 60000])
def test_k10c_parse(dev, bs):
    """K10c against its plain version, K7 and golden.compress_dense."""
    blocks = [b[:bs] for b in _blocks(max(bs, 8192))] + [
        b"", b"a", b"x" * 13]
    raw, rlen = _batch(blocks, bs, dev)
    cand = K2.dense_candidates(raw, rlen)
    cand_v, mcode = M.dense_mcode(cand, raw, rlen)
    got = K10C.parse_blocks_enc3_mlen(raw, cand_v, mcode, rlen)
    want = K10C.parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, rlen)
    k7 = K7.parse_blocks_enc3(raw, cand, rlen)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, k7):
        assert torch.equal(a, b) and torch.equal(a, c)
    out, out_len, err, tails, _ = (t.cpu().numpy() for t in got)
    assert not err.any()
    for j, b in enumerate(blocks):
        w = golden.compress_dense(b, hashlog=16)
        assert out[j, :out_len[j]].tobytes() == w, j
        assert int(tails[j]) == golden.tail_offset(w), j


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


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_t3_chained_decode(dev, chain):
    """T3 against its plain version and K1 on the card, with and without
    the sort and under a sort key."""
    _, ct, lt = _retired_payloads(65536, 92, dev)
    want = K1.decompress_blocks_v7(ct, lt, 65536)
    keys = torch.randint(0, 100, lt.shape, dtype=torch.int32, device=dev)
    for sort, key in ((True, None), (False, None), (True, keys)):
        T3.launches = 0
        got = T3.decompress_blocks_lockstep_v9(ct, lt, 65536, chain=chain,
                                               sort=sort, sort_key=key)
        plain = T3.decompress_blocks_lockstep_v9(
            ct.cpu(), lt.cpu(), 65536, chain=chain, sort=sort,
            sort_key=None if key is None else key.cpu())
        torch.cuda.synchronize()
        assert T3.launches == 1
        for a, b, c in zip(got, want, plain):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c), sort


@pytest.mark.parametrize("logn", [1, 4, 10, 16])
def test_t4_probe_sort(dev, logn):
    """The tool's keys and random int32 with negatives, each column
    sorted: equal to torch.sort and to the plain network."""
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


@pytest.mark.parametrize("name", P15.T14B)
def test_t14b_probe_harness_tc(dev, name):
    """Each tensor-core reading (both sources) against its plain version
    and the float64 reference at R 0, 1, 3 and 300 on the tool's inputs,
    one launch a call: ``gather``'s out and sink and ``cumsum_mxu``'s out
    bit for bit, every other out within E of the reference in each cell
    and every float sink within the summed bound."""
    ins = P15.body_inputs(name, dev)
    for r in (0, 1, 3, 300):
        P15.harness_launches[name] = 0
        out, sink = P15.harness(name, r, *ins)
        want_out, want_sink = P15.harness_plain(name, r, *ins)
        torch.cuda.synchronize()
        assert P15.harness_launches[name] == 1
        assert sink.shape == () and sink.dtype == want_sink.dtype
        if P15.BODIES[name].exact:
            assert torch.equal(out.view(torch.int32),
                               want_out.view(torch.int32)), r
        if P15.BODIES[name].sink == torch.int32:
            assert torch.equal(sink, want_sink), r
            continue
        ref, e_out, ref_sink, e_sink = P15.harness_reference(name, r, *ins)
        assert bool(((out.double() - ref).abs() <= e_out).all()), r
        assert abs(float(sink) - ref_sink) <= e_sink, r


@pytest.mark.parametrize("name", [n for n, b in P15.BODIES.items()
                                  if b.source == P15.WG])
def test_t14b_probe_harness_wg_waves(dev, name):
    """The whole-card readings over the grid's waves: at R 33 (whole waves
    of items on 132 SMs) and 301 (a partial last wave) against the plain
    version (``ohbuild``'s and ``gather``'s out and sink and
    ``cumsum_mxu``'s out bit for bit; ``mxu_f32``'s out within E of the
    float64 reference; float sinks within the summed bound), and two calls
    at each R that give the same out and sink bits."""
    ins = P15.body_inputs(name, dev)
    for r in (33, 301):
        out, sink = P15.harness(name, r, *ins)
        out2, sink2 = P15.harness(name, r, *ins)
        want_out, want_sink = P15.harness_plain(name, r, *ins)
        torch.cuda.synchronize()
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
                                                                 *ins)
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

"""The seventeen CUDA kernels (K1-K7, K9, K8's gaps, K8-seg and K8-enc3,
K10's mcode, K10b and K10c, and the retired engines T1-T3) against their
plain PyTorch versions and their golden oracles, on the card. Marked ``cuda``; each
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

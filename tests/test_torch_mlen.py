"""The mlen mode (K10) on CPU tensors: the verified candidates and match
codes of ``mcode.dense_mcode_plain`` against the JAX package's
``golden.dense_mcode``, the port's copy of that oracle against the JAX
package's, the seg engine (K10b) and the enc3 engine (K10c) with
``mlen=True`` against ``mlen=False`` and golden, a hypothesis fuzz, and
the mode end to end through ``LZ4J_ENC_MLEN=1`` (container and store).

The JAX package's mlen kernels are too slow in interpret mode for this
lane (a 2 KiB enc3 call runs for minutes), and its own suite holds them
to golden (``tests/test_mlen_cand.py``), so golden is the reference
here. Outputs are bytes, so every comparison is exact."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import lz4_sgori_torch
from lz4_sgori_torch import golden as TG
from lz4_sgori_torch.ops import enc3 as E3
from lz4_sgori_torch.ops import seg as S
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import mcode as M
from lz4_sgori_torch.ops.kernels import parse_enc3_mlen as K10C
from lz4_sgori_torch.ops.kernels import parse_seg_mlen as K10B
from lz4_sgori_tpu import golden

LOREM = (b"Lorem ipsum dolor sit amet, consectetur adipiscing "
         b"elit, sed do eiusmod tempor incididunt ut labore. ")


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw), torch.from_numpy(rlen)


def mcode_cases():
    """The cases of tests/test_mlen_cand.py (text, mixed, rle, random:
    hash16 collisions that the verify drops) at 8 KiB, the empty block,
    3 bytes (no read32 position) and one 64 KiB block of the corpus."""
    from __graft_entry__ import _synth_corpus
    rng = np.random.RandomState(41)
    bs = 8192
    return {
        "text": (LOREM * 100)[:bs],
        "mixed": ((LOREM * 30)[:2048] + bytes(2048)
                  + rng.randint(0, 256, 2048).astype(np.uint8).tobytes()
                  + (b"ab" * 1024)),
        "rle": b"x" * 4000 + b"yz" * 2000 + b"Q" * 96,
        "random": rng.randint(0, 256, bs).astype(np.uint8).tobytes(),
        "empty": b"",
        "three": b"abc",
        "corpus64k": _synth_corpus(65536, seed=5),
    }


@pytest.mark.parametrize("case", list(mcode_cases()))
def test_mcode_plain_matches_golden(case):
    """K10a's plain version, through its wrapper, equals
    golden.dense_mcode at every position, both outputs, and is zero past
    the block."""
    b = mcode_cases()[case]
    bs = 65536 if len(b) > 8192 else 8192
    raw, rlen = _batch([b], bs)
    cand = K2.dense_candidates(raw, rlen)
    cand_v, mcode = M.dense_mcode(cand, raw, rlen)
    want_d, want_m = golden.dense_mcode(b)
    n = len(b)
    assert np.array_equal(cand_v[0, :n].numpy(), want_d)
    assert np.array_equal(mcode[0, :n].numpy(), want_m)
    assert not cand_v[0, n:].any() and not mcode[0, n:].any()
    if case == "random":   # hash16 collisions: unverified candidates drop
        assert (cand[0] != 0).sum() > (cand_v[0] != 0).sum()
    if case in ("text", "rle"):   # both caps are reached
        m = mcode[0].numpy()
        assert ((m & 1) != 0).any() and ((m >> 5) & 1).any()


@pytest.mark.parametrize("case", list(mcode_cases()))
def test_golden_mcode_copy_equals_the_jax_package(case):
    b = mcode_cases()[case]
    assert TG.dense_mcode(b) == golden.dense_mcode(b)


def test_mcode_zero_pads_past_raw_len():
    """Bytes past ``raw_len`` read 0 even where the row holds other bytes
    there, and reads past the row's end read 0: the codes equal golden's
    of the cut block."""
    b = (LOREM * 10)[:600]
    raw, _ = _batch([b], 640)
    for n in (600, 500, 13, 0):
        rlen = torch.tensor([n], dtype=torch.int32)
        cand = K2.dense_candidates(raw, rlen)
        cand_v, mcode = M.dense_mcode(cand, raw, rlen)
        want_d, want_m = golden.dense_mcode(b[:n])
        assert np.array_equal(cand_v[0, :n].numpy(), want_d), n
        assert np.array_equal(mcode[0, :n].numpy(), want_m), n


def test_mlen_wrappers_reject_bad_inputs():
    raw = torch.zeros((2, 4096), dtype=torch.uint8)
    rl = torch.zeros(2, dtype=torch.int32)
    c = torch.zeros((2, 4096), dtype=torch.int32)
    with pytest.raises(TypeError, match="cand"):
        M.dense_mcode(c.to(torch.int64), raw, rl)
    with pytest.raises(TypeError, match="raw_len"):
        M.dense_mcode(c, raw, rl.to(torch.int64))
    with pytest.raises(ValueError, match="at most 65536"):
        big = torch.zeros((1, 131072), dtype=torch.uint8)
        M.dense_mcode(big.to(torch.int32), big,
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="mcode"):
        K10B.parse_segments_mlen(raw, c, c[:, :100], rl)
    with pytest.raises(TypeError, match="mcode"):
        K10C.parse_blocks_enc3_mlen(raw, c, c.to(torch.int64), rl)
    with pytest.raises(ValueError, match="seg"):
        K10B.parse_segments_mlen(raw, c, c, rl, seg=3000)
    with pytest.raises(ValueError, match="mlen"):
        S.compress_blocks_seg(raw, rl, 4096, depth=3, mlen=True)
    with pytest.raises(ValueError, match="mlen"):
        S.compress_blocks_seg(torch.zeros((1, 131072), dtype=torch.uint8),
                              rl[:1], 131072, mlen=True)
    with pytest.raises(ValueError, match="mlen"):
        E3.compress_blocks_enc3(raw, rl, 4096, depth=3, mlen=True)


def seg_blocks(bs=4096):
    """The blocks of tests/test_mlen_cand.py's seg parity test: text,
    zeros-random-period, tiny, zeros, matches crossing segment starts, a
    catch-up exercise, the empty block and one under MIN_LENGTH."""
    rng = np.random.RandomState(77)
    return [
        (LOREM * 40)[:bs],
        bytes(1000) + rng.randint(0, 256, 2000).astype(
            np.uint8).tobytes() + (b"ab" * 600)[:1096],
        b"abcabcabcabcabcabc",
        bytes(bs),
        (b"x" * 511 + b"Q") * 8,
        (b"Q" * 37 + b"R" * 3) * 100,
        b"",
        b"tiny",
    ]


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the mode's parse is reached)."""
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _check_seg(blocks, bs, seg, window, monkeypatch, accel=1):
    raw, rlen = _batch(blocks, bs)
    calls = _spy(monkeypatch, S, "parse_segments_mlen")
    off = S.compress_blocks_seg(raw, rlen, bs, seg=seg, window=window,
                                accel=accel)
    on = S.compress_blocks_seg(raw, rlen, bs, seg=seg, window=window,
                               accel=accel, mlen=True)
    assert calls == ["parse_segments_mlen"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    comp, clen, err, _ = on
    assert not err.any()
    for j, b in enumerate(blocks):
        want = golden.compress_dense_seg(b, seg=seg, window=window,
                                         acceleration=accel)
        assert comp[j, :clen[j]].numpy().tobytes() == want, j


def test_seg_mlen_matches_golden_small_window(monkeypatch):
    """bs 4096, seg 512, window 4096 (wlim 4032): the blocks of
    tests/test_mlen_cand.py's seg parity test, mlen on == off == golden."""
    _check_seg(seg_blocks(), 4096, 512, 4096, monkeypatch)


@pytest.mark.parametrize("bs,accel", [(16384, 1), (65536, 1), (16384, 8)])
def test_seg_mlen_matches_golden(monkeypatch, bs, accel):
    """seg 4096 at 16 KiB and 64 KiB: corpus blocks (a short one too),
    4-symbol noise, zeros, a period crossing every segment start and the
    catch-up exercise; mlen on == off == golden.compress_dense_seg."""
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(bs)
    data = _synth_corpus(2 * bs, seed=bs)
    blocks = [data[:bs], data[bs:2 * bs - 777],
              rng.integers(0, 4, bs, dtype=np.uint8).tobytes(), bytes(bs),
              ((b"x" * 4095 + b"Q") * (bs // 4096)),
              ((b"Q" * 37 + b"R" * 3) * (bs // 40 + 1))[:bs]]
    _check_seg(blocks, bs, 4096, 65536, monkeypatch, accel)


def enc3_blocks(bs=4096):
    """The blocks of tests/test_mlen_cand.py's enc3 parity test."""
    rng = np.random.RandomState(9)
    return [(LOREM * 40)[:bs], bytes(bs),
            rng.randint(0, 256, bs).astype(np.uint8).tobytes(),
            (b"Q" * 37 + b"R" * 3) * 50, b""]


@pytest.mark.parametrize("accel", [1, 8])
def test_enc3_mlen_matches_golden(accel):
    """The enc3 engine with mlen (K2, K10a, K10c) equals mlen off and
    golden.compress_dense(hashlog=16), with its tails and nseq."""
    blocks = enc3_blocks() + [b"x" * 13, (LOREM * 3)[:300]]
    raw, rlen = _batch(blocks, 4096)
    off = E3.compress_blocks_enc3(raw, rlen, 4096, accel=accel,
                                  return_tails=True, return_nseq=True)
    on = E3.compress_blocks_enc3(raw, rlen, 4096, accel=accel,
                                 return_tails=True, return_nseq=True,
                                 mlen=True)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    comp, clen, err, tails, _ = on
    assert not err.any()
    for j, b in enumerate(blocks):
        want = golden.compress_dense(b, accel, hashlog=16)
        assert comp[j, :clen[j]].numpy().tobytes() == want, j
        assert int(tails[j]) == golden.tail_offset(want), j


def test_mlen_kernel_wrappers_match_golden_parts():
    """K10b's plain version, through its wrapper, gives every segment's
    golden.compress_dense_seg_parts stream and scalars; K10c's gives
    compress_dense's bytes."""
    blocks = seg_blocks()
    raw, rlen = _batch(blocks, 4096)
    cand_v, mcode = M.dense_mcode(K2.dense_candidates(raw, rlen), raw, rlen)
    streams, slen, err, last_end, nseq, p1, m1h = K10B.parse_segments_mlen(
        raw, cand_v, mcode, rlen, seg=512, window=4096)
    assert not err.any()
    for j, b in enumerate(blocks):
        for k, pt in enumerate(golden.compress_dense_seg_parts(b, 512, 4096)):
            r = j * 8 + k
            assert streams[r, :slen[r]].numpy().tobytes() == pt["stream"]
            assert int(last_end[r]) == pt["last_end"], (j, k)
            if pt["has_match"]:
                assert int(p1[r]) == pt["p1"], (j, k)
                assert int(m1h[r]) == pt["m1"] | 1 << 16, (j, k)
    out, out_len, err, tails, _ = K10C.parse_blocks_enc3_mlen(
        raw, cand_v, mcode, rlen)
    for j, b in enumerate(blocks):
        assert out[j, :out_len[j]].numpy().tobytes() == \
            golden.compress_dense(b, hashlog=16), j


@settings(max_examples=50, deadline=None, derandomize=True, database=None)
@given(st.binary(min_size=256, max_size=4096).flatmap(
    lambda b: st.integers(2, 6).map(lambda k: bytes(x % k for x in b))))
def test_mlen_fuzz_small_alphabet(data):
    """Small-alphabet inputs (long catch-ups, lcp at its cap, matches
    ending at segment limits): seg at 4 KiB (seg 512) and enc3, mlen on
    == off == golden."""
    raw, rlen = _batch([data], 4096)
    off = S.compress_blocks_seg(raw, rlen, 4096, seg=512)
    on = S.compress_blocks_seg(raw, rlen, 4096, seg=512, mlen=True)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert on[0][0, :on[1][0]].numpy().tobytes() == \
        golden.compress_dense_seg(data, seg=512)
    e_on = E3.compress_blocks_enc3(raw, rlen, 4096, mlen=True)
    assert e_on[0][0, :e_on[1][0]].numpy().tobytes() == \
        golden.compress_dense(data, hashlog=16)


def test_container_with_mlen_is_the_default_container(fixtures, monkeypatch):
    """The slice end to end: ``lz4_sgori_torch.compress`` at 64 KiB with
    LZ4J_ENC_MLEN=1 runs the mode (K10a and K10b reached) and writes the
    container it writes without the variable, which decodes under the
    port and the JAX package."""
    from lz4_sgori_torch.utils.stats import Stats
    from lz4_sgori_tpu import blocks as JB
    data = fixtures["mixed"] + fixtures["structured"][:30000]
    monkeypatch.delenv("LZ4J_ENC_MLEN", raising=False)
    want = lz4_sgori_torch.compress(data, 65536, device="cpu")
    calls = _spy(monkeypatch, S, "dense_mcode")
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    stats = Stats()
    got = lz4_sgori_torch.compress(data, 65536, stats=stats, device="cpu")
    assert calls and stats.encode_fallbacks == 0
    assert got == want
    assert lz4_sgori_torch.decompress(got, device="cpu") == data
    assert JB.decompress(got) == data


def test_proxy_store_with_mlen_round_trips(tmp_path, fixtures, monkeypatch):
    """A 64 KiB ProxyStore with LZ4J_ENC_MLEN=1 writes through the mode
    and reads back its bytes."""
    from lz4_sgori_torch import store as ST
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    calls = _spy(monkeypatch, S, "parse_segments_mlen")
    st_ = ST.ProxyStore(str(tmp_path / "m.img"), chunk_size=65536,
                        capacity=4 * 65536, device="cpu")
    payload = (fixtures["text_large"] * 8)[:100000]
    st_.write(0, payload)
    st_.write(131072, fixtures["zeros_64k"])
    assert st_.read(0, len(payload)) == payload
    assert st_.read(131072, 65536) == fixtures["zeros_64k"]
    assert calls and st_.stats.encode_fallbacks == 0
    st_.close()

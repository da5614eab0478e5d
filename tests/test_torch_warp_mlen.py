"""The mlen mode's warp walks emulated on the CPU, lane for lane: K10b
(``csrc/parse_seg_mlen.cu``, ``parse_seg_warp.cuh``'s ``Walk<1, true>``,
``test_torch_warp_seg.emulate`` with ``mcode``) and K10c
(``csrc/parse_enc3_mlen.cu``, ``parse_enc3_warp.cuh``'s ``Walk<1,
true>``, ``test_torch_warp_parse.emulate`` with ``mcode``, the codes
through the ring or from the row). A probe hits on the verified
candidate alone, with no read32; the hit's code gives the catch-up's
first bytes and the extension's, and the byte steps run only where the
code reached its cap.

Both are held bit for bit against ``parse_segments_mlen_plain`` and
``parse_blocks_enc3_mlen_plain`` at 4 KiB and 64 KiB and acceleration 1
and 8, window 65536 and 4096 (wlim 4032), on corpus text, noise, a
motif, zeros, random bytes, a short block and blocks under 13 bytes,
counting that the walks met a catch-up past the code's 4 bytes, one
stopped by the anchor, an lcp of 8 running on past 12 bytes and a match
cut at the match limit; with a stream cap the blocks would pass; and on
a few blocks over the JAX package's ``golden.dense_mcode`` against its
``compress_dense_seg_parts`` and ``compress_dense``. The card runs the
kernels themselves (``test_torch_kernels_cuda.py``, ``-k "k10 or
mlen"``)."""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import mcode as M
from lz4_sgori_torch.ops.kernels import parse_enc3_mlen as K10C
from lz4_sgori_torch.ops.kernels import parse_seg_mlen as K10B
from lz4_sgori_tpu import golden
from test_torch_threads import one_thread  # noqa: F401 (a fixture)
from test_torch_warp_enc3 import blocks_of
from test_torch_warp_parse import _OnCuda
from test_torch_warp_parse import emulate as emulate_enc3
from test_torch_warp_seg import assert_equal_parse
from test_torch_warp_seg import emulate as emulate_seg

FIVE = ("out", "out_len", "err", "tails", "nseq")
CASES = ("cu4", "anchor", "lcp8", "lim")


def batch(blocks, bs):
    """raw, rlen, and the mlen tapes (cand_v, mcode) of ``blocks``."""
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    raw, rlen = torch.from_numpy(raw), torch.from_numpy(rlen)
    cand_v, mcode = M.dense_mcode(K2.dense_candidates(raw, rlen), raw, rlen)
    return raw, rlen, cand_v, mcode


def collision(w: bytes, rng) -> bytes:
    """4 other bytes whose hash16 is that of ``w``: a later one takes
    ``w``'s table entry, so a probe at ``w``'s next copy finds a candidate
    that fails pass 1's verify (cand_v 0)."""
    v = int.from_bytes(w, "little")
    c = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
    hit = ((c * F.HASH4_PRIME) & 0xFFFFFFFF) >> 16 == F.hash4(v, 16)
    return int(c[np.flatnonzero(hit & (c != v))[0]]).to_bytes(4, "little")


def crafted(j: int) -> bytes:
    """About 3.6 KiB that meet each mlen case at acceleration 1 and 8:
    a match (A) that ends where a second (B) begins whose first probe
    finds a colliding candidate, so that B's hit one byte on catches up
    to the anchor; 64-byte runs (D) found again after 2000 + j literals,
    where the skip schedule's steps pass 4 bytes, and after 9 + j (the
    steps of acceleration 8); a 40-byte run (E) that the lcp's 8 bytes
    cannot cover."""
    rng = np.random.default_rng(100 + j)

    def rand(k):
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()
    a, b, d, e = rand(40), rand(34), rand(64), rand(40)
    return (rand(64) + a + rand(8) + b + rand(64) + collision(b[:4], rng)
            + rand(64) + a + b + rand(16) + d + rand(2000 + j) + d
            + rand(9 + j) + e + rand(9 + j) + e + rand(200))


@functools.lru_cache(maxsize=None)
def mlen_blocks(bs: int) -> list[bytes]:
    """``test_torch_warp_enc3.blocks_of`` (corpus text, noise cut to 8 KiB
    above 8 KiB, a motif, zeros, random bytes, a short block, 0, 12 and
    13 bytes) and four ``crafted`` blocks."""
    return blocks_of(bs) + [crafted(j) for j in range(4)]


@pytest.mark.parametrize("bs,seg,accel,window", [
    (4096, 4096, 1, 65536), (4096, 1024, 8, 4096),
    (65536, 4096, 1, 65536), (65536, 4096, 8, 4096)])
def test_k10b_emulation_matches_plain(bs, seg, accel, window):
    raw, rlen, cand_v, mcode = batch(mlen_blocks(bs), bs)
    seen = Counter()
    got = emulate_seg(raw, cand_v, rlen, seg, window, accel, mcode=mcode,
                      seen=seen)
    want = K10B.parse_segments_mlen_plain(raw, cand_v, mcode, rlen, seg,
                                          window, accel)
    assert not want[2].any()
    assert_equal_parse(got, want)
    assert all(seen[c] for c in CASES), seen


@pytest.mark.parametrize("bs,accel", [(4096, 1), (4096, 8), (65536, 8)])
def test_k10c_emulation_matches_plain(bs, accel):
    raw, rlen, cand_v, mcode = batch(mlen_blocks(bs), bs)
    seen = Counter()
    got = emulate_enc3(raw, cand_v, None, None, rlen, accel, 1,
                       mcode=mcode, seen=seen)
    want = K10C.parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, rlen,
                                             accel)
    assert not want[2].any()
    for name, a, b in zip(FIVE, got, want):
        assert torch.equal(a, b), name
    assert all(seen[c] for c in CASES), seen


def test_window_4096_drops_the_far_candidates():
    """At window 4096 (wlim 4032) K10b skips verified candidates farther
    than 4032 that window 65536 takes, and still gives the plain bytes."""
    raw, rlen, cand_v, mcode = batch(mlen_blocks(65536)[:1], 65536)
    assert int(((cand_v > 4032) & (cand_v <= 65535)).sum()) > 0
    near = emulate_seg(raw, cand_v, rlen, 4096, 4096, 1, mcode=mcode)
    far = emulate_seg(raw, cand_v, rlen, 4096, 65536, 1, mcode=mcode)
    assert not torch.equal(near[1], far[1])
    assert_equal_parse(near, K10B.parse_segments_mlen_plain(
        raw, cand_v, mcode, rlen, 4096, 4096))


def test_k10b_emulation_past_the_cap():
    """A segment stream cap the streams would pass: err on exactly the
    segments whose plain stream is longer, the plain outputs elsewhere."""
    raw, rlen, cand_v, mcode = batch(mlen_blocks(4096)[:5], 4096)
    want = K10B.parse_segments_mlen_plain(raw, cand_v, mcode, rlen, 1024)
    cap = int(want[1].float().median())
    got = emulate_seg(raw, cand_v, rlen, 1024, 65536, 1, mcode=mcode,
                      cap=cap)
    over = want[1] > cap
    assert over.any() and (~over).any()
    assert torch.equal(got[2].bool(), over)
    ok = ~over
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[ok], b[ok])
    for t in ok.nonzero().flatten().tolist():
        n = int(want[1][t])
        assert torch.equal(got[0][t, :n], want[0][t, :n]), t


@pytest.mark.parametrize("accel", [1, 8])
def test_k10c_emulation_past_the_cap(accel):
    """A cap one byte short of the block's stream, half of it and 0 set
    err and leave a zero row and zero out_len, tails and nseq; a cap of
    exactly its length gives the plain bytes (acceleration 1 and 8)."""
    raw, rlen, cand_v, mcode = batch(mlen_blocks(4096)[:3], 4096)
    want = K10C.parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, rlen,
                                             accel)
    for j in range(len(rlen)):
        n = int(want[1][j])
        sel = slice(j, j + 1)
        for cap in (n - 1, n // 2, 0):
            out, out_len, err, tails, nseq = emulate_enc3(
                raw[sel], cand_v[sel], None, None, rlen[sel], accel, 1,
                cap=cap, mcode=mcode[sel])
            assert bool(err[0]) and not out.any(), (j, cap)
            assert int(out_len[0]) == int(tails[0]) == int(nseq[0]) == 0
        got = emulate_enc3(raw[sel], cand_v[sel], None, None, rlen[sel],
                           accel, 1, cap=n, mcode=mcode[sel])
        for name, a, b in zip(FIVE, got, want):
            assert torch.equal(a[0], b[j]), (j, name)


def _golden_tapes(blocks, bs):
    """raw, rlen and the JAX package's golden.dense_mcode tapes, zero
    past each block."""
    raw, rlen, _, _ = batch(blocks, bs)
    cv = np.zeros((len(blocks), bs), np.int32)
    mc = np.zeros((len(blocks), bs), np.int32)
    for j, b in enumerate(blocks):
        d, m = golden.dense_mcode(b)
        cv[j, :len(b)], mc[j, :len(b)] = d, m
    return raw, rlen, torch.from_numpy(cv), torch.from_numpy(mc)


def test_mlen_emulations_match_jax_golden():
    """Corpus text, noise and random bytes at 4 KiB over the JAX
    package's golden.dense_mcode: K10b's segments (seg 1024, windows
    65536 and 4096) are golden.compress_dense_seg_parts, K10c's blocks
    golden.compress_dense with golden.tail_offset, at acceleration 1 and
    8."""
    bs, seg = 4096, 1024
    blocks = [mlen_blocks(bs)[i] for i in (0, 1, 4, 9)]
    raw, rlen, cv, mc = _golden_tapes(blocks, bs)
    for window in (65536, 4096):
        streams, slen, err, last_end, _, p1, m1h = emulate_seg(
            raw, cv, rlen, seg, window, 1, mcode=mc)
        assert not err.any()
        for j, b in enumerate(blocks):
            parts = golden.compress_dense_seg_parts(b, seg, window)
            for k, pt in enumerate(parts):
                r = j * (bs // seg) + k
                assert streams[r, :slen[r]].numpy().tobytes() == \
                    pt["stream"], (window, j, k)
                assert int(last_end[r]) == pt["last_end"], (window, j, k)
                if pt["has_match"]:
                    assert int(p1[r]) == pt["p1"], (window, j, k)
                    assert int(m1h[r]) == pt["m1"] | 1 << 16, (window, j, k)
    for accel in (1, 8):
        out, out_len, err, tails, _ = emulate_enc3(
            raw, cv, None, None, rlen, accel, 1, mcode=mc)
        for j, b in enumerate(blocks):
            want = golden.compress_dense(b, accel, hashlog=16)
            assert not bool(err[j])
            assert out[j, :int(out_len[j])].numpy().tobytes() == want
            assert int(tails[j]) == golden.tail_offset(want)


def test_mlen_wrappers_run_the_plain_versions_on_the_cpu():
    raw, rlen, cand_v, mcode = batch(mlen_blocks(4096)[:1], 4096)
    K10B.launches = K10C.launches = 0
    got = K10B.parse_segments_mlen(raw, cand_v, mcode, rlen, seg=1024)
    want = K10B.parse_segments_mlen_plain(raw, cand_v, mcode, rlen, 1024)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = K10C.parse_blocks_enc3_mlen(raw, cand_v, mcode, rlen)
    want = K10C.parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, rlen)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K10B.launches == K10C.launches == 0


@pytest.mark.parametrize("kernel", ["k10b", "k10c"])
def test_mlen_failed_build_raises_and_never_falls_back(monkeypatch, kernel):
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    raw, rlen, cand_v, mcode = (t.as_subclass(_OnCuda) for t in
                                batch(mlen_blocks(4096)[:1], 4096))
    monkeypatch.setattr(_build, "load", no_nvcc)
    mod = K10B if kernel == "k10b" else K10C
    mod.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        if kernel == "k10b":
            K10B.parse_segments_mlen(raw, cand_v, mcode, rlen)
        else:
            K10C.parse_blocks_enc3_mlen(raw, cand_v, mcode, rlen)
    assert mod.launches == 0


def test_mlen_stream_rows_are_the_bound():
    """The wrappers' rows: compress_bound(seg) a segment, compress_bound
    (block size) + 8 a block, as K3's and K7's."""
    raw, rlen, cand_v, mcode = batch(mlen_blocks(4096)[:1], 4096)
    seg = K10B.parse_segments_mlen(raw, cand_v, mcode, rlen, seg=1024)
    blk = K10C.parse_blocks_enc3_mlen(raw, cand_v, mcode, rlen)
    assert seg[0].shape == (4, F.compress_bound(1024))
    assert blk[0].shape == (1, F.compress_bound(4096) + 8)

"""K7's warp parse (``csrc/parse_enc3.cu``: ``csrc/parse_enc3_warp.cuh``
at N = 1) emulated on the CPU, lane for lane (``test_torch_warp_parse``'s
``WarpWalk`` at depth 1: K3's hit test, no previews and no lazy step, the
extension from the catch-up and read32's 4 bytes), and held bit for bit
against ``parse_blocks_enc3_plain`` (all five outputs) at 4 KiB, 5,000
bytes and 64 KiB, acceleration 1 and 8, on corpus text, 4-symbol noise,
a repeated motif, zeros, random bytes, a short corpus block and blocks
under 13 bytes; with a stream cap that the block would pass; and on a
few blocks against the JAX package's own ``golden.compress_dense``."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
from lz4_sgori_tpu import golden
from test_torch_deep import deep_blocks
from test_torch_threads import one_thread  # noqa: F401 (a fixture)
from test_torch_warp_parse import _OnCuda, emulate

FIVE = ("out", "out_len", "err", "tails", "nseq")


def blocks_of(bs: int) -> list[bytes]:
    """``deep_blocks`` (corpus text, 4-symbol noise, a motif, zeros,
    random bytes, a short corpus block) and blocks of 0, 12 and 13
    bytes; at 64 KiB the noise is cut to 8 KiB (its 64 KiB takes the
    emulation minutes)."""
    b = deep_blocks(bs)[:6]
    if bs > 8192:
        b[1] = b[1][:8192]
    return b + [b"", b"x" * 12, b"abcabcabcabca"]


def batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    raw, rlen = torch.from_numpy(raw), torch.from_numpy(rlen)
    return raw, K2.dense_candidates(raw, rlen), rlen


@pytest.mark.parametrize("bs,accel", [(4096, 1), (4096, 8), (5000, 1),
                                      (5000, 8), (65536, 1), (65536, 8)])
def test_k7_emulation_matches_plain(bs, accel):
    raw, cand, rlen = batch(blocks_of(bs), bs)
    got = emulate(raw, cand, None, None, rlen, accel, 1)
    want = K7.parse_blocks_enc3_plain(raw, cand, rlen, accel)
    assert not want[2].any()
    for name, a, b in zip(FIVE, got, want):
        assert torch.equal(a, b), name


def test_k7_emulation_matches_jax_golden():
    """Corpus text, noise and random bytes at 4 KiB and 5,000 bytes,
    acceleration 1 and 8: the stream is ``golden.compress_dense(block,
    accel, hashlog=16)`` and its tail ``golden.tail_offset``."""
    for bs in (4096, 5000):
        blocks = [blocks_of(bs)[i] for i in (0, 1, 4)]
        raw, cand, rlen = batch(blocks, bs)
        for accel in (1, 8):
            out, out_len, err, tails, _ = emulate(raw, cand, None, None,
                                                  rlen, accel, 1)
            for j, b in enumerate(blocks):
                want = golden.compress_dense(b, accel, hashlog=16)
                assert not bool(err[j])
                assert out[j, :int(out_len[j])].numpy().tobytes() == want
                assert int(tails[j]) == golden.tail_offset(want)


def test_k7_emulation_past_the_cap():
    """A cap the stream would pass (one byte short of it, half of it, a
    cap of 0) sets err and leaves a zero row and zero out_len, tails and
    nseq; a cap of exactly its length gives the plain bytes."""
    raw, cand, rlen = batch(blocks_of(4096)[:5], 4096)
    want = K7.parse_blocks_enc3_plain(raw, cand, rlen)
    for j in range(len(rlen)):
        n = int(want[1][j])
        sel = slice(j, j + 1)
        for cap in (n - 1, n // 2, 0):
            out, out_len, err, tails, nseq = emulate(
                raw[sel], cand[sel], None, None, rlen[sel], 1, 1, cap=cap)
            assert bool(err[0]) and not out.any(), (j, cap)
            assert int(out_len[0]) == int(tails[0]) == int(nseq[0]) == 0
        got = emulate(raw[sel], cand[sel], None, None, rlen[sel], 1, 1,
                      cap=n)
        for name, a, b in zip(FIVE, got, want):
            assert torch.equal(a[0], b[j]), (j, name)


def test_k7_wrapper_runs_the_plain_version_on_the_cpu():
    raw, cand, rlen = batch(blocks_of(4096)[:2], 4096)
    K7.launches = 0
    got = K7.parse_blocks_enc3(raw, cand, rlen)
    want = K7.parse_blocks_enc3_plain(raw, cand, rlen)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K7.launches == 0


def test_k7_failed_build_raises_and_never_falls_back(monkeypatch):
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    raw, cand, rlen = (t.as_subclass(_OnCuda)
                       for t in batch(blocks_of(4096)[:1], 4096))
    monkeypatch.setattr(_build, "load", no_nvcc)
    K7.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        K7.parse_blocks_enc3(raw, cand, rlen)
    assert K7.launches == 0

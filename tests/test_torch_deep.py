"""The deep match modes (K8) on CPU tensors: the chain-gaps tapes against
golden.dense_gaps / dense_gaps2 and the piecewise gaps of
golden.dense_candidates_piecewise(with_gaps=True); K8-enc3 against
compress_deep (depth 3 and 5, acceleration 1 and 8); the mlen gate at
depth (the mode at depth 1 only); and the plain enc3 at depth 3 against the JAX engine in interpret
mode. The seg engines at depth and the slice as a whole are in
test_torch_deep_seg.py. Outputs are bytes, so every comparison is
exact."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
from lz4_sgori_torch.ops.kernels import gaps as G
from lz4_sgori_torch.ops.kernels import parse_enc3_deep as K8E
from lz4_sgori_torch.ops.kernels import parse_seg_deep as K8S
from lz4_sgori_tpu import golden

LOREM = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed "
         b"do eiusmod tempor incididunt ut labore et dolore magna aliqua. ")


def deep_blocks(bs: int, seed: int = 5):
    """Corpus text, 4-symbol noise (long chains with gaps past 254), a
    repeated 96-byte motif (chains of gap 96), zeros (gap 1), random
    bytes, a short corpus block and tiny blocks."""
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(seed)
    data = _synth_corpus(2 * bs, seed=seed)
    motif = rng.integers(0, 256, 96, dtype=np.uint8).tobytes()
    return [data[:bs], rng.integers(0, 4, bs, dtype=np.uint8).tobytes(),
            (motif * (bs // 96 + 1))[:bs], bytes(bs),
            rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),
            data[bs:2 * bs - bs // 3], (LOREM * 3)[:min(bs, 200)],
            b"abcabcabcabcabcab"[:bs], b""]


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw), torch.from_numpy(rlen)


def _padded(values, bs):
    out = np.zeros(bs, np.int64)
    out[:len(values)] = values
    return out


@pytest.mark.parametrize("bs", [256, 4096, 20000, 65536])
def test_gaps_plain_matches_golden(bs):
    """Following K2's tape gives dense_gaps and dense_gaps2 exactly."""
    blocks = deep_blocks(bs)
    cand = K2.dense_candidates(*_batch(blocks, bs))
    gaps, gaps2 = G.chain_gaps(cand, 4)
    g3, none = G.chain_gaps(cand, 2)
    assert none is None and torch.equal(g3, gaps)
    for j, b in enumerate(blocks):
        assert np.array_equal(gaps[j].numpy(),
                              _padded(golden.dense_gaps(b, 16), bs)), j
        assert np.array_equal(gaps2[j].numpy(),
                              _padded(golden.dense_gaps2(b, 16), bs)), j
    if bs >= 4096:        # the cases reach both truncation rules
        assert (gaps.numpy() >> 8).any() and (gaps2.numpy() >> 8).any()


def _piecewise_cases(bs: int, seed: int = 55):
    """Chains across every half-piece edge: corpus text, 3-symbol noise,
    period 1,000 (every position from 1,000 on has a candidate) and
    period 200 with a shorter last block, so links land on both sides
    of each edge, the last half-piece's (no straddle pass above it)
    included."""
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(seed)
    p1k = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    p200 = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    return [_synth_corpus(bs, seed=seed),
            rng.integers(0, 3, bs, dtype=np.uint8).tobytes(),
            (p1k * (bs // 1000 + 1))[:bs],
            (p200 * (bs // 200 + 1))[:bs - 999]]


@pytest.mark.parametrize("bs,piece,cases", [
    (131072, 65536, 4), (262144, 65536, 4), (1 << 20, 65536, 2),
    (16384, 1024, 4)])
def test_gaps_piecewise_matches_golden(bs, piece, cases):
    """Following K9's tape with the floor of the winning pass gives the
    gaps of dense_candidates_piecewise(with_gaps=True) exactly."""
    blocks = _piecewise_cases(bs)[:cases]
    cand = K9.dense_candidates_piecewise(*_batch(blocks, bs), piece=piece)
    gaps, _ = G.chain_gaps(cand, 2, piece // 2)
    for j, b in enumerate(blocks):
        _, want = golden.dense_candidates_piecewise(b, piece, with_gaps=True)
        want = _padded(want, bs)
        got = gaps[j].numpy()
        assert np.array_equal(got, want), (j, np.nonzero(got != want)[0][:8])
    # the cases keep links in the first bytes after every half-piece edge
    half = piece // 2
    near = (np.arange(half, bs, half)[:, None] + np.arange(64)).ravel()
    assert (gaps[:, near] > 0).any(dim=0).reshape(-1, 64).any(dim=1).all()


def test_chain_gaps_rejects_bad_inputs():
    c = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="links"):
        G.chain_gaps(c, 3)
    with pytest.raises(TypeError):
        G.chain_gaps(c.to(torch.int64))
    with pytest.raises(ValueError, match="half"):
        G.chain_gaps(c, 2, -1)


@pytest.mark.parametrize("bs,depth,accel", [
    (4096, 3, 1), (4096, 5, 1), (4096, 3, 8), (4096, 5, 8),
    (5000, 3, 1)])
def test_enc3_deep_plain_matches_compress_deep(bs, depth, accel):
    """K8-enc3's plain version, called through its wrapper, and the enc3
    engine at ``depth`` equal golden.compress_deep block for block, with
    the terminal sequence's offset as golden.tail_offset."""
    blocks = deep_blocks(bs, seed=bs + depth)
    raw, rlen = _batch(blocks, bs)
    cand = K2.dense_candidates(raw, rlen)
    gaps, gaps2 = G.chain_gaps(cand, 4 if depth == 5 else 2)
    out, out_len, err, tails, nseq = K8E.parse_blocks_enc3_deep(
        raw, cand, gaps, gaps2, rlen, accel, depth)
    assert not err.any()
    comp, clen = compress_blocks_device(raw, rlen, bs, match_depth=depth,
                                        acceleration=accel, impl="enc3")
    assert torch.equal(comp, out) and torch.equal(clen, out_len)
    for j, b in enumerate(blocks):
        want = golden.compress_deep(b, accel, hashlog=16, depth=depth)
        assert out[j, :out_len[j]].numpy().tobytes() == want, j
        assert not out[j, out_len[j]:].any(), j
        assert int(tails[j]) == golden.tail_offset(want), j


def test_mlen_gate_at_depth(monkeypatch):
    """LZ4J_ENC_MLEN=1 runs mlen in the JAX package only at depth 1
    (lz4_sgori_tpu/ops/encode.py:345-346): at depth 3 the port serves the
    default deep bytes without the mode, at depth 1 it runs the mode
    (K10) with golden's bytes."""
    from lz4_sgori_torch.ops import seg as S
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    calls = []
    real = S.dense_mcode
    monkeypatch.setattr(S, "dense_mcode",
                        lambda *a: calls.append(1) or real(*a))
    block = (LOREM * 300)[:16384 - 1000]
    raw, rlen = _batch([block], 16384)
    comp, clen = compress_blocks_device(raw, rlen, 16384, match_depth=3)
    assert comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg(block, 4096, 65536, 16, depth=3)
    assert not calls
    comp, clen = compress_blocks_device(raw, rlen, 16384)
    assert calls and comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg(block, 4096, 65536, 16)


def test_deep_wrappers_reject_bad_inputs():
    raw = torch.zeros((2, 4096), dtype=torch.uint8)
    rl = torch.zeros(2, dtype=torch.int32)
    c = torch.zeros((2, 4096), dtype=torch.int32)
    with pytest.raises(ValueError, match="depth 3 or 5"):
        K8E.parse_blocks_enc3_deep(raw, c, c, None, rl, depth=4)
    with pytest.raises(ValueError, match="gaps2"):
        K8E.parse_blocks_enc3_deep(raw, c, c, None, rl, depth=5)
    with pytest.raises(ValueError, match="gaps2"):
        K8E.parse_blocks_enc3_deep(raw, c, c, c, rl, depth=3)
    with pytest.raises(TypeError, match="gaps"):
        K8S.parse_segments_deep(raw, c, c[:, :100], rl)
    with pytest.raises(ValueError, match="seg"):
        K8S.parse_segments_deep(raw, c, c, rl, seg=3000)
    from lz4_sgori_torch.ops.enc3 import compress_blocks_enc3
    with pytest.raises(ValueError, match="depth"):
        compress_blocks_enc3(raw, rl, 4096, depth=2)


def test_enc3_deep_plain_matches_the_jax_engine_in_interpret_mode():
    """The JAX enc3 engine at depth 3 in interpret mode, as
    tests/test_lockstep_enc3.py runs it, and the port's enc3 engine give
    the same bytes on 256-byte blocks."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_tpu.ops.pallas.lockstep_enc3 import \
        compress_blocks_lockstep_enc3
    rng = np.random.RandomState(5)
    bs = 256
    blocks = [_synth_corpus(bs, seed=3), (b"the quick brown fox " * 20)[:bs],
              bytes(rng.randint(0, 4, bs).astype(np.uint8)),
              (bytes(rng.randint(0, 256, 40).astype(np.uint8)) * 8)[:bs]]
    raw, rlen = _batch(blocks, bs)
    jc, jl, je = compress_blocks_lockstep_enc3(raw.numpy(), rlen.numpy(), bs,
                                               interpret=True, depth=3)
    jc, jl = np.asarray(jc), np.asarray(jl)
    assert not np.asarray(je).any()
    comp, clen = compress_blocks_device(raw, rlen, bs, match_depth=3)
    for j, b in enumerate(blocks):
        got = comp[j, :clen[j]].numpy().tobytes()
        assert got == jc[j, :jl[j]].tobytes() == golden.compress_deep(b), j

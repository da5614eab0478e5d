"""The enc3 engine's plain versions (K2 candidates and K7 whole-block
parse on CPU tensors) and the seg_splice engine against golden and the
JAX enc3 kernel in interpret mode. Outputs are bytes and integers: every
comparison is exact."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops import encode as E
from lz4_sgori_torch.ops import seg as S
from lz4_sgori_torch.ops.decode import decompress_blocks_device
from lz4_sgori_torch.ops.enc3 import compress_blocks_enc3
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

LOREM = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed "
         b"do eiusmod tempor incididunt ut labore et dolore magna aliqua. ")


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return raw, rlen


def _match_sequences(stream: bytes) -> int:
    """Sequences with a match in an LZ4 block (all but the terminal)."""
    tail = golden.tail_offset(stream)
    ip = n = 0
    while ip < tail:
        token = stream[ip]
        ip += 1
        for nib, is_lit in ((token >> 4, True), (token & 15, False)):
            if nib == 15:
                while True:
                    b = stream[ip]
                    ip += 1
                    nib += b
                    if b != 255:
                        break
            if is_lit:
                ip += nib + 2               # literals and the offset
        n += 1
    return n


def _jax_blocks(bs, rng):
    """test_enc3_parity_small's cases, sized to ``bs``."""
    return [
        bytes(bs),
        (b"the quick brown fox " * (bs // 16))[:bs],
        bytes(rng.randint(0, 256, bs, np.int64).astype(np.uint8)),
        b"ab" * (bs // 2),
        (bytes(rng.randint(0, 256, 100).astype(np.uint8)) * 12)[:bs],
        b"z" * 37,
        b"",
        b"abc",
        bytes(rng.randint(0, 3, bs, np.int64).astype(np.uint8)),
        bytes(rng.randint(0, 256, 20).astype(np.uint8)) + bytes(bs // 5)
        + bytes(rng.randint(0, 256, bs - 20 - bs // 5).astype(np.uint8)),
    ]


def _port(raw, rlen, bs, accel=1):
    return [t.numpy() for t in compress_blocks_enc3(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs, accel,
        return_tails=True, return_nseq=True)]


@pytest.mark.parametrize("bs", [256, 512, 1024])
def test_plain_enc3_matches_jax_enc3_interpret(bs):
    """out, out_len, err and tails against the JAX kernel; nseq against
    the golden stream's match count (and the JAX kernel's at 512)."""
    from lz4_sgori_tpu.ops.pallas.lockstep_enc3 import (
        compress_blocks_lockstep_enc3)
    raw, rlen = _batch(_jax_blocks(bs, np.random.RandomState(bs)), bs)
    comp, clen, err, tails, nseq = _port(raw, rlen, bs)
    jc, jl, je, jt = map(np.asarray, compress_blocks_lockstep_enc3(
        raw, rlen, bs, interpret=True, return_tails=True))
    bound = F.compress_bound(bs)
    assert comp.shape == (len(rlen), bound + 8)
    assert np.array_equal(comp[:, :bound], jc)
    assert not comp[:, bound:].any()
    assert np.array_equal(clen, jl)
    assert np.array_equal(err, je) and not err.any()
    assert np.array_equal(tails, jt)
    for j in range(len(rlen)):
        s = comp[j, :clen[j]].tobytes()
        assert s == golden.compress_dense(raw[j, :rlen[j]].tobytes(),
                                          hashlog=16), j
        assert int(nseq[j]) == _match_sequences(s), j
    if bs == 512:
        *_, jn = compress_blocks_lockstep_enc3(raw, rlen, bs, interpret=True,
                                               return_nseq=True)
        assert np.array_equal(nseq, np.asarray(jn))


@pytest.mark.parametrize("accel", [1, 2, 8])
def test_plain_enc3_matches_golden_dense_4k(fixtures, accel):
    bs = 4096
    rng = np.random.default_rng(accel)
    blocks = [fixtures[k][:bs] for k in
              ("text_small", "zeros_4k", "random_4k", "rle_period3",
               "structured", "mixed", "tiny", "min_len", "one", "empty")]
    blocks += [rng.integers(0, 4, bs, dtype=np.uint8).tobytes(),
               (LOREM * 70)[:bs - 999]]
    raw, rlen = _batch(blocks, bs)
    comp, clen, err, tails, nseq = _port(raw, rlen, bs, accel)
    assert not err.any()
    for j, b in enumerate(blocks):
        want = golden.compress_dense(b, acceleration=accel, hashlog=16)
        assert comp[j, :clen[j]].tobytes() == want, j
        assert not comp[j, clen[j]:].any(), j
        assert int(tails[j]) == golden.tail_offset(want), j
        assert int(nseq[j]) == _match_sequences(want), j


@pytest.mark.parametrize("n", [0, 1, 12, 13, 5000])
def test_edge_lengths_through_the_routed_engines(fixtures, n):
    """Short and empty blocks (below MIN_LENGTH they are literal-only) and
    a short last block, in the non-aligned enc3 band (5000-byte blocks),
    encoded and decoded through the routing table."""
    bs = 5000
    data = (fixtures["text_large"] + fixtures["random_jpeg_scale"])[:n]
    blocks = [data, fixtures["text_large"][:bs], data]
    raw, rlen = _batch(blocks, bs)
    comp, clen = E.compress_blocks_device(torch.from_numpy(raw),
                                          torch.from_numpy(rlen), bs)
    for j, b in enumerate(blocks):
        assert comp[j, :clen[j]].numpy().tobytes() == \
            golden.compress_dense(b, hashlog=16), j
    out, out_len, err = decompress_blocks_device(comp, clen, bs)
    assert not err.any()
    for j, b in enumerate(blocks):
        assert out[j, :len(b)].numpy().tobytes() == b
        assert int(out_len[j]) == len(b)


def test_plain_k7_equals_k3_then_k4_at_seg_block_size(fixtures):
    """K7's contract is K3's parse over one segment spanning the block plus
    the terminal run, which the seg engine's assembly (K4) appends."""
    bs = 4096
    blocks = [fixtures[k][:bs] for k in
              ("text_small", "random_4k", "structured", "tiny", "empty")]
    raw, rlen = _batch(blocks, bs)
    rt, lt = torch.from_numpy(raw), torch.from_numpy(rlen)
    comp, clen, err, tails, nseq = compress_blocks_enc3(
        rt, lt, bs, return_tails=True, return_nseq=True)
    sc, sl, serr, sns = S.compress_blocks_seg(rt, lt, bs, seg=bs)
    assert not err.any() and not serr.any()
    assert torch.equal(comp, sc) and torch.equal(clen, sl)
    assert torch.equal(nseq, sns)


def test_plain_tails_splice_to_golden_segmented():
    """The tails output feeds golden.splice_segments (test_enc3_tails_
    match_oracle_and_splice's shape, 2 KiB segments)."""
    from __graft_entry__ import _synth_corpus
    seg = 2048
    data = _synth_corpus(3 * seg + 501, seed=21)
    parts = [data[s:s + seg] for s in range(0, len(data), seg)]
    raw, rlen = _batch(parts, seg)
    comp, clen, err, tails, _ = _port(raw, rlen, seg)
    assert not err.any()
    streams = [comp[s, :clen[s]].tobytes() for s in range(len(parts))]
    spliced = golden.splice_segments(streams, [int(t) for t in tails])
    assert spliced == golden.compress_segmented(data, seg=seg)
    assert golden.decompress(spliced, len(data)) == data


def test_seg_splice_matches_golden_segmented_96k():
    """Two 96 KiB blocks (one short) through the seg_splice engine: the
    bytes equal golden.compress_segmented and decode through v7."""
    from __graft_entry__ import _synth_corpus
    bs = 96 * 1024
    data = _synth_corpus(2 * bs - 5000, seed=7)
    blocks = [data[:bs], data[bs:]]
    raw, rlen = _batch(blocks, bs)
    comp, clen, cost = E.compress_blocks_device(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs, return_cost=True)
    assert comp.shape == (2, F.compress_bound(bs) + 8)
    assert torch.equal(cost, clen)
    for j, b in enumerate(blocks):
        assert comp[j, :clen[j]].numpy().tobytes() == \
            golden.compress_segmented(b), j
    out, out_len, err = decompress_blocks_device(comp, clen, bs)
    assert not err.any()
    for j, b in enumerate(blocks):
        assert out[j, :len(b)].numpy().tobytes() == b


def test_errors_fold_to_comp_len_zero(monkeypatch, fixtures):
    """A K7 error (a block past compress_bound) gives comp_len 0 through
    the enc3 dispatch and the seg_splice engine."""
    from lz4_sgori_torch.ops import enc3 as E3
    real = E3.parse_blocks_enc3

    def failing(raw, cand, raw_len, accel=1):
        out, out_len, err, tails, nseq = real(raw, cand, raw_len, accel)
        return out, out_len, torch.ones_like(err), tails, nseq

    monkeypatch.setattr(E3, "parse_blocks_enc3", failing)
    raw, rlen = _batch([fixtures["text_small"][:4096]], 4096)
    _, clen = E.compress_blocks_device(torch.from_numpy(raw),
                                       torch.from_numpy(rlen), 4096)
    assert clen.tolist() == [0]
    raw, rlen = _batch([fixtures["text_large"]], 96 * 1024)
    _, clen = E.compress_blocks_device(torch.from_numpy(raw),
                                       torch.from_numpy(rlen), 96 * 1024)
    assert clen.tolist() == [0]


def test_wrappers_reject_bad_inputs():
    raw = torch.zeros((2, 4096), dtype=torch.uint8)
    rl = torch.zeros(2, dtype=torch.int32)
    cand = torch.zeros((2, 4096), dtype=torch.int32)
    with pytest.raises(TypeError):
        K7.parse_blocks_enc3(raw, cand.to(torch.int64), rl)
    with pytest.raises(TypeError):
        K7.parse_blocks_enc3(raw, cand, rl.to(torch.int64))
    with pytest.raises(ValueError, match="seg_splice"):
        K7.parse_blocks_enc3(torch.zeros((1, 65537), dtype=torch.uint8),
                             torch.zeros((1, 65537), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="at most 65536"):
        compress_blocks_enc3(torch.zeros((1, 70000), dtype=torch.uint8),
                             torch.zeros(1, dtype=torch.int32), 70000)
    before = (K2.launches, K7.launches)
    compress_blocks_enc3(raw, rl, 4096)
    assert (K2.launches, K7.launches) == before   # CPU runs plain versions

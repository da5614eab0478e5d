"""The big-block path on CPU tensors: K9's plain version against
golden.dense_candidates_piecewise, the seg_big engine against
golden.compress_dense_seg_big, the mlen gate (the mode at 64 KiB, the
default bytes above), and container round trips
at 128 KiB (seg_big + v7) and 512 KiB (seg_big + v8). Outputs are bytes,
so every comparison is exact. The JAX seg engine is too slow in
interpret mode at these sizes, so golden is the reference here, as it is
for the JAX package's own big-block tests."""

import numpy as np
import pytest
import torch

import lz4_sgori_torch
from lz4_sgori_torch import routing as R
from lz4_sgori_torch.ops import seg as S
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
from lz4_sgori_tpu import golden

LOREM = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed "
         b"do eiusmod tempor incididunt ut labore et dolore magna aliqua. ")


def big_blocks(bs: int, seed: int = 55):
    """K9's cases at block size ``bs`` (a multiple of 64 KiB): full and
    short (``bs - 999``) corpus blocks, zeros, random bytes, and two
    periodic inputs: period 1,000 gives every position from 1,000 on a
    candidate, among them a piece's position 65,535 and the next
    half-piece's first positions; period 40,000 puts its repeats across
    the half-piece windows' edges."""
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(seed)
    data = _synth_corpus(2 * bs, seed=seed)
    return [
        data[:bs],
        data[bs:2 * bs - 999],
        bytes(bs),
        rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),
        (rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
         * (bs // 1000 + 1))[:bs],
        (rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
         * (bs // 40000 + 1))[:bs],
    ]


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw), torch.from_numpy(rlen)


def _golden_piecewise(blocks, bs, piece=65536):
    want = np.zeros((len(blocks), bs), np.int64)
    for j, b in enumerate(blocks):
        want[j, :len(b)] = golden.dense_candidates_piecewise(b, piece)
    return want


@pytest.mark.parametrize("bs", [131072, 262144])
def test_k9_plain_matches_golden(bs):
    blocks = big_blocks(bs)
    got = K9.dense_candidates_piecewise(*_batch(blocks, bs)).numpy()
    want = _golden_piecewise(blocks, bs)
    for j in range(len(blocks)):
        assert np.array_equal(got[j], want[j]), j
    per = want[4]                      # period 1,000 across the boundaries
    assert per[65535] == per[65536] == 1000
    assert (per[65536:65540] > 0).all()


@pytest.mark.parametrize("bs,lens", [
    (8192, (8192, 8191, 4096 + 5, 515, 512 + 3, 3, 0)),
    (16384, (16384, 16384 - 999, 9000)),
    (32768, (32768, 32768 - 1)),
])
def test_k9_plain_piece_boundary_sweep(bs, lens):
    """piece = 1,024 (half-pieces of 512) crosses many boundaries on small
    inputs: text, 4-symbol and random data at the lengths given."""
    rng = np.random.default_rng(bs)
    kinds = [(LOREM * (bs // 64 + 1))[:bs],
             rng.integers(0, 4, bs, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, bs, dtype=np.uint8).tobytes()]
    blocks = [k[:n] for k in kinds for n in lens]
    got = K9.dense_candidates_piecewise(*_batch(blocks, bs),
                                        piece=1024).numpy()
    assert np.array_equal(got, _golden_piecewise(blocks, bs, 1024))


def test_k9_and_k2_wrappers_reject_bad_inputs():
    raw = torch.zeros((1, 131072), dtype=torch.uint8)
    rl = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="dense_candidates_piecewise"):
        K2.dense_candidates(raw, rl)
    for piece in (1000, 32, 131072):
        with pytest.raises(ValueError, match="piece"):
            K9.dense_candidates_piecewise(raw, rl, piece=piece)
    with pytest.raises(TypeError):
        K9.dense_candidates_piecewise(raw, rl.to(torch.int64))
    with pytest.raises(ValueError, match="multiples of 64 KiB"):
        S.compress_blocks_seg(torch.zeros((1, 139264), dtype=torch.uint8),
                              rl, 139264, seg=4096)


@pytest.mark.parametrize("bs,accel", [(131072, 1), (131072, 8),
                                      (524288, 1)])
def test_seg_big_matches_golden(bs, accel):
    """compress_blocks_device at 128 KiB (32 segments) and 512 KiB (128
    segments), seg = seg_for(bs) = 4,096: each block equals
    golden.compress_dense_seg_big, a short last block included."""
    from __graft_entry__ import _synth_corpus
    assert R.select_encode_engine(bs, 1) == "seg_big"
    seg = R.seg_for(bs)
    assert seg == 4096
    data = _synth_corpus(2 * bs, seed=55)
    blocks = [data[:bs], data[bs:2 * bs - 12345]]
    comp, clen, cost = compress_blocks_device(*_batch(blocks, bs), bs,
                                              acceleration=accel,
                                              return_cost=True)
    comp, clen = comp.numpy(), clen.numpy()
    for j, b in enumerate(blocks):
        want = golden.compress_dense_seg_big(b, seg, acceleration=accel)
        assert comp[j, :clen[j]].tobytes() == want, j
        assert not comp[j, clen[j]:].any(), j
    assert (cost.numpy() > 0).all()


def test_mlen_gate_follows_the_jax_package(monkeypatch):
    """LZ4J_ENC_MLEN=1 runs mlen in the JAX package only at depth 1 and
    blocks of at most 64 KiB: the port runs the mode there (K10, golden's
    bytes) and serves 128 KiB with the default bytes, without the mode."""
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    calls = []
    real = S.dense_mcode
    monkeypatch.setattr(S, "dense_mcode",
                        lambda *a: calls.append(1) or real(*a))
    block = (LOREM * 2100)[:131072 - 5000]
    raw, rl = _batch([block], 131072)
    comp, clen = compress_blocks_device(raw[:, :65536].contiguous(),
                                        rl.clamp(max=65536), 65536)
    assert len(calls) == 1 and comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg(block[:65536], 4096, 65536, 16)
    comp, clen = compress_blocks_device(raw, rl, 131072)
    assert len(calls) == 1
    assert comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg_big(block, 4096)


@pytest.mark.parametrize("bs,decode", [(131072, "v7"), (524288, "v8")])
def test_big_block_container_round_trip(fixtures, bs, decode):
    """The slice as a whole on CPU tensors: a container through seg_big
    and the routed decode with no host fallback. The 128 KiB container
    also decodes under the JAX package, native and liblz4."""
    from lz4_sgori_tpu import blocks as JB
    from lz4_sgori_tpu import native
    from lz4_sgori_tpu.utils import oracle
    from lz4_sgori_tpu.utils.stats import Stats
    assert R.select_decode_engine(bs) == decode
    data = fixtures["mixed"] + fixtures["structured"]
    if bs == 131072:
        data = data + fixtures["text_large"] + fixtures["mixed"]
    stats = Stats()
    container = lz4_sgori_torch.compress(data, bs, stats=stats, device="cpu")
    assert lz4_sgori_torch.decompress(container, device="cpu") == data
    assert stats.encode_fallbacks == 0
    cb = JB.CompressedBlocks.from_container(container)
    for j in range(cb.num_blocks):
        blk = data[j * bs:(j + 1) * bs]
        c = cb.comp[j, :cb.comp_len[j]].tobytes()
        assert c == golden.compress_dense_seg_big(blk, R.seg_for(bs)), j
        if bs == 131072 and native.available():
            assert native.decompress(c, bs) == blk
        if bs == 131072 and oracle.available():
            assert oracle.decompress(c, bs) == blk
    if bs == 131072:
        assert cb.num_blocks > 1
        assert JB.decompress(container) == data

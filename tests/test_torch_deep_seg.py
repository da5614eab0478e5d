"""The deep match modes (K8) of the seg engines and the slice as a whole
on CPU tensors: K8-seg against compress_dense_seg_parts(depth=3), the seg
engine at depth 2-3 against compress_dense_seg(depth=3), seg_big at
depth 3 (K9's tape, the piecewise gaps, K8-seg) against
compress_dense_seg_big(depth=3) with the depth-cap warning, and
``lz4_sgori_torch.compress`` at match depth 3 and 5 round-tripping.
Outputs are bytes, so every comparison is exact."""

import pytest
import torch

import lz4_sgori_torch
from lz4_sgori_torch import routing as R
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import gaps as G
from lz4_sgori_torch.ops.kernels import parse_seg_deep as K8S
from lz4_sgori_tpu import golden
from test_torch_deep import _batch, _piecewise_cases, deep_blocks
from test_torch_threads import one_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("bs,accel", [(16384, 1), (16384, 8), (65536, 1)])
def test_seg_deep_plain_matches_golden(bs, accel):
    """K8-seg's plain version against compress_dense_seg_parts(depth=3)
    segment for segment, and the seg engine at depth 3 (and 2, which the
    seg engines run as 3) against compress_dense_seg(depth=3)."""
    blocks = deep_blocks(bs, seed=bs)
    if bs == 65536:
        blocks = [blocks[0], blocks[2], blocks[5]]
    raw, rlen = _batch(blocks, bs)
    cand = K2.dense_candidates(raw, rlen)
    gaps, _ = G.chain_gaps(cand, 2)
    streams, slen, serr, last_end, nseq, p1, m1h = \
        K8S.parse_segments_deep(raw, cand, gaps, rlen, seg=4096,
                                accel=accel)
    assert not serr.any()
    nseg = bs // 4096
    for j, b in enumerate(blocks):
        parts = golden.compress_dense_seg_parts(b, 4096, acceleration=accel,
                                                depth=3)
        for k, pt in enumerate(parts):
            r = j * nseg + k
            assert streams[r, :slen[r]].numpy().tobytes() == pt["stream"]
            assert (int(last_end[r]), int(p1[r]), int(m1h[r]) & 0xFFFF,
                    bool(m1h[r] >> 16)) == (pt["last_end"], pt["p1"],
                                            pt["m1"], pt["has_match"])
    for md in (2, 3):
        assert R.select_encode_engine(bs, md) == "seg"
        comp, clen = compress_blocks_device(raw, rlen, bs, match_depth=md,
                                            acceleration=accel)
        for j, b in enumerate(blocks):
            want = golden.compress_dense_seg(b, 4096, 65536, 16, accel,
                                             depth=3)
            assert comp[j, :clen[j]].numpy().tobytes() == want, (md, j)


@pytest.mark.parametrize("bs", [131072])
def test_seg_big_deep_matches_golden(bs):
    """seg_big at depth 3 (K9, piecewise gaps, K8-seg, K4) equals
    compress_dense_seg_big(depth=3); depth 5 warns and runs depth 3."""
    blocks = _piecewise_cases(bs)
    raw, rlen = _batch(blocks, bs)
    comp, clen = compress_blocks_device(raw, rlen, bs, match_depth=3)
    for j, b in enumerate(blocks):
        want = golden.compress_dense_seg_big(b, R.seg_for(bs), depth=3)
        assert comp[j, :clen[j]].numpy().tobytes() == want, j
    with pytest.warns(UserWarning, match="depth cap"):
        c5, l5 = compress_blocks_device(raw[:1], rlen[:1], bs, match_depth=5)
    assert torch.equal(c5, comp[:1]) and torch.equal(l5, clen[:1])


@pytest.mark.parametrize("bs,depth", [(4096, 5), (16384, 3), (20000, 3),
                                      (131072, 3)])
def test_compress_at_depth_round_trips(fixtures, bs, depth):
    """The slice as a whole: lz4_sgori_torch.compress at match_depth 3 and
    5 on CPU tensors round-trips with no host fallback, is no larger than
    depth 1, and decodes under the JAX package."""
    from lz4_sgori_torch.utils.stats import Stats
    from lz4_sgori_tpu import blocks as JB
    data = (fixtures["mixed"] + fixtures["text_large"]
            + fixtures["structured"][:30000])[:2 * bs + 777]
    stats = Stats()
    deep = lz4_sgori_torch.compress(data, bs, match_depth=depth, stats=stats,
                                    device="cpu")
    assert stats.encode_fallbacks == 0
    assert lz4_sgori_torch.decompress(deep, device="cpu") == data
    assert JB.decompress(deep) == data
    greedy = lz4_sgori_torch.compress(data, bs, device="cpu")
    assert len(deep) <= len(greedy)


def test_stores_write_at_match_depth(tmp_path, fixtures):
    """The stores take a match depth for their writes: a ProxyStore at
    depth 3 (seg) verifies and writes through, a CompressedStore at depth
    5 (enc3) persists golden.compress_deep's bytes and reads them back."""
    from lz4_sgori_torch import blocks as TB
    from lz4_sgori_torch import store as ST
    data = (fixtures["text_large"] + fixtures["mixed"])[:4 * 16384]
    st = ST.ProxyStore(str(tmp_path / "b.img"), chunk_size=16384,
                       capacity=len(data), device="cpu", match_depth=3)
    st.write(0, data)
    assert st.read(0, len(data)) == data
    assert st.stats.encode_fallbacks == 0
    st.close()
    cst = ST.CompressedStore(str(tmp_path / "c"), chunk_size=4096,
                             device="cpu", match_depth=5)
    for i in range(3):
        cst.write_chunk(i, data[i * 4096:(i + 1) * 4096])
    for i in range(3):
        chunk = data[i * 4096:(i + 1) * 4096]
        assert cst.read_chunk(i) == chunk
        with open(cst._path(i), "rb") as f:
            cb = TB.CompressedBlocks.from_container(f.read())
        assert cb.comp[0, :cb.comp_len[0]].tobytes() == \
            golden.compress_deep(chunk, depth=5)
    assert cst.stats.encode_fallbacks == 0

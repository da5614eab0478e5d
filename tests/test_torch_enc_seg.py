"""The seg engine's plain versions (K2 candidates, K3 parse, the glue and
K4 assembly on CPU tensors) against the golden seg oracles and the JAX
kernels in interpret mode. Outputs are bytes: every comparison is exact."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops import seg as S
from lz4_sgori_torch.ops.kernels import asm_seg as K4
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import parse_seg as K3
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


def _cand_blocks(bs):
    rng = np.random.RandomState(5)
    return [
        (b"abcab" * 300)[:bs],
        bytes(rng.randint(0, 256, bs).astype(np.uint8)),
        bytes(rng.randint(0, 4, bs).astype(np.uint8)),
        bytes(bs),
        b"xyz",                         # < MINMATCH positions
    ]


def test_plain_candidates_match_golden_and_jax_interpret():
    from lz4_sgori_tpu.ops.pallas.lockstep_enc3 import (
        compress_blocks_lockstep_enc3)
    bs = 1024
    blocks = _cand_blocks(bs)
    raw, rlen = _batch(blocks, bs)
    got = K2.dense_candidates(torch.from_numpy(raw),
                              torch.from_numpy(rlen)).numpy()
    jc, jdens = compress_blocks_lockstep_enc3(raw, rlen, bs, interpret=True,
                                              cand_only=True)
    jc = np.asarray(jc)
    for j, b in enumerate(blocks):
        want = np.zeros(bs, np.int64)
        want[:len(b)] = golden.dense_candidates(b, hashlog=16,
                                                val16_filter=False)
        assert np.array_equal(got[j], want), j
        assert np.array_equal(got[j], jc[0, :bs, j] & 0xFFFF), j
        assert int((got[j] != 0).sum()) == int(np.asarray(jdens)[0, 0, j])


def test_hash16_matches_format():
    from lz4_sgori_tpu import format as F
    vs = [0, 1, 0xFFFFFFFF, 0x12345678, 0x80000000, 0xDEADBEEF, 65535]
    got = K2.hash16(torch.tensor(vs, dtype=torch.int64)).tolist()
    assert got == [F.hash4(v, 16) for v in vs]


def _seg_blocks(bs, rng):
    return [
        (LOREM * 300)[:bs],
        bytes(bs // 4) + rng.integers(0, 256, bs // 2,
                                      dtype=np.uint8).tobytes()
        + (b"ab" * bs)[:bs // 4],
        rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),
        (LOREM * 3)[:300],
        b"",
        b"abcabcabcabcabcabc",
        b"aaaaaaaaaaaa",                  # n < 13
        bytes(bs),
        (b"x" * 4095 + b"Q") * (bs // 4096),   # matches crossing segments
        (LOREM * 200)[:bs - 4096 - 77],        # tail segments past raw_len
    ]


def test_plain_parse_glue_assembly_match_golden_parts():
    """16 KiB blocks, seg 4096, window 65536: per-segment parse outputs
    equal golden.compress_dense_seg_parts and the assembled blocks equal
    golden.assemble_seg_parts."""
    bs, seg = 16384, 4096
    nseg = bs // seg
    blocks = _seg_blocks(bs, np.random.default_rng(42))
    raw, rlen = _batch(blocks, bs)
    rt, lt = torch.from_numpy(raw), torch.from_numpy(rlen)
    cand = K2.dense_candidates(rt, lt)
    streams, slen, serr, last_end, nseq, p1, m1h = K3.parse_segments(
        rt, cand, lt, seg=seg, window=65536)
    assert not serr.any()
    for j, b in enumerate(blocks):
        parts = golden.compress_dense_seg_parts(b, seg, 65536, 16)
        for k, pt in enumerate(parts):
            r = j * nseg + k
            assert streams[r, :slen[r]].numpy().tobytes() == pt["stream"]
            assert int(last_end[r]) == pt["last_end"], (j, k)
            assert bool(m1h[r] >> 16) == pt["has_match"], (j, k)
            if k > 0 and pt["has_match"]:
                assert int(p1[r]) == pt["p1"], (j, k)
                assert int(m1h[r] & 0xFFFF) == pt["m1"], (j, k)
        for k in range(len(parts), nseg):      # past raw_len: empty
            assert int(slen[j * nseg + k]) == 0
            assert not int(m1h[j * nseg + k])
    comp, clen, err, nseq_b = S.compress_blocks_seg(rt, lt, bs, seg=seg)
    assert not err.any()
    assert torch.equal(nseq_b, nseq.reshape(-1, nseg).sum(1).to(torch.int32))
    for j, b in enumerate(blocks):
        parts = golden.compress_dense_seg_parts(b, seg, 65536, 16)
        want = golden.assemble_seg_parts(b, parts, seg)
        assert comp[j, :clen[j]].numpy().tobytes() == want, j
        assert not comp[j, clen[j]:].any(), j
        assert golden.decompress(want, len(b)) == b


@pytest.mark.parametrize("accel,window", [(1, 4096), (8, 4096), (3, 65536)])
def test_plain_engine_matches_golden_small_shapes(accel, window):
    """The JAX seg tests' small shape (4 KiB blocks, 512-byte segments),
    with the restricted window and the acceleration knob."""
    bs, seg = 4096, 512
    rng = np.random.default_rng(7)
    blocks = [
        (LOREM * 40)[:bs],
        bytes(1000) + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
        + (b"ab" * 600)[:1096],
        rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),
        (LOREM * 3)[:300], b"", b"abcabcabcabcabcabc", bytes(bs),
        (b"x" * 511 + b"Q") * 8,
    ]
    raw, rlen = _batch(blocks, bs)
    comp, clen, err, _ = S.compress_blocks_seg(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs, seg=seg,
        window=window, accel=accel)
    assert not err.any()
    for j, b in enumerate(blocks):
        want = golden.compress_dense_seg(b, seg=seg, window=window,
                                         acceleration=accel)
        assert comp[j, :clen[j]].numpy().tobytes() == want, j


def test_plain_engine_matches_jax_seg_interpret():
    """test_seg_quick_smoke's shape through the JAX seg engine (interpret
    mode) and the port."""
    from lz4_sgori_tpu.ops.pallas.lockstep_enc3 import (
        compress_blocks_lockstep_seg)
    bs, seg, w = 4096, 512, 4096
    rng = np.random.default_rng(7)
    raw, rlen = _batch([
        (LOREM * 40)[:bs],
        bytes(512) + rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
        + (b"ab" * 300)[:600],
        b"abcabcabcabcabcabc",
    ], bs)
    jc, jl, je = map(np.asarray, compress_blocks_lockstep_seg(
        raw, rlen, bs, seg=seg, window=w, interpret=True))
    comp, clen, err, _ = S.compress_blocks_seg(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs, seg=seg, window=w)
    assert not je.any() and not err.any()
    assert np.array_equal(clen.numpy(), jl)
    for j in range(raw.shape[0]):
        assert comp[j, :clen[j]].numpy().tobytes() == \
            jc[j, :jl[j]].tobytes(), j


def test_plain_assembly_random_pieces():
    """K4's plain version against a host concat of random pieces,
    including an output that passes the capacity."""
    rng = np.random.default_rng(9)
    nb, nseg, scap, hmax, bs = 3, 4, 40, 12, 96
    streams = rng.integers(0, 256, (nb * nseg, scap), dtype=np.uint8)
    hdr = rng.integers(0, 256, (nb * nseg, hmax), dtype=np.uint8)
    raw = rng.integers(0, 256, (nb, bs), dtype=np.uint8)
    plan = np.zeros((nb, nseg, 4), np.int32)
    plan[..., 0] = rng.integers(0, scap + 1, (nb, nseg))
    plan[..., 1] = rng.integers(0, hmax + 1, (nb, nseg))
    plan[..., 2] = rng.integers(0, bs // 2, (nb, nseg))
    plan[..., 3] = rng.integers(0, bs // 2, (nb, nseg))
    ocap = 200
    out, out_len = K4.assemble_segments(
        *(torch.from_numpy(a) for a in (streams, hdr, raw, plan)), ocap)
    for b in range(nb):
        want = b""
        for k in range(nseg):
            r = b * nseg + k
            sl, hl, t0, tl = plan[b, k]
            want += streams[r, :sl].tobytes() + hdr[r, :hl].tobytes() \
                + raw[b, t0:t0 + tl].tobytes()
        assert int(out_len[b]) == len(want)
        n = min(len(want), ocap)
        assert out[b, :n].numpy().tobytes() == want[:n]
        assert not out[b, n:].any()


def test_run_headers_match_golden_lit_header():
    """Owner headers of long runs need the literal LSIC (up to 258 bytes
    at 64 KiB): a block of one long literal run plus a late match."""
    bs = 65536
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, bs - 9000, dtype=np.uint8).tobytes() \
        + (LOREM * 100)[:9000]
    raw, rlen = _batch([b], bs)
    comp, clen, err, _ = S.compress_blocks_seg(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs)
    assert not err.any()
    assert comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg(b, 4096, 65536, 16)


def test_wrappers_reject_bad_inputs():
    raw = torch.zeros((2, 4096), dtype=torch.uint8)
    rl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="piecewise"):
        K2.dense_candidates(torch.zeros((1, 131072), dtype=torch.uint8),
                            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        K2.dense_candidates(raw, rl.to(torch.int64))
    with pytest.raises(ValueError, match="divide"):
        K3.parse_segments(raw, torch.zeros((2, 4096), dtype=torch.int32),
                          rl, seg=3000)
    with pytest.raises(TypeError):
        K4.assemble_segments(raw, raw, raw, torch.zeros((2, 1, 3),
                                                        dtype=torch.int32),
                             64)

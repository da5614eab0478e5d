"""K8-seg's warp walk (``csrc/parse_seg_warp.cuh`` at N = 3) emulated on
the CPU, lane for lane, and held bit for bit against
``parse_segments_deep_plain`` (err, and where err is 0 the stream, slen,
last_end, nseq, p1 and m1h).

The emulation is K3's (``test_torch_warp_seg.emulate`` and its walk, the
CTA's bytes and its reads from the row) with the gaps row: the probe
hits when one of the chain candidates d1, d1 + g2, + g3 passes the
checks, and the hit's and p + 1's candidates are previewed by
``test_torch_warp_parse.WarpWalk.previews`` (two lanes a candidate, 32
bytes a lane, the key ``(mc + 1) << 4 | (15 - i)``, the cap at mlim), the
lazy step taken on a strictly longer preview and the extension going on
from the winner's preview. Cases: 64 KiB at acceleration 1 and 8 and
window 65536 and 4096; 128 KiB at seg 4096 on K9's tape with its floored
gaps, reading back into the previous 64 KiB; a tie at the mlim cap, at a
segment's end and at a block's; a lazy step on a segment's last probe;
and every routed deep shape's CTA fitting the card. The card runs the
kernel itself (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest

from lz4_sgori_torch import routing as R
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
from lz4_sgori_torch.ops.kernels import gaps as G
from lz4_sgori_torch.ops.kernels import parse_seg_deep as K8S
from test_torch_threads import one_thread  # noqa: F401 (a fixture)
from test_torch_warp_parse import cap_block
from test_torch_warp_seg import (MAX_WARPS, SMEM_LIMIT, Geometry, _batch,
                                 _blocks, assert_equal_parse, emulate)


def _deep(raw, rlen, seg, window=65536, accel=1, stats=None):
    """The emulated kernel and the plain version over the same tapes."""
    bs = raw.shape[1]
    big = bs > 65536
    cand = (K9.dense_candidates_piecewise(raw, rlen) if big
            else K2.dense_candidates(raw, rlen))
    gaps, _ = G.chain_gaps(cand, 2, K9.PIECE // 2 if big else 0)
    got = emulate(raw, cand, rlen, seg, window, accel, stats=stats,
                  gaps=gaps)
    want = K8S.parse_segments_deep_plain(raw, cand, gaps, rlen, seg, window,
                                         accel)
    return got, want


def sequences(stream: bytes, s0: int):
    """(match start, offset, match length) of each sequence of a segment
    stream with a header on its first sequence (k = 0), from s0."""
    out, i, pos = [], 0, s0

    def lsic(i, v):
        if v == 15:
            while True:
                b = stream[i]
                i += 1
                v += b
                if b != 255:
                    break
        return i, v
    while i < len(stream):
        tok = stream[i]
        i, lit = lsic(i + 1, tok >> 4)
        i += lit
        pos += lit
        off = stream[i] | stream[i + 1] << 8
        i, ml = lsic(i + 2, tok & 15)
        out.append((pos, off, ml + 4))
        pos += ml + 4
    return out


@pytest.mark.parametrize("accel,window", [(1, 65536), (8, 4096)])
def test_warp_seg_deep_64k_matches_plain(accel, window):
    raw, rlen = _batch(_blocks(65536), 65536)
    got, want = _deep(raw, rlen, 4096, window, accel)
    assert not want[2].any()
    assert_equal_parse(got, want)


def test_warp_seg_deep_128k_reads_back_into_the_previous_64k():
    """128 KiB at seg 4096 (seg_big's shape there), K9's tape and its
    floored gaps: the CTAs of segments past 64 KiB read older sources,
    the previews' 64 bytes of them too, from the row."""
    raw, rlen = _batch(_blocks(131072, seed=4)[:1], 131072)
    assert R.seg_for(131072) == 4096
    stats = {}
    got, want = _deep(raw, rlen, 4096, stats=stats)
    assert_equal_parse(got, want)
    assert stats["global_reads"] > 0
    nseg = 32
    back = []
    for t in range(16, nseg):
        s0, p1 = t * 4096, int(want[5][t])
        if want[6][t] >> 16:
            lit = p1 - s0
            off = int(want[0][t, lit]) | int(want[0][t, lit + 1]) << 8
            back.append(p1 - off)
    assert min(back) < 65536


def _rand(rng, k):
    return rng.integers(0, 256, k, dtype=np.uint8).tobytes()


def test_tie_at_the_mlim_cap():
    """The cap min(mlim - p - 4, 64) at a segment's end (mlim = s1) and at
    a block's (mlim = n - 5): a far candidate that would preview past the
    cap ties a near one at it, and the near one wins."""
    rng = np.random.default_rng(23)
    t = b"ABCDEFGHIJKLMNOP"
    part = cap_block(rng)                       # ends with t at n - 16
    seg0 = _rand(rng, 4096 - len(part) + 5) + part[:-5]
    assert len(seg0) == 4096 and seg0[-11:] == t[:11]
    block = seg0 + t[11:] + _rand(rng, 3000)    # the far t goes on past s1
    blocks = [block, part]
    raw, rlen = _batch(blocks, 8192)
    got, want = _deep(raw, rlen, 4096)
    assert_equal_parse(got, want)
    # segment 0 of the first block and the second block's only stream:
    # the last match takes the near t[:11] + "lmnop" (offset to it)
    for row, s_end, p in ((0, 4096, 4096 - 11), (2, len(part),
                                                 len(part) - 16)):
        seqs = sequences(bytes(want[0][row, :int(want[1][row])].numpy()), 0)
        src = bytes(raw[row // 2].numpy())
        near = src.rfind(t[:11] + b"lmnop", 0, p)
        far = src.find(t, 0, p)
        assert 0 <= far < near
        assert (p, p - near, 11) in seqs, (row, seqs[-3:])


def test_lazy_step_on_a_segments_last_probe():
    """At the last probe p = mfl - 1 of a block's last segment, p's only
    candidate previews 0 bytes and p + 1's 3 (its cap): the match moves to
    p + 1 = mfl."""
    rng = np.random.default_rng(29)
    a1, a2 = b"WXYZQ", b"XYZcdefghijk"
    tail = b"WXYZcdefghijk"                     # from p = n - 13
    b = _rand(rng, 24) + b"\x01"
    block = (_rand(rng, 3000) + a1 + _rand(rng, 40) + a2 + _rand(rng, 40)
             + b + _rand(rng, 7) + b[:-1] + tail)
    n = len(block)
    raw, rlen = _batch([block], 4096)
    got, want = _deep(raw, rlen, 4096)
    assert_equal_parse(got, want)
    seqs = sequences(bytes(want[0][0, :int(want[1][0])].numpy()), 0)
    mfl = n - 12
    src = block
    assert seqs[-1][0] == mfl and seqs[-1][1] == mfl - src.find(a2), seqs


@pytest.mark.parametrize("bs", [8192, 16384, 65536, 131072, 262144, 524288,
                                1 << 20, 4 << 20])
def test_deep_geometry_fits_the_card(bs):
    """Every block size the deep rows route to seg or seg_big (K8-seg)
    takes a CTA that fits the H100's 227 KiB, each segment once."""
    engine = R.select_encode_engine(bs, 3)
    assert engine in ("seg", "seg_big")
    seg = 4096 if engine == "seg" else R.seg_for(bs)
    nb = 3
    G_ = Geometry(nb, bs, seg)
    assert G_.bytes <= SMEM_LIMIT and G_.rows * G_.segs <= MAX_WARPS
    seen = []
    for cta in range(G_.ctas):
        for w in range(G_.rows * G_.segs):
            r, j = divmod(w, G_.segs)
            b = cta * G_.rows + r if G_.cpr == 1 else cta // G_.cpr
            k = (0 if G_.cpr == 1 else (cta % G_.cpr) * G_.segs) + j
            if b < nb and k < bs // seg:
                seen.append(b * (bs // seg) + k)
    assert sorted(seen) == list(range(nb * (bs // seg)))

"""K3's warp walk (``csrc/parse_seg_warp.cuh``) emulated on the CPU, lane
for lane, and held bit for bit against ``parse_segments_plain`` (err,
and where err is 0 the stream, slen, last_end, nseq, p1 and m1h) on a
64 KiB block at seg 4096 and on a 128 KiB block at seg 4096, whose later
segments read back into the previous 64 KiB.

The emulation keeps the kernel's decisions and its memory: the CTA's
shape (``Geometry``: whole small blocks several to a CTA, else 2
consecutive segments of one block, one above seg 4096), the bytes each
CTA copies into shared memory (its segments',
``[s0, min(n, end of its last segment))``), garbage around them, every
read at or past ``s0`` asserted inside the slot, a match source before
them read from the row); the 32-probe
round on the closed-form skip schedule and the first-hit ballot, each
probe reading read32 at ``p - d`` only where the candidate passes; the
catch-up 32 bytes a step back to the anchor; the extension from the
known-equal bytes 128 bytes a step; the sequence's length checked before
it is written; the headerless first sequence of a segment k > 0, its
``p1`` and ``m1``. The card runs the kernel itself
(``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
from lz4_sgori_torch.ops.kernels import parse_seg as K3
from test_torch_threads import one_thread  # noqa: F401 (a fixture)
from test_torch_warp_parse import WarpWalk, ffs, mlen_seen, skip_sum

LANES = 32
GROUP = 2           # seg_warp::kGroup
BACK = 0            # seg_warp::kBack
MAX_WARPS = 16      # seg_warp::kMaxWarps
SPAN = 131072       # seg_warp::kSpan
SLACK = 256         # seg_warp::kSlack
SMEM_LIMIT = 232448


class Geometry:
    """``seg_warp::Geometry``: ``rows`` blocks of ``segs`` segments a CTA,
    ``cpr`` CTAs a block, ``slot`` bytes of shared memory a block."""

    def __init__(self, nb, bs, seg, group=None, back=BACK):
        nseg = bs // seg
        self.back = back
        if group is None:                 # the kernel's choice
            group = 1 if seg > 4096 else GROUP
        if bs <= 65536 and nseg <= group:
            self.segs, self.rows, self.cpr = nseg, max(
                1, min(MAX_WARPS // nseg, 65536 // bs)), 1
            self.ctas = -(-nb // self.rows)
        else:
            self.segs = max(1, min(group, nseg, SPAN // seg))
            self.rows, self.cpr = 1, -(-nseg // self.segs)
            self.ctas = nb * self.cpr
        span_b = min(bs, back + self.segs * seg)
        self.slot = (16 + span_b + SLACK + 15) & ~15
        self.bytes = self.rows * self.slot + 16


class Resident:
    """The bytes of one block that a CTA holds, [lo, hi), garbage
    elsewhere in its slot; the reads at or past s0 must find them there,
    a match source before lo is read from the row in global memory."""

    def __init__(self, block: bytes, lo: int, hi: int, rng):
        self.lo, self.hi = lo, hi
        self.b = rng.integers(0, 256, hi + SLACK + 16, dtype=np.uint8)
        self.b[lo:hi] = np.frombuffer(block[lo:hi], np.uint8)
        self.row = np.frombuffer(block, np.uint8).astype(np.int64)
        self.w64 = self.b.astype(np.int64)
        self.bb, self.rowb = self.b.tobytes(), block
        self.global_reads = 0

    def byte(self, i):
        assert self.lo <= i < self.hi, i
        return int(self.b[i])

    def byte_m(self, i):
        if i >= self.lo:
            return self.byte(i)
        self.global_reads += 1
        return int(self.row[i])

    def rd32(self, i):
        """read32 at each index of ``i`` (a word's 8 aligned bytes must
        lie in the slot)."""
        i = np.asarray(i, np.int64)
        assert (i >= self.lo).all() and (i + 8 <= len(self.b)).all(), i
        w = self.w64
        return w[i] | w[i + 1] << 8 | w[i + 2] << 16 | w[i + 3] << 24

    def rd32_m1(self, i: int) -> int:
        """``rd32_m`` at one index."""
        if i >= self.lo:
            assert i + 8 <= len(self.bb), i
            return int.from_bytes(self.bb[i:i + 4], "little")
        assert i >= 0
        self.global_reads += 1
        return int.from_bytes(self.rowb[i:i + 4], "little")

    def rd32_m(self, i):
        i = np.asarray(i, np.int64)
        on = i >= self.lo
        out = np.zeros(i.shape, np.int64)
        if on.any():
            out[on] = self.rd32(i[on])
        if (~on).any():
            j = i[~on]
            assert (j >= 0).all()
            self.global_reads += int((~on).sum())
            r = self.row
            out[~on] = r[j] | r[j + 1] << 8 | r[j + 2] << 16 | r[j + 3] << 24
        return out


def lsic_len(x):
    return (x - 15) // 255 + 1 if x >= 15 else 0


class Previews:
    """What ``test_torch_warp_parse.WarpWalk.previews`` reads of a walk,
    for a segment's walk at three candidates a probe (``Walk<3>``): the
    chain from the cand and gaps rows under the window's wlim, and every
    read32 through the CTA's bytes (a source before them from the row)."""

    N = 3

    def __init__(self, res, cd, gp, wlim):
        self.res, self.cd, self.gp, self.wlim = res, cd, gp, wlim

    def chain(self, p):
        d1, g = int(self.cd[p]), int(self.gp[p])
        ds = [d1, d1 + (g & 255), d1 + (g & 255) + (g >> 8)]
        live = [0 < d1 <= self.wlim]
        live.append(live[0] and (g & 255) != 0)
        live.append(live[1] and (g >> 8) != 0)
        return ds, live

    def rd32(self, i):
        return self.res.rd32_m1(i)

    def usable(self, p, dd, v):
        m = p - dd
        return m >= 0 and dd <= self.wlim and self.rd32(m) == v


def probe_round(res, cd, gp, q, valid, wlim, mlen=False):
    """The hits of a round of probes at q (``Walk<N>::probe_hits``): read32
    at a candidate only where it passes the cheaper checks; in the mlen
    mode (``cd`` the verified candidates) no read32 at all."""
    if mlen:
        d = cd[q]
        return valid & (d > 0) & (d <= wlim) & (d <= q)
    v = np.zeros(len(q), np.int64)
    v[valid] = res.rd32(q[valid])
    dd = cd[q]
    if gp is None:
        ds, live = dd[None], (dd > 0)[None]
    else:
        g = gp[q]
        ds = np.stack([dd, dd + (g & 255), dd + (g & 255) + (g >> 8)])
        l0 = (dd > 0) & (dd <= wlim)
        l1 = l0 & ((g & 255) != 0)
        live = np.stack([l0, l1, l1 & ((g >> 8) != 0)])
    hit = np.zeros(len(q), bool)
    for d, lv in zip(ds, live):
        ok = valid & lv & (d <= wlim) & (d <= q)
        got = np.zeros(len(q), bool)
        got[ok] = res.rd32_m(q[ok] - d[ok]) == v[ok]
        hit |= got
    return hit


def walk(res, cd, s0, s1, n, frag, wlim, accel, cap, gp=None, mcr=None,
         seen=None):
    """``Walk<N>::run`` on one segment: (stream, o, ok, anchor, nseq, p1,
    m1h); with the gaps row ``gp`` at three candidates a probe, the
    previews of the hit and of the lazy step (``WarpWalk.previews``); with
    the mcode row ``mcr`` (``cd`` then cand_v) the mlen mode
    (``Walk<1, true>``): no read32 at a probe, the hit's code read with
    it, the catch-up's cu bytes and the extension's lcp bytes from the
    code, the byte steps only where the code reached its cap. ``seen``
    (a Counter) counts the mlen cases met (``mlen_seen``)."""
    mlen = mcr is not None
    mfl, mlim = min(s1 - 4, n - 12), min(s1, n - 5)
    A = accel << 6
    SA = skip_sum(A)
    lanes = np.arange(LANES, dtype=np.int64)
    d = bytearray(cap)
    o, anchor, nseq, pos, p1, m1 = 0, s0, 0, max(s0, 1), 0, 0
    has_match, bad = False, False
    while True:
        start, k0, hp = pos, 0, -1
        while True:                                   # 32 probes a round
            k = k0 + lanes
            pk = np.where(k == 0, start, start + 1 + skip_sum(A + k - 1) - SA)
            pn = start + 1 + skip_sum(A + k) - SA
            valid = pn <= mfl + 1
            if not valid[0]:
                break
            q = np.where(valid, pk, start)
            hit = probe_round(res, cd, gp, q, valid, wlim, mlen)
            if hit.any():
                hp = int(pk[np.argmax(hit)])
                code = int(mcr[hp]) if mlen else 0  # shuffled with hp
                break
            if not valid.all():
                break
            k0 += LANES
        if hp < 0:
            break
        pos1, mpos, pmc, pcl = hp, hp - int(cd[hp]), 0, 0
        if mlen:
            pmc, pcl = (code >> 1) & 15, 8
        if gp is not None:
            lazy = hp + 1 <= mfl
            pmc, mpos, mb, mposb = WarpWalk.previews(
                Previews(res, cd, gp, wlim), hp, lazy, mlim)
            if lazy and mb > pmc:
                pos1, mpos, pmc = hp + 1, mposb, mb
            pcl = min(mlim - pos1 - 4, 64)
        back, steps = 0, True
        if mlen:                                      # the code's cu
            back = min((code >> 6) & 7, pos1 - anchor, mpos)
            pos1, mpos, steps = pos1 - back, mpos - back, back == 4
        while steps:                                  # catch-up
            c = 0
            while c < LANES and c < pos1 - anchor and c < mpos and \
                    res.byte(pos1 - 1 - c) == res.byte_m(mpos - 1 - c):
                c += 1
            pos1, mpos, back = pos1 - c, mpos - c, back + c
            if c < LANES:
                break
        p, m = pos1 + 4, mpos + 4
        lim = mlim - p
        mc = back + pmc                               # known equal
        more = pmc == pcl and mc < lim
        while more:                                   # extension
            x = res.rd32(p + mc + 4 * lanes) ^ res.rd32_m(m + mc + 4 * lanes)
            nz = np.flatnonzero(x)
            if len(nz):
                mc += 4 * int(nz[0]) + ((ffs(int(x[nz[0]])) - 1) >> 3)
                break
            mc += 128
            more = mc < lim
        if mlen and seen is not None:
            mlen_seen(seen, back, pos1 - anchor, pmc, mc, lim)
        mc = min(mc, lim)
        lit = pos1 - anchor
        hl = 0 if frag else 1 + lsic_len(lit)
        ml = lsic_len(mc)
        if hl + lit + 2 + ml > cap - o:
            bad = True
            break
        if not frag:
            d[o] = (min(lit, 15) << 4) | min(mc, 15)
            if lit >= 15:
                r = lit - 15
                d[o + 1:o + hl] = b"\xff" * (r // 255) + bytes([r % 255])
        o += hl
        d[o:o + lit] = bytes(res.byte(anchor + i) for i in range(lit))
        o += lit
        off = pos1 - mpos
        d[o:o + 2] = bytes([off & 255, off >> 8])
        o += 2
        if mc >= 15:
            r = mc - 15
            d[o:o + ml] = b"\xff" * (r // 255) + bytes([r % 255])
        o += ml
        if frag:
            p1, m1, frag = pos1, mc, False
        has_match = True
        nseq += 1
        anchor = pos = p + mc
        if pos > mfl:
            break
    return d, o, not bad, anchor, nseq, p1, m1 | (has_match << 16)


def emulate(raw, cand, rlen, seg, window, accel, group=None, back=BACK,
            seed=0, stats=None, gaps=None, mcode=None, cap=None, seen=None):
    """Every CTA of the launch, each warp's segment walked (with ``gaps``
    at three candidates a probe; with ``mcode``, ``cand`` the verified
    candidates, in the mlen mode); the kernel's seven outputs in
    block-major segment order. ``cap``: the streams' limit, by default
    ``compress_bound(seg)``."""
    rng = np.random.default_rng(seed)
    nb, bs = raw.shape
    nseg = bs // seg
    G = Geometry(nb, bs, seg, group, back)
    assert G.bytes <= SMEM_LIMIT
    row = F.compress_bound(seg)
    cap = row if cap is None else cap
    wlim = K3.window_limit(window)
    outs = {}
    for cta in range(G.ctas):
        for r in range(G.rows):
            if G.cpr == 1:
                b, g0 = cta * G.rows + r, 0
            else:
                b, g0 = cta // G.cpr, (cta % G.cpr) * G.segs
            if b >= nb:
                continue
            n = min(max(int(rlen[b]), 0), bs)
            lo = max(0, g0 * seg - G.back)
            hi = min(n, (g0 + G.segs) * seg)
            assert 16 + max(hi - lo, 0) + SLACK <= G.slot
            block = raw[b].numpy().tobytes()
            res = Resident(block, lo, max(hi, lo), rng)
            cd = cand[b].numpy().astype(np.int64)
            gp = None if gaps is None else gaps[b].numpy().astype(np.int64)
            mcr = None if mcode is None else \
                mcode[b].numpy().astype(np.int64)
            for k in range(g0, min(g0 + G.segs, nseg)):
                s0 = k * seg
                s1 = s0 + min(max(n - s0, 0), seg)
                outs[b * nseg + k] = walk(res, cd, s0, s1, n, k > 0, wlim,
                                          accel, cap, gp, mcr, seen)
            if stats is not None:
                stats["global_reads"] = stats.get("global_reads", 0) + \
                    res.global_reads
    assert sorted(outs) == list(range(nb * nseg))
    streams = np.zeros((nb * nseg, row), np.uint8)
    cols = [[] for _ in range(6)]
    for t in range(nb * nseg):
        d, o, ok, anchor, ns, p1, m1h = outs[t]
        streams[t, :o] = np.frombuffer(bytes(d[:o]), np.uint8)
        for c, v in zip(cols, (o, 0 if ok else 1, anchor, ns, p1, m1h)):
            c.append(v)
    return (torch.from_numpy(streams),
            *(torch.tensor(c, dtype=torch.int32) for c in cols))


def assert_equal_parse(got, want):
    assert torch.equal(got[2], want[2]), "err"
    ok = want[2] == 0
    for name, a, b in zip(("slen", "err", "last_end", "nseq", "p1", "m1h"),
                          got[1:], want[1:]):
        assert torch.equal(a[ok], b[ok]), name
    mask = (torch.arange(want[0].shape[1])[None, :] < want[1][:, None]) \
        & ok[:, None]
    assert torch.equal(got[0][mask], want[0][mask]), "streams"


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw), torch.from_numpy(rlen)


def _blocks(bs, seed=3):
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(seed)
    data = _synth_corpus(2 * bs, seed=seed)
    return [data[:bs],
            data[bs:2 * bs - bs // 3 - 77],               # short: segments
            bytes(bs),                                    # past n; zeros
            rng.integers(0, 256, bs, dtype=np.uint8).tobytes()]


@pytest.mark.parametrize("accel,window", [(1, 65536), (8, 4096)])
def test_warp_seg_64k_matches_plain(accel, window):
    raw, rlen = _batch(_blocks(65536), 65536)
    cand = K2.dense_candidates(raw, rlen)
    got = emulate(raw, cand, rlen, 4096, window, accel)
    want = K3.parse_segments_plain(raw, cand, rlen, 4096, window, accel)
    assert not want[2].any()
    assert_equal_parse(got, want)


@pytest.mark.parametrize("group,back", [(None, BACK), (16, 65536)])
def test_warp_seg_128k_reads_back_into_the_previous_64k(group, back):
    """At 128 KiB and seg 4096 a CTA of 2 segments holds only its own
    bytes, and its walks read older match sources from the row in global
    memory; CTAs of 16 segments with the 64 KiB before them (the first
    design, the widest the card fits) read nothing from the row."""
    blocks = _blocks(131072, seed=4)[:2]
    raw, rlen = _batch(blocks, 131072)
    cand = K9.dense_candidates_piecewise(raw, rlen)
    G = Geometry(2, 131072, 4096, group, back)
    assert G.cpr == 32 // (group or GROUP)
    stats = {}
    got = emulate(raw, cand, rlen, 4096, 65536, 1, group, back, stats=stats)
    want = K3.parse_segments_plain(raw, cand, rlen, 4096, 65536, 1)
    assert_equal_parse(got, want)
    assert (stats["global_reads"] > 0) == (back < 65536)
    # some first match of a segment past 64 KiB takes its source from
    # before 64 KiB: the frag stream is the literals, then the offset
    nseg = 32
    back = []
    for t in range(16, nseg):
        s0, p1 = t * 4096, int(want[5][t])
        if want[6][t] >> 16:
            lit = p1 - s0
            off = int(want[0][t, lit]) | int(want[0][t, lit + 1]) << 8
            back.append(p1 - off)
    assert min(back) < 65536


def test_small_blocks_share_a_cta_and_tiny_segments():
    """4 KiB blocks at seg 4096 go 16 to a CTA (K7's check at seg = block
    size runs this shape); 256-byte blocks at seg 16, where most
    segments end before a probe can run."""
    G = Geometry(40, 4096, 4096)
    assert (G.rows, G.segs, G.ctas) == (16, 1, 3)
    blocks = _blocks(4096)[:3] + [b"ab" * 2048]
    raw, rlen = _batch(blocks, 4096)
    cand = K2.dense_candidates(raw, rlen)
    assert_equal_parse(emulate(raw, cand, rlen, 4096, 65536, 1),
                       K3.parse_segments_plain(raw, cand, rlen, 4096))
    rng = np.random.default_rng(8)
    small = [bytes(rng.integers(0, 3, 256, dtype=np.uint8)) for _ in range(4)]
    raw, rlen = _batch(small, 256)
    cand = K2.dense_candidates(raw, rlen)
    want = K3.parse_segments_plain(raw, cand, rlen, 16)
    got = emulate(raw, cand, rlen, 16, 65536, 1)
    assert_equal_parse(got, want)


@pytest.mark.parametrize("bs,seg", [(4096, 4096), (8192, 4096),
                                    (16384, 4096), (65536, 4096),
                                    (65536, 1024), (131072, 4096),
                                    (262144, 4096), (524288, 4096),
                                    (1 << 20, 8192), (4 << 20, 32768)])
def test_geometry_fits_the_card(bs, seg):
    """Every routed shape's CTA fits the H100's 227 KiB and covers each
    segment once."""
    nb = 3
    G = Geometry(nb, bs, seg)
    assert G.bytes <= SMEM_LIMIT and G.rows * G.segs <= MAX_WARPS
    seen = []
    for cta in range(G.ctas):
        for w in range(G.rows * G.segs):
            r, j = divmod(w, G.segs)
            b = cta * G.rows + r if G.cpr == 1 else cta // G.cpr
            k = (0 if G.cpr == 1 else (cta % G.cpr) * G.segs) + j
            if b < nb and k < bs // seg:
                seen.append(b * (bs // seg) + k)
    assert sorted(seen) == list(range(nb * (bs // seg)))

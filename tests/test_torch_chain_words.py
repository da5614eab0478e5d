"""K10a (``csrc/mcode.cu``) and the chain gaps (``csrc/gaps.cu``),
emulated on the CPU CTA for CTA and word for word, and held against
``dense_mcode_plain`` and ``chain_gaps_plain`` and against the port's and
the JAX package's ``golden.dense_mcode``, ``dense_gaps``, ``dense_gaps2``
and ``dense_candidates_piecewise(with_gaps=True)``.

The emulations keep the kernels' memory and index math. K10a: the
kernel's geometry (whole rows a CTA, 16 KiB of them; where that leaves
fewer than 4 CTAs an SM, a row's quads in runs of at least 1024
positions), each CTA's segments of shared memory (garbage at
first) filled with the words its quads read, 16 bytes at a time in the
row's alignment in global memory (rows start 0-15 bytes past a
boundary), masked to [0, n) with golden's zero pads around it; each
aligned quad of the outputs reads six words at p and five at q, every
compared word a funnel shift of two, lcp and cu the zero bytes of XOR
words, and a read outside the words its CTA staged fails. The gaps:
CTAs over (block, run of 256 aligned quads), the quad's candidates as
one int4 (or element by element when the tape is off the 16-byte grid),
the floor from one division a quad, the four chains a link step
together, every link read inside [floor, p) of the row. Both take the
hand-made tapes of ``chip_smoke`` at odd block sizes and a hypothesis
fuzz; the card runs the kernels themselves on such tapes
(``test_torch_kernels_cuda.py``: ``-k "gaps or k10a"``)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import hand_gaps_tape, hand_mcode_case
from lz4_sgori_torch import golden as TG
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import gaps as G
from lz4_sgori_torch.ops.kernels import mcode as M
from lz4_sgori_tpu import golden
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

THREADS = 256        # both kernels' kThreads
ROW_BYTES = 16384    # mcode.cu kRowBytes
WAVE_CTAS = 4        # mcode.cu kWaveCtas
MIN_TILE = 1024      # mcode.cu kMinTile
SMS = 132            # the H100's SMs
U64 = np.uint64      # words are held in 64 bits for the funnel shifts

LOREM = (b"Lorem ipsum dolor sit amet, consectetur adipiscing "
         b"elit, sed do eiusmod tempor incididunt ut labore. ")


def fshr(lo, hi, sh):
    """``__funnelshift_r(lo, hi, sh)`` for sh in {0, 8, 16, 24}."""
    return ((hi.astype(U64) << U64(32) | lo.astype(U64))
            >> sh.astype(U64)) & U64(0xFFFFFFFF)


def zero_bytes(x, leading: bool):
    """The zero bytes of 32-bit words: trailing (``(__ffs(x) - 1) >> 3``)
    or leading (``__clz(x) >> 3``), 4 for 0."""
    out = np.full(x.shape, 4, np.int64)
    for j in (range(4) if leading else range(3, -1, -1)):
        nz = ((x >> U64(8 * j)) & U64(0xFF)) != 0
        out = np.where(nz, 3 - j if leading else j, out)
    return out


def live_mask(x, n):
    """mcode.cu ``live_mask``: the bytes of the word at row position x
    that lie in [0, n)."""
    hi = np.clip(n - x, 0, 4)
    lo = np.clip(-x, 0, 4)
    m = np.where(hi == 4, 0xFFFFFFFF, (1 << (8 * hi)) - 1)
    return np.where(lo == 4, 0, m & ((0xFFFFFFFF << (8 * lo)) & 0xFFFFFFFF))


# ---- K10a ----

class MGeom:
    """mcode.cu's ``seg_stride`` and ``Geom``."""

    def __init__(self, nb, bs, sms):
        self.S = (bs + 50 + 15) & ~15
        self.rows = max(1, ROW_BYTES // self.S)
        self.tiles = 1
        if -(-nb // self.rows) < WAVE_CTAS * sms:
            self.rows = 1
            self.tiles = min(-(-WAVE_CTAS * sms // nb), -(-bs // MIN_TILE))


def emulate_mcode(cand, raw, raw_len, raw_shift=0, cand_quads=True,
                  seed=0, stats=None, sms=SMS):
    """mcode.cu's (cand_v, mcode): ``raw`` starts ``raw_shift`` bytes past
    a 16-byte boundary; ``cand`` on the grid (int4 loads) or not (element
    loads); the outputs on it, as the C entry requires; the geometry of a
    card of ``sms`` SMs. ``stats`` (a dict) counts the CTAs and the words
    staged."""
    cand, raw, raw_len = (np.asarray(t) for t in (cand, raw, raw_len))
    nb, bs = raw.shape
    rng = np.random.default_rng(seed)
    # the tensors in global memory with other bytes around them
    flat = rng.integers(0, 256, raw_shift + nb * bs + 64, dtype=np.uint8)
    flat[raw_shift:raw_shift + nb * bs] = raw.reshape(-1)
    cflat = rng.integers(-9, 300, 4 + nb * bs + 4).astype(np.int64)
    cflat[4:4 + nb * bs] = cand.reshape(-1)
    cand_v = np.full((nb, bs), -7, np.int64)     # the wrapper's torch.empty
    mcode = np.full((nb, bs), -7, np.int64)
    g = MGeom(nb, bs, sms)
    S = g.S
    Q = (bs + 6) >> 2
    Qt = -(-Q // g.tiles)
    st = stats if stats is not None else {}
    for cta in range(-(-nb // g.rows) * g.tiles):
        b0, t = (cta // g.tiles) * g.rows, cta % g.tiles
        nr = min(g.rows, nb - b0)
        kbeg, kend = t * Qt, min(Q, t * Qt + Qt)
        if kbeg >= kend:
            continue
        st["ctas"] = st.get("ctas", 0) + 1
        smem = rng.integers(0, 256, g.rows * S, dtype=np.uint8)
        staged = np.zeros(g.rows * S, bool)
        words = min(S >> 4, (46 + 4 * kend) // 16 + 1)
        st["words"] = st.get("words", 0) + nr * words
        for r in range(nr):
            row = b0 + r
            a = (raw_shift + row * bs) & 15
            n = min(max(int(raw_len[row]), 0), bs)
            k = np.arange(words)
            x0 = 16 * (k - 1) - a
            load = (x0 + 16 > 0) & (x0 < n)
            src = raw_shift + row * bs + x0[:, None] + np.arange(16)
            w = np.where(load[:, None], flat[np.clip(src, 0, len(flat) - 1)],
                         0).astype(np.uint8).view("<u4").reshape(-1, 4)
            x = x0[:, None] + 4 * np.arange(4)
            edge = (x0 < 0) | (x0 + 16 > n)
            mask = np.where((load & edge)[:, None], live_mask(x, n),
                            0xFFFFFFFF)
            w = (w.astype(np.int64) & mask).astype("<u4")
            seg = w.view(np.uint8).reshape(-1)
            smem[r * S:r * S + 16 * words] = seg
            staged[r * S:r * S + 16 * words] = True
            want = np.zeros(S, np.uint8)
            want[16 + a:16 + a + n] = raw[row, :n]
            assert np.array_equal(seg, want[:16 * words]), (row, "staging")
        s32 = smem.view("<u4").astype(U64)
        ok32 = staged.reshape(-1, 4).all(1)
        # the quads
        r, k = np.divmod(np.arange(nr * (kend - kbeg)), kend - kbeg)
        k = k + kbeg
        row = b0 + r
        e = (row * bs) & 3
        p0 = 4 * k - e
        keep = p0 < bs
        r, row, p0 = r[keep], row[keep], p0[keep]
        a = (raw_shift + row * bs) & 15
        o = r * S + 16 + a
        A = o + p0 - 4
        widx = (A >> 2)[:, None] + np.arange(6)
        assert (A >= r * S).all() and ok32[widx].all(), "unstaged word"
        assert (widx < ((r + 1) * S // 4)[:, None]).all()
        sh = 8 * (A & 3)
        W = s32[widx]
        V = [fshr(W[:, m], W[:, m + 1], sh) for m in range(5)]
        whole = (p0 >= 0) & (p0 + 4 <= bs)
        for i in range(4):
            p = p0 + i
            inrow = (p >= 0) & (p < bs)
            quad = whole & cand_quads
            # an int4 reads the quad whole; element loads only in the row
            d = np.where(inrow | quad,
                         cflat[4 + row * bs + np.clip(p, -4, bs + 3)], 0)
            ok = (d > 0) & (d <= p)
            B = np.where(ok, o + p - d - 4, o)
            xidx = (B >> 2)[:, None] + np.arange(5)
            assert (B >= r * S).all() and ok32[xidx[ok]].all()
            X = s32[xidx]
            shq = 8 * (B & 3)
            iv = np.full(p.shape, 8 * i)
            ok &= fshr(V[1], V[2], iv) == fshr(X[:, 1], X[:, 2], shq)
            lcp1 = zero_bytes(fshr(V[2], V[3], iv)
                              ^ fshr(X[:, 2], X[:, 3], shq), False)
            lcp2 = zero_bytes(fshr(V[3], V[4], iv)
                              ^ fshr(X[:, 3], X[:, 4], shq), False)
            lcp = np.where(lcp1 < 4, lcp1, 4 + lcp2)
            cu = zero_bytes(fshr(V[0], V[1], iv)
                            ^ fshr(X[:, 0], X[:, 1], shq), True)
            code = (lcp == 8) | (lcp << 1) | ((cu == 4) << 5) | (cu << 6)
            pr, pp = row[inrow], p[inrow]
            assert (cand_v[pr, pp] == -7).all(), "written twice"
            cand_v[pr, pp] = np.where(ok, d, 0)[inrow]
            mcode[pr, pp] = np.where(ok, code, 0)[inrow]
    assert (cand_v != -7).all() and (mcode != -7).all()
    return cand_v, mcode


# ---- the gaps ----

def emulate_gaps(cand, links=2, half=0, cand_quads=True, seed=0):
    """gaps.cu's (gaps, gaps2): the outputs on the 16-byte grid (the C
    entry's check), ``cand`` on it (int4 loads) or not (element loads)."""
    cand = np.asarray(cand).astype(np.int64)
    nb, bs = cand.shape
    rng = np.random.default_rng(seed)
    cflat = rng.integers(-300, 300, 4 + nb * bs + 4).astype(np.int64)
    cflat[4:4 + nb * bs] = cand.reshape(-1)
    gaps = np.full((nb, bs), -7, np.int64)
    gaps2 = np.full((nb, bs), -7, np.int64)
    quads = bs // 4 if bs % 4 == 0 else (bs + 6) // 4
    per_row = -(-quads // THREADS)
    for cta in range(nb * per_row):
        row, c = divmod(cta, per_row)
        k = c * THREADS + np.arange(THREADS)
        j0 = 4 * k - ((row * bs) & 3)
        j0 = j0[j0 < bs]
        base = 4 + row * bs
        whole = (j0 >= 0) & (j0 + 4 <= bs)
        p = j0[:, None] + np.arange(4)
        inrow = (p >= 0) & (p < bs)
        take = inrow | (whole & cand_quads)[:, None]
        v = np.where(take, cflat[base + np.clip(p, -4, bs + 3)], 0)
        q = p - v
        if half > 0:
            hq = np.maximum(j0, 0) // half
            h = np.broadcast_to(hq[:, None], p.shape).copy()
            for _ in range(4):
                h += (p - h * half >= half)
            lo = np.where(h & 1, (h - 1) * half,
                          np.where(q >= h * half, h * half,
                                   np.maximum(h - 1, 0) * half))
        else:
            lo = np.zeros(p.shape, np.int64)
        alive = inrow & (v > 0) & (q >= lo)
        gk = np.zeros((4,) + p.shape, np.int64)
        for li in range(links):
            assert ((q >= lo) & (q < p))[alive].all(), "a read off the row"
            t = np.where(alive, cflat[base + np.where(alive, q, 0)], 0)
            t = np.where((t >= 1) & (t <= G.MAX_GAP), t, 0)
            qn = q - t
            alive &= (t != 0) & (qn >= lo)
            gk[li] = np.where(alive, t, 0)
            q = np.where(alive, qn, q)
        rr = np.full(p.shape, row)[inrow]
        assert (gaps[rr, p[inrow]] == -7).all(), "written twice"
        gaps[rr, p[inrow]] = (gk[0] | gk[1] << 8)[inrow]
        gaps2[rr, p[inrow]] = (gk[2] | gk[3] << 8)[inrow]
    assert (gaps != -7).all()
    return gaps, (gaps2 if links == 4 else None)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return raw, rlen


def _golden_blocks(bs):
    rng = np.random.default_rng(3)
    return [(LOREM * (bs // 64 + 1))[:bs],
            (b"abcab" * bs)[:bs // 2] + bytes(bs // 4)
            + rng.integers(0, 4, bs // 4, dtype=np.uint8).tobytes(),
            (LOREM * 9)[:bs - 777], b"", b"abcabcabc"]


# ---- K10a tests ----

@pytest.mark.parametrize("bs,nb", [(1, 9), (3, 7), (5, 11), (16, 70),
                                   (4096, 9), (4097, 3), (12345, 2),
                                   (16384, 2), (16385, 1), (65536, 1),
                                   (65536, 3)])
@pytest.mark.parametrize("raw_shift,cand_quads,sms", [
    (0, True, SMS), (5, True, 1), (13, False, SMS), (13, False, 1)])
def test_mcode_words_equal_plain(bs, nb, raw_shift, cand_quads, sms):
    """Rows split into runs (few blocks on 132 SMs; at 64 KiB 64 runs a
    row, the third row's bytes live) and whole (one SM's geometry)."""
    raw, rlen, c = hand_mcode_case(nb, bs, seed=bs + raw_shift)
    st = {}
    cv, mc = emulate_mcode(c, raw, rlen, raw_shift, cand_quads, stats=st,
                           sms=sms)
    wv, wm = (t.numpy() for t in M.dense_mcode_plain(*_t(c, raw, rlen)))
    assert np.array_equal(cv, wv) and np.array_equal(mc, wm)
    if bs == 65536 and sms == SMS:
        # 64 runs a row, run t copying the row's words up to its last quad,
        # about 64 * (t + 1) + 4 of them: some 33 rows a row, which is what
        # a lone block's launch pays (PERF.md, PR 23)
        runs = (np.arange(64) + 1) * 257
        need = np.minimum(4100, (46 + 4 * np.minimum(runs, 16385)) // 16 + 1)
        assert st["ctas"] == 64 * nb and st["words"] == nb * need.sum()
        assert 32 * 4100 < need.sum() < 33 * 4100


@pytest.mark.parametrize("bs", [4096, 12345, 20000])
def test_mcode_words_equal_golden(bs):
    """K2's tape (plain) through the emulation equals both goldens'
    dense_mcode, zeros past the length."""
    blocks = _golden_blocks(bs)
    raw, rlen = _batch(blocks, bs)
    c = K2.dense_candidates_plain(*_t(raw, rlen)).numpy()
    cv, mc = emulate_mcode(c, raw, rlen, raw_shift=bs % 16)
    for j, b in enumerate(blocks):
        for gold in (golden, TG):
            wd, wm = gold.dense_mcode(b)
            assert np.array_equal(cv[j, :len(b)], wd), j
            assert np.array_equal(mc[j, :len(b)], wm), j
        assert not cv[j, len(b):].any() and not mc[j, len(b):].any()


# ---- gaps tests ----

@pytest.mark.parametrize("bs,nb,half", [
    (1, 5, 0), (5, 9, 0), (16, 70, 0), (4096, 9, 0), (4097, 3, 0),
    (12345, 2, 0), (65536, 1, 0), (12345, 2, 1000), (12345, 2, 3),
    (131072, 1, 0), (1 << 20, 1, 32768)])
@pytest.mark.parametrize("links", [2, 4])
def test_gaps_words_equal_plain(bs, nb, half, links):
    c = hand_gaps_tape(nb, bs, half, seed=bs + links)
    got = emulate_gaps(c, links, half)
    want = G.chain_gaps_plain(torch.from_numpy(c), links, half)
    assert np.array_equal(got[0], want[0].numpy())
    if links == 4:
        assert np.array_equal(got[1], want[1].numpy())
    else:
        assert got[1] is None and want[1] is None


def test_gaps_words_element_loads():
    """cand off the 16-byte grid (element loads) at odd block sizes."""
    for bs in (5001, 4096, 7):
        c = hand_gaps_tape(3, bs, seed=9)
        want = G.chain_gaps_plain(torch.from_numpy(c), 4)
        got = emulate_gaps(c, 4, cand_quads=False, seed=bs)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("bs", [4096, 9000])
def test_gaps_words_equal_golden(bs):
    """K2's tape through the emulation equals both goldens' dense_gaps
    (links 2) and dense_gaps2 (links 4)."""
    blocks = _golden_blocks(bs)
    raw, rlen = _batch(blocks, bs)
    c = K2.dense_candidates_plain(*_t(raw, rlen)).numpy()
    g, g2 = emulate_gaps(c, 4)
    g3, _ = emulate_gaps(c, 2, cand_quads=False)
    assert np.array_equal(g, g3)
    for j, b in enumerate(blocks):
        for gold in (golden, TG):
            for tape, fn in ((g, gold.dense_gaps), (g2, gold.dense_gaps2)):
                w = np.asarray(fn(b, 16), np.int64)
                assert np.array_equal(tape[j, :len(b)], w), (j, fn.__name__)
                assert not tape[j, len(b):].any()


def test_gaps_words_equal_golden_piecewise():
    """golden.dense_candidates_piecewise's own tape at piece 4096 (half
    2048) on a 20,000-byte block: its gaps, through the emulation, both
    goldens."""
    from __graft_entry__ import _synth_corpus
    src = _synth_corpus(20000, seed=8)
    for gold in (golden, TG):
        cand, want = gold.dense_candidates_piecewise(src, piece=4096,
                                                     with_gaps=True)
        c = np.asarray(cand, np.int32)[None, :]
        got, _ = emulate_gaps(c, 2, 2048)
        assert np.array_equal(got[0], np.asarray(want, np.int64))
        plain, _ = G.chain_gaps_plain(torch.from_numpy(c), 2, 2048)
        assert np.array_equal(plain[0].numpy(), got[0])


@settings(max_examples=25, deadline=None)
@given(bs=st.integers(1, 700), nb=st.integers(1, 4),
       seed=st.integers(0, 999), links=st.sampled_from([2, 4]),
       half=st.sampled_from([0, 0, 1, 64, 200]), shift=st.integers(0, 15))
def test_chain_words_fuzz(bs, nb, seed, links, half, shift):
    c = hand_gaps_tape(nb, bs, half, seed=seed)
    got = emulate_gaps(c, links, half, cand_quads=shift < 8, seed=seed)
    want = G.chain_gaps_plain(torch.from_numpy(c), links, half)
    assert np.array_equal(got[0], want[0].numpy())
    raw, rlen, mc = hand_mcode_case(nb, bs, seed=seed)
    rlen = np.random.default_rng(seed).integers(-3, bs + 4, nb).astype(
        np.int32)
    cv, code = emulate_mcode(mc, raw, rlen, shift, shift < 8, seed=seed)
    wv, wm = (t.numpy() for t in M.dense_mcode_plain(*_t(mc, raw, rlen)))
    assert np.array_equal(cv, wv) and np.array_equal(code, wm)

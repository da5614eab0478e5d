"""K8-enc3's warp parse (``csrc/parse_enc3_warp.cuh``) emulated on the
CPU, lane for lane, and held bit for bit against
``parse_blocks_enc3_deep_plain`` (all five outputs) on 4 KiB blocks at
depth 3 and 5 and acceleration 1 and 8, with a short, a random and an
all-zero block among them. ``WarpWalk`` at depth 1 is K7's walk (K3's
hit test, no previews or lazy step; ``test_torch_warp_enc3.py``).

The emulation keeps the kernel's decisions and its memory: the 32-probe
round with the closed-form skip schedule and the first-hit ballot; the
tape ring, whose chunks hold garbage until a ``cp.async.wait_group``
would have landed them; previews of two lanes a candidate by 4-byte
words, the first mismatch from the XOR's lowest set bit, the key
``(mc + 1) << 4 | (15 - i)`` reduced by max (chain order, nearest on a
tie, the cap cl); the lazy step; catch-up 32 bytes a step and extension
128; a raw buffer whose bytes past the block are garbage. The card runs
the kernel itself on the same blocks (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_torch.ops.kernels import gaps as G
from lz4_sgori_torch.ops.kernels import parse_enc3_deep as K8E
from test_torch_deep import deep_blocks
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

LANES = 32
CHUNKS = 4          # warp_parse::kChunks
SLACK = 256         # warp_parse::kSlack
MAX_D = 65535       # the window limit of a whole-block parse


def skip_sum(x):
    """S(x) = sum_{y < x} (y >> 6) (works on int64 arrays)."""
    q, r = x >> 6, x & 63
    return 32 * q * (q - 1) + r * q


def chunk_log(bs: int) -> int:
    return 9 if bs > 8192 else 8


def ffs(x: int) -> int:
    """__ffs: the 1-based index of the lowest set bit, 0 for none."""
    return (x & -x).bit_length()


def mlen_seen(seen, back, lit, pmc, mc, lim):
    """The mlen cases a sequence met: a catch-up whose code reached its
    cap of 4 bytes, so that the byte steps ran (``cu4``), one stopped by
    the anchor (``anchor``), an lcp of 8 that ran on past the probe's 12
    bytes (``lcp8``), a match cut at the match limit (``lim``)."""
    seen["cu4"] += back >= 4
    seen["anchor"] += lit == 0 and back > 0
    seen["lcp8"] += pmc == 8 and mc > back + 8
    seen["lim"] += mc >= lim


class TapeRing:
    """The tape ring of one warp: a chunk's slots hold garbage from its
    issue until a wait lets it land; reads assert the resident window."""

    def __init__(self, tapes, bs, rng):
        self.tapes, self.bs, self.rng = tapes, bs, rng
        self.log = chunk_log(bs)
        self.w = CHUNKS << self.log
        self.ring = [rng.integers(-2**31, 2**31, self.w, dtype=np.int64)
                     for _ in tapes]
        self.pending = []          # issued chunks, oldest first
        self.wbase, self.whi = -1, 0

    def _issue(self, c):
        lo = c << self.log
        for t, ring in enumerate(self.ring):
            idx = (lo + np.arange(1 << self.log)) & (self.w - 1)
            ring[idx] = self.rng.integers(-2**31, 2**31, len(idx))
        self.pending.append(c)

    def _wait(self, keep):
        while len(self.pending) > keep:
            c = self.pending.pop(0)
            lo = c << self.log
            hi = min(lo + (1 << self.log), self.bs)
            for t, ring in enumerate(self.ring):
                if lo < hi:
                    ring[np.arange(lo, hi) & (self.w - 1)] = \
                        self.tapes[t][lo:hi]

    def window(self, p0):
        c0 = p0 >> self.log
        if c0 == self.wbase:
            return
        first = max(self.whi, c0)
        if c0 + CHUNKS - first > 1:
            self._wait(0)
        for c in range(first, c0 + CHUNKS):
            self._issue(c)
        self.whi, self.wbase = c0 + CHUNKS, c0
        self._wait(1)

    def resident_end(self):
        return (self.wbase + CHUNKS - 1) << self.log

    def read(self, t, p):
        assert self.wbase << self.log <= p < self.resident_end(), p
        return int(self.ring[t][p & (self.w - 1)])


class WarpWalk:
    """One warp's walk (``Walk<N>::run``). ``codes``: the mlen mode
    (``Walk<1, true>``, ``tapes`` then cand_v alone), the mcode row, read
    through the ring as a second tape."""

    def __init__(self, block, bs, tapes, accel, depth, rng, cap=None,
                 codes=None, seen=None):
        self.n, self.bs, self.accel, self.N = len(block), bs, accel, depth
        self.cap = F.compress_bound(bs) if cap is None else cap
        self.s = block + rng.integers(0, 256, SLACK,
                                      dtype=np.uint8).tobytes()
        self.mlen, self.seen = codes is not None, seen
        if self.mlen:
            tapes = list(tapes) + [codes]
        self.tapes = TapeRing(tapes, bs, rng)
        self.d = bytearray(self.cap)

    def rd32(self, i):
        assert 0 <= i and i + 4 <= self.n + SLACK, i
        return int.from_bytes(self.s[i:i + 4], "little")

    def chain(self, p):
        d1 = self.tapes.read(0, p)
        g = self.tapes.read(1, p)
        g2 = self.tapes.read(2, p) if self.N > 3 else 0
        ds = [d1, d1 + (g & 255)]
        live = [d1 != 0 and d1 <= MAX_D]
        live.append(live[0] and (g & 255) != 0)
        ds.append(ds[1] + (g >> 8))
        live.append(live[1] and (g >> 8) != 0)
        if self.N > 3:
            ds.append(ds[2] + (g2 & 255))
            live.append(live[2] and (g2 & 255) != 0)
            ds.append(ds[3] + (g2 >> 8))
            live.append(live[3] and (g2 >> 8) != 0)
        return ds, live

    def usable(self, p, dd, v):
        m = p - dd
        return m >= 0 and dd <= MAX_D and self.rd32(m) == v

    def probe_hits(self, p):
        if self.N == 1:                  # K3's test (mlen: no read32)
            d = self.tapes.read(0, p)
            return 0 < d <= MAX_D and d <= p and (
                self.mlen or self.rd32(p - d) == self.rd32(p))
        ds, live = self.chain(p)
        v = self.rd32(p)
        return any(live[i] and self.usable(p, ds[i], v)
                   for i in range(self.N))

    def previews(self, p, lazy, mlim):
        keys, ms = [], []
        for lane in range(LANES):
            slot, half = lane >> 1, lane & 1
            q = p if slot < 8 else p + 1
            ci = slot & 7
            key, m = 0xFFFF, 0
            if ci < self.N and (slot < 8 or lazy):
                ds, live = self.chain(q)
                dd = ds[ci]
                m = q - dd
                if live[ci] and self.usable(q, dd, self.rd32(q)):
                    b0 = 4 + 32 * half
                    mm = 32
                    for w in range(7, -1, -1):
                        x = self.rd32(q + b0 + 4 * w) ^ \
                            self.rd32(m + b0 + 4 * w)
                        if x:
                            mm = 4 * w + ((ffs(x) - 1) >> 3)
                    key = 32 * half + mm
            keys.append(key)
            ms.append(m)
        ks = []
        for lane in range(LANES):
            slot, half, key = lane >> 1, lane & 1, keys[lane]
            other = keys[lane ^ 1]
            mm = key if half else (key if key < 32 else other)
            if key == 0xFFFF:
                mm = 0xFFFF
            k = 0
            if mm != 0xFFFF:
                q = p if slot < 8 else p + 1
                mc = min(mm, min(mlim - q - 4, 64))
                k = ((mc + 1) << 4) | (15 - (slot & 7))
            ks.append(0 if half else k)
        ka = max(k for lane, k in enumerate(ks) if lane < 16)
        kb = max(k for lane, k in enumerate(ks) if lane >= 16)
        mpos = ms[2 * (15 - (ka & 15))]
        mposb = ms[(16 + 2 * (15 - (kb & 15))) % 32]
        mb = (kb >> 4) - 1 if kb else -1
        return (ka >> 4) - 1, mpos, mb, mposb

    def lsic(self, o, rem):
        nff = rem // 255
        if nff + 1 > self.cap - o:
            return None
        self.d[o:o + nff] = b"\xff" * nff
        self.d[o + nff] = rem - 255 * nff
        return o + nff + 1

    def run(self):
        n, s = self.n, self.s
        mfl, mlim = n - 12, n - 5
        A = self.accel << 6
        SA = skip_sum(A)
        lanes = np.arange(LANES, dtype=np.int64)
        o = anchor = nseq = 0
        pos, bad = 1, False
        while True:
            start, k0, hp = pos, 0, -1
            while True:
                k = k0 + lanes
                pk = np.where(k == 0, start,
                              start + 1 + skip_sum(A + k - 1) - SA)
                pn = start + 1 + skip_sum(A + k) - SA
                valid = pn <= mfl + 1
                if not valid[0]:
                    break
                p0 = int(min(pk[0], n))
                self.tapes.window(p0)
                act = valid & (pk + 1 < self.tapes.resident_end())
                hit = [bool(act[j]) and self.probe_hits(int(pk[j]))
                       for j in range(LANES)]
                if any(hit):
                    hp = int(pk[hit.index(True)])
                    break
                if not valid.all() and (act | ~valid).all():
                    break
                k0 += int(act.sum())
            if hp < 0:
                break
            if self.N == 1:              # hp's candidate, no preview
                pos, mpos, pmc, pcl = hp, hp - self.tapes.read(0, hp), 0, 0
                if self.mlen:            # the code's lcp, capped at 8
                    code = self.tapes.read(1, hp)
                    pmc, pcl = (code >> 1) & 15, 8
            else:
                lazy = hp + 1 <= mfl
                mca, mpos, mb, mposb = self.previews(hp, lazy, mlim)
                pos, pmc = hp, mca
                if lazy and mb > mca:
                    pos, mpos, pmc = hp + 1, mposb, mb
                pcl = min(mlim - pos - 4, 64)
            back, steps = 0, True
            if self.mlen:                                  # the code's cu
                back = min((code >> 6) & 7, pos - anchor, mpos)
                pos, mpos, steps = pos - back, mpos - back, back == 4
            while steps:                                   # catch-up
                ok = [j < pos - anchor and j < mpos
                      and s[pos - 1 - j] == s[mpos - 1 - j]
                      for j in range(LANES)]
                c = ok.index(False) if False in ok else 32
                pos -= c
                mpos -= c
                back += c
                if c < 32:
                    break
            lit = pos - anchor
            token_at = o
            if o >= self.cap:
                bad = True
                break
            o += 1
            if lit >= 15:
                token = 15 << 4
                o = self.lsic(o, lit - 15)
                if o is None:
                    bad = True
                    break
            else:
                token = lit << 4
            if lit > self.cap - o:
                bad = True
                break
            self.d[o:o + lit] = s[anchor:pos]
            o += lit
            off = pos - mpos
            if 2 > self.cap - o:
                bad = True
                break
            self.d[o:o + 2] = bytes([off & 255, off >> 8])
            o += 2
            p, m = pos + 4, mpos + 4
            lim = mlim - p
            mc = back + pmc              # known equal through the preview
            more = pmc == pcl and mc < lim
            while more:                                    # extension
                xs = [self.rd32(p + mc + 4 * j) ^ self.rd32(m + mc + 4 * j)
                      for j in range(LANES)]
                nz = [j for j, x in enumerate(xs) if x]
                if nz:
                    mc += 4 * nz[0] + ((ffs(xs[nz[0]]) - 1) >> 3)
                    break
                mc += 128
                more = mc < lim
            if self.mlen and self.seen is not None:
                mlen_seen(self.seen, back, lit, pmc, mc, lim)
            mc = min(mc, lim)
            pos = p + mc
            if mc >= 15:
                token += 15
                o = self.lsic(o, mc - 15)
                if o is None:
                    bad = True
                    break
            else:
                token += mc
            self.d[token_at] = token
            nseq += 1
            anchor = pos
            if pos > mfl:
                break
        tpos = o
        if not bad:
            lit = n - anchor
            hlen = 2 + (lit - 15) // 255 if lit >= 15 else 1
            if hlen + lit > self.cap - o:
                bad = True
            else:
                self.d[o] = min(lit, 15) << 4
                o += 1
                if lit >= 15:
                    o = self.lsic(o, lit - 15)
                self.d[o:o + lit] = s[anchor:n]
                o += lit
        row = np.zeros(F.compress_bound(self.bs) + 8, np.uint8)
        if bad:
            return row, 0, True, 0, 0
        row[:o] = np.frombuffer(bytes(self.d[:o]), np.uint8)
        return row, o, False, tpos, nseq


def emulate(raw, cand, gaps, gaps2, rlen, accel, depth, seed=0, cap=None,
            mcode=None, seen=None):
    """The kernel's five outputs, one WarpWalk a block (depth 1: K7's
    walk, gaps and gaps2 None; with ``mcode``, ``cand`` the verified
    candidates, K10c's, the codes through the ring; ``cap``: the stream's limit, by default
    ``compress_bound(block_size)``)."""
    rng = np.random.default_rng(seed)
    nb, bs = raw.shape
    tapes = [t.numpy().astype(np.int64) for t in (cand, gaps, gaps2)
             if t is not None]
    codes = None if mcode is None else mcode.numpy().astype(np.int64)
    rows, lens, errs, tails, nseqs = [], [], [], [], []
    for j in range(nb):
        n = min(max(int(rlen[j]), 0), bs)
        w = WarpWalk(raw[j, :n].numpy().tobytes(), bs,
                     [t[j] for t in tapes], accel, depth, rng, cap,
                     None if codes is None else codes[j], seen)
        r, o, e, tp, ns = w.run()
        rows.append(r)
        lens.append(o)
        errs.append(e)
        tails.append(tp)
        nseqs.append(ns)
    return (torch.from_numpy(np.stack(rows)),
            torch.tensor(lens, dtype=torch.int32),
            torch.tensor(errs, dtype=torch.bool),
            torch.tensor(tails, dtype=torch.int32),
            torch.tensor(nseqs, dtype=torch.int32))


def cap_block(rng) -> bytes:
    """A block whose last probe meets the preview cap: at p = n - 16 the
    nearest candidate (T') and a farther one (T) both preview the 7 bytes
    to mlim, and only T goes on through the last 5 bytes. Capped, they
    tie and the nearest wins; uncapped, T would."""
    def filler(k):
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()
    t = b"ABCDEFGHIJKLMNOP"
    return (filler(100) + t + filler(50) + t[:11] + b"lmnop" + filler(20)
            + t)


def _inputs(bs, depth):
    rng = np.random.default_rng(17)
    blocks = deep_blocks(bs)[:6] + [
        deep_blocks(bs)[0][:bs - 777],                        # short
        rng.integers(0, 256, bs, dtype=np.uint8).tobytes(),   # random
        bytes(bs), b"", b"x" * 13, cap_block(rng)]
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    raw, rlen = torch.from_numpy(raw), torch.from_numpy(rlen)
    cand = K2.dense_candidates(raw, rlen)
    gaps, gaps2 = G.chain_gaps(cand, 4 if depth == 5 else 2)
    return raw, cand, gaps, gaps2, rlen


@pytest.mark.parametrize("depth,accel", [(3, 1), (5, 1), (3, 8), (5, 8)])
def test_warp_parse_emulation_matches_plain(depth, accel):
    raw, cand, gaps, gaps2, rlen = _inputs(4096, depth)
    got = emulate(raw, cand, gaps, gaps2, rlen, accel, depth)
    want = K8E.parse_blocks_enc3_deep_plain(raw, cand, gaps, gaps2, rlen,
                                            accel, depth)
    assert not want[2].any()
    for name, a, b in zip(("out", "out_len", "err", "tails", "nseq"),
                          got, want):
        assert torch.equal(a, b), name


def test_skip_schedule_closed_form_matches_the_serial_loop():
    """p_k of the closed form against the serial loop's fpos / step /
    smn (``parse_segments_plain``'s), for accelerations 1, 2, 8 and
    65537 and 5000 probes."""
    for accel in (1, 2, 8, 65537):
        A = accel << 6
        fpos, step, smn = 100, 1, A
        k = np.arange(5000, dtype=np.int64)
        closed = np.where(k == 0, 100,
                          100 + 1 + skip_sum(A + k - 1) - skip_sum(A))
        for kk in range(5000):
            assert closed[kk] == fpos, (accel, kk)
            fpos += step
            step = smn >> 6
            smn += 1


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to send a wrapper down
    its kernel branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("depth", [3, 5])
def test_warp_parse_failed_build_raises_and_never_falls_back(monkeypatch,
                                                             depth):
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    raw, cand, gaps, gaps2, rlen = (
        t.as_subclass(_OnCuda) if t is not None else None
        for t in _inputs(4096, depth))
    monkeypatch.setattr(_build, "load", no_nvcc)
    K8E.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        K8E.parse_blocks_enc3_deep(raw, cand, gaps, gaps2, rlen, depth=depth)
    assert K8E.launches == 0

"""K6's ring decode (``csrc/lz4_decode_ring.cuh``, the geometry of the
128 KiB history ring) emulated on the CPU and held against
``decompress_blocks_plain`` (out, out_len, err) on the
crafted streams of ``chip_smoke.crafted_streams``: an offset of exactly
65,535, matches across the history ring's wrap and from sources across
it, overlapping matches at offsets 1-4, LSIC runs over stage boundaries,
each error of the safe decoder near the end of a long stream, ``clen``
equal to ``slot``, and a ``slot`` that is not a multiple of 16.

The emulation keeps the kernel's memory and decisions: the comp tensor
as one flat buffer, each row's stream staged from its address rounded
down to 16 in 8 KiB stages whose slots hold garbage until their barrier
is waited for; the batches (every window position parsed, the links
doubled and checked against a serial chase, the scan and checks, the
copies of literals and independent matches, the dependency waves) and
the general walk between them; the 128 KiB output ring (garbage at
first) with the step rule of the match copy; flushes of the pending
bytes to an output row that starts as garbage (the wrapper's
``torch.empty``); and the final zeroing of the row past the decoded
bytes, or all of it on an error. ``emulate(..., whole=True)`` is K1's
geometry (``test_torch_ring_decode_v7.py``): the block's whole output in
a 64 KiB region, never flushed during the walk, and the row written
from it at the end; ``emulate(..., geom=small(L))`` is K5's
(``test_torch_ring_decode_v6.py``): the whole block in 2^L bytes, the
stream in 4 stages of 2^(L-1). The card runs the kernel itself on the
same streams (``test_torch_kernels_cuda.py``)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from chip_smoke import crafted_streams
from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
from lz4_sgori_torch.ops.kernels.lockstep_v7 import decompress_blocks_plain
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

STAGE_LOG = 13      # ring::RingGeom's and ring::WholeGeom's kStageLog
STAGE = 1 << STAGE_LOG
STAGES = 4          # their kStages
OUT_RING = 1 << 17  # ring::RingGeom::kOutRing
WHOLE = 1 << 16     # ring::kWholeMax, ring::WholeGeom::kOutRing
FLUSH = 16384       # ring::kFlush
PIECE = 4096        # ring::kPiece
STEP = 128          # ring::kStep, the general walk's match step
OUT_SIZE = 393216   # slot 394,782: 14 mod 16, so rows start at every head
WINDOW = 256        # ring::kWindow
BATCH_OUT = 16384   # ring::kBatchOut
INVALID = 0xFFFF


class Geom(NamedTuple):
    """A geometry of ``ring::Geom``: the output region's and a stage's
    log2 sizes, the stages, whether the region holds the whole block."""
    out_log: int
    stage_log: int
    stages: int
    whole: bool


RING = Geom(17, STAGE_LOG, STAGES, False)     # ring::RingGeom, K6
WHOLE_GEOM = Geom(16, STAGE_LOG, STAGES, True)  # ring::WholeGeom, K1


def small(L: int) -> Geom:
    """ring::SmallGeom<L>, K5 below 16 KiB."""
    return Geom(L, L - 1, 4, True)


class Stream:
    """The stage ring (``ring::Stream``) over the flat comp buffer."""

    def __init__(self, flat, row_start, ilen, slot, rng, geom=RING):
        self.flat, self.rng = flat, rng
        self.stage_log, self.stages = geom.stage_log, geom.stages
        self.stage = 1 << geom.stage_log
        self.gbase = row_start & ~15
        self.head = row_start & 15
        ok = 0 < ilen <= slot
        self.total = (self.head + ilen + 15) & ~15 if ok else 0
        self.nst = -(-self.total // self.stage)
        self.buf = rng.integers(0, 256, self.stage * self.stages,
                                dtype=np.uint8)
        self.landed = {}            # slot -> stage whose bytes it holds
        self.issued = set()
        for s in range(min(self.stages, self.nst)):
            self.issue(s)
        self.refills = 0            # stages issued after the first ones
        self.cur = 0
        if self.nst:
            self.wait(0)

    def issue(self, s):
        self.issued.add(s)
        k, st = s % self.stages, self.stage
        self.buf[k * st:(k + 1) * st] = self.rng.integers(
            0, 256, st, dtype=np.uint8)
        self.landed.pop(k, None)

    def wait(self, s):
        assert s in self.issued, s
        k, st = s % self.stages, self.stage
        lo = self.gbase + s * st
        n = min(st, self.total - s * st)
        assert n % 16 == 0 and lo % 16 == 0 and lo + n <= len(self.flat)
        self.buf[k * st:k * st + n] = self.flat[lo:lo + n]
        self.landed[k] = s

    def advance(self, s):
        while self.cur < s:
            if self.cur + self.stages < self.nst:
                self.issue(self.cur + self.stages)
                self.refills += 1
            self.cur += 1
            self.wait(self.cur)

    def at(self, a):
        s = a >> self.stage_log
        assert self.landed.get(s % self.stages) == s
        return int(self.buf[a & (self.stage * self.stages - 1)])

    def byte(self, i):
        a = self.head + i
        if a >> self.stage_log != self.cur:
            self.advance(a >> self.stage_log)
        return self.at(a)


class Out:
    """The output region and the flushed prefix (``ring::Out``): K6's
    history ring, or in a whole geometry (K1's 64 KiB, K5's 2^L bytes)
    the block, never flushed."""

    def __init__(self, flat_out, row_start, rng, geom=RING):
        self.g = flat_out
        self.gbase = row_start & ~15
        self.ohead = row_start & 15
        self.fx = self.ohead
        self.whole = geom.whole
        self.size = 1 << geom.out_log
        self.ring = rng.integers(0, 256, self.size, dtype=np.uint8)

    def idx(self, o):
        return (self.ohead + o) & (self.size - 1)

    def flush_to(self, xe):
        assert not self.whole
        for x in range(self.fx, xe):
            self.g[self.gbase + x] = self.ring[x & (self.size - 1)]
        self.fx = xe

    def check(self, op):
        x = self.ohead + op
        if not self.whole and x - self.fx >= FLUSH:
            self.flush_to(x & ~15)


def match_step(out, op, off, ml, step=32):
    """A match of ``ml`` bytes at ``op``, ``step`` bytes a step (32 in a
    batch's waves, ``STEP`` in the general walk), byte i of a step reading
    ``off`` bytes back from ``step`` on, else ``off + i - i % off`` (the
    step rule): all of a step's reads, then its writes."""
    i = np.arange(step)
    back = np.where(off >= step, off, off + i - i % off)
    for b in range(0, ml, step):
        live = b + i < ml
        o = op + b + i[live]
        out.ring[out.idx(o)] = out.ring[out.idx(o - back[live])]


def batch(inp, out, ip, op, ilen, out_size):
    """The kernel's batch of up to 32 sequences (``decode_batch``):
    (ip, op, count) after it, or None when it holds none and the general
    path takes one sequence."""
    a0 = inp.head + ip
    mask = inp.stage * inp.stages - 1
    if a0 >> inp.stage_log != inp.cur:
        return None
    if ((a0 + WINDOW - 1) >> inp.stage_log != inp.cur
            and inp.cur + 1 < inp.nst):
        inp.wait(inp.cur + 1)                 # issued, three ahead at most
    rel = min(WINDOW, ilen - ip)
    buf = inp.buf.astype(np.int64)
    x = np.arange(WINDOW)                     # every lane, 8 positions
    a = a0 + x
    t, b1 = buf[a & mask], buf[(a + 1) & mask]
    ln, mn = t >> 4, t & 15
    lh = np.where(ln == 15, 2, 1)
    lit = np.where(ln == 15, 15 + b1, ln)
    ao = a + lh + lit
    off = buf[ao & mask] | buf[(ao + 1) & mask] << 8
    b2 = buf[(ao + 2) & mask]
    ml = np.where(mn == 15, 19 + b2, mn + 4)
    n = lh + lit + 2 + (mn == 15)
    simple = ((ln < 15) | (b1 < 255)) & ((mn < 15) | (b2 < 255)) \
        & (x + n <= rel)
    nxt = np.where(simple, x + n, INVALID)
    fields = np.stack([lit, ml, off], 1)      # lit, ml, off a position
    links = [nxt]                             # 1, 2, 4, 8 and 16 steps
    for _ in range(4):
        v = links[-1]
        links.append(np.where(v >= WINDOW, INVALID,
                              v[np.minimum(v, WINDOW - 1)]))
    xs = []
    for lane in range(32):                    # lane s: s steps from ip
        p = 0
        for b in range(5):
            if lane >> b & 1:
                p = INVALID if p >= WINDOW else int(links[b][p])
        if p < WINDOW and nxt[p] != INVALID:
            xs.append(p)
    count = len(xs)
    if not count:
        return None
    chase, x = [], 0                          # the serial chase agrees
    while len(chase) < 32 and x < WINDOW and nxt[x] != INVALID:
        chase.append(x)
        x = int(nxt[x])
    assert xs == chase, (xs, chase)
    lit, ml, off = (fields[xs, i] for i in range(3))
    excl = np.concatenate([[0], np.cumsum(lit + ml)[:-1]])
    ops = op + excl
    ok = ((lit + ml <= out_size - ops) & (off != 0) & (off <= ops + lit)
          & (excl + lit + ml <= BATCH_OUT))
    if not ok.all():
        count = int(np.argmin(ok))
        if not count:
            return None
    for s in range(count):                    # literals, a lane each
        lh = 2 if lit[s] >= 15 else 1
        for i in range(lit[s]):
            out.ring[out.idx(ops[s] + i)] = inp.at(a0 + xs[s] + lh + i)
    m = ops + lit
    src = m - off
    indep = src + ml <= op                    # sources before the batch
    for s in range(count):
        if indep[s]:
            for i in range(ml[s]):
                out.ring[out.idx(m[s] + i)] = out.ring[out.idx(src[s] + i)]
    # the others in waves: a match waits for the earlier ones whose output
    # its source overlaps
    dep = [s for s in range(count) if not indep[s]]
    deps = {j: {i for i in dep if i < j and m[i] < src[j] + ml[j]
                and src[j] < m[i] + ml[i]} for j in dep}
    rem = set(dep)
    while rem:
        ready = sorted(j for j in rem if not deps[j] & rem)
        assert ready
        par = [j for j in ready if ml[j] <= 20 and off[j] >= ml[j]]
        vals = {j: [out.ring[out.idx(src[j] + i)] for i in range(ml[j])]
                for j in par}                 # a lane a match: all reads,
        for j in par:                         # then the writes
            for i in range(ml[j]):
                out.ring[out.idx(m[j] + i)] = vals[j][i]
        for j in ready:
            if j not in par:                  # the warp a match
                match_step(out, int(m[j]), int(off[j]), int(ml[j]))
        rem -= set(ready)
    ip += int(nxt[xs[count - 1]])
    op = int(m[count - 1] + ml[count - 1])
    out.check(op)
    return ip, op, count


def walk(inp, out, ilen, slot, out_size):
    """``decode_block_ring``: the decoded length, or -1."""
    bad = ilen <= 0 or ilen > slot
    ip = op = 0
    while not bad:
        if ip < ilen and (inp.head + ip) >> inp.stage_log != inp.cur:
            inp.advance((inp.head + ip) >> inp.stage_log)
        step = batch(inp, out, ip, op, ilen, out_size)
        if step is not None:
            ip, op, _ = step
            continue
        if ip >= ilen:
            bad = True
            break
        token = inp.byte(ip)
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= ilen:
                    bad = True
                    break
                b = inp.byte(ip)
                ip += 1
                lit += b
                if b != 255:
                    break
            if bad:
                break
        if lit > ilen - ip or lit > out_size - op:
            bad = True
            break
        while lit > 0:
            a = inp.head + ip
            if a >> inp.stage_log != inp.cur:
                inp.advance(a >> inp.stage_log)
            piece = min(lit, ((inp.cur + 1) << inp.stage_log) - a, PIECE)
            for i in range(piece):
                out.ring[out.idx(op + i)] = inp.at(a + i)
            ip += piece
            op += piece
            lit -= piece
            out.check(op)
        if ip == ilen:
            break
        if ip + 2 > ilen:
            bad = True
            break
        off = inp.byte(ip) | (inp.byte(ip + 1) << 8)
        ip += 2
        if off == 0 or off > op:
            bad = True
            break
        ml = (token & 15) + 4
        if token & 15 == 15:
            while True:
                if ip >= ilen:
                    bad = True
                    break
                b = inp.byte(ip)
                ip += 1
                ml += b
                if b != 255:
                    break
            if bad:
                break
        if ml > out_size - op:
            bad = True
            break
        while ml > 0:
            piece = min(ml, PIECE)
            match_step(out, op, off, piece, STEP)
            op += piece
            ml -= piece
            out.check(op)
    if not bad and not out.whole:
        out.flush_to(out.ohead + op)
    return -1 if bad else op


def emulate(comp, comp_len, out_size, seed=0, whole=False, geom=None,
            shift=0, refills=None):
    """The kernel's (out, out_len, err) for every row; ``whole``: K1's
    geometry (``out_size`` at most 64 KiB), ``geom`` any other. The comp
    and output tensors start ``shift`` bytes past a 16-byte boundary;
    ``refills``, a list, gets each row's stages issued after the first
    ones."""
    geom = geom or (WHOLE_GEOM if whole else RING)
    assert not geom.whole or out_size <= 1 << geom.out_log
    rng = np.random.default_rng(seed)
    nb, slot = comp.shape
    flat = np.concatenate([rng.integers(0, 256, shift, dtype=np.uint8),
                           comp.numpy().reshape(-1),
                           rng.integers(0, 256, 16, dtype=np.uint8)])
    flat_out = rng.integers(0, 256, shift + nb * out_size + 16,
                            dtype=np.uint8)
    lens, errs = [], []
    for j in range(nb):
        ilen = int(comp_len[j])
        r0 = shift + j * out_size
        inp = Stream(flat, shift + j * slot, ilen, slot, rng, geom)
        out = Out(flat_out, r0, rng, geom)
        n = walk(inp, out, ilen, slot, out_size)
        for s in range(inp.cur + 1, min(inp.cur + inp.stages, inp.nst)):
            inp.wait(s)                                       # drain
        if refills is not None:
            refills.append(inp.refills)
        z0 = 0 if n < 0 else n
        if geom.whole:          # the row from the region, by the CTA
            row = r0 + np.arange(n if n > 0 else 0)
            flat_out[row] = out.ring[out.idx(row - r0)]
        flat_out[r0 + z0:r0 + out_size] = 0
        lens.append(max(n, 0))
        errs.append(n < 0)
    out = torch.from_numpy(
        flat_out[shift:shift + nb * out_size].reshape(nb, out_size).copy())
    return (out, torch.tensor(lens, dtype=torch.int32),
            torch.tensor(errs, dtype=torch.bool))


def _rows(named, slot, extra_lens=()):
    comp = np.zeros((len(named) + len(extra_lens), slot), np.uint8)
    clen = np.zeros(len(comp), np.int32)
    for j, (_, s) in enumerate(named):
        comp[j, :len(s)] = np.frombuffer(s, np.uint8)
        clen[j] = len(s)
    for k, n in enumerate(extra_lens):
        src = named[0][1]
        comp[len(named) + k, :min(len(src), slot)] = np.frombuffer(
            src[:slot], np.uint8)
        clen[len(named) + k] = n
    return torch.from_numpy(comp), torch.from_numpy(clen)


@pytest.fixture(scope="module")
def streams():
    return crafted_streams(OUT_SIZE)


def test_crafted_streams_cover_the_ring(streams):
    """The crafted streams hold what the ring must get right."""
    slot = F.compress_bound(OUT_SIZE) + 8
    assert slot % 16 != 0
    names = [n for n, _ in streams]
    assert names.count("mixed") == 1 and "clen == slot" in names
    assert len(dict(streams)["clen == slot"]) == slot
    assert len(names) == 11


@pytest.mark.parametrize("part", [0, 1, 2])
def test_ring_emulation_matches_plain(streams, part):
    """Every crafted stream (a third of them a case), the empty input,
    clen past slot and a negative clen, against the plain decoder."""
    slot = F.compress_bound(OUT_SIZE) + 8
    named = streams[part::3]
    extra = {0: (0, slot + 1), 1: (-5,), 2: ()}[part]
    comp, clen = _rows(named, slot, extra)
    got = emulate(comp, clen, OUT_SIZE)
    want = decompress_blocks_plain(comp, clen, OUT_SIZE)
    for name, a, b in zip(("out", "out_len", "err"), got, want):
        assert torch.equal(a, b), name
    if part == 0:
        assert not bool(want[2][0])         # "mixed" decodes


def test_ring_wrapper_runs_the_plain_version_on_the_cpu(streams):
    """K6's wrapper on CPU tensors is the plain decoder, and counts no
    launch."""
    slot = F.compress_bound(OUT_SIZE) + 8
    comp, clen = _rows(streams[:2], slot)
    K6.launches = 0
    got = K6.decompress_blocks_v8(comp, clen, OUT_SIZE)
    want = decompress_blocks_plain(comp, clen, OUT_SIZE)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K6.launches == 0


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to send a wrapper down
    its kernel branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_ring_failed_build_raises_and_never_falls_back(monkeypatch,
                                                       streams):
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    slot = F.compress_bound(OUT_SIZE) + 8
    comp, clen = _rows(streams[:1], slot)
    monkeypatch.setattr(_build, "load", no_nvcc)
    K6.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        K6.decompress_blocks_v8(comp.as_subclass(_OnCuda),
                                clen.as_subclass(_OnCuda), OUT_SIZE)
    assert K6.launches == 0

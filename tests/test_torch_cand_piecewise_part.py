"""K9's runs of half-pieces over K2's split table (``csrc/cand_part.cuh``,
``cand_piecewise_kernel``) emulated on the CPU and held bit for bit
against ``dense_candidates_piecewise_plain`` and
``golden.dense_candidates_piecewise``.

The emulation keeps the kernel's decisions and its memory: the host's run
length (``cand_part::Runs``, from the grid's waves on a card of ``sms``
SMs); a CTA a run of half-pieces [h0, h1) of one block, zeroing its
positions at or past n - 3; the warm half-piece h0 - 1 walked without
writing, at h0's origin; each half-piece's bytes staged in a buffer whose
bytes past the copy are garbage; the scan of 32 positions a tile, 16
tiles a round, every warp hashing every position and queueing those of
its buckets (``h & 7``) as hash << 16 | (p - origin); a 32-wide match
step for every 32 entries waiting after each round and a last partial
one at the half-piece's end; the uint16 table (entries r + 1, the last
position's 2H wrapping to 0 at H = 32768); and between half-pieces the
sweep that rebases every entry by H and empties those at or below it,
then the fix-up that writes h's last position again as H. Every position
must be written exactly once. The card runs the kernel itself
(``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
from lz4_sgori_tpu import golden
from test_torch_cand_part import collide_block, hash16
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

LANES = 32
WARPS = 8               # cand_part::kWarps
UNROLL = 16             # cand_part::kUnroll
QUEUE = 64 * UNROLL     # cand_part::kQueue
SLACK = 32 * UNROLL + 16  # cand_part::kSlack
SMS = 132               # the H100's SMs


def runs(nb: int, bs: int, half: int, sms: int = SMS):
    """``cand_part::Runs``: (run length, runs a block)."""
    nhalf = -(-bs // half)
    best, length = None, 1
    for r in range(1, nhalf + 1):
        ctas = nb * -(-nhalf // r)
        cost = -(-ctas // sms) * (r + (1 if r < nhalf else 0))
        if best is None or cost < best:
            best, length = cost, r
    return length, -(-nhalf // length)


class Run:
    """One CTA's run of half-pieces [h0, h1) of a block."""

    def __init__(self, block: bytes, bs: int, half: int, h0: int, h1: int,
                 out, rng, fixup: bool = True):
        self.block, self.half, self.out, self.rng = block, half, out, rng
        self.table = np.zeros(1 << 16, np.uint16)    # the CTA's clear
        self.steps = 0
        n = len(block)
        npos = n - 3
        for p in range(max(npos, h0 * half), min(h1 * half, bs)):
            self.write(p, 0)                          # the CTA's zeros
        he = min(h1, -(-npos // half) if npos > 0 else 0)
        if he <= h0:
            return
        for h in range(max(h0 - 1, 0), he):
            lo = h * half
            buf = self.stage(lo, min(lo + half + 3, n))
            origin = (max(h, h0) - 1) * half
            self.half_piece(buf, lo, min(lo + half, npos), origin, h >= h0)
            if h + 1 == he:
                break
            hb = int(hash16(self.word(buf, lo, lo + half - 1)))
            if h >= h0:                               # the sweep
                t = self.table
                self.table = np.where(t > half, t - half, 0).astype(
                    np.uint16)
                if fixup:
                    self.table[hb] = half

    def write(self, p, d):
        assert self.out[p] == -1, f"position {p} written twice"
        self.out[p] = d

    def stage(self, lo, hi):
        """The buffer of a half-piece: bytes [lo, hi), garbage after."""
        buf = self.rng.integers(0, 256, self.half + 3 + SLACK + 16,
                                dtype=np.uint8).astype(np.uint64)
        buf[:hi - lo] = np.frombuffer(self.block[lo:hi], np.uint8)
        return buf

    @staticmethod
    def word(buf, lo, p):
        i = np.asarray(p) - lo
        assert (i >= 0).all() and (i + 8 <= len(buf)).all(), "read past"
        return buf[i] | buf[i + 1] << 8 | buf[i + 2] << 16 | buf[i + 3] << 24

    def half_piece(self, buf, p0, p1, origin, emit):
        """``scan_range``: every warp's scan, queue and steps."""
        if p1 <= p0:
            return
        width = -(-(p1 - p0) // (LANES * UNROLL)) * LANES * UNROLL
        p = p0 + np.arange(width)
        h = hash16(self.word(buf, p0, p)).astype(np.int64)
        for w in range(WARPS):
            mine = (p < p1) & ((h & (WARPS - 1)) == w)
            rounds = mine.reshape(-1, LANES * UNROLL)
            tail = np.cumsum(rounds.sum(axis=1))
            head = np.concatenate([[0], tail[:-1]]) // LANES * LANES
            assert (tail - head <= QUEUE).all()
            own = p[mine]
            r = own - origin
            assert ((r >= 0) & (r < 1 << 16)).all()
            entries = h[mine] << 16 | r
            for j in range(0, len(own), LANES):
                e = np.zeros(LANES, np.int64)
                live = np.arange(LANES) < len(own) - j
                e[live] = entries[j:j + LANES]
                self.step(e, live, origin, emit)

    def step(self, e, act, origin, emit):
        """``match_step``, lane for lane, the table in uint16."""
        self.steps += 1
        r, h = e & 0xFFFF, e >> 16
        lanes = np.arange(LANES)
        key = np.where(act, h, 0x10000 + lanes)
        peers = key[:, None] == key[None, :]
        lower = peers & (lanes[None, :] < lanes[:, None])
        higher = peers & (lanes[None, :] > lanes[:, None])
        q = r[np.where(lower, lanes[None, :], -1).max(axis=1)]
        t = self.table[h & 0xFFFF].astype(np.int64)
        d = np.where(lower.any(axis=1), r - q,
                     np.where(t > 0, r - (t - 1), 0))
        w = act & ~higher.any(axis=1)                 # one lane a bucket
        self.table[h[w]] = ((r[w] + 1) & 0xFFFF).astype(np.uint16)
        if emit:
            at = origin + r[act]
            assert (self.out[at] == -1).all(), "a position written twice"
            self.out[at] = d[act]


def emulate(raw, rlen, piece, sms=SMS, seed=0, fixup=True, stats=None):
    """Every CTA of the launch; cand int32 [B, bs]."""
    rng = np.random.default_rng(seed)
    nb, bs = raw.shape
    half = piece // 2
    length, per_block = runs(nb, bs, half, sms)
    out = np.full((nb, bs), -1, np.int64)
    for cta in range(nb * per_block):
        b, k = divmod(cta, per_block)
        n = min(max(int(rlen[b]), 0), bs)
        h0 = k * length
        h1 = min(h0 + length, -(-bs // half))
        run = Run(raw[b, :n].numpy().tobytes(), bs, half, h0, h1, out[b],
                  rng, fixup)
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + run.steps
    assert (out >= 0).all(), "a position was never written"
    return torch.from_numpy(out).to(torch.int32)


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw), torch.from_numpy(rlen)


def _blocks(bs, half, seed=5):
    """Corpus, zero, random and colliding blocks, and the short lengths n
    of 0, 3, 4, 5, H - 1 and H + 1."""
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(seed)
    data = _synth_corpus(bs, seed=seed)
    return [data, bytes(bs), rng.integers(0, 256, bs,
                                          dtype=np.uint8).tobytes(),
            collide_block(bs, seed), b"", data[:3], data[:4], data[:5],
            data[:half - 1], data[:half + 1]]


@pytest.mark.parametrize("piece,bs,sms,length", [(64, 4096, 132, 10),
                                                 (64, 4096, 3, 43),
                                                 (4096, 32768, 132, 2),
                                                 (4096, 32768, 2, 16),
                                                 (65536, 196608, 132, 1),
                                                 (65536, 196608, 1, 6)])
def test_runs_match_plain_and_golden(piece, bs, sms, length):
    """Ten blocks in runs of one half-piece (a warm half and its own: 6
    half-pieces a block at piece 65536 on the card), of 2, 10 and 43
    half-pieces, and a run a block, the sweep at each boundary."""
    half = piece // 2
    blocks = _blocks(bs, half)
    raw, rlen = _batch(blocks, bs)
    assert runs(len(blocks), bs, half, sms)[0] == length
    got = emulate(raw, rlen, piece, sms)
    assert torch.equal(got, K9.dense_candidates_piecewise_plain(raw, rlen,
                                                                piece))
    for j in (0, 3, 9):
        want = np.zeros(bs, np.int64)
        want[:len(blocks[j])] = golden.dense_candidates_piecewise(
            blocks[j], piece)
        assert np.array_equal(got[j].numpy(), want), j


def test_zero_run_across_a_boundary_needs_the_fixup():
    """A run of zeros across half-piece boundaries at piece 65536: the
    last position of each half-piece is the latest of the zero bucket, its
    entry 2H = 65536 wraps to empty, and only the fix-up after the sweep
    gives the next half-piece's first zero its candidate 1."""
    from __graft_entry__ import _synth_corpus
    bs, half = 131072, 32768
    data = bytearray(_synth_corpus(bs, seed=9))
    data[half - 5000:half + 7000] = bytes(12000)
    data[2 * half - 3:2 * half + 3] = bytes(6)
    raw, rlen = _batch([bytes(data)], bs)
    assert runs(1, bs, half, 1)[0] == 4              # one run, 3 sweeps
    want = K9.dense_candidates_piecewise_plain(raw, rlen)
    got = emulate(raw, rlen, 65536, sms=1)
    assert torch.equal(got, want)
    assert int(want[0, half]) == 1
    broken = emulate(raw, rlen, 65536, sms=1, fixup=False)
    assert not torch.equal(broken, want)
    assert int(broken[0, half]) != 1


def test_all_zero_block_falls_to_one_warp():
    """An all-zero block is one bucket: one warp steps every position, a
    step of 32 each, and the candidates are all 1 from position 1."""
    bs, piece = 65536, 4096
    raw, rlen = _batch([bytes(bs)], bs)
    stats = {}
    got = emulate(raw, rlen, piece, sms=4, stats=stats)
    assert torch.equal(got, K9.dense_candidates_piecewise_plain(raw, rlen,
                                                                piece))
    assert (got[0, 1:bs - 3] == 1).all() and got[0, 0] == 0
    nhalf, length = bs // (piece // 2), runs(1, bs, piece // 2, 4)[0]
    walked = nhalf + -(-nhalf // length) - 1          # warm halves too
    assert stats["steps"] >= walked * (piece // 2) // LANES - 2


@pytest.mark.parametrize("nb,bs,want", [(128, 1 << 20, 32), (1, 1 << 20, 1),
                                        (4, 1 << 20, 1), (1, 4 << 20, 1),
                                        (2, 1 << 20, 1), (512, 1 << 20, 32),
                                        (16, 4 << 20, 16)])
def test_the_host_choice_of_run_length(nb, bs, want):
    """Config 6's 128 blocks of 1 MiB take a CTA a block (no warm half);
    a single 1 or 4 MiB request a CTA a half-piece, spread over the card;
    the waves' half-pieces are the fewest over all run lengths."""
    length, per_block = runs(nb, bs, 32768)
    assert length == want
    nhalf = bs // 32768

    def cost(r):
        return -(-nb * -(-nhalf // r) // SMS) * (r + (r < nhalf))
    assert cost(length) == min(cost(r) for r in range(1, nhalf + 1))
    assert per_block * length >= nhalf > (per_block - 1) * length


def test_shared_memory_fits_at_every_piece():
    """Two staged half-pieces of 32 KiB beside the table and the queues
    fit the H100's 232,448 bytes (``Layout(half, true)``)."""
    for half in (32, 2048, 32768):
        buf = (16 + half + 3 + SLACK + 15) & ~15
        assert (1 << 17) + WARPS * QUEUE * 4 + 16 + 2 * buf <= 232448

"""A CPU model of T1's walk (``csrc/retired_encode.cu``), lane for lane
where the warp splits the work: the skip search 32 probes a round (the
schedule's positions in closed form, held to its scan; the bound mask;
the round's equal hashes resolved by ``__match_any_sync`` to the latest
lower lane; the commit up to the first match, the highest lane of each
hash class the one that writes), the catch-up 32 bytes a step, the match
count a word a lane with the immediate rematch taken at each lane's end,
and the row written in 16-byte stores between unaligned ends. It must equal
``golden.compress`` byte for byte, and the JAX engine of
``tools/retired/`` where it runs in interpret mode, on rows built to
stress each part: random and text-like rows, all-zero rows and short
periods (many probes of a round share a hash), rows whose 4-byte words
collide in ``hash4`` within a round, lengths 13 to 16384, and
accelerations 1, 8 and 65537."""

import numpy as np
import pytest

from __graft_entry__ import _synth_corpus
from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from test_torch_retired import jax_retired  # noqa: F401 (a fixture)
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

LANES = 32
HASH_LOG = 13
SKIP = 6
MF_LIMIT, LAST_LITERALS, MIN_MATCH, MASK = 12, 5, 4, 15


def hash4(v: int) -> int:
    return ((v * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_LOG)


class Model:
    """One block's walk by one warp, as the kernel runs it."""

    def __init__(self, src: bytes, acceleration: int, row_addr: int = 0):
        self.s = src
        self.acc = acceleration
        self.row_addr = row_addr           # the output row's address mod 16
        self.table = [0] * (1 << HASH_LOG)
        self.rounds = self.in_round_hits = self.shared_hashes = 0

    def read32(self, p: int) -> int:
        return int.from_bytes(self.s[p:p + 4], "little")

    def search(self, fpos: int, mflimit: int):
        """``search``: (pos, mpos) of the first match, or None."""
        step, smn = 1, self.acc << SKIP
        while True:
            self.rounds += 1
            st = [step] + [(smn + i - 1) >> SKIP for i in range(1, LANES)]
            incl = np.cumsum(st).tolist()          # the schedule's scan
            q, r = smn >> SKIP, smn & 63

            def past(i):                           # the kernel's closed form
                return 0 if i == 0 else step + (i - 1) * q + max(0, i - 65 + r)
            p = [fpos + past(i) for i in range(LANES)]
            assert p == [fpos + incl[i] - st[i] for i in range(LANES)]
            valid = [fpos + past(i + 1) <= mflimit + 1 for i in range(LANES)]
            v = [self.read32(p[i] if valid[i] else 0) for i in range(LANES)]
            h = [hash4(v[i]) for i in range(LANES)]
            key = [h[i] if valid[i] else (1 << HASH_LOG) + i
                   for i in range(LANES)]
            same = [sum(1 << j for j in range(LANES) if key[j] == key[i])
                    for i in range(LANES)]
            tv = [self.table[h[i]] for i in range(LANES)]
            m, hits = [], []
            for i in range(LANES):
                prior = same[i] & ((1 << i) - 1)
                j = prior.bit_length() - 1 if prior else i
                m.append(p[j] if prior else tv[i])
                # the lower lane's word, or the table candidate's bytes
                hits.append(valid[i] and (v[j] == v[i] if prior else
                                          self.read32(tv[i]) == v[i]))
                self.shared_hashes += bool(prior and valid[i])
            k = hits.index(True) if any(hits) else None
            vmask = sum(1 << i for i in range(LANES) if valid[i])
            commit = vmask & ((2 << k) - 1) if k is not None else vmask
            for i in range(LANES):
                if (commit >> i) & 1 and not ((same[i] & commit) >> i) >> 1:
                    self.table[h[i]] = p[i]
            if k is not None:
                prior = same[k] & ((1 << k) - 1)
                self.in_round_hits += bool(prior)
                return p[k], m[k]
            if not all(valid):
                return None
            assert fpos + past(32) == p[31] + st[31]
            fpos += past(32)
            step = (smn + 31) >> SKIP
            smn += LANES

    def catch_up(self, pos: int, mpos: int, limit: int) -> int:
        c = 0
        while True:
            j = [max(min(c + i, limit - 1), 0) for i in range(LANES)]
            stop = [c + i >= limit or self.s[pos - 1 - j[i]]
                    != self.s[mpos - 1 - j[i]] for i in range(LANES)]
            if any(stop):
                return c + stop.index(True)
            c += LANES

    def match_step(self, p: int, m: int, limit: int, mflimit: int):
        """``match_step``: the match length from p and m, a word a lane;
        each lane also takes the rematch at its own end, and the lane
        that ends the match writes the refill and the swap. Returns
        (mc, the rematch's candidate, whether it matches)."""
        mc = 0
        while True:
            lanes = []
            for i in range(LANES):
                k = mc + 4 * i
                x = self.read32(p + k) ^ self.read32(m + k)
                b = ((x & -x).bit_length() - 1) // 8 if x else 4
                e, stop = min(k + b, limit), b < 4 or k + 4 >= limit
                end = p + e
                h2, h = (hash4(self.read32(end - 2)),
                         hash4(self.read32(end)))
                cand = end - 2 if h == h2 else self.table[h]
                lanes.append((stop, e, end, h2, h, cand,
                              self.read32(cand) == self.read32(end)))
            stops = [ln[0] for ln in lanes]
            if any(stops):
                _, e, end, h2, h, cand, hit = lanes[stops.index(True)]
                if end <= mflimit:
                    self.table[h2] = end - 2
                    self.table[h] = end
                return e, cand, hit
            mc += 4 * LANES

    def put_bytes(self, d: bytearray, op: int, data: bytes):
        """``put_bytes``: the unaligned head a byte a lane, 16-byte
        words, the tail a byte a lane; every byte written once."""
        n = len(data)
        lead = min((16 - (self.row_addr + op) % 16) % 16, n)
        words = (n - lead) >> 4
        written = []
        for i in range(lead):
            written.append(i)
        for w in range(words):
            i = lead + 16 * w
            assert (self.row_addr + op + i) % 16 == 0
            written.extend(range(i, i + 16))
        for i in range(lead + 16 * words, n):
            written.append(i)
        assert written == list(range(n))
        d[op:op + n] = data

    def lsic(self, d: bytearray, op: int, rem: int) -> int:
        d[op:op + rem // 255] = b"\xff" * (rem // 255)
        d[op + rem // 255] = rem % 255
        return op + rem // 255 + 1

    def compress(self, cb: int) -> bytes:
        s, n = self.s, len(self.s)
        d = bytearray(cb)
        anchor = op = 0
        if n >= MF_LIMIT + 1:
            mflimit, matchlimit = n - MF_LIMIT, n - LAST_LITERALS
            pos = 1
            while (found := self.search(pos, mflimit)) is not None:
                pos, mpos = found
                back = self.catch_up(pos, mpos, min(pos - anchor, mpos))
                pos, mpos = pos - back, mpos - back
                lit = pos - anchor
                token_at, op = op, op + 1
                token = min(lit, MASK) << 4
                if lit >= MASK:
                    op = self.lsic(d, op, lit - MASK)
                self.put_bytes(d, op, s[anchor:pos])
                op += lit
                while True:
                    off, off_at = pos - mpos, op
                    op += 2
                    p = pos + MIN_MATCH
                    mc, cand, hit = self.match_step(
                        p, mpos + MIN_MATCH, matchlimit - p, mflimit)
                    pos = p + mc
                    if mc >= MASK:
                        op = self.lsic(d, op, mc - MASK)
                    d[token_at] = token + min(mc, MASK)
                    d[off_at:off_at + 2] = off.to_bytes(2, "little")
                    anchor = pos
                    if pos > mflimit or not hit:
                        break
                    mpos, token, token_at, op = cand, 0, op, op + 1
                if pos > mflimit:
                    break
                pos += 1
        last = n - anchor
        if last >= MASK:
            d[op] = MASK << 4
            op = self.lsic(d, op + 1, last - MASK)
        else:
            d[op] = last << 4
            op += 1
        self.put_bytes(d, op, s[anchor:])
        op += last
        self.put_bytes(d, op, bytes(cb - op))
        assert not any(d[op:])
        return bytes(d[:op])


def colliding_row(n: int, seed: int) -> bytes:
    """Random bytes with words of equal hash4 where a round probes them:
    every 48 bytes from 1, words w0, w1, w1 back to back, then w2 at +24,
    (w0, w1, w2) one of 3 classes of colliding words in turn. A round
    finds w1 after w0 (a collision, no match) and w1 again (a match with
    a candidate of the same round, which the table does not hold yet)."""
    rng = np.random.default_rng(seed)
    by_hash: dict[int, list[int]] = {}
    while sum(len(v) >= 3 for v in by_hash.values()) < 3:
        v = int(rng.integers(0, 1 << 32))
        by_hash.setdefault(hash4(v), []).append(v)
    classes = [v[:3] for v in by_hash.values() if len(v) >= 3][:3]
    row = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    for j, at in enumerate(range(1, min(n, 1200) - 28, 48)):
        w0, w1, w2 = (w.to_bytes(4, "little") for w in classes[j % 3])
        row[at:at + 12] = w0 + w1 + w1
        row[at + 24:at + 28] = w2
    return bytes(row)


def _rows(seed: int, n: int = 16384) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    return {
        "random": rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
        "text": _synth_corpus(n, seed=seed),
        "zeros": bytes(n),
        "period": (b"ab" * n)[:n],
        "period5": (b"xyz12" * n)[:n],
        "collide": colliding_row(n, seed),
    }


LENGTHS = (13, 14, 31, 4096, 16384)


@pytest.mark.parametrize("acc", [1, 8, 65537])
@pytest.mark.parametrize("kind", ["random", "text", "zeros", "period",
                                  "period5", "collide"])
def test_model_equals_golden(kind, acc):
    """Every length of every row kind, the output row at two alignments:
    the model's stream is golden.compress's byte for byte."""
    row = _rows(7)[kind]
    for n in LENGTHS:
        src = row[:n]
        for addr in (0, 9):
            m = Model(src, acc, addr)
            got = m.compress(F.compress_bound(n))
            assert got == golden.compress(src, acc), (kind, n, addr)


def test_rounds_meet_what_they_are_built_for():
    """The rows exercise the round logic: on the short periods and the
    colliding row probes of one round share a hash, and some matches
    come from a candidate of the same round, not from the table."""
    rows = _rows(7)
    for kind in ("zeros", "period", "period5", "collide"):
        m = Model(rows[kind][:4096], 1)
        m.compress(F.compress_bound(4096))
        assert m.shared_hashes > 0, kind
    m = Model(rows["collide"][:4096], 1)
    m.compress(F.compress_bound(4096))
    assert m.in_round_hits > 0
    m = Model(rows["random"], 1)
    m.compress(F.compress_bound(16384))
    assert m.rounds > 30                  # a literal stretch: many rounds


def test_model_equals_the_jax_engine(jax_retired):
    """Against ``compress_blocks_pallas`` in interpret mode: 4 KiB rows
    of each kind at acceleration 1 and 8, whole rows and lengths."""
    enc, _ = jax_retired
    rows = _rows(8)
    raw = np.stack([np.frombuffer(r[:4096], np.uint8) for r in rows.values()])
    rlen = np.full(raw.shape[0], 4096, np.int32)
    cb = F.compress_bound(4096)
    for acc in (1, 8):
        jc, jl = map(np.asarray, enc.compress_blocks_pallas(
            raw, rlen, 4096, interpret=True, acceleration=acc))
        for j in range(raw.shape[0]):
            got = Model(raw[j].tobytes(), acc).compress(cb)
            assert jl[j] == len(got), j
            assert jc[j, :jl[j]].tobytes() == got, j
            assert not jc[j, jl[j]:].any()

"""K2's split table (``csrc/cand_part.cuh``) emulated on the CPU and held
bit for bit against ``dense_candidates_plain`` and
``golden.dense_candidates(hashlog=16)`` for 1, 8 and 16 warps a CTA.

The emulation keeps the kernel's decisions: the block in a buffer whose
bytes past n are garbage; the scan of 32 positions a tile, 16 tiles a
round, each warp hashing every position; the ballot of the lanes whose
bucket (``h & (W - 1)``) the warp owns; the warp's queue, a ring of 1024
entries (hash << 16 | position); after each round, a 32-wide match step
for every 32 entries waiting (equal hashes grouped, a lane's candidate
its nearest lower peer's position, else the table's entry, the group's
highest lane writing); the zeros past n - 3; and the table kept from
block to block on one CTA, cleared between blocks by hashing the last
block's positions again (blocks of 16 KiB and less) or whole. Every
position must be written exactly once, and the table must be empty after
each clear. The card runs the kernel itself on the same blocks
(``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.kernels import cand as K2
from lz4_sgori_tpu import golden
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

LANES = 32
UNROLL = 16             # cand_part::kUnroll
QUEUE = 64 * UNROLL     # cand_part::kQueue
SLACK = 32 * UNROLL + 16  # cand_part::kSlack
SMALL = 16384           # cand_part::kSmallBlock
PRIME = 2654435761


def hash16(v):
    return ((v * PRIME) & 0xFFFFFFFF) >> 16


class Cta:
    """One CTA of ``warps`` warps and its table, kept from block to block
    (``cand_part_kernel``)."""

    def __init__(self, warps: int, rng):
        self.W, self.rng = warps, rng
        self.table = np.zeros(1 << 16, np.int64)    # the first, full clear
        self.steps = 0

    def block(self, block: bytes, bs: int) -> np.ndarray:
        n = len(block)
        npos = n - 3
        buf = np.frombuffer(block + self.rng.integers(
            0, 256, SLACK, dtype=np.uint8).tobytes(), np.uint8).astype(
                np.uint64)
        # every position a round reads, garbage past n included
        width = -(-max(npos, 0) // (LANES * UNROLL)) * LANES * UNROLL
        assert width + 3 < len(buf)
        i = np.arange(width)
        h = hash16(buf[i] | buf[i + 1] << 8 | buf[i + 2] << 16
                   | buf[i + 3] << 24).astype(np.int64)
        out = np.full(bs, -1, np.int64)
        for w in range(self.W):
            self.warp(w, h, npos, out)
        assert (out[max(npos, 0):] == -1).all()
        out[max(npos, 0):] = 0                       # the CTA's zeros
        assert (out >= 0).all(), "a position was never written"
        if n <= SMALL:
            self.table[h[:max(npos, 0)]] = 0         # the rescan clear
        else:
            self.table[:] = 0
        assert not self.table.any(), "a stale bucket"
        return out

    def warp(self, w, h, npos, out):
        """The warp's scan: per tile the ballot of its buckets into the
        ring queue, and after each round of 16 tiles a match step for
        every 32 entries waiting. The ballot keeps lane order, so the queue
        takes the warp's positions in increasing order; the ring's slot of
        entry k is k mod 1024."""
        width = len(h)
        p = np.arange(width)
        mine = (p < npos) & ((h & (self.W - 1)) == w)
        rounds = mine.reshape(-1, LANES * UNROLL)      # round r, 16 tiles
        tail = np.cumsum(rounds.sum(axis=1))           # after each round
        before = np.concatenate([[0], tail[:-1]])
        # the steps drain to fewer than 32 after each round, so the ring
        # (1024 slots) never overwrites an entry it has not read
        head = before // LANES * LANES
        assert (tail - head <= QUEUE).all()
        own = p[mine]
        entries = h[own] << 16 | own
        ring = self.rng.integers(0, 1 << 32, QUEUE)    # garbage
        lanes = np.arange(LANES)
        nsteps = -(-len(own) // LANES)
        for j in range(nsteps):
            k = LANES * j + lanes
            live = k < len(own)
            ring[k[live] & (QUEUE - 1)] = entries[k[live]]
            self.step(ring[k & (QUEUE - 1)], live, out)

    def step(self, e, act, out):
        """``match_step``, lane for lane."""
        self.steps += 1
        p, h = e & 0xFFFF, e >> 16
        lanes = np.arange(LANES)
        key = np.where(act, h, 0x10000 + lanes)
        peers = key[:, None] == key[None, :]
        lower = peers & (lanes[None, :] < lanes[:, None])
        higher = peers & (lanes[None, :] > lanes[:, None])
        q = p[np.where(lower, lanes[None, :], -1).max(axis=1)]
        t = self.table[h]
        d = np.where(lower.any(axis=1), p - q, np.where(t > 0, p - (t - 1),
                                                        0))
        w = act & ~higher.any(axis=1)         # one lane a bucket
        self.table[h[w]] = p[w] + 1
        assert (out[p[act]] == -1).all(), "a position written twice"
        out[p[act]] = d[act]


def emulate(blocks, bs, warps, seed=0):
    """One CTA taking the blocks in turn; returns cand int32 [B, bs]."""
    cta = Cta(warps, np.random.default_rng(seed))
    return torch.from_numpy(np.stack([cta.block(b, bs) for b in blocks])
                            ).to(torch.int32), cta


def collide_block(bs: int, seed: int = 3) -> bytes:
    """Words that share one hash16 bucket at every fourth position."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
    hv = hash16(v)
    same = v[hv == np.bincount(hv.astype(np.int64)).argmax()]
    words = rng.choice(same, bs // 4 + 1)
    return words.astype("<u4").tobytes()[:bs]


def _blocks(bs):
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(bs)
    data = _synth_corpus(bs + 8192, seed=7)
    full = data[:bs]
    return [full, bytes(bs), rng.integers(0, 256, bs,
                                          dtype=np.uint8).tobytes(),
            collide_block(bs), data[8192:8192 + min(bs, 5000)], b"",
            full[:3], full[:4], full[:5], full[:bs - 77]]


def _batch(blocks, bs):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        raw[i, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[i] = len(b)
    return torch.from_numpy(raw), torch.from_numpy(rlen)


@pytest.mark.parametrize("warps", [1, 8, 16])
@pytest.mark.parametrize("bs", [4096, 8192, 65536])
def test_split_table_matches_plain_and_golden(bs, warps):
    blocks = _blocks(bs)
    if bs == 65536 and warps != 16:
        blocks = blocks[:4]        # the kernel's 16 covers the rest
    got, cta = emulate(blocks, bs, warps)
    raw, rlen = _batch(blocks, bs)
    assert torch.equal(got, K2.dense_candidates_plain(raw, rlen))
    for j, b in enumerate(blocks[:4]):
        want = np.zeros(bs, np.int64)
        want[:len(b)] = golden.dense_candidates(b, 16, val16_filter=False)
        assert np.array_equal(got[j].numpy(), want), j
    # the warps' steps together are the one-warp design's, plus at most
    # one partial step a warp a block: each warp steps only its buckets
    npos = sum(max(len(b) - 3, 0) for b in blocks)
    assert cta.steps <= -(-npos // 32) + len(blocks) * warps


def test_small_blocks_in_turn_clear_only_their_buckets():
    """Many 4 KiB blocks through one CTA, the zero and colliding blocks
    among them: a bucket the rescan missed would give a stale candidate
    (and fails the emptiness check after each clear)."""
    from __graft_entry__ import _synth_corpus
    data = _synth_corpus(12 * 4096, seed=11)
    blocks = [data[i * 4096:(i + 1) * 4096] for i in range(12)]
    blocks[3] = bytes(4096)
    blocks[6] = collide_block(4096, seed=9)
    blocks[8] = blocks[8][:1000]
    got, _ = emulate(blocks, 4096, 16, seed=2)
    raw, rlen = _batch(blocks, 4096)
    assert torch.equal(got, K2.dense_candidates_plain(raw, rlen))


def test_collide_block_shares_a_bucket():
    b = np.frombuffer(collide_block(4096), np.uint8).astype(np.uint64)
    v = b[0:4092:4] | b[1:4093:4] << 8 | b[2:4094:4] << 16 | b[3:4095:4] << 24
    assert len(np.unique(hash16(v))) == 1


def test_encode_pace_edits_and_variants_apply():
    """``probes.encode_pace``'s instrumented copies and every variant's
    replacements still apply to the sources."""
    import os

    from lz4_sgori_torch.ops.kernels import _build
    from lz4_sgori_torch.probes import encode_pace as E

    for f in E.PROFILE:
        with open(os.path.join(_build.CSRC, f)) as fh:
            text = fh.read()
        assert E.instrumented(f, text) != text
    for name, (src, header, _) in E.VARIANTS.items():
        assert src in E.MODS
        with open(os.path.join(_build.CSRC, header)) as fh:
            assert E.variant_header(name) != fh.read(), name

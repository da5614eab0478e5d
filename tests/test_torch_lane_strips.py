"""A CPU model of T9's and T10's partition on the card
(``csrc/probe_lane.cu``): the ``(R, 128)`` array held in row tiles, one
a CTA, each tile cut into strips of ``STRIP_ROWS`` rows of one lane's
column, one a thread. The model replays every thread's loop as the
kernel runs it, in uint32 arithmetic, every thread at once in numpy:
``StripWalk`` finds the strip's first ``STRIP_ROWS`` rounds (the first in
closed form, then round by round, and from the end of a wrap's run to
the next wrap's without dividing); the walk is back on the same row
every R rounds, so the thread then serves rounds ``first[j] + b`` for
b = 0, R, 2R, ..., one access each, in round order.

It shows that every (lane, round) is served exactly once, by the thread
whose strip holds the round's row, and that each thread serves its rounds
in increasing order, so each cell takes its writes in round order; that
the outputs equal ``gather_plain`` and ``scatter_plain``, and the tool's
own kernels in interpret mode (the ``tools`` fixture of
``test_torch_probes2``); and that the first-round function is right at
rounds near 2^31, where ``i * s`` passes 2^32."""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from lz4_sgori_torch.probes import microbench3 as T3
from test_torch_probes2 import UNWRITTEN, tools  # noqa: F401 (a fixture)
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = T3.L
M32 = 0xFFFFFFFF
STRIDES = {"gather": T3.GATHER_STRIDE, "scatter": T3.SCATTER_STRIDE}
pytestmark = pytest.mark.usefixtures("one_thread")


def first_round(i0, lane, a, R, stride, strip=T3.STRIP_ROWS):
    """``StripWalk``'s constructor: the first round at or after ``i0``
    whose row lies in ``[a, a + strip)``, and that row less ``a``; with
    the lane's step ``s`` and ``R - strip = gq * s + gr``. Works on
    numpy arrays or ints; rows modulo R, rounds modulo 2^32."""
    mask = R - 1
    s = lane % stride + 1
    gq, gr = (R - strip) // s, (R - strip) % s
    r = (lane + (i0 & mask) * s) & mask
    past = (r - a) & mask
    ahead = R - past
    n = (ahead + s - 1) // s
    inside = past < strip
    i = np.where(inside, i0, (i0 + n) & M32)
    off = np.where(inside, past, n * s - ahead)
    return i, off, s, gq, gr


def next_round(i, off, s, gq, gr, strip=T3.STRIP_ROWS):
    """``StripWalk::next``: the next round in the strip."""
    i, off = i + 1, off + s
    wrap = off >= strip
    e = off - strip
    low = e < gr
    i = np.where(wrap, i + gq + low, i) & M32
    off = np.where(wrap, np.where(low, e + s - gr, e - gr), off)
    return i, off


def replay(R, reps, name, tile=None, strip=T3.STRIP_ROWS):
    """Every thread's loop over its strip, all threads at once (a thread
    whose next round is at or past ``reps`` serves nothing). Returns the
    threads' CTA, lane and strip start, and per step the served mask,
    rounds and rows."""
    tile = T3.tile_rows(R) if tile is None else tile
    assert R % tile == 0 and tile % strip == 0
    per = tile // strip * L                    # threads a CTA
    t = np.arange(R // tile * per)
    cta, tt = t // per, t % per
    lane, a = tt % L, cta * tile + tt // L * strip
    i, off, s, gq, gr = first_round(0, lane, a, R, STRIDES[name], strip)
    first, offs = [], []
    for _ in range(strip):
        assert (off < strip).all()
        first.append(i)
        offs.append(off)
        i2, off = next_round(i, off, s, gq, gr, strip)
        assert (i2 > i).all()                  # rounds rise, no wrap at 2^32
        i = i2
    # R rounds later the walk is back on the strip's first row
    assert (i == first[0] + R).all() and (off == offs[0]).all()
    steps = []
    b = 0
    while (first[0] + b < reps).any():
        for f, o in zip(first, offs):
            steps.append((f + b < reps, f + b, a + o))
        b += R
    return cta, lane, a, steps


def model_gather(tape_np, reps, **kw):
    """T9 as the kernel computes it: each thread's sum over its strip,
    the CTA's sums by lane, then their sum into row 0."""
    R = tape_np.shape[0]
    cta, lane, _, steps = replay(R, reps, "gather", **kw)
    u = tape_np.astype(np.int64) & M32
    acc = np.zeros(len(lane), np.int64)
    for live, _, row in steps:
        acc = (acc + np.where(live, u[row, lane], 0)) & M32
    sums = np.zeros((cta.max() + 1, L), np.int64)
    np.add.at(sums, (cta, lane), acc)
    out = np.zeros((8, L), np.int64)
    out[0] = sums.sum(0) & M32
    return torch.from_numpy(((out + (1 << 31)) & M32) - (1 << 31)).to(
        torch.int32)


def model_scatter(R, reps, **kw):
    """T10 as the kernel computes it: every thread's stores in its order
    of steps into a zeroed tile; the whole ``(R, 128)`` output."""
    _, lane, _, steps = replay(R, reps, "scatter", **kw)
    out = np.zeros((R, L), np.int64)
    for live, i, row in steps:
        out[row[live], lane[live]] = (row[live] + i[live]) & M32
    return torch.from_numpy(((out + (1 << 31)) & M32) - (1 << 31)).to(
        torch.int32)


def cases():
    """R 8, 16, 64 and 1024 at reps 0, 1, R - 1, R, R + 1 and a count
    that crosses many wraps of every lane (a step of at least 1 row)."""
    return [(R, reps) for R in (8, 16, 64, 1024)
            for reps in (0, 1, R - 1, R, R + 1, 9 * R + 5)]


@pytest.mark.parametrize("name", ["gather", "scatter"])
@pytest.mark.parametrize("R,reps", cases())
def test_every_lane_round_is_served_once_in_order(name, R, reps):
    """Each (lane, round) exactly once, at the walk's row, by the thread
    whose strip and CTA's tile hold that row; each thread's rounds rise,
    so a cell's writes (one thread's) come in round order."""
    cta, lane, a, steps = replay(R, reps, name)
    tile = T3.tile_rows(R)
    got_lane, got_i, got_row, got_t = [], [], [], []
    for live, i, row in steps:
        got_lane.append(lane[live])
        got_i.append(i[live])
        got_row.append(row[live])
        got_t.append(np.flatnonzero(live))
    got_lane, got_i, got_row, got_t = (np.concatenate(x) if x else
                                       np.zeros(0, np.int64) for x in
                                       (got_lane, got_i, got_row, got_t))
    assert len(got_i) == L * reps
    key = got_lane * max(reps, 1) + got_i
    assert np.array_equal(np.sort(key), np.arange(L * reps))
    s = got_lane % STRIDES[name] + 1
    assert np.array_equal(got_row, (got_lane % R + got_i * s) % R)
    assert ((got_row >= a[got_t]) & (got_row < a[got_t] + T3.STRIP_ROWS)).all()
    assert (got_row // tile == cta[got_t]).all()
    # a thread's rounds in the order it serves them rise: so the order of
    # its writes to any cell does too
    order = np.lexsort((np.arange(len(got_t)), got_t))
    same = got_t[order][1:] == got_t[order][:-1]
    assert (np.diff(got_i[order])[same] > 0).all()


@pytest.mark.parametrize("R,reps", cases())
def test_model_equals_the_plain_versions(R, reps):
    tape = torch.from_numpy(T3.tape(R))
    assert torch.equal(model_gather(T3.tape(R), reps),
                       T3.gather_plain(tape, reps))
    assert torch.equal(model_scatter(R, reps),
                       T3.scatter_plain(R, reps, whole=True))


@pytest.mark.parametrize("tile,strip", [(8, 8), (16, 8), (64, 8), (64, 16),
                                         (32, 32)])
def test_any_tile_and_strip_of_at_least_the_step(tile, strip):
    """The partition holds for other tile and strip sizes (a strip at
    least the largest step): R 64, a random tape with negatives."""
    R, reps = 64, 1000
    t_np = np.random.default_rng(tile * strip).integers(
        -(1 << 31), 1 << 31, (R, L)).astype(np.int32)
    assert torch.equal(model_gather(t_np, reps, tile=tile, strip=strip),
                       T3.gather_plain(torch.from_numpy(t_np), reps))
    assert torch.equal(model_scatter(R, reps, tile=tile, strip=strip),
                       T3.scatter_plain(R, reps, whole=True))


@settings(max_examples=25, deadline=None)
@given(logr=st.integers(3, 8), reps=st.integers(0, 700),
       seed=st.integers(0, 2 ** 32 - 1))
def test_model_fuzz(logr, reps, seed):
    R = 1 << logr
    t_np = np.random.default_rng(seed).integers(
        -(1 << 31), 1 << 31, (R, L)).astype(np.int32)
    assert torch.equal(model_gather(t_np, reps),
                       T3.gather_plain(torch.from_numpy(t_np), reps))
    assert torch.equal(model_scatter(R, reps),
                       T3.scatter_plain(R, reps, whole=True))


@pytest.mark.parametrize("R,reps", [(8, 9), (8, 100), (16, 15), (16, 33),
                                    (64, 65), (1024, 1025)])
def test_model_equals_the_tool(tools, R, reps):  # noqa: F811
    """The tool's ``make_gather`` and ``make_scatter`` in interpret mode:
    row 0 of the gather; the scatter's rows [:8] where the walk writes
    (the interpreter fills the others with 2^31 - 1, the model 0)."""
    with pltpu.force_tpu_interpret_mode():
        f, tape = tools["microbench3"].make_gather(R)(reps)
        want9 = np.asarray(f(tape)[0])
        (g,) = tools["microbench3"].make_scatter(R)(reps)
        want10 = np.asarray(g()[0])
    got9 = model_gather(np.asarray(tape), reps).numpy()
    assert np.array_equal(got9[0], want9[0]) and not got9[1:].any()
    got10 = model_scatter(R, reps).numpy()[:8]
    written = T3.last_visit(R, reps, T3.SCATTER_STRIDE, "cpu")[:8].numpy() >= 0
    assert np.array_equal(got10[written], want10[written])
    assert (want10[~written] == UNWRITTEN).all() and not got10[~written].any()


def brute_first(i0, lane, a, R, stride, strip=T3.STRIP_ROWS):
    """The first round at or after ``i0`` in the strip: the rows of the
    next R rounds, each from its round in 64 bits, searched in order."""
    s = lane % stride + 1
    i = i0 + np.arange(R + 1, dtype=np.int64)
    row = (lane + i * s) % R
    k = int(np.argmax((row >= a) & (row < a + strip)))
    assert a <= row[k] < a + strip
    return int(i[k]), int(row[k]) - a


@pytest.mark.parametrize("name", ["gather", "scatter"])
@pytest.mark.parametrize("R", [8, 64, 1024, 16384])
def test_first_round_near_2_31(name, R):
    """The first-round function alone, from rounds near 2^31 (i * s past
    2^32), every lane, strips at the start, middle and end; then a few
    of ``next_round``'s steps against stepping round by round."""
    stride = STRIDES[name]
    for i0 in ((1 << 31) - 1, (1 << 31) - R - 3, (1 << 31) - 12345):
        for a in sorted({0, R // 2 // T3.STRIP_ROWS * T3.STRIP_ROWS,
                         R - T3.STRIP_ROWS}):
            for lane in range(L):
                i, off, s, gq, gr = first_round(i0, lane, a, R, stride)
                want_i, want_off = brute_first(i0, lane, a, R, stride)
                assert (int(i), int(off)) == (want_i, want_off)
                assert int(i) < 1 << 32
                if lane % 37:
                    continue
                for _ in range(3):
                    i, off = next_round(i, off, s, gq, gr)
                    want_i, want_off = brute_first(want_i + 1, lane, a, R,
                                                   stride)
                    assert (int(i), int(off)) == (want_i, want_off)


def test_the_kernel_uses_the_modules_geometry():
    """``probe_lane.cu``'s strip and largest tile are the module's, which
    the model takes; its tile rule is ``tile_rows``'s."""
    src = open(os.path.join(ROOT, "lz4_sgori_torch", "csrc",
                            "probe_lane.cu")).read()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kStrip"]) == T3.STRIP_ROWS
    assert int(const["kTileMax"]) == T3.TILE_ROWS_MAX
    assert T3.STRIP_ROWS >= max(STRIDES.values())
    assert [T3.tile_rows(R) for R in (8, 64, 1024, 4096, 8192, 16384)] == \
        [8, 8, 8, 32, 64, 64]
    assert "t < kStrip ? kStrip : t > kTileMax ? kTileMax : t" in src

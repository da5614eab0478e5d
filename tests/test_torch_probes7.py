"""The two T14a readings that run on every SM since their redesign,
``transpose`` and ``shiftsel`` (``probe_harness_wg.cu``), on the CPU:
the kernels' static list, the bands their blocks hold, the split of
acc's chains, and the whole kernel emulated in torch against
``harness_plain`` bit for bit.

- Items (iteration, 64-row band): the blocks after the chain blocks
  deal the bands, band b on the b-th, (b + 8)-th, ... of them, each a
  contiguous range of the iterations; an item is 16 warp tasks.
- ``transpose``: a block holds ``x128[:, 64 b : 64 b + 64]``; a task
  reads 16 columns of 32 rows of t and adds i to each element.
- ``shiftsel``: a block holds the 95 rows ``(64 b + k) & 511`` of
  ``a512`` and ``amt[64 b : 64 b + 64]``; a task selects 4 rows.
- Every element enters the block's wrapping sink partial; the partials
  are added into one word in any order.
- acc's 1024 chains run on the first 1, 2, 4 or 8 blocks, which hold
  band 0 and take no items (1024 / that many cells each; on a grid of 8
  block 0 also takes band 0's items): each cell's value read from the
  held band, converted to float32 and added in iteration order."""

import os
import re

import numpy as np
import pytest
import torch

from lz4_sgori_torch.probes import microbench2 as T14
from lz4_sgori_torch.probes import wg_ab, wg_pace
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M32 = 0xFFFFFFFF
BANDS, TASKS = 8, 16       # 64-row bands of the result; warp tasks an item
MAX_CHAINS = 8             # chain blocks, one row of acc each
SEL = 64 + 31              # shiftsel: rows a band's selects reach
GRIDS = (8, 9, 16, 33, 64, 132)


def _source() -> str:
    with open(os.path.join(ROOT, "lz4_sgori_torch", "csrc",
                           "probe_harness_wg.cu")) as f:
        return f.read()


def _chains(grid: int) -> int:
    """The chain blocks: as many of 1, 2, 4, 8 as leave a block a band."""
    chains = 1
    while 2 * chains <= min(MAX_CHAINS, max(1, grid - BANDS)):
        chains *= 2
    return chains


def _first(grid: int) -> int:
    """The first block that takes items: block 0 on a grid of 8."""
    return _chains(grid) if grid - _chains(grid) >= BANDS else 0


def _deal(r: int, grid: int) -> list[tuple[int, int, int, int, int, int]]:
    """The kernels' static list, ``(block, band, lo, hi, cell0, cells)``:
    block b holds band ``band`` and takes iterations lo .. hi - 1 of it,
    and chains acc's cells cell0 .. cell0 + cells - 1. The first 1, 2, 4
    or 8 blocks chain and hold band 0; the blocks from ``_first`` on deal
    the bands. A grid below the 8 bands is refused, as the C entry
    refuses it."""
    if grid < BANDS:
        raise ValueError(f"a grid of {grid} blocks has no block for a band")
    chains, first = _chains(grid), _first(grid)
    out = []
    for blk in range(grid):
        cells = 1024 // chains if blk < chains else 0
        band, lo, hi = 0, 0, 0
        if blk >= first:
            band, k = (blk - first) % BANDS, (blk - first) // BANDS
            blocks = (grid - first - band + BANDS - 1) // BANDS
            lo, hi = r * k // blocks, r * (k + 1) // blocks
        out.append((blk, band, lo, hi, blk * cells, cells))
    return out


def test_source_holds_the_emulated_constants():
    """The constants the emulation mirrors are the kernels' own, both
    readings are bodies 6 and 7 of the switch and need no scratch, and a
    grid below the bands is refused before anything is launched."""
    src = _source()
    for pattern in (r"constexpr int kBands = 512 / 64;",
                    r"constexpr int kTasks = 16;",
                    r"constexpr int kMaxChains = 8;",
                    r"constexpr int kSel = 64 \+ 31;",
                    r"if \(grid < rb::kBands\) return \(int\)"
                    r"cudaErrorInvalidValue;"):
        assert re.search(pattern, src), pattern
    assert (T14.BODY_ID["transpose"], T14.BODY_ID["shiftsel"]) == (6, 7)
    assert "if (body == 6 || body == 7 || body == 8) return 0;" in src
    for name in ("transpose", "shiftsel"):
        assert re.search(rf"int run_{name}\([^{{]*\{{\n  int e;\n  if \(\(e = "
                         r"zero_sink\(sink, grid, st\)\)\) return e;", src)
    assert T14.RESIDENT == ("transpose", "shiftsel", "red1")


@pytest.mark.parametrize("grid", [8, 9, 132])
def test_items_cover_each_band_once(grid):
    """Every (iteration, band) once at grids 8, 9 and 132 (the H100's
    SMs), each band's blocks taking contiguous ranges that differ by at
    most one item; the chain blocks take none but on a grid of 8, where
    block 0 also takes band 0's; a grid of 7 is refused."""
    for r in (0, 1, 3, 33, 301, 32768):
        deal = _deal(r, grid)
        got = sorted((i, band) for _, band, lo, hi, *_ in deal
                     for i in range(lo, hi))
        assert got == [(i, b) for i in range(r) for b in range(BANDS)], r
        for band in range(BANDS):
            ranges = [(lo, hi) for blk, b, lo, hi, *_ in deal
                      if b == band and blk >= _first(grid)]
            assert ranges[0][0] == 0 and ranges[-1][1] == r
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1, (r, band)
        took = [hi > lo for _, _, lo, hi, _, c in deal if c]
        assert took == ([r > 0] if grid == 8 else [False] * len(took)), r
        assert _first(grid) == (0 if grid == 8 else _chains(grid))
    with pytest.raises(ValueError, match="a grid of 7"):
        _deal(3, 7)


@pytest.mark.parametrize("grid", GRIDS)
def test_chains_cover_each_cell_once(grid):
    """acc's 1024 cells once over the chain blocks, which hold band 0: one
    row of acc on each of blocks 0-7 from 16 blocks on (beside 124 item
    blocks, 15 or 16 a band, at 132), all 1024 on block 0 at 8 and 9."""
    deal = _deal(5, grid)
    cells = [q for blk, band, _, _, c0, n in deal for q in range(c0, c0 + n)]
    assert sorted(cells) == list(range(1024))
    chains = [(blk, n) for blk, band, _, _, _, n in deal if n]
    assert all(band == 0 for _, band, _, _, _, n in deal if n)
    if grid >= 16:
        assert chains == [(blk, 128) for blk in range(8)]
    if grid in (8, 9):
        assert chains == [(0, 1024)]
    if grid == 132:
        per = [sum(1 for _, b, *_, n in deal if b == band and not n)
               for band in range(BANDS)]
        assert per == [16] * 4 + [15] * 4


def test_shiftsel_band_holds_every_select():
    """A band's 95 held rows are the rows its selects reach: result row
    64 b + j with shift d (0-31) reads held row j + d, a512's row (64 b
    + j + d) & 511, the last band wrapping past row 511 to rows 0-30; the
    tool's amounts reach every shift 0-31 over a few iterations."""
    for band in range(BANDS):
        held = [(64 * band + k) & 511 for k in range(SEL)]
        for j in range(64):
            for d in range(32):
                assert j + d < SEL
                assert held[j + d] == (64 * band + j + d) & 511
    assert [(64 * 7 + k) & 511 for k in range(64, SEL)] == list(range(31))
    amt = torch.from_numpy(T14.tool_inputs()["amt"]).to(torch.int64)
    shifts = torch.cat([T14._idx(amt, i)[:, 0] & 31 for i in range(8)])
    assert sorted(set(shifts.tolist())) == list(range(32))


def _held(name: str, band: int, ins) -> list[torch.Tensor]:
    """What a block of ``band`` holds in shared memory (int64 values)."""
    if name == "transpose":
        (x,) = ins
        return [x.to(torch.int64)[:, 64 * band:64 * band + 64]]
    a, amt = (t.to(torch.int64) for t in ins)
    rows = torch.tensor([(64 * band + k) & 511 for k in range(SEL)])
    return [a[rows], amt[64 * band:64 * band + 64, 0]]


def _task(name: str, i: int, task: int, held) -> torch.Tensor:
    """The elements warp task ``task`` of an item of iteration ``i``
    reads from the held band, as int64."""
    if name == "transpose":
        (xs,) = held
        cols = 16 * (task >> 1) + torch.arange(16)
        rows = 32 * (task & 1) + torch.arange(32)
        return xs[cols][:, rows] + i
    rows, sa = held
    j = 4 * task + torch.arange(4)
    sh = T14._idx(sa[j], i) & 31
    return rows[j + sh]


def _cell(name: str, i: int, q: torch.Tensor, held) -> torch.Tensor:
    """Chain cells ``q`` of acc in iteration ``i``, read from band 0's
    held operand, as int64."""
    row, c = q >> 7, q & 127
    if name == "transpose":
        (xs,) = held
        return xs[c, row] + i
    rows, sa = held
    return rows[row + (T14._idx(sa[row], i) & 31), c]


def _emulated(name: str, r: int, ins, grid: int, rng):
    """The kernel of ``name`` on the CPU: every block's warp tasks run
    in a shuffled order into the block's wrapping partial, the partials
    added in a shuffled order, and each chain block's cells chained in
    iteration order."""
    deal = _deal(r, grid)
    held = {band: _held(name, band, ins) for band in range(BANDS)}
    tasks = [(blk, band, i, t) for blk, band, lo, hi, *_ in deal
             for i in range(lo, hi) for t in range(TASKS)]
    part = [0] * grid
    for k in rng.permutation(len(tasks)):
        blk, band, i, t = tasks[k]
        part[blk] = (part[blk] + int(_task(name, i, t, held[band]).sum())) \
            & M32
    sink = 0
    for blk in rng.permutation(grid):
        sink = (sink + part[blk]) & M32
    out = torch.full((1024,), float("nan"), dtype=torch.float32)
    for _, _, _, _, c0, n in deal:
        if not n:
            continue
        q = torch.arange(c0, c0 + n)
        acc = torch.zeros(n, dtype=torch.float32)
        for i in range(r):
            acc = acc + T14.wrap32(_cell(name, i, q, held[0])).to(
                torch.float32)
        out[q] = acc
    return out.reshape(8, 128), torch.tensor(sink).to(torch.int64)


def _wide(ins, rng):
    return [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, t.shape)
                             .astype(np.int32)) for t in ins]


def test_tasks_cover_each_element_once():
    """An item's 16 warp tasks read each element of the band's 64 x 128
    result once (transpose: each (column, row) of the held x128; shiftsel:
    each of the band's 64 rows, 128 words each)."""
    seen = torch.zeros((128, 64), dtype=torch.int64)
    for t in range(TASKS):
        cols = 16 * (t >> 1) + torch.arange(16)
        rows = 32 * (t & 1) + torch.arange(32)
        seen[cols[:, None], rows[None, :]] += 1
    assert bool((seen == 1).all())
    rows = sorted(4 * t + u for t in range(TASKS) for u in range(4))
    assert rows == list(range(64))


@pytest.mark.parametrize("name", ["transpose", "shiftsel"])
def test_emulated_kernel_equals_plain(name):
    """At R 0, 1, 3 and 40 on 9 and 132 blocks, on the tool's inputs and
    on inputs drawn over all of int32: the emulated kernel's ``out`` and
    ``sink`` equal ``harness_plain``'s bit for bit."""
    rng = np.random.default_rng(15)
    tool = T14.body_inputs(name, "cpu")
    for ins in (tool, _wide(tool, rng)):
        for r in (0, 1, 3, 40):
            want_out, want_sink = T14.harness_plain(name, r, *ins)
            for grid in (9, 132):
                out, sink = _emulated(name, r, ins, grid, rng)
                assert torch.equal(out.view(torch.int32),
                                   want_out.view(torch.int32)), (r, grid)
                assert int(T14.wrap32(sink)) == int(want_sink), (r, grid)
            if r == 0:
                assert not want_out.any() and int(want_sink) == 0


def test_wg_pace_variants_apply_to_the_source():
    """Each of ``wg_pace``'s variants changes this source, one whose
    pattern is gone raises, and without a card it refuses to time."""
    src = _source()
    for name in wg_pace.VARIANTS:
        assert wg_pace.variant_source(src, name) != src, name
    shared = wg_pace.variant_source(src, "shared")
    assert "4LL * q - min(q, chains)" in shared and "first" not in \
        shared[shared.index("struct Deal"):shared.index("add_sink")]
    with pytest.raises(ValueError, match="not in the source"):
        wg_pace.variant_source("int main() {}", "batch8")
    with pytest.raises(SystemExit):
        wg_pace.main(["--device", "cpu"])


def test_wg_ab_names_a_reading_the_other_source_lacks():
    """Against a source of the six earlier bodies, ``wg_ab`` times the six
    and names each of the three later readings on a line of its own."""
    six = "\n".join(f"    case {k}: return run_{n}(in0, in1, r);" for k, n
                    in enumerate(("ohbuild", "mxu_bf16", "mxu_f32", "gather",
                                  "cumsum_mxu", "cumsum_mxu_lane")))
    other = wg_ab.body_ids(six)
    names = [n for n, b in T14.BODIES.items() if b.source == T14.WG]
    assert [n for n in names if n not in other] == ["transpose", "shiftsel",
                                                    "red1"]
    line = wg_ab.lacking("shiftsel", "old.cu")
    assert "shiftsel" in line and "old.cu" in line and "\n" not in line

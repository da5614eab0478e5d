"""The two kernels redesigned last, on the CPU: ``red1`` on every SM
(``probe_harness_wg.cu``, body 8) and T4's column sort in the passes of
``sort_probe.plan`` (``probe_sort.cu``).

- ``red1``: the blocks deal the bands as ``transpose`` and ``shiftsel``
  do (``test_torch_probes7._deal``); a block holds a 64-row band of
  ``a512``, rows of 32 chunks of 16 bytes padded to 33; an item's 2 warp
  tasks take 32 rows each, a lane a row, its 128 words summed in the
  lane, plus 128 i, into the block's wrapping sink partial. acc's 8
  chains, a warp a row on the chain blocks: lane u sums the row's 32
  chunks from chunk u on for iteration i0 + u, and the warp adds the 32
  sums in iteration order.
- T4: the passes' stages concatenated are the network's; each pass
  emulated with the kernel's index math (a thread's rows, its
  compare-exchanges in order, each pair's direction) equals the plain
  stages and np.sort, at tile sizes shrunk so that global passes of four
  stages and split groups occur at small N; the tile's row swizzle puts a
  warp's 32 reads in 32 banks at every distance; ``sort_pace``'s
  variants apply to the source."""

import os
import re

import numpy as np
import pytest
import torch

from lz4_sgori_torch.probes import microbench2 as T14
from lz4_sgori_torch.probes import sort_pace
from lz4_sgori_torch.probes import sort_probe as T4
from test_torch_probes7 import BANDS, _deal
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lz4_sgori_torch", "csrc")
M32 = 0xFFFFFFFF
GRIDS = (8, 9, 16, 33, 64, 132)
CHAIN_WARPS = 4
ROW_TASKS = 2              # red1: warp tasks (32 rows, a lane a row) an item
PITCH = 33                 # red1: 16-byte chunks a held row


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---- red1 ----

def test_red1_is_body_8_of_the_whole_card_source():
    """``red1`` is body 8 of ``probe_harness_wg.cu``'s switch, needs no
    scratch, zeroes the sink and refuses a grid below the bands; the
    one-SM source has no ``Red1`` and its 11 bodies in table order."""
    wg, vpu = _read("probe_harness_wg.cu"), _read("probe_harness.cu")
    assert T14.BODIES["red1"].source == T14.WG
    assert T14.BODY_ID["red1"] == 8
    assert "    case 8: return run_red1(in0, r, out, sink, grid, st);" in wg
    assert "if (body == 6 || body == 7 || body == 8) return 0;" in wg
    assert re.search(r"int run_red1\([^{]*\{\n  int e;\n  if \(\(e = "
                     r"zero_sink\(sink, grid, st\)\)\) return e;", wg)
    assert f"constexpr int kRowTasks = {ROW_TASKS};" in wg
    assert f"constexpr int kRowPitch = {PITCH};" in wg
    assert "__shared__ uint4 twice[8 * 64];" in wg
    assert "Red1" not in vpu and "red1" not in re.sub(
        r"//.*", "", vpu)
    cases = re.findall(r"case (\d+): return launch<(\w+)>", vpu)
    assert len(cases) == 11
    assert [int(k) for k, _ in cases] == list(range(11))
    assert T14.wg_scratch_bytes("red1", 300, 132) == 0
    assert T14.BODIES["red1"].card == (8192, 65536)
    assert "red1" in T14.RESIDENT


def test_red1_lanes_cover_each_word_once():
    """An item's 2 tasks cover the band's 64 rows, a lane a row, each
    lane reading its row's 32 chunks; a chain lane reads all 32 chunks of
    its row (chunk lane + k of the row held twice over, k = 0 .. 31), and
    a step's 32 lanes read 32 different chunks. Every quarter warp's 8
    reads fall in 8 distinct bank groups (of 4 banks): an item's at one
    chunk of 8 neighbouring padded rows, a chain's at 8 neighbouring
    chunks of the doubled row."""
    seen = torch.zeros(64, dtype=torch.int64)
    for task in range(ROW_TASKS):
        for lane in range(32):
            seen[32 * task + lane] += 1
    assert bool((seen == 1).all())
    for task in range(ROW_TASKS):
        for k in range(32):
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                assert len({((32 * task + lane) * PITCH + k) % 8
                            for lane in lanes}) == 8
    for q in range(8):
        for k in range(32):
            held = [q * 64 + lane + k for lane in range(32)]
            assert sorted(c % 64 % 32 for c in held) == list(range(32))
            for quarter in range(4):
                assert len({c % 8 for c in
                            held[8 * quarter:8 * quarter + 8]}) == 8
    for u in range(32):
        assert sorted((k + u) & 31 for k in range(32)) == list(range(32))


def _lane_sums(band: torch.Tensor) -> torch.Tensor:
    """Each row's sum as an item's lane forms it (the part of it that
    does not depend on i): its 32 chunks added in order; (64,) int64
    modulo 2^32."""
    sums = torch.zeros(64, dtype=torch.int64)
    for k in range(32):
        sums = (sums + band[:, 4 * k:4 * k + 4].sum(1)) & M32
    return sums


def _task_sum(sums: torch.Tensor, i: int, task: int) -> int:
    """What warp task ``task`` of an item of iteration ``i`` adds into
    the block's partial: its 32 rows' sums, each plus 128 i."""
    return sum((int(sums[32 * task + lane]) + 128 * i) & M32
               for lane in range(32))


def _chain(row: torch.Tensor, r: int) -> torch.Tensor:
    """acc's value of one row: lane u of a batch sums the row's 32 chunks
    from chunk u on, plus 128 (i0 + u), for iteration i0 + u; the warp
    adds the sums, each converted to float32, in iteration order."""
    chunks = [int(c) for c in row.reshape(32, 4).sum(1)]
    lane = [sum(chunks[(k + u) & 31] for k in range(32)) for u in range(32)]
    acc = np.float32(0)
    for i in range(r):
        v = (lane[i % 32] + 128 * i) & M32
        acc = np.float32(acc + np.float32(v - (1 << 32) if v >> 31 else v))
    return torch.tensor(acc, dtype=torch.float32)


def _red1_emulated(r: int, a: torch.Tensor, grid: int, rng):
    """The red1 kernel on the CPU: every block's warp tasks in a shuffled
    order into its wrapping partial, the partials added in a shuffled
    order, and each chain warp's row in iteration order (the chain
    blocks' rows cell0 / 128 + warp, + 4, ...)."""
    deal = _deal(r, grid)
    a = a.to(torch.int64)
    bands = {b: a[64 * b:64 * b + 64] for b in range(BANDS)}
    sums = {b: _lane_sums(band) for b, band in bands.items()}
    tasks = [(blk, band, i, t) for blk, band, lo, hi, *_ in deal
             for i in range(lo, hi) for t in range(ROW_TASKS)]
    part = [0] * grid
    for k in rng.permutation(len(tasks)):
        blk, band, i, t = tasks[k]
        part[blk] = (part[blk] + _task_sum(sums[band], i, t)) & M32
    sink = 0
    for blk in rng.permutation(grid):
        sink = (sink + part[blk]) & M32
    out = torch.full((8, 128), float("nan"), dtype=torch.float32)
    for _, band, _, _, c0, n in deal:
        for warp in range(CHAIN_WARPS if n else 0):
            for q in range(c0 // 128 + warp, (c0 + n) // 128, CHAIN_WARPS):
                out[q] = _chain(bands[band][q], r)
    return out, torch.tensor(sink).to(torch.int64)


@pytest.mark.parametrize("grid", GRIDS)
def test_red1_chains_are_the_rows_of_acc(grid):
    """acc's 8 rows once over the chain blocks' warps, which hold band 0:
    one row a block on blocks 0-7 from 16 blocks on, all 8 on block 0's
    four chain warps (two each) at 8 and 9."""
    deal = _deal(5, grid)
    rows = sorted(q for _, band, _, _, c0, n in deal if n
                  for warp in range(CHAIN_WARPS)
                  for q in range(c0 // 128 + warp, (c0 + n) // 128,
                                 CHAIN_WARPS))
    assert rows == list(range(8))
    assert all(band == 0 for _, band, _, _, _, n in deal if n)
    assert sum(1 for *_, n in deal if n) == (8 if grid >= 16 else
                                             1 if grid < 10 else 2)


@pytest.mark.parametrize("grid", GRIDS)
def test_red1_emulated_kernel_equals_plain(grid):
    """At R 0, 1, 3 and 33 (and 300 on 132 blocks), on the tool's inputs
    and on inputs drawn over all of int32: the emulated kernel's ``out``
    and ``sink`` equal ``harness_plain``'s bit for bit."""
    rng = np.random.default_rng(16 + grid)
    tool = T14.body_inputs("red1", "cpu")
    wide = [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (512, 128))
                             .astype(np.int32))]
    rs = (0, 1, 3, 33, 300) if grid == 132 else (0, 1, 3, 33)
    for ins in (tool, wide):
        for r in rs:
            want_out, want_sink = T14.harness_plain("red1", r, *ins)
            out, sink = _red1_emulated(r, ins[0], grid, rng)
            assert torch.equal(out.view(torch.int32),
                               want_out.view(torch.int32)), (r, grid)
            assert int(T14.wrap32(sink)) == int(want_sink), (r, grid)


# ---- T4 ----

def _stages(p: tuple, logn: int, tile_log: int):
    """The (j, k) stages of pass ``p`` of ``sort_probe.plan(logn,
    tile_log)``."""
    if p[0] == "global":
        _, j, khi, klo = p
        return [(j, k) for k in range(khi, klo - 1, -1)]
    t = min(logn, tile_log)
    return [(j, k) for j in range(p[1], p[2] + 1)
            for k in range(min(j, t - 1), -1, -1)]


@pytest.mark.parametrize("tile_log", [1, 2, 3, 5, 12])
def test_plan_covers_the_network(tile_log):
    """The passes' stages, concatenated, are ``bitonic_stages`` in order;
    a global pass holds one j and one to four stages, all at k >= the
    tile's log; a tile pass's stages are all below it; at logN 16 and the
    kernel's tile of 4096 rows, 9 passes (1 tile, then 4 global and 4
    tile), against 29 before."""
    for logn in range(0, 21):
        passes = T4.plan(logn, tile_log)
        t = min(logn, tile_log)
        stages = [s for p in passes for s in _stages(p, logn, tile_log)]
        assert stages == T4.bitonic_stages(1 << logn), logn
        for p in passes:
            got = _stages(p, logn, tile_log)
            if p[0] == "global":
                assert 1 <= len(got) <= T4.GLOBAL_STAGES
                assert len({j for j, _ in got}) == 1
                assert all(k >= t for _, k in got)
            else:
                assert all(k < t for _, k in got)
        assert passes[0] == ("tile", 0, t - 1)
    got = T4.plan(16)
    assert len(got) == 9
    assert [p[0] for p in got] == ["tile"] + ["global", "tile"] * 4
    assert len(T4.plan(17)) == 12 and len(T4.plan(T4.MAX_LOGN)) == 37


HELD = 4          # log2 of the values a thread holds in a tile round


def _slot(row, col):
    """The kernel's word of (row, col) in a tile (``slot``)."""
    mix = ((row >> 3) & 3) ^ (-((row >> 5) & 1) & 3)
    return ((row ^ mix) << 3) | col


def _round_rows(lo, held, b):
    """The base rows of groups ``b`` in a round that holds ``held`` bits
    from ``lo`` (those bits clear), as the kernel computes them."""
    return ((b >> lo) << (lo + held)) | (b & ((1 << lo) - 1))


@pytest.mark.parametrize("held", [3, 4])
def test_tile_swizzle_is_a_bijection_without_bank_conflicts(held):
    """``slot`` maps a 4096 x 8 tile onto its 32768 words; the reads of
    every round (4 neighbouring groups x 8 columns a warp, value m of
    each; the first round's groups of 2^held neighbouring rows) hit 32
    distinct banks at every lo; and the 16-byte moves of a tile's load
    and store do too, a quarter warp at a time."""
    rows = torch.arange(4096)[:, None]
    cols = torch.arange(8)[None, :]
    words = _slot(rows, cols).flatten()
    assert sorted(words.tolist()) == list(range(4096 * 8))
    groups = 4096 >> held
    for lo in range(0, 13 - held):
        for b0 in range(0, groups, 4):
            base = _round_rows(lo, held, torch.arange(b0, b0 + 4))
            for m in range(1 << held):
                r = (base | (m << lo))[:, None]
                banks = (_slot(r, cols) % 32).flatten()
                assert len(set(banks.tolist())) == 32, (lo, b0, m)
    for b0 in range(0, groups, 4):
        base = torch.arange(b0, b0 + 4) << held
        for m in range(1 << held):
            banks = (_slot((base | m)[:, None], cols) % 32).flatten()
            assert len(set(banks.tolist())) == 32, (b0, m)
    for e0 in range(0, 2 * 4096, 8):
        e = torch.arange(e0, e0 + 8)
        start = _slot(e >> 1, 4 * (e & 1))
        banks = {(int(s) + w) % 32 for s in start for w in range(4)}
        assert len(banks) == 32


def _exchange(vals, m, n, desc):
    a, c = vals[:, m], vals[:, n]
    mn, mx = torch.minimum(a, c), torch.maximum(a, c)
    vals[:, m] = torch.where(desc, mx, mn)
    vals[:, n] = torch.where(desc, mn, mx)


def _global_pass(x, logn, j, khi, klo):
    """The global kernel: thread group b holds rows base + m 2^klo of
    every column; pairs (m, m + 2^h) for h = NS - 1 .. 0 in m's order,
    one direction from bit j + 1 of base."""
    ns = khi - klo + 1
    base = _round_rows(klo, ns, torch.arange(1 << (logn - ns)))
    rows = base[:, None] + (torch.arange(1 << ns)[None, :] << klo)
    vals = x[rows]                                  # (groups, V, columns)
    desc = (((base >> (j + 1)) & 1) == 1)[:, None]
    for h in range(ns - 1, -1, -1):
        for m in range(1 << ns):
            if not m & (1 << h):
                _exchange(vals, m, m | (1 << h), desc)
    x[rows] = vals


def _tile_pass(x, logn, tile_log, j0, j1, held):
    """The tile kernel on every tile at once (``held`` the kernel's
    kHeld, at most the tile's log): the first pass's first round runs j
    = 0 .. hb - 1 on groups of 2^hb neighbouring rows, a pair's direction
    from bit j + 1 of m, or of row0 | base; then for each later j, rounds
    from khi = min(j, t - 1) down, each holding 2^held values 2^lo apart
    (lo = khi - held + 1, or 0) and running stages khi .. lo, every pair
    of a group in the direction of bit j + 1 of row0 | base."""
    t = min(logn, tile_log)
    hb = min(t, held)
    row0 = torch.arange(0, 1 << logn, 1 << t)[:, None]
    j = j0
    if j0 == 0 and j1 >= 0:
        base = torch.arange(1 << (t - hb))[None, :] << hb
        rows = ((row0 | base)[:, :, None]
                + torch.arange(1 << hb)[None, None, :]).reshape(-1, 1 << hb)
        vals = x[rows]
        dx = (((row0 | base) >> hb) & 1).reshape(-1, 1) == 1
        for jj in range(min(hb, j1 + 1)):
            for k in range(jj, -1, -1):
                for m in range(1 << hb):
                    if not m & (1 << k):
                        desc = (dx if jj + 1 == hb else
                                torch.tensor(bool((m >> (jj + 1)) & 1)))
                        _exchange(vals, m, m | (1 << k), desc)
        x[rows] = vals
        j = hb
    for j in range(j, j1 + 1):
        khi = min(j, t - 1)
        while khi >= 0:
            lo = max(0, khi - held + 1)
            assert j + 1 >= lo + held
            base = _round_rows(lo, held,
                               torch.arange(1 << (t - held))[None, :])
            rows = ((row0 | base)[:, :, None] + (
                torch.arange(1 << held)[None, None, :] << lo)
            ).reshape(-1, 1 << held)
            desc = (((row0 | base) >> (j + 1)) & 1).reshape(-1, 1) == 1
            vals = x[rows]
            for h in range(held - 1, -1, -1):
                if lo + h > khi:
                    continue
                for m in range(1 << held):
                    if not m & (1 << h):
                        _exchange(vals, m, m | (1 << h), desc)
            x[rows] = vals
            khi = lo - 1


def _emulated_sort(x, tile_log, held=HELD, check=None):
    """The kernel's passes on ``x`` (int64 values of int32, any number of
    columns); after each, ``check(pass, x)`` if given."""
    logn = x.shape[0].bit_length() - 1
    held = min(held, tile_log)
    out = x.clone()
    for p in T4.plan(logn, tile_log):
        if p[0] == "global":
            _global_pass(out, logn, *p[1:])
        else:
            _tile_pass(out, logn, tile_log, p[1], p[2], held)
        if check:
            check(p, out)
    return out


@pytest.mark.parametrize("tile_log", [1, 2, 3, 12])
def test_emulated_passes_equal_the_plain_stages(tile_log):
    """Each emulated pass equals its stages run by ``sort_stage``, the
    plain network's step, from the same array, at logN 1 to 9 (global
    passes of four stages and split groups from logN 6 at tile 1); the
    result is np.sort's."""
    rng = np.random.default_rng(tile_log)
    for logn in range(1, 10):
        x_np = rng.integers(-(1 << 31), 1 << 31, (1 << logn, 8))
        iota = torch.arange(1 << logn)[:, None]
        state = {"x": torch.from_numpy(x_np)}

        def check(p, got):
            want = state["x"]
            for j, k in _stages(p, logn, tile_log):
                want = T4.sort_stage(want, j, k, iota)
            assert torch.equal(got, want), (logn, p)
            state["x"] = got.clone()

        out = _emulated_sort(torch.from_numpy(x_np), tile_log, check=check)
        assert np.array_equal(out.numpy(), np.sort(x_np, axis=0))


@pytest.mark.parametrize("tile_log", [2, 3, 5, 12])
def test_emulated_sort_equals_numpy(tile_log):
    """The emulated kernel sorts like np.sort at logN 1 to 16 on random
    int32 with negatives and repeats (8 columns: the columns do not meet),
    and on the tool's keys at logN 12."""
    rng = np.random.default_rng(40 + tile_log)
    for logn in range(1, 17):
        x_np = rng.integers(-(1 << 31), 1 << 31, (1 << logn, 8))
        x_np[::3] = x_np[0]
        out = _emulated_sort(torch.from_numpy(x_np), tile_log)
        assert np.array_equal(out.numpy(), np.sort(x_np, axis=0)), logn
    keys = T4.keys(12)[:, :8].astype(np.int64)
    out = _emulated_sort(torch.from_numpy(keys), tile_log)
    assert np.array_equal(out.numpy(), np.sort(keys, axis=0))


def test_kernel_source_holds_the_plan_constants():
    """The constants the plan mirrors are the kernel's own, the entry
    takes x and out, and the pass count is exported."""
    src = _read("probe_sort.cu")
    for pattern in (rf"constexpr int kTileLog = {T4.TILE_LOG};",
                    rf"constexpr int kGlobalStages = {T4.GLOBAL_STAGES};",
                    rf"constexpr int kMaxLogN = {T4.MAX_LOGN};",
                    r"constexpr int kTileCols = 8;",
                    rf"constexpr int kHeld = {HELD};",
                    r'extern "C" int lz4t_probe_sort\(const void\* x, '
                    r"void\* out, int n,",
                    r'extern "C" int lz4t_probe_sort_passes\(int n\)'):
        assert re.search(pattern, src), pattern
    assert "clone" not in open(T4.__file__).read()


def test_sort_pace_variants_apply_to_the_source():
    """Each of ``sort_pace``'s variants changes the kernel's source (the
    I/O one both the load and the store loop), one whose pattern is gone
    raises, and without a card it refuses to time."""
    src = _read("probe_sort.cu")
    for name in sort_pace.VARIANTS:
        assert sort_pace.variant_source(src, name) != src, name
    io16 = sort_pace.variant_source(src, "io16")
    assert io16.count("#pragma unroll 16\n  for (int e = threadIdx.x;") == 2
    with pytest.raises(ValueError, match="not in the source"):
        sort_pace.variant_source("int main() {}", "held3")
    with pytest.raises(SystemExit):
        sort_pace.main(["--device", "cpu"])

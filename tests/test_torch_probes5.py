"""The two harness readings that run on every SM since their redesign,
``ohbuild`` (T14a) and ``mxu_f32`` (T14b), on the CPU: their kernels'
reduction contracts emulated (``probe_harness_wg.cu``), and the one
PyTorch call that prices each of twelve T14a bodies (``library_call``)
against the body's plain step.

- ``ohbuild``: items (iteration, 64-row band); in each, every element of
  the band's one-hot is compared and the ones enter a packed sum biased
  by 4096 a column, whose halves give the count and the columns of the
  ones; acc's rows 0-7 are counted in integers a block and the counts
  summed over the blocks. ``out`` and ``sink`` equal ``harness_plain``
  bit for bit.
- ``mxu_f32``: items (iteration, 64-row band, k-half), a tile of 16 held
  by each block; each k-half's product is rounded to float32 apart, the
  two halves' rows 0-7 added, then added into acc in iteration order; a
  float64 sink partial a block. ``out`` within E of the float64
  reference (``harness_reference``), ``sink`` within the summed bound."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.kernels import _build
from lz4_sgori_torch.probes import microbench2 as T14
from test_torch_probes3 import _OnCuda
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

M32 = 0xFFFFFFFF
BIAS = 4096      # the kernel's bias of a column in ohbuild's packed sum
TILES = 16       # mxu_f32's (64-row band, k-half) tiles
WGS = 4          # mxu_f32's warpgroups a block


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _as_int32(x: int) -> torch.Tensor:
    return torch.tensor(((x + (1 << 31)) & M32) - (1 << 31),
                        dtype=torch.int32)


# ---- ohbuild ----

def _packed_sink(rows: np.ndarray, lo_ones: np.ndarray, hi_ones: np.ndarray
                 ) -> int:
    """The kernel's sink of the one-hot's ``rows`` from the masks of each
    (row, lane, word): column ``2 (lane + 32 word)`` (low half) and the
    next (high half); each mask selects its column plus ``BIAS`` into a
    packed 32-bit sum a (row, lane), and ``lo + hi + (512 row - BIAS) x
    ((lo >> 12) + (hi >> 12))`` of its halves enters the wrapping sum."""
    lane, word = np.arange(32)[:, None], np.arange(8)[None, :]
    col = 2 * (lane + 32 * word)
    s = (lo_ones * (col + BIAS)).sum(-1) + (
        (hi_ones * (col + 1 + BIAS)).sum(-1) << 16)
    lo, hi = s & 0xFFFF, s >> 16
    n = (lo >> 12) + (hi >> 12)
    return int(((lo + hi + (512 * rows[:, None] - BIAS) * n) & M32).sum()
               ) & M32


def test_trap_biased_packed_sum_recovers_every_one():
    """However many ones a lane's words hold (up to 8 a half), the halves
    of the biased sum stay below 2^16 and give the count (above bit 12)
    and the columns (below): the kernel's sink is the flat index sum of
    every one, not of one a row."""
    rng = np.random.default_rng(5)
    rows = np.arange(0, 2048, 37)
    for p in (0.05, 0.5, 1.0):
        lo = rng.random((len(rows), 32, 8)) < p
        hi = rng.random((len(rows), 32, 8)) < p
        lane, word = np.arange(32)[:, None], np.arange(8)[None, :]
        col = 2 * (lane + 32 * word)
        flat = 512 * rows[:, None, None] + col[None]
        want = int((flat * lo).sum() + ((flat + 1) * hi).sum())
        assert _packed_sink(rows, lo, hi) == want & M32, p


def _ohbuild_emulated(r: int, ids: torch.Tensor, grid: int, rng):
    """``probe_harness_wg``'s ohbuild: items (iteration, 64-row band) in a
    shuffled order, dealt to ``grid`` blocks; a block's sink partial and
    its counts of acc's ones (rows 0-7, columns 0-127); then the counts
    and partials summed over the blocks."""
    counts = np.zeros((grid, 8, 128), np.int64)
    part = [0] * grid
    lane, word = np.arange(32)[:, None], np.arange(8)[None, :]
    col = 2 * (lane + 32 * word)
    for w in rng.permutation(r * 32):
        i, band = divmod(int(w), 32)
        rows = np.arange(64 * band, 64 * band + 64)
        idv = ((T14._lcg(ids.to(torch.int64) + i) >> 7) & 511)[:, 0].numpy()
        v = idv[rows][:, None, None]
        lo, hi = col[None] == v, col[None] + 1 == v
        b = int(w) % grid
        part[b] = (part[b] + _packed_sink(rows, lo, hi)) & M32
        if band == 0:
            for row in range(8):
                ones = np.stack([lo[row, :, :2], hi[row, :, :2]], -1)
                # words 0 and 1 of lane l: columns 2 (l + 32 j) + half
                counts[b, row] += ones.transpose(1, 0, 2).reshape(128)
    out = torch.from_numpy(counts.sum(0).astype(np.float32))
    return out, _as_int32(sum(part))


def test_ohbuild_wg_reduction_contract():
    """At R 0, 1, 3 and 40 the emulated whole-card kernel's ``out`` and
    ``sink`` equal ``harness_plain``'s bit for bit, on the tool's ids and
    on ids drawn over all of int32."""
    rng = np.random.default_rng(13)
    tool = T14.body_inputs("ohbuild", "cpu")[0]
    wide = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (2048, 1))
                            .astype(np.int32))
    for ids in (tool, wide):
        for r in (0, 1, 3, 40):
            out, sink = _ohbuild_emulated(r, ids, 7, rng)
            want_out, want_sink = T14.harness_plain("ohbuild", r, ids)
            assert np.array_equal(_bits(out), _bits(want_out)), r
            assert torch.equal(sink, want_sink), r


def test_ohbuild_refuses_r_from_2_24():
    """acc's cells count ones in integers on the card; the float32 running
    sum stops counting at 2^24, so the harness refuses such an R for
    ``ohbuild`` (and only for it) before any work."""
    ids = T14.body_inputs("ohbuild", "cpu")
    assert T14.BODIES["ohbuild"].r_limit == 1 << 24
    T14.check_harness_args("ohbuild", (1 << 24) - 1, ids)
    with pytest.raises(ValueError, match=r"2\^24\) for ohbuild"):
        T14.harness("ohbuild", 1 << 24, *ids)
    T14.check_harness_args("vpu", 1 << 24, T14.body_inputs("vpu", "cpu"))


# ---- mxu_f32 ----

def _mxu_f32_items(r: int, grid: int) -> list[tuple[int, int, int, int]]:
    """The kernel's static list, ``(block, warpgroup, iteration, tile)``:
    block b holds tile b % 16, the tile's blocks take its iterations in
    turn, and a block's four warpgroups take the block's items in turn."""
    items = []
    for b in range(grid):
        tile = b % TILES
        blocks = (grid - tile + TILES - 1) // TILES
        for wg in range(WGS):
            j = wg
            while (i := b // TILES + blocks * j) < r:
                items.append((b, wg, i, tile))
                j += WGS
    return items


def test_fragments_cover_the_tile():
    """The accumulator layout the emulated sums follow: each cell of the
    (64, 128) tile once, rows 0-7 with warp 0's even accumulators of
    e < 2 (what the kernel stores)."""
    rows, cols = _fragments()
    assert sorted((rows * 128 + cols).flatten().tolist()) == list(
        range(64 * 128))
    top = rows < 8
    assert torch.equal(top.nonzero()[:, 0].unique(), torch.arange(32))
    assert torch.equal((torch.arange(64)[None, :].expand(128, 64)[top] & 2),
                       torch.zeros(int(top.sum()), dtype=torch.int64))


@pytest.mark.parametrize("grid", [16, 17, 132])
def test_mxu_f32_items_cover_each_tile_once(grid):
    """Every (iteration, tile) once, on a grid of 16, 17 and 132 blocks
    (the H100's SMs), and no block more than one item above another of
    its tile."""
    for r in (0, 1, 3, 33, 301):
        items = _mxu_f32_items(r, grid)
        got = sorted((i, t) for _, _, i, t in items)
        assert got == [(i, t) for i in range(r) for t in range(TILES)], r
        for t in range(TILES):
            load = [sum(1 for b, *_ in items if b == blk)
                    for blk in range(t, grid, TILES)]
            assert max(load) - min(load) <= 1, (r, t)


def _fragments() -> tuple[torch.Tensor, torch.Tensor]:
    """The (row, column) of accumulator q of thread 32 w + 4 g + t of a
    warpgroup's m64n128 wgmma tile: q = 4 j + e holds row 16 w + g (+ 8
    for e >= 2), column 8 j + 2 t (+ 1 for odd e); (128, 64) each."""
    thr, q = torch.arange(128)[:, None], torch.arange(64)[None, :]
    w, g, t = thr >> 5, (thr >> 2) & 7, thr & 3
    j, e = q >> 2, q & 3
    return 16 * w + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)


def _thread_sums(c: torch.Tensor) -> torch.Tensor:
    """Each thread's 64 accumulators of tile ``c`` (64, 128) summed as the
    kernel sums them, in float32, in pairs: q += q + h for h = 32 .. 1."""
    rows, cols = _fragments()
    d = c[rows, cols]
    h = 32
    while h:
        d = d[:, :h] + d[:, h:2 * h]
        h >>= 1
    return d[:, 0]


def _mxu_f32_emulated(r: int, ins, grid: int, rng):
    """``probe_harness_wg``'s mxu_f32: items (iteration, band, k-half) in a
    shuffled order, dealt to ``grid`` blocks; each k-half's product
    rounded to float32; band 0's rows 0-7 of both halves, scaled by the
    factor, to a per-iteration buffer, added (half 0 + half 1) and then
    into acc in iteration order; each thread's elements summed in pairs
    in float32, scaled, into a float64 sink partial a block, summed in
    block order."""
    a, b = (t.double() for t in ins)
    scratch = torch.full((r, 2, 8, 128), float("nan"))
    part = [0.0] * grid
    for w in rng.permutation(r * TILES):
        i, tile = divmod(int(w), TILES)
        band, kh = tile >> 1, tile & 1
        ks = slice(256 * kh, 256 * kh + 256)
        c = (a[64 * band:64 * band + 64, ks] @ b[ks]).to(torch.float32)
        f = (i & 1) + 1
        for x in (_thread_sums(c) * f).double():
            part[int(w) % grid] += float(x)
        if band == 0:
            scratch[i, kh] = c[:8] * f
    acc = torch.zeros((8, 128), dtype=torch.float32)
    for i in range(r):
        acc = acc + (scratch[i, 0] + scratch[i, 1])
    sink = 0.0
    for p in part:
        sink += p
    return acc, torch.tensor(sink, dtype=torch.float64)


def test_mxu_f32_wg_reduction_contract():
    """At R 0, 1, 3 and 40 the emulated whole-card kernel's ``out`` lies
    within E of the float64 reference in every cell (as does
    ``harness_plain``'s) and its ``sink`` within the summed bound."""
    rng = np.random.default_rng(16)
    ins = T14.body_inputs("mxu_f32", "cpu")
    for r in (0, 1, 3, 40):
        out, sink = _mxu_f32_emulated(r, ins, 7, rng)
        ref, e_out, ref_sink, e_sink = T14.harness_reference("mxu_f32", r,
                                                             *ins)
        want_out, _ = T14.harness_plain("mxu_f32", r, *ins)
        for got in (out, want_out):
            assert bool(((got.double() - ref).abs() <= e_out).all()), r
        assert abs(float(sink) - ref_sink) <= e_sink, r
        if r == 0:
            assert not out.any() and float(sink) == 0.0


# ---- both: the scratch, and no fallback ----

def test_wg_scratch_bytes():
    """Rows of 4 KiB an iteration (two for mxu_f32's k-halves), ohbuild's
    counts 4 KiB a block, then 8 bytes a block; none for transpose,
    shiftsel and red1; the whole-card source runs ohbuild, the five
    tensor-core readings, transpose, shiftsel and red1."""
    g = 132
    assert T14.wg_scratch_bytes("gather", 300, g) == 300 * 4096 + 8 * g
    assert T14.wg_scratch_bytes("cumsum_mxu", 0, g) == 8 * g
    assert T14.wg_scratch_bytes("mxu_f32", 300, g) == 600 * 4096 + 8 * g
    assert T14.wg_scratch_bytes("ohbuild", 300, g) == g * 4096 + 8 * g
    assert T14.wg_scratch_bytes("transpose", 300, g) == 0
    assert T14.wg_scratch_bytes("shiftsel", 300, g) == 0
    assert T14.wg_scratch_bytes("red1", 300, g) == 0
    assert [n for n, b in T14.BODIES.items() if b.source == T14.WG] == [
        "ohbuild", "mxu_bf16", "mxu_f32", "gather", "cumsum_mxu",
        "cumsum_mxu_lane", "transpose", "shiftsel", "red1"]


@pytest.mark.parametrize("name", ["ohbuild", "mxu_f32"])
def test_redesigned_failed_build_raises_and_never_falls_back(monkeypatch,
                                                             name):
    """On the card's branch each redesigned reading builds
    ``probe_harness_wg``; when the build fails it raises, and no plain
    result comes back."""
    built = []

    def no_nvcc(source, *_a, **_k):
        built.append(source)
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    T14.harness_launches[name] = 0
    args = [t.as_subclass(_OnCuda) for t in T14.body_inputs(name, "cpu")]
    with pytest.raises(RuntimeError, match="nvcc"):
        T14.harness(name, 3, *args)
    assert built == ["probe_harness_wg"]
    assert T14.harness_launches[name] == 0


# ---- the library calls of T14a ----

def _int64(ins):
    return [t if t.is_floating_point() else t.to(torch.int64) for t in ins]


@pytest.mark.parametrize("name", sorted(T14.WHOLE))
def test_library_call_is_iteration_0s_whole_result(name):
    """The call gives the whole result of iteration 0 of the body's plain
    step (``whole``), in its shape, value for value (floats by their
    bits), and the step's sink is the sum of that result's elements (the
    one-hot's by flat index, a float input's by its bits, converted
    integers by value): the library time prices the function the kernel
    computes."""
    ins = T14.body_inputs(name, "cpu")
    fn, label = T14.library_call(name, *ins)
    got = fn()
    want = T14.whole(name, 0, *_int64(ins))
    assert tuple(got.shape) == tuple(want.shape) and label
    if got.dtype == torch.float32:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        vals = got.view(torch.int32) if ins[0].is_floating_point() else got
        total = int(vals.to(torch.int64).sum())
    elif got.dtype == torch.bool:
        assert torch.equal(got, want)
        flat = torch.arange(got.numel()).reshape(got.shape)
        total = int(torch.where(got, flat, 0).sum())
    else:
        assert got.dtype == torch.int32
        assert torch.equal(got.to(torch.int64), want)
        total = int(got.to(torch.int64).sum())
    _, sink = T14.BODIES[name].step(0, *_int64(ins))
    assert total == int(sink)


def test_library_calls_cover_twelve_bodies():
    """Twelve of T14a's bodies have a call; the three chains of
    operations have none, and no T14b reading is priced here (its call
    is a product)."""
    assert set(T14.T14A) - set(T14.WHOLE) == {"vpu", "sroll", "lroll"}
    assert set(T14.WHOLE) < set(T14.T14A)
    for name in set(T14.BODIES) - set(T14.WHOLE):
        with pytest.raises(KeyError, match="no single PyTorch call"):
            T14.library_call(name, *T14.body_inputs(name, "cpu"))


@pytest.mark.parametrize("name", ["statrow", "cumsum_shift", "red0"])
def test_whole_wraps_as_int32(name):
    """At an ``i`` that carries ``a512 + i`` past 2^31, the plain whole
    result is the int32 operation's, wrapped: the library call's on
    int32 inputs offset by the same ``i``."""
    i = (1 << 31) - 1000
    ins = T14.body_inputs(name, "cpu")
    want = T14.whole(name, i, *_int64(ins))
    shifted = [T14._plus(ins[0], i), *ins[1:]]
    fn, _ = T14.library_call(name, *shifted)
    assert torch.equal(fn().to(torch.int64), want)

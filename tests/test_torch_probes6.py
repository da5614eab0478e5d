"""The two tensor-core readings that run on every SM since their
redesign, ``mxu_bf16`` and ``cumsum_mxu_lane`` (``probe_harness_wg.cu``),
on the CPU, and the one PyTorch call that prices a round of T5, T9 and
T10.

- ``mxu_bf16``: items (iteration, 64-row band), band b held by blocks b,
  b + 8, ... which take the iterations in turn, a block's four
  warpgroups its items in turn; each band's product rounded to float32,
  band 0's rows 0-7 (times the factor) to a per-iteration buffer added
  into acc in iteration order; each thread's 64 elements summed in pairs
  in float32, times the factor, into a float64 sink partial a block.
- ``cumsum_mxu_lane``: items (iteration, 64-row band) dealt the same way
  over three warpgroups a block; A = float32(a512 + i) split into hi +
  lo in TF32, exact below 2^22 (R below 2^21); each thread's 64 elements
  summed in pairs in float32 into a float64 sink partial.

Both: ``out`` within E of the float64 reference (``harness_reference``),
as ``harness_plain``'s is, ``sink`` within the summed bound."""

import os
import re

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.kernels import _build
from lz4_sgori_torch.probes import dma_probe as T5
from lz4_sgori_torch.probes import microbench2 as T14
from lz4_sgori_torch.probes import microbench3 as T9
from lz4_sgori_torch.probes import wg_ab
from test_torch_probes3 import _OnCuda
from test_torch_probes4 import _bits_as_float, _tf32
from test_torch_probes5 import _thread_sums
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = 8                                   # 64-row bands of a product
WGS = {"mxu_bf16": 4, "cumsum_mxu_lane": 3}  # warpgroups a block
REDESIGNED = tuple(WGS)


def _items(r: int, grid: int, wgs: int) -> list[tuple[int, int, int, int]]:
    """The kernels' static list, ``(block, warpgroup, iteration, band)``:
    block b holds band b % 8, the band's blocks take its iterations in
    turn, and a block's warpgroups take the block's items in turn."""
    items = []
    for b in range(grid):
        band = b % BANDS
        blocks = (grid - band + BANDS - 1) // BANDS
        for wg in range(wgs):
            j = wg
            while (i := b // BANDS + blocks * j) < r:
                items.append((b, wg, i, band))
                j += wgs
    return items


@pytest.mark.parametrize("name", REDESIGNED)
@pytest.mark.parametrize("grid", [8, 9, 132])
def test_items_cover_each_band_once(name, grid):
    """Every (iteration, band) once on a grid of 8, 9 and 132 blocks (the
    H100's SMs), no block more than one item above another of its band,
    and a block's warpgroups within one item of each other."""
    for r in (0, 1, 3, 33, 301):
        items = _items(r, grid, WGS[name])
        got = sorted((i, band) for *_, i, band in items)
        assert got == [(i, b) for i in range(r) for b in range(BANDS)], r
        for band in range(BANDS):
            load = [sum(1 for b, *_ in items if b == blk)
                    for blk in range(band, grid, BANDS)]
            assert max(load) - min(load) <= 1, (r, band)
        for blk in range(grid):
            per = [sum(1 for b, w, *_ in items if (b, w) == (blk, wg))
                   for wg in range(WGS[name])]
            assert max(per) - min(per) <= 1, (r, blk)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of float32 ``x``: hi its sign, exponent and 10
    mantissa bits, lo = x - hi rounded to TF32 (cvt.rna)."""
    hi = _bits_as_float(x.view(torch.int32).to(torch.int64) & 0xFFFFE000)
    return hi, _tf32(x - hi)


def _is_tf32(x: torch.Tensor) -> bool:
    return not bool((x.view(torch.int32) & 0x1FFF).any())


def _emulated(name: str, r: int, ins, grid: int, rng):
    """The whole-card kernel of ``name`` on the CPU: the static list's
    items run in a shuffled order, the scratch, the second kernel's adds
    in iteration order and the partials summed in block order."""
    scratch = torch.full((r, 8, 128), float("nan"))
    part = [0.0] * grid
    items = _items(r, grid, WGS[name])
    for k in rng.permutation(len(items)):
        blk, _, i, band = items[k]
        rows = slice(64 * band, 64 * band + 64)
        if name == "mxu_bf16":
            a, b = (t.double() for t in ins)
            c = (a[rows] @ b).to(torch.float32)
            f = (i & 1) + 1
            for v in (_thread_sums(c) * f).double():
                part[blk] += float(v)
            top = c[:8] * f
        else:
            a, triu = ins
            x = (a[rows].to(torch.int64) + i).to(torch.float32)
            hi, lo = _split(x)
            assert _is_tf32(hi) and _is_tf32(lo)
            c = ((hi.double() + lo.double()) @ triu.double()).to(
                torch.float32)
            for v in _thread_sums(c).double():
                part[blk] += float(v)
            top = c[:8]
        if band == 0:
            scratch[i] = top
    acc = torch.zeros((8, 128), dtype=torch.float32)
    for i in range(r):
        acc = acc + scratch[i]
    sink = 0.0
    for p in part:
        sink += p
    return acc, torch.tensor(sink, dtype=torch.float64)


@pytest.mark.parametrize("name", REDESIGNED)
def test_wg_reduction_contract(name):
    """At R 0, 1, 3 and 40 on 9 blocks: the emulated kernel's ``out``
    within E of the float64 reference in every cell (as is
    ``harness_plain``'s), its ``sink`` within the summed bound; R 0 gives
    zeros."""
    rng = np.random.default_rng(14)
    ins = T14.body_inputs(name, "cpu")
    for r in (0, 1, 3, 40):
        out, sink = _emulated(name, r, ins, 9, rng)
        ref, e_out, ref_sink, e_sink = T14.harness_reference(name, r, *ins)
        want_out, want_sink = T14.harness_plain(name, r, *ins)
        for got in (out, want_out):
            assert bool(((got.double() - ref).abs() <= e_out).all()), r
        for got in (sink, want_sink):
            assert abs(float(got) - ref_sink) <= e_sink, r
        if r == 0:
            assert not out.any() and float(sink) == 0.0


def test_cumsum_lane_split_is_exact_on_the_tools_inputs():
    """hi + lo is x itself, both TF32, for float32(a512 + i) at the R the
    kernel takes (up to 2^21 - 1), so each band's split product equals
    the float64 product of x; at 2^22 + 2^11 + 1 (out of range) lo needs
    12 bits and the split is not exact."""
    a, triu = T14.body_inputs("cumsum_mxu_lane", "cpu")
    for i in (0, 1, 3, 40, 4095, (1 << 21) - 1):
        x = (a.to(torch.int64) + i).to(torch.float32)
        assert bool((x < 1 << 22).all())
        hi, lo = _split(x)
        assert _is_tf32(hi) and _is_tf32(lo)
        assert torch.equal(hi.double() + lo.double(), x.double()), i
        assert torch.equal(hi.double() @ triu.double()
                           + lo.double() @ triu.double(),
                           x.double() @ triu.double()), i
    far = torch.tensor([float((1 << 22) + (1 << 11) + 1)])
    hi, lo = _split(far)
    assert float(hi.double() + lo.double()) != float(far)


def test_cumsum_lane_refuses_r_from_2_21():
    """The wrapper refuses R >= 2^21 before any launch, as the C entry
    does, and takes the card's counts."""
    ins = T14.body_inputs("cumsum_mxu_lane", "cpu")
    with pytest.raises(ValueError, match=r"2\^21"):
        T14.check_harness_args("cumsum_mxu_lane", 1 << 21, ins)
    T14.check_harness_args("cumsum_mxu_lane", (1 << 21) - 1, ins)
    assert T14.BODIES["cumsum_mxu_lane"].card[1] < 1 << 21


@pytest.mark.parametrize("name", REDESIGNED + T14.RESIDENT)
def test_redesigned_failed_build_raises_and_never_falls_back(monkeypatch,
                                                             name):
    """On the card's branch each redesigned reading (``mxu_bf16``,
    ``cumsum_mxu_lane``, ``transpose``, ``shiftsel``, ``red1``) builds
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


def test_scratch_bytes_and_scratch_need():
    """``wg_scratch_bytes``: 4 KiB of rows an iteration for both redesigned
    readings (one k-part), then 8 bytes a block; the C entry's
    ``scratch_need`` lays out the same bytes for each of the nine
    bodies by its number (two rows an iteration for ``mxu_f32`` alone, a
    block's counts for ``ohbuild``, none for ``transpose``, ``shiftsel``
    and ``red1``), refuses R from 2^21 for ``cumsum_mxu_lane``, and each
    kernel refuses a grid below its tiles."""
    g = 132
    for name in REDESIGNED:
        assert T14.wg_scratch_bytes(name, 300, g) == 300 * 4096 + 8 * g
        assert T14.wg_scratch_bytes(name, 0, g) == 8 * g
    with open(os.path.join(ROOT, "lz4_sgori_torch", "csrc",
                           "probe_harness_wg.cu")) as f:
        src = f.read()
    none = re.search(r"if \(body == (\d+) \|\| body == (\d+) \|\| "
                     r"body == (\d+)\) return 0;", src)
    assert none and [int(none[k]) for k in (1, 2, 3)] == [
        T14.BODY_ID[n] for n in T14.RESIDENT]
    need = re.search(r"size_t rows = body == (\d+) \? \(size_t\)grid : "
                     r"\(size_t\)r \* \(body == (\d+) \? 2 : 1\);", src)
    assert need and int(need[1]) == T14.BODY_ID["ohbuild"]
    assert int(need[2]) == T14.BODY_ID["mxu_f32"]
    assert re.search(r"\(body == (\d+) && r >= 1 << 21\)", src)[1] == str(
        T14.BODY_ID["cumsum_mxu_lane"])
    for name in T14.BODIES:
        if T14.BODIES[name].source != T14.WG:
            continue
        if name in T14.RESIDENT:
            assert T14.wg_scratch_bytes(name, 300, g) == 0
            continue
        rows = (g if name == "ohbuild"
                else 300 * (2 if name == "mxu_f32" else 1))
        assert T14.wg_scratch_bytes(name, 300, g) == rows * 4096 + 8 * g
    assert "if (grid < 8 * E::kParts)" in src
    assert "if (grid < cl::kBands)" in src
    assert "if (grid < rb::kBands)" in src


def test_wg_ab_reads_a_sources_body_numbers():
    """``wg_ab`` reads a harness source's body numbers from its switch:
    this source's are ``BODY_ID``'s, ``transpose`` and ``shiftsel`` its
    bodies 6 and 7, and a source of four bodies (the order before
    ``mxu_bf16`` and ``cumsum_mxu_lane`` joined) keeps its own; without a
    card it refuses to time."""
    with open(os.path.join(ROOT, "lz4_sgori_torch", "csrc",
                           "probe_harness_wg.cu")) as f:
        got = wg_ab.body_ids(f.read())
    assert got == {n: T14.BODY_ID[n] for n, b in T14.BODIES.items()
                   if b.source == T14.WG}
    assert (got["transpose"], got["shiftsel"]) == (6, 7)
    four = "\n".join(f"    case {k}: return run_{n}(in0, in1, r);" for k, n
                     in enumerate(("ohbuild", "mxu_f32", "gather",
                                   "cumsum_mxu")))
    assert wg_ab.body_ids(four) == {"ohbuild": 0, "mxu_f32": 1, "gather": 2,
                                    "cumsum_mxu": 3}
    with pytest.raises(SystemExit):
        wg_ab.main(["--device", "cpu"])


# ---- the library calls of T5, T9 and T10: a round each ----

def test_t5_library_call_is_round_0():
    """T5's call gives round 0's staging block: each of the lanes' ``w``
    words from ``idx[lane]`` of its row of the tape (numpy's slices), and
    its ``[0, 0]`` is what the plain version adds in round 0."""
    idx_np, hbm_np = T5.inputs()
    idx, hbm = torch.from_numpy(idx_np), torch.from_numpy(hbm_np)
    for nl, w in ((1, 128), (32, 512), (128, 512)):
        fn, label = T5.library_call(idx, hbm, w, nl)
        got = fn()
        want = np.stack([hbm_np[lane, idx_np[0, lane]:idx_np[0, lane] + w]
                         for lane in range(nl)])
        assert label and np.array_equal(got.numpy(), want), (nl, w)
        assert int(got[0, 0]) == int(T5.run_plain(idx, hbm, w, nl, 1)[0, 0])


@pytest.mark.parametrize("R", [8, 1024, 16384])
def test_t9_t10_library_calls_are_round_0(R):
    """T9's call reads round 0's 128 cells, row 0 of the plain version
    after one round; T10's writes round 0's 128 cells, the plain
    version's whole output after one round; neither takes another name."""
    tape = torch.from_numpy(T9.tape(R))
    fn, label = T9.library_call("gather", tape)
    assert label and torch.equal(fn(), T9.gather_plain(tape, 1)[0])
    out = torch.zeros((R, 128), dtype=torch.int32)
    fn, label = T9.library_call("scatter", out)
    assert label and fn() is out
    assert torch.equal(out, T9.scatter_plain(R, 1, "cpu", whole=True))
    with pytest.raises(KeyError, match="no single PyTorch call"):
        T9.library_call("fifo", tape)

"""T14 and T15, the primitive rates of the vectorized design.

T14, ``harness(name, r, *inputs) -> (out, sink)``: the tool's harness
(``tools/microbench2.py:_harness``) around one of its bodies. From ``acc =
zeros((8, 128), float32)``, each ``i`` of ``0 .. r - 1`` computes the
body's whole result from the read-only inputs and adds its rows ``[:8]``
(or a row or column of it, broadcast) into ``acc`` as float32, one add an
iteration in iteration order; nothing else carries over. int32 arithmetic
wraps and ``>>`` is arithmetic; ``lcg(x) = x * 1664525 + 1013904223``.
``out`` is ``acc``; ``sink`` is the sum, over all iterations, of every
element of the whole result, so that a kernel must compute all of it. For
T14a's bodies it is an int32, the wrapping sum (an int32 by value, a
float32 by its bit pattern; the one-hot of ``ohbuild`` as the flat index
``512 * row + col`` of each of its ones). T14a's bodies (``BODIES``, the
tool's lines), on the vector unit:

- ``vpu`` (:105): ``x = a512 + i``, then 8x ``x = (x ^ (x + 1)) + (x >>
  1)`` over all 512 rows;
- ``ohbuild`` (:144): the (2048, 512) one-hot of ``(lcg(ids + i) >> 7) &
  511``;
- ``extract`` (:155): ``g2048[r, lcg(ids[r] + i) & 127]`` for 2048 rows;
- ``red1``, ``red0`` (:168, :175): the row and column sums of ``a512 + i``;
- ``bitroll`` (:183): row r of ``a512`` rolled left by ``lcg(amt[r] + i) &
  127`` lanes;
- ``sroll``, ``lroll`` (:197, :206): 8x ``x = x + roll(x, 1)`` of ``a512 +
  i`` along the rows or the lanes, cyclic;
- ``vlookup`` (:216): ``tbl[lcg(idx1[c] + i) & 127, c]`` for 512 columns;
- ``fori`` (:257): ``small``; ``dynrow`` (:265): ``a512[row:row + 8]``,
  ``row = (37 i) & 255``; ``statrow`` (:275): ``a512[8:16] + i``;
- ``cumsum_shift`` (:284): the inclusive prefix sum down the rows of
  ``a512 + i``; ``transpose`` (:318): ``(x128 + i)`` transposed;
- ``shiftsel`` (:327): row r of ``a512[(r + (lcg(amt[r] + i) & 31)) %
  512]``.

T14b, the tool's tensor-core readings through the same ``harness`` (the
body's matrix product each iteration, rows ``[:8]`` into ``acc``):

- ``mxu_bf16``, ``mxu_f32`` (:115): ``(mA * ((i & 1) + 1)) @ mB`` on the
  bf16 draws, and on the same values as float32;
- ``gather`` (:130): ``onehot((lcg(ids + i) >> 7) & 511, 512) @
  data_bf``, a (2048, 128) row gather, exact;
- ``cumsum_mxu`` (:296): ``tril(ones(512, 512)) @ float32(a512 + i)``;
- ``cumsum_mxu_lane`` (:307): ``float32(a512 + i) @ triu(ones(128,
  128))``.

Their ``sink`` is a 0-d float64, the sum of every element of the float32
product (``gather``'s an int32 as above). The plain versions take each
product in float64, round it once to float32 and add rows ``[:8]`` into
``acc`` in iteration order; the kernel's order of summation inside a
product differs, so ``mxu_bf16``, ``mxu_f32`` and ``cumsum_mxu_lane`` are
held within ``harness_reference``'s bound E of the float64 value, and
``gather`` and ``cumsum_mxu``'s ``out`` (every product row 0-7 exact,
``Body.exact``) bit for bit. The kernel rounds the float32 operands of a
product to TF32, exact on the tool's inputs (bf16 values, 0/1
triangles), and splits ``float32(a512 + i)`` into two TF32 parts, exact
below 2^22 (``cumsum_mxu_lane`` takes R below 2^21, so that ``a512 + i``
stays there).

``harness`` launches ``csrc/probe_harness.cu`` (eleven of T14a's
bodies: one block of 1024 threads on one SM, ``acc`` in registers, the
loop over ``r`` in the kernel) or ``csrc/probe_harness_wg.cu``
(``ohbuild``, the five tensor-core readings, ``transpose``, ``shiftsel``
and ``red1``: a persistent grid of one block an SM over a static list of
work items, read-only operands held in shared memory; wgmma for the
products, ``mxu_bf16`` and ``mxu_f32`` one kernel template, tri through
TMA, ``cumsum_mxu_lane``'s A split in registers; for those six each
iteration's rows 0-7 go to a scratch buffer that a second kernel adds
into ``acc`` in iteration order, ``ohbuild``'s counted in integers, so
that it takes R below 2^24; ``transpose``, ``shiftsel`` and ``red1``
(``RESIDENT``) hold a 64-row band of their operand a block and run
``acc``'s chains in the main kernel, in iteration order, on 8 blocks of
their own that hold band 0) on CUDA tensors and runs the body's plain
version on CPU tensors; without inputs it takes the tool's
(``tool_inputs``) on ``device``.
``library_call`` gives the one PyTorch call that computes iteration 0's
whole result of twelve of T14a's bodies (``WHOLE``; all but the chains
``vpu``, ``sroll`` and ``lroll``), the yardstick that ``chip_smoke.py``
times them against, on the card (a CUDA graph of the calls) and eager;
the port never calls it.

T15, ``walk(tbl, r)``: the dependent scalar walk, from ``x = 1``, ``r``
steps of ``x = tbl[x & 511] + x + 1`` over a 512-word int32 table in
wrapping int32 arithmetic; the result is ``(8, 128)`` float32 holding
``float32(x)`` in every cell. It launches ``csrc/probe_walk.cu`` (the port
of ``walk_kernel``: one thread walks, the table staged in shared memory as
the TPU holds it in SMEM) on a CUDA tensor and runs ``walk_plain`` on a
CPU tensor. No single PyTorch call computes it (a dependent load and two
adds a step, each step's index from the last), so no library call prices
it.

``main()`` prints the tool's readings in its order, each as ``us/iter``
and ``ns/item`` by differencing two repeat counts (``Body.card``, chosen
so that a call of the higher takes 50-200 ms on one SM of an H100, or
0.3-1 ms on every SM; the tool's are ``Body.tool``), then the walk's.

    python -m lz4_sgori_torch.probes.microbench2 [--div D] \
        [--steps LO HI] [--device cpu]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import M32, check_device, check_int32, device_name, parser, \
    per_iter, signed32, wrap32

TBL = 512
STEPS = (65536, 1 << 25)    # the walk's two step counts (the tool's)
N = 512 * 128               # the cells of a512
ACC = 8 * 128
MXU = 512 * 512 * 128       # the multiply-adds of body_mxu's product
LANES, BF16, TF32 = 128, 4096, 2048     # ops an SM a clock (Body.rate)
VPU, WG = "probe_harness", "probe_harness_wg"
# the WG readings whose band each block holds and whose acc chains run in
# the main kernel: no scratch, no second kernel
RESIDENT = ("transpose", "shiftsel", "red1")
launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_walk.cu (T15)."""
    return _build.load("probe_walk", {"lz4t_probe_walk": "ppip"})


def load_harness_kernel(source: str):
    """Build (once) and load a harness source: csrc/probe_harness.cu
    (``VPU``, 11 of T14a's bodies) or csrc/probe_harness_wg.cu (``WG``,
    the whole-card ones: ``ohbuild``, T14b's five, ``transpose``,
    ``shiftsel`` and ``red1``)."""
    if source == WG:
        return _build.load("probe_harness_wg",
                           {"lz4t_probe_harness_wg": "ippipppnip"})
    return _build.load("probe_harness", {"lz4t_probe_harness": "ippippp"})


def wg_grid(device) -> int:
    """The blocks of a ``WG`` launch: one on each SM of ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def wg_scratch_bytes(name: str, r: int, grid: int) -> int:
    """The scratch of a ``WG`` launch of body ``name``: each iteration's
    rows 0-7 (4 KiB, two for ``mxu_f32``'s k-halves) or, for ``ohbuild``,
    each block's counts of acc's ones (4 KiB); then a sink partial (8
    bytes) a block. ``RESIDENT``'s readings need none: their chains run
    in the main kernel and each block adds its partial into the sink.
    The C entry is told the size and refuses a launch that needs more
    (its ``scratch_need``)."""
    if name in RESIDENT:
        return 0
    rows = grid if name == "ohbuild" else r * (2 if name == "mxu_f32" else 1)
    return rows * 4 * ACC + 8 * grid


# ---- the tool's inputs ----

def tool_inputs() -> dict[str, np.ndarray]:
    """The inputs of the tool's ``main()``: ``default_rng(0)``'s draws
    replayed in its order, each consuming the stream, the tensor-core
    readings' (``mA``, ``mB``, ``data_bf``, float64 as drawn) included,
    and the triangles the tool builds (``tri`` :302, ``triu`` :313).
    Integer arrays are int32, ``g2048`` float64 rounded to float32."""
    rng = np.random.default_rng(0)
    out = {"a512": rng.integers(0, 1 << 20, (512, 128))}        # :102
    out["mA"] = rng.normal(size=(512, 512))                       # :121
    out["mB"] = rng.normal(size=(512, 128))                       # :122
    out["ids"] = rng.integers(0, 1 << 20, (2048, 1))              # :138
    out["data_bf"] = rng.normal(size=(512, 128))                  # :139
    out["g2048"] = rng.normal(size=(2048, 128)).astype(np.float32)  # :163
    out["amt"] = rng.integers(0, 128, (512, 1))                   # :192
    out["tbl"] = rng.integers(0, 1 << 20, (128, 512))             # :224
    out["idx1"] = rng.integers(0, 128, (1, 512))                  # :225
    out["tblv"] = rng.integers(0, TBL, (TBL,))                    # :253
    out["small"] = rng.integers(0, 100, (8, 128))                 # :260
    out["x128"] = rng.integers(0, 1 << 20, (128, 512))            # :323
    out["tri"] = np.tril(np.ones((512, 512), np.float32))
    out["triu"] = np.triu(np.ones((128, 128), np.float32))
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in out.items()}


def walk_table() -> np.ndarray:
    """The tool's walk table (``tblv``, :253)."""
    return tool_inputs()["tblv"]


# (dtype, shape) of each input a body takes
INPUTS = {"a512": (torch.int32, (512, 128)), "ids": (torch.int32, (2048, 1)),
          "g2048": (torch.float32, (2048, 128)),
          "amt": (torch.int32, (512, 1)), "tbl": (torch.int32, (128, 512)),
          "idx1": (torch.int32, (1, 512)), "small": (torch.int32, (8, 128)),
          "x128": (torch.int32, (128, 512)),
          "mA": (torch.bfloat16, (512, 512)),
          "mB": (torch.bfloat16, (512, 128)),
          "mA32": (torch.float32, (512, 512)),
          "mB32": (torch.float32, (512, 128)),
          "data_bf": (torch.bfloat16, (512, 128)),
          "tri": (torch.float32, (512, 512)),
          "triu": (torch.float32, (128, 128))}
# the f32 reading's inputs: the bf16 draws as float32 (the tool's astype)
AS_F32 = {"mA32": "mA", "mB32": "mB"}


# ---- the bodies' plain versions: one iteration each ----
# Each takes ``i`` and the inputs (int64, float32 as float32) and returns
# what enters ``acc`` (int64 values or float32, broadcast to (8, 128)) and
# the int64 sum of the whole result's elements.

def _lcg(x: torch.Tensor) -> torch.Tensor:
    """``lcg`` of int64 ``x`` below 2^32 in magnitude, as int32 values."""
    return signed32(x * 1664525 + 1013904223)


def _vpu(i, a):
    x = signed32(a + i)
    for _ in range(8):
        x = signed32((x ^ (x + 1)) + (x >> 1))
    return x[:8], x.sum()


# The twelve bodies whose iteration is one PyTorch call: the call's
# arguments in iteration i from the body's inputs (int64 in the plain
# steps, the tool's types in ``library_call``; indices int64), and the
# call. Iteration i's whole result is the call on them (``whole``); the
# plain steps are built on it, and ``library_call`` binds iteration 0's
# arguments to the same call.

class Call(NamedTuple):
    args: Callable           # (i, *inputs) -> the call's arguments
    fn: Callable             # the one PyTorch call
    label: str


def _idx(t, i):
    """``lcg(t + i)`` of an int32-valued input, as int64."""
    return _lcg(t.to(torch.int64) + i)


def _plus(a, i):
    """``a + i`` wrapped to int32's range, in ``a``'s dtype."""
    return signed32(a.to(torch.int64) + i).to(a.dtype)


def _ohbuild_args(i, ids):
    return (torch.arange(512, device=ids.device)[None, :],
            (_idx(ids, i) >> 7) & 511)


def _bitroll_args(i, a, amt):
    lanes = torch.arange(128, device=a.device)[None, :]
    return a, 1, (lanes + (_idx(amt, i) & 127)) & 127


def _dynrow_args(i, a):
    row = (i * 37) & 255
    return (a[row:row + 8],)


def _shiftsel_args(i, a, amt):
    rows = torch.arange(512, device=a.device)
    return a, 0, (rows + (_idx(amt, i)[:, 0] & 31)) & 511


def _sum(x, dim):
    return torch.sum(x, dim, keepdim=True, dtype=x.dtype)


def _cumsum(x, dim):
    return torch.cumsum(x, dim, dtype=x.dtype)


WHOLE = {
    "ohbuild": Call(_ohbuild_args, torch.eq, "torch.eq of the (1, 512) "
                    "column iota with idv (2048, 1)"),
    "extract": Call(lambda i, g, ids: (g, 1, _idx(ids, i) & 127),
                    torch.gather, "torch.gather(g2048, 1, idx)"),
    "red1": Call(lambda i, a: (_plus(a, i), 1), _sum, "torch.sum over dim 1"),
    "red0": Call(lambda i, a: (_plus(a, i), 0), _sum, "torch.sum over dim 0"),
    "bitroll": Call(_bitroll_args, torch.gather,
                    "torch.gather(a512, 1, idx)"),
    "vlookup": Call(lambda i, tbl, idx1: (tbl, 0, _idx(idx1, i) & 127),
                    torch.gather, "torch.gather(tbl, 0, idx)"),
    "fori": Call(lambda i, small: (small, torch.float32), torch.Tensor.to,
                 "small.to(torch.float32), the tool's astype"),
    "dynrow": Call(_dynrow_args, torch.clone,
                   "torch.clone of the 8 rows a512[row:row + 8]"),
    "statrow": Call(lambda i, a: (a[8:16], i), torch.add,
                    "torch.add(a512[8:16], i)"),
    "cumsum_shift": Call(lambda i, a: (_plus(a, i), 0), _cumsum,
                         "torch.cumsum(x, 0, dtype=torch.int32)"),
    "transpose": Call(lambda i, x128: (_plus(x128, i),),
                      lambda x: x.t().contiguous(), "x128.t().contiguous()"),
    "shiftsel": Call(_shiftsel_args, torch.index_select,
                     "torch.index_select(a512, 0, idx)"),
}


def whole(name: str, i: int, *ins: torch.Tensor) -> torch.Tensor:
    """Iteration ``i``'s whole result of body ``name`` (``WHOLE``), an
    int64 result wrapped to int32's range."""
    c = WHOLE[name]
    v = c.fn(*c.args(i, *ins))
    return signed32(v) if v.dtype == torch.int64 else v


def _ohbuild(i, ids):
    oh = whole("ohbuild", i, ids)
    flat = torch.arange(2048 * 512, device=ids.device).reshape(2048, 512)
    return oh[:8, :128].to(torch.int64), torch.where(oh, flat, 0).sum()


def _extract(i, g, ids):
    v = whole("extract", i, g, ids)
    return v[:8], v.view(torch.int32).to(torch.int64).sum()


def _rows(name: str):
    """The step of a body whose rows 0-7 enter acc."""
    def step(i, *ins):
        v = whole(name, i, *ins)
        return v[:8], v.sum()
    return step


def _chained_roll(dim: int):
    def step(i, a):
        x = signed32(a + i)
        for _ in range(8):
            x = signed32(x + x.roll(1, dim))
        return x[:8], x.sum()
    return step


def _vlookup(i, tbl, idx1):
    v = whole("vlookup", i, tbl, idx1)
    return v[:, :128], v.sum()


def _fori(i, small):
    return whole("fori", i, small), small.sum()


def library_call(name: str, *ins: torch.Tensor):
    """The yardstick of a T14a body's time: one PyTorch call that computes
    iteration 0's whole result (``whole(name, 0, ...)``, in int32, float32
    or bool) from the body's inputs (in the tool's types), its arguments
    precomputed; ``(fn, label)``. The three bodies that no single call
    computes have none (``KeyError``): ``vpu``, ``sroll`` and ``lroll``
    are chains of operations. Only timings call it."""
    if name not in WHOLE:
        raise KeyError(f"no single PyTorch call computes body {name!r}")
    c = WHOLE[name]
    args = c.args(0, *ins)
    return (lambda: c.fn(*args)), c.label


# T14b: the tensor-core bodies. Each float reading is a product A_i @ B of
# operands exact in float64 (bf16 and float32 values, int32 sums converted
# to float32 as the tool's astype); the plain version rounds it once to
# float32, and its sink is the float64 sum of that float32 result.

def _f64(t):
    return t.to(torch.float64)


def _x(i, a):
    """``float32(a512 + i)``, the int32 sum wrapped."""
    return signed32(a.to(torch.int64) + i).to(torch.float32)


def tool_operands(name: str, i: int, *ins: torch.Tensor):
    """The two operands of iteration ``i``'s product of T14b reading
    ``name``, in the tool's types (bf16 or float32) from its inputs (int32
    or int64 integers)."""
    if name == "gather":
        ids, data = ins
        idv = (_lcg(ids.to(torch.int64) + i) >> 7) & 511
        cols = torch.arange(512, device=ids.device)
        return (cols[None, :] == idv).to(torch.bfloat16), data
    if name == "cumsum_mxu":
        return ins[1], _x(i, ins[0])
    if name == "cumsum_mxu_lane":
        return _x(i, ins[0]), ins[1]
    a, b = ins
    return a * ((i & 1) + 1), b     # a power of two: exact in bf16


def _product(name: str):
    def step(i, *ins):
        a, b = tool_operands(name, i, *ins)
        c = (_f64(a) @ _f64(b)).to(torch.float32)
        return c[:8], _f64(c).sum()
    return step


def _gather(i, ids, data):
    idv = (_lcg(ids + i) >> 7) & 511
    g = data.to(torch.float32)[idv[:, 0]]
    return g[:8], g.view(torch.int32).to(torch.int64).sum()


@dataclass(frozen=True)
class Body:
    reading: str             # the tool's reading name
    line: int                # the body's line in tools/microbench2.py
    inputs: tuple[str, ...]
    tool: tuple[int, int]    # the tool's two repeat counts
    card: tuple[int, int]    # the port's on the card
    items: int               # the tool's divisor of ns/item
    ops: int                 # the fewest operations an iteration (below)
    nbytes: int              # input bytes an iteration reads
    step: Callable
    rate: int = LANES        # ops one SM does a clock
    source: str = VPU        # the kernel's source, csrc/<source>.cu
    sink: torch.dtype = torch.int32
    exact: bool = True       # out equals the plain version's bit for bit
    r_limit: int = 1 << 31   # R must be below it


# ops: for T14a's bodies, on the vector unit (at LANES a clock an SM), the
# fewest instructions a lane executes to compute an iteration's

# whole result and acc's update, for a bound on the time: each operation
# of an element fused as the ISA allows (lcg(x + i) and a mask, one IMAD
# with i * 1664525 + 1013904223 formed once and one LOP3; a shift and an
# add one LEA.HI; three addends one IADD3, so that a reduction or a scan
# of a512 + i takes N / 2 or N); two elements of the one-hot (bfloat16 in
# the tool) one compare-select into a 32-bit word; loads and the index
# arithmetic of data movement not counted, nor the sink's adds (the
# kernel's own check); then one int-to-float conversion for each int32
# value that enters acc (fori's, loop-invariant, none) and acc's 1024
# float adds. For T14b's, on the tensor cores, the FLOPs of the product
# the function needs, 2 m n k (not the kernel's two passes of a split TF32
# product), at the H100's dense rate an SM a clock for the product's type:
# 4096 in bf16, 2048 in TF32. nbytes: the input bytes the
# function reads (4 a word, 2 a bf16).
BODIES = {b_name: Body(*fields) for b_name, fields in {
    "vpu": ("vpu_16ops_512x128", 105, ("a512",), (16384, 2097152),
            (1024, 8192), 512 * 128 * 16, 25 * N + 2 * ACC, 4 * N, _vpu),
    # ohbuild's kernel counts acc's ones in integers: exact below 2^24,
    # where the float32 running sum of 0s and 1s stops counting
    "ohbuild": ("onehot_build_2048x512", 144, ("ids",), (4096, 262144),
                (1024, 8192), 2048, 2 * 2048 + 2048 * 256 + ACC, 4 * 2048,
                _ohbuild, LANES, WG, torch.int32, True, 1 << 24),
    "extract": ("lane_extract_2048x128", 155, ("g2048", "ids"),
                (4096, 262144), (8192, 65536), 2048, 2 * 2048 + ACC,
                8 * 2048, _extract),
    "red0": ("reduce_sublanes_512x128", 175, ("a512",), (16384, 1048576),
             (8192, 65536), 1, N // 2 + 128 + ACC, 4 * N, _rows("red0")),
    "bitroll": ("bitroll7_lanes_512x128", 183, ("a512", "amt"),
                (8192, 262144), (4096, 32768), 512, 2 * 512 + 2 * ACC,
                4 * N + 4 * 512, _rows("bitroll")),
    "sroll": ("chained8_sublane_roll_512x128", 197, ("a512",),
              (8192, 262144), (2048, 16384), 8, 8 * N + 2 * ACC, 4 * N,
              _chained_roll(0)),
    "lroll": ("chained8_lane_roll_512x128", 206, ("a512",),
              (8192, 262144), (2048, 16384), 8, 8 * N + 2 * ACC, 4 * N,
              _chained_roll(1)),
    "vlookup": ("sublane_lookup_128x512", 216, ("tbl", "idx1"),
                (16384, 2097152), (32768, 262144), 512, 2 * 512 + 128 + ACC,
                8 * 512, _vlookup),
    "fori": ("fori_overhead_tinybody", 257, ("small",), (65536, 1 << 23),
             (1 << 21, 1 << 24), 1, ACC, 4 * ACC, _fori),
    "dynrow": ("dyn_sublane_read8_512x128", 265, ("a512",),
               (16384, 1048576), (1 << 18, 1 << 21), 1, 2 * ACC, 4 * ACC,
               _rows("dynrow")),
    "statrow": ("static_sublane_read8_512x128", 275, ("a512",),
                (16384, 1048576), (1 << 19, 1 << 22), 1, 3 * ACC, 4 * ACC,
                _rows("statrow")),
    "cumsum_shift": ("cumsum_logshift_rows_512x128", 284, ("a512",),
                     (2048, 65536), (2048, 16384), 512 * 128, N + 2 * ACC,
                     8 * N, _rows("cumsum_shift")),
    "mxu_bf16": ("mxu_512x512x128_bf16", 115, ("mA", "mB"), (8192, 524288),
                 (512, 4096), MXU, 2 * MXU, 2 * (512 * 512 + N),
                 _product("mxu_bf16"), BF16, WG, torch.float64, False),
    "mxu_f32": ("mxu_512x512x128_f32", 115, ("mA32", "mB32"),
                (8192, 524288), (256, 2048), MXU, 2 * MXU,
                4 * (512 * 512 + N), _product("mxu_f32"), TF32, WG,
                torch.float64, False),
    "gather": ("onehot_rowgather_2048q_512rows", 130, ("ids", "data_bf"),
               (4096, 262144), (256, 2048), 2048, 2 * 2048 * N,
               4 * 2048 + 2 * N, _gather, BF16, WG),
    "cumsum_mxu": ("cumsum_mxu_tri_512x128", 296, ("a512", "tri"),
                   (4096, 131072), (128, 1024), N, 2 * 512 * N,
                   4 * (N + 512 * 512), _product("cumsum_mxu"), TF32, WG,
                   torch.float64),
    # cumsum_mxu_lane's kernel splits a512 + i (below 2^20 + R) into two
    # TF32 parts, exact below 2^22
    "cumsum_mxu_lane": ("cumsum_mxu_lane_512x128", 307, ("a512", "triu"),
                        (2048, 65536), (512, 4096), N, 2 * 128 * N,
                        4 * (N + 128 * 128), _product("cumsum_mxu_lane"),
                        TF32, WG, torch.float64, False, 1 << 21),
    # T14a's two readings on every SM with a resident band, after T14b's
    # so that their numbers in probe_harness_wg.cu follow its first six;
    # at about 9 and 11 ns an iteration on an H100 their card counts
    # doubled to keep a call above 0.3 ms
    "transpose": ("transpose_128x512", 318, ("x128",), (2048, 65536),
                  (8192, 65536), 1, N + 2 * ACC, 4 * N, _rows("transpose"),
                  LANES, WG),
    "shiftsel": ("shiftsel32_rows_512x128", 327, ("a512", "amt"),
                 (2048, 65536), (4096, 32768), 512 * 128, 2 * 512 + 2 * ACC,
                 4 * N + 4 * 512, _rows("shiftsel"), LANES, WG),
    # red1 in the same form after them (its number 8 there); at about 9 ns
    # an iteration its card counts doubled as transpose's were
    "red1": ("reduce_lanes_512x128", 168, ("a512",), (16384, 1048576),
             (8192, 65536), 1, N // 2 + 8 + ACC, 4 * N, _rows("red1"),
             LANES, WG),
}.items()}
# the body's number in its source's switch: its place among the bodies of
# that source in BODIES
BODY_ID = {b_name: [n for n in BODIES if BODIES[n].source == b.source
                    ].index(b_name) for b_name, b in BODIES.items()}
# T14a's vector-unit bodies and T14b's tensor-core readings, by rate
T14A = tuple(n for n, b in BODIES.items() if b.rate == LANES)
T14B = tuple(n for n, b in BODIES.items() if b.rate != LANES)
# the tool's readings in its order
ORDER = ("vpu", "mxu_bf16", "mxu_f32", "gather", "ohbuild", "extract",
         "red1", "red0", "bitroll", "sroll", "lroll", "vlookup", "fori",
         "dynrow", "statrow", "cumsum_shift", "cumsum_mxu",
         "cumsum_mxu_lane", "transpose", "shiftsel")
harness_launches = dict.fromkeys(BODIES, 0)


def body_inputs(name: str, device) -> list[torch.Tensor]:
    """The tool's inputs of body ``name`` on ``device``, in the tool's
    types (torch's float64 -> bfloat16 cast rounds as ``jnp.asarray``'s)."""
    ins = tool_inputs()
    out = []
    for k in BODIES[name].inputs:
        t = torch.from_numpy(ins[AS_F32.get(k, k)])
        if k in AS_F32:
            t = t.to(torch.bfloat16)
        out.append(t.to(INPUTS[k][0]).to(device))
    return out


def check_harness_args(name: str, r: int, inputs) -> torch.device:
    if name not in BODIES:
        raise ValueError(f"unknown body {name!r}; the bodies: "
                         f"{', '.join(BODIES)}")
    want = BODIES[name].inputs
    if len(inputs) != len(want):
        raise TypeError(f"body {name} takes {len(want)} inputs {want}, got "
                        f"{len(inputs)}")
    for t, k in zip(inputs, want):
        dtype, shape = INPUTS[k]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{k} must be {dtype} {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    limit = BODIES[name].r_limit
    if not 0 <= r < limit:
        raise ValueError(f"r must be in [0, 2^{limit.bit_length() - 1}) "
                         f"for {name}, got {r}")
    return check_device(*inputs)


def harness(name: str, r: int, *inputs: torch.Tensor, device="cuda"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``r`` iterations of body ``name`` on ``inputs`` (the tool's on
    ``device`` when none are given): ``out`` (8, 128) float32 and ``sink``,
    a 0-d tensor of ``BODIES[name].sink`` (int32, or float64 for the
    float tensor-core readings)."""
    if not inputs:
        inputs = body_inputs(name, resolve_device(device))
    dev = check_harness_args(name, r, inputs)
    if dev.type == "cpu":
        return harness_plain(name, r, *inputs)
    body = BODIES[name]
    lib = load_harness_kernel(body.source)
    entry = getattr(lib, f"lz4t_{body.source}")
    ins = [t.contiguous() for t in inputs]
    ptrs = [t.data_ptr() for t in ins] + [None] * (2 - len(ins))
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    sink = torch.empty((), dtype=body.sink, device=dev)
    extra = []
    if body.source == WG:
        grid = wg_grid(dev)
        scratch = torch.empty(wg_scratch_bytes(name, r, grid),
                              dtype=torch.uint8, device=dev)
        extra = [scratch.data_ptr(), scratch.numel(), grid]
    _build.check(entry(BODY_ID[name], *ptrs, r, out.data_ptr(),
                       sink.data_ptr(), *extra, _build.stream(dev)),
                 f"{body.source} {name}")
    harness_launches[name] += 1
    return out, sink


def harness_plain(name: str, r: int, *inputs: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the iterations one after another on the inputs'
    device, int32 values in int64 wrapped to 32 bits (float inputs keep
    their values), each contribution converted from int32 to float32
    (rounded to nearest) and added into ``acc`` in iteration order."""
    body = BODIES[name]
    ins = [t if t.is_floating_point() else t.to(torch.int64)
           for t in inputs]
    dev = inputs[0].device
    wraps = body.sink == torch.int32
    acc = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    sink = torch.zeros((), dtype=torch.int64 if wraps else torch.float64,
                       device=dev)
    for i in range(r):
        part, whole = body.step(i, *ins)
        if part.dtype != torch.float32:
            part = wrap32(part).to(torch.float32)
        acc = acc + part.expand(8, 128)
        sink = (sink + whole) & M32 if wraps else sink + whole
    return acc, wrap32(sink) if wraps else sink


def harness_reference(name: str, r: int, *inputs: torch.Tensor):
    """The float64 reference of a float tensor-core reading
    (``tool_operands``) and its bound: ``(out, e_out, sink, e_sink)``.
    ``out`` is the exact running sum of the products' rows ``[:8]``
    (float64), ``sink`` the sum of every element of every product; a
    result within ``e_out`` of ``out`` in every cell and within ``e_sink``
    of ``sink`` is right:

        E = sum_i (n 2^-24 sum_k |a_ik b_kj| + 2^-24 |acc_i|),

    n the product's depth (512, or 128 for the lane cumsum) and ``acc_i``
    the exact running sum after iteration i (no acc term for the sink).
    Any order of summation in float32 of each product, rounded to float32
    and added into a float32 ``acc`` in iteration order, stays within E."""
    check_harness_args(name, r, inputs)
    if BODIES[name].sink != torch.float64:
        raise ValueError(f"{name} is held bit for bit, not within a bound")
    dev = inputs[0].device
    out = torch.zeros((8, 128), dtype=torch.float64, device=dev)
    e_out = torch.zeros_like(out)
    sink = e_sink = torch.zeros((), dtype=torch.float64, device=dev)
    u = 2.0 ** -24
    for i in range(r):
        a, b = (_f64(t) for t in tool_operands(name, i, *inputs))
        p, q = a @ b, a.abs() @ b.abs()
        out = out + p[:8]
        e_out = e_out + a.shape[1] * u * q[:8] + u * out.abs()
        sink = sink + p.sum()
        e_sink = e_sink + a.shape[1] * u * q.sum()
    return out, e_out, float(sink), float(e_sink)


# ---- T15: the dependent scalar walk ----

def check_walk_args(tbl: torch.Tensor, r: int) -> torch.device:
    check_int32(tbl, "tbl", (TBL,))
    if not 0 <= r < 1 << 31:
        raise ValueError(f"r must be in [0, 2^31), got {r}")
    return check_device(tbl)


def walk(tbl: torch.Tensor, r: int) -> torch.Tensor:
    """``r`` steps of the walk over ``tbl (512,)`` int32; returns ``(8,
    128)`` float32 of the final ``x``."""
    global launches
    dev = check_walk_args(tbl, r)
    if dev.type == "cpu":
        return walk_plain(tbl, r)
    lib = load_kernel()
    tbl = tbl.contiguous()
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    _build.check(lib.lz4t_probe_walk(tbl.data_ptr(), out.data_ptr(), r,
                                     _build.stream(dev)), "probe_walk")
    launches += 1
    return out


def walk_plain(tbl: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version: the steps one after another on the input's device,
    ``x`` kept modulo 2^32."""
    t = tbl.to(torch.int64)
    x = torch.ones((), dtype=torch.int64, device=tbl.device)
    for _ in range(r):
        x = (t[x & (TBL - 1)] + x + 1) & M32
    return wrap32(x).to(torch.float32).expand(8, 128).clone()


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--div", type=int, default=1,
                   help="divide the harness's repeat counts by D (the "
                        "card's at 1; the plain versions on the CPU want "
                        "1000 or more)")
    p.add_argument("--steps", nargs=2, type=int, default=STEPS,
                   metavar=("LO", "HI"),
                   help="the walk's two step counts to difference (the "
                        "tool's 65536 and 2^25)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    lo, hi = a.steps
    if not 0 <= lo < hi < 1 << 31:
        p.error(f"--steps needs 0 <= LO < HI < 2^31, got {lo} {hi}")
    if a.div < 1:
        p.error(f"--div must be at least 1, got {a.div}")
    print(f"devices: {device_name(dev)}", flush=True)
    for name in ORDER:
        body = BODIES[name]
        ins = body_inputs(name, dev)
        n_lo = max(1, body.card[0] // a.div)
        n_hi = max(n_lo + 1, body.card[1] // a.div)
        # a call of the higher count runs for 50-200 ms: one a timing
        best = per_iter(lambda n: harness(name, n, *ins), n_lo, n_hi, dev,
                        calls=1)
        print(f"{body.reading}: {best * 1e6:.3f} us/iter "
              f"({best * 1e9 / body.items:.3f} ns/item)", flush=True)
    tbl = torch.from_numpy(walk_table()).to(dev)
    best = per_iter(lambda n: walk(tbl, n), lo, hi, dev, calls=1)
    print(f"smem_scalar_walk (dependent): {best * 1e6:.3f} us/iter "
          f"({best * 1e9:.3f} ns/item)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

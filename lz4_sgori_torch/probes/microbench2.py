"""T14a and T15, the primitive rates of the vectorized design.

T14a, ``harness(name, r, *inputs) -> (out, sink)``: the tool's harness
(``tools/microbench2.py:_harness``) around one of its bodies. From ``acc =
zeros((8, 128), float32)``, each ``i`` of ``0 .. r - 1`` computes the
body's whole result from the read-only inputs and adds its rows ``[:8]``
(or a row or column of it, broadcast) into ``acc`` as float32, one add an
iteration in iteration order; nothing else carries over. int32 arithmetic
wraps and ``>>`` is arithmetic; ``lcg(x) = x * 1664525 + 1013904223``.
``out`` is ``acc``; ``sink`` (int32) is the wrapping sum, over all
iterations, of every element of the whole result (an int32 by value, a
float32 by its bit pattern; the one-hot of ``ohbuild`` as the flat index
``512 * row + col`` of each of its ones), so that a kernel must compute
all of it. The bodies (``BODIES``, the tool's lines):

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

The tool's five tensor-core readings (``body_mxu`` in bf16 and f32,
``body_gather``, ``body_cumsum_mxu`` and ``body_cumsum_mxu_lane``) are not
ported yet. ``harness`` launches ``csrc/probe_harness.cu`` (one block of
1024 threads, ``acc`` in registers, the loop over ``r`` in the kernel) on
CUDA tensors and runs the body's plain version on CPU tensors; without
inputs it takes the tool's (``tool_inputs``) on ``device``.

T15, ``walk(tbl, r)``: the dependent scalar walk, from ``x = 1``, ``r``
steps of ``x = tbl[x & 511] + x + 1`` over a 512-word int32 table in
wrapping int32 arithmetic; the result is ``(8, 128)`` float32 holding
``float32(x)`` in every cell. It launches ``csrc/probe_walk.cu`` (the port
of ``walk_kernel``: one thread walks, the table staged in shared memory as
the TPU holds it in SMEM) on a CUDA tensor and runs ``walk_plain`` on a
CPU tensor.

``main()`` prints the tool's readings in its order, each as ``us/iter``
and ``ns/item`` by differencing two repeat counts (``Body.card``, chosen
so that a call of the higher takes 50-200 ms on an H100; the tool's are
``Body.tool``), then the walk's.

    python -m lz4_sgori_torch.probes.microbench2 [--div D] \
        [--steps LO HI] [--device cpu]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

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
launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_walk.cu (T15)."""
    return _build.load("probe_walk", {"lz4t_probe_walk": "ppip"})


def load_harness_kernel():
    """Build (once) and load csrc/probe_harness.cu (T14a)."""
    return _build.load("probe_harness", {"lz4t_probe_harness": "ippippp"})


# ---- the tool's inputs ----

def tool_inputs() -> dict[str, np.ndarray]:
    """The inputs of the tool's ``main()``: ``default_rng(0)``'s draws
    replayed in its order, each consuming the stream, the tensor-core
    readings' (``mA``, ``mB``, ``data_bf``) included. Integer arrays are
    int32, ``g2048`` float64 rounded to float32."""
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
          "x128": (torch.int32, (128, 512))}


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


def _ohbuild(i, ids):
    idv = (_lcg(ids + i) >> 7) & 511
    cols = torch.arange(512, device=ids.device)
    oh = cols[None, :] == idv
    flat = torch.arange(2048 * 512, device=ids.device).reshape(2048, 512)
    return oh[:8, :128].to(torch.int64), torch.where(oh, flat, 0).sum()


def _extract(i, g, ids):
    v = g.gather(1, _lcg(ids + i) & 127)
    return v[:8], v.view(torch.int32).to(torch.int64).sum()


def _red1(i, a):
    v = signed32(signed32(a + i).sum(1, keepdim=True))
    return v[:8], v.sum()


def _red0(i, a):
    v = signed32(signed32(a + i).sum(0, keepdim=True))
    return v, v.sum()


def _bitroll(i, a, amt):
    lanes = torch.arange(128, device=a.device)
    x = a.gather(1, (lanes[None, :] + (_lcg(amt + i) & 127)) & 127)
    return x[:8], x.sum()


def _chained_roll(dim: int):
    def step(i, a):
        x = signed32(a + i)
        for _ in range(8):
            x = signed32(x + x.roll(1, dim))
        return x[:8], x.sum()
    return step


def _vlookup(i, tbl, idx1):
    v = tbl.gather(0, _lcg(idx1 + i) & 127)
    return v[:, :128], v.sum()


def _fori(i, small):
    return small, small.sum()


def _dynrow(i, a):
    row = (i * 37) & 255
    v = a[row:row + 8]
    return v, v.sum()


def _statrow(i, a):
    v = signed32(a[8:16] + i)
    return v, v.sum()


def _cumsum_shift(i, a):
    x = signed32(signed32(a + i).cumsum(0))
    return x[:8], x.sum()


def _transpose(i, x128):
    t = signed32(x128 + i).T
    return t[:8], t.sum()


def _shiftsel(i, a, amt):
    rows = torch.arange(512, device=a.device)[:, None]
    sel = a[((rows + (_lcg(amt + i) & 31)) & 511)[:, 0]]
    return sel[:8], sel.sum()


@dataclass(frozen=True)
class Body:
    reading: str             # the tool's reading name
    line: int                # the body's line in tools/microbench2.py
    inputs: tuple[str, ...]
    tool: tuple[int, int]    # the tool's two repeat counts
    card: tuple[int, int]    # the port's on the card
    items: int               # the tool's divisor of ns/item
    ops: int                 # the fewest lane operations an iteration (below)
    nbytes: int              # input bytes an iteration reads
    step: Callable


# ops: the fewest instructions a lane executes to compute an iteration's
# whole result and acc's update, for a bound on the time: each operation
# of an element fused as the ISA allows (lcg(x + i) and a mask, one IMAD
# with i * 1664525 + 1013904223 formed once and one LOP3; a shift and an
# add one LEA.HI; three addends one IADD3, so that a reduction or a scan
# of a512 + i takes N / 2 or N); two elements of the one-hot (bfloat16 in
# the tool) one compare-select into a 32-bit word; loads and the index
# arithmetic of data movement not counted, nor the sink's adds (the
# kernel's own check); then one int-to-float conversion for each int32
# value that enters acc (fori's, loop-invariant, none) and acc's 1024
# float adds. nbytes: the input words the function reads, 4 bytes each.
BODIES = {b_name: Body(*fields) for b_name, fields in {
    "vpu": ("vpu_16ops_512x128", 105, ("a512",), (16384, 2097152),
            (1024, 8192), 512 * 128 * 16, 25 * N + 2 * ACC, 4 * N, _vpu),
    "ohbuild": ("onehot_build_2048x512", 144, ("ids",), (4096, 262144),
                (384, 3072), 2048, 2 * 2048 + 2048 * 256 + ACC, 4 * 2048,
                _ohbuild),
    "extract": ("lane_extract_2048x128", 155, ("g2048", "ids"),
                (4096, 262144), (8192, 65536), 2048, 2 * 2048 + ACC,
                8 * 2048, _extract),
    "red1": ("reduce_lanes_512x128", 168, ("a512",), (16384, 1048576),
             (4096, 32768), 1, N // 2 + 8 + ACC, 4 * N, _red1),
    "red0": ("reduce_sublanes_512x128", 175, ("a512",), (16384, 1048576),
             (8192, 65536), 1, N // 2 + 128 + ACC, 4 * N, _red0),
    "bitroll": ("bitroll7_lanes_512x128", 183, ("a512", "amt"),
                (8192, 262144), (4096, 32768), 512, 2 * 512 + 2 * ACC,
                4 * N + 4 * 512, _bitroll),
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
               _dynrow),
    "statrow": ("static_sublane_read8_512x128", 275, ("a512",),
                (16384, 1048576), (1 << 19, 1 << 22), 1, 3 * ACC, 4 * ACC,
                _statrow),
    "cumsum_shift": ("cumsum_logshift_rows_512x128", 284, ("a512",),
                     (2048, 65536), (2048, 16384), 512 * 128, N + 2 * ACC,
                     8 * N, _cumsum_shift),
    "transpose": ("transpose_128x512", 318, ("x128",), (2048, 65536),
                  (4096, 32768), 1, N + 2 * ACC, 4 * N, _transpose),
    "shiftsel": ("shiftsel32_rows_512x128", 327, ("a512", "amt"),
                 (2048, 65536), (2048, 16384), 512 * 128, 2 * 512 + 2 * ACC,
                 4 * N + 4 * 512, _shiftsel),
}.items()}
# the body's number in csrc/probe_harness.cu: its place in BODIES
BODY_ID = {b_name: k for k, b_name in enumerate(BODIES)}
# the tool's readings in its order; the tensor-core ones are not ported
ORDER = ("vpu", "mxu_512x512x128_bf16", "mxu_512x512x128_f32",
         "onehot_rowgather_2048q_512rows", "ohbuild", "extract", "red1",
         "red0", "bitroll", "sroll", "lroll", "vlookup", "fori", "dynrow",
         "statrow", "cumsum_shift", "cumsum_mxu_tri_512x128",
         "cumsum_mxu_lane_512x128", "transpose", "shiftsel")
harness_launches = dict.fromkeys(BODIES, 0)


def body_inputs(name: str, device) -> list[torch.Tensor]:
    """The tool's inputs of body ``name`` on ``device``."""
    ins = tool_inputs()
    return [torch.from_numpy(ins[k]).to(device) for k in BODIES[name].inputs]


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
    if not 0 <= r < 1 << 31:
        raise ValueError(f"r must be in [0, 2^31), got {r}")
    return check_device(*inputs)


def harness(name: str, r: int, *inputs: torch.Tensor, device="cuda"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``r`` iterations of body ``name`` on ``inputs`` (the tool's on
    ``device`` when none are given): ``out`` (8, 128) float32 and ``sink``,
    a 0-d int32."""
    if not inputs:
        inputs = body_inputs(name, resolve_device(device))
    dev = check_harness_args(name, r, inputs)
    if dev.type == "cpu":
        return harness_plain(name, r, *inputs)
    lib = load_harness_kernel()
    ins = [t.contiguous() for t in inputs]
    ptrs = [t.data_ptr() for t in ins] + [None] * (2 - len(ins))
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    sink = torch.empty((), dtype=torch.int32, device=dev)
    _build.check(lib.lz4t_probe_harness(
        BODY_ID[name], *ptrs, r, out.data_ptr(), sink.data_ptr(),
        _build.stream(dev)), f"probe_harness {name}")
    harness_launches[name] += 1
    return out, sink


def harness_plain(name: str, r: int, *inputs: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the iterations one after another on the inputs'
    device, int32 values in int64 wrapped to 32 bits, each contribution
    converted from int32 to float32 (rounded to nearest) and added into
    ``acc`` in iteration order."""
    body = BODIES[name]
    ins = [t if t.dtype == torch.float32 else t.to(torch.int64)
           for t in inputs]
    dev = inputs[0].device
    acc = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    sink = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(r):
        part, whole = body.step(i, *ins)
        if part.dtype != torch.float32:
            part = wrap32(part).to(torch.float32)
        acc = acc + part.expand(8, 128)
        sink = (sink + whole) & M32
    return acc, wrap32(sink)


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
        if name not in BODIES:
            print(f"{name}: not ported yet (a tensor-core reading)",
                  flush=True)
            continue
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

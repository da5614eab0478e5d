"""T15, the dependent scalar walk: from ``x = 1``, ``r`` steps of ``x =
tbl[x & 511] + x + 1`` over a 512-word int32 table, in wrapping int32
arithmetic; the result is ``(8, 128)`` float32 holding ``float32(x)`` in
every cell.

``walk`` launches ``csrc/probe_walk.cu`` (the port of
``tools/microbench2.py:walk_kernel``, the ``pallas_call`` of ``run_walk``:
one thread walks, the table staged in shared memory as the TPU holds it
in SMEM) on a CUDA tensor and runs ``walk_plain`` on a CPU tensor. The
tool's other probes, the bodies of its harness (VPU and MXU rates, one-hot
gathers, lane extracts, rolls, lookups, cumsum and transpose forms), are
not ported yet.

    python -m lz4_sgori_torch.probes.microbench2 [--steps LO HI] \
        [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import M32, check_device, check_int32, device_name, parser, \
    per_iter, wrap32

TBL = 512
STEPS = (65536, 1 << 25)    # the tool's two step counts
launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_walk.cu."""
    return _build.load("probe_walk", {"lz4t_probe_walk": "ppip"})


def walk_table() -> np.ndarray:
    """The tool's table (``tblv``, :253): ``default_rng(0)``'s draws of its
    ``main()`` replayed in order, each consuming the stream, then the
    table's own."""
    rng = np.random.default_rng(0)
    rng.integers(0, 1 << 20, (512, 128))          # a512, :102
    rng.normal(size=(512, 512))                   # mA, :121
    rng.normal(size=(512, 128))                   # mB, :122
    rng.integers(0, 1 << 20, (2048, 1))           # ids, :138
    rng.normal(size=(512, 128))                   # data_bf, :139
    rng.normal(size=(2048, 128))                  # g2048, :163
    rng.integers(0, 128, (512, 1))                # amt, :192
    rng.integers(0, 1 << 20, (128, 512))          # tbl, :224
    rng.integers(0, 128, (1, 512))                # idx1, :225
    return rng.integers(0, TBL, (TBL,)).astype(np.int32)


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
    p.add_argument("--steps", nargs=2, type=int, default=STEPS,
                   metavar=("LO", "HI"),
                   help="the two step counts to difference (the tool's "
                        "65536 and 2^25)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    lo, hi = a.steps
    if not 0 <= lo < hi < 1 << 31:
        p.error(f"--steps needs 0 <= LO < HI < 2^31, got {lo} {hi}")
    print(f"devices: {device_name(dev)}", flush=True)
    tbl = torch.from_numpy(walk_table()).to(dev)
    # a call of 2^25 steps runs far longer than a launch: one call a timing
    best = per_iter(lambda n: walk(tbl, n), lo, hi, dev, calls=1)
    print(f"smem_scalar_walk (dependent): {best * 1e6:.3f} us/iter "
          f"({best * 1e9:.3f} ns/item)", flush=True)
    print("the tool's harness bodies (VPU and MXU rates, one-hot gathers, "
          "lane extracts, rolls, lookups, cumsum and transpose forms): not "
          "ported yet", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

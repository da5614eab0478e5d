"""T5, the per-lane async copy probe (the enc4 window-refill design):
``reps`` rounds in which each of ``nl`` lanes copies ``w`` words of its
row of a ``(128, T)`` int32 tape, from word ``idx[lane] + 128 * r``, into
its row of a staging block, and every copy is waited. The result,
``(1, 1)`` int32, is the wrapping sum over the rounds of ``stage[0, 0]``.

``run`` launches ``csrc/probe_dma.cu`` (the port of
``tools/dma_probe.py:_kernel``: one bulk copy a lane a round, each on its
own barrier) on CUDA tensors and runs ``run_plain`` on CPU tensors. Both
refuse reads past the tape, where the tool's defaults (idx up to
63 * 128, w = 512, 64 rounds) would read past a 16,384-word row, and, for
the bulk copies' 16-byte granule, a ``w``, a tape row or an ``idx`` that
is not a multiple of 4 words.

``library_call`` gives the one PyTorch call that computes a round's
copies: round 0's ``(nl, w)`` words, one ``torch.gather`` on the tape
with the index precomputed (the rounds do not depend on one another).
``chip_smoke.py`` times the kernel's round against it; the port never
calls it.

    python -m lz4_sgori_torch.probes.dma_probe [nlanes] [rows_per_dma] \
        [--reps LO HI] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import check_device, check_int32, device_name, parser, per_iter, \
    wrap32

LANES = 128
TAPE = 16384
STAGE = 1024          # words of a lane's staging row
ROUND = 128           # words each round moves a lane's window on
ALIGN = 4             # words of the bulk copy's 16-byte granule
launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_dma.cu."""
    return _build.load("probe_dma", {"lz4t_probe_dma": "pppiiiip"})


def check_run_args(idx: torch.Tensor, hbm: torch.Tensor, w: int, nl: int,
                   reps: int) -> None:
    check_int32(idx, "idx", (1, LANES))
    check_int32(hbm, "hbm", (LANES, None))
    check_device(idx, hbm)
    if not 1 <= nl <= LANES:
        raise ValueError(f"nl must be in [1, {LANES}], got {nl}")
    if not 1 <= w <= STAGE:
        raise ValueError(f"w must be in [1, {STAGE}] (the staging row), "
                         f"got {w}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    tape = hbm.shape[1]
    if w % ALIGN or tape % ALIGN:
        raise ValueError(f"w and the tape's row length must be multiples of "
                         f"{ALIGN} words, got {w} and {tape}")
    used = idx[0, :nl].tolist()               # one read from the device
    if min(used) < 0 or any(i % ALIGN for i in used):
        raise ValueError(f"idx must be >= 0 and a multiple of {ALIGN}")
    top = max(used) + (reps - 1) * ROUND + w
    if reps and top > tape:
        raise ValueError(f"round {reps - 1} reads words up to {top} of a "
                         f"{tape}-word row: max(idx) + (reps - 1) * {ROUND} "
                         f"+ w must be at most {tape}")


def run(idx: torch.Tensor, hbm: torch.Tensor, w: int, nl: int,
        reps: int) -> torch.Tensor:
    """``reps`` rounds of ``nl`` per-lane copies of ``w`` words; returns
    the ``(1, 1)`` int32 sum of ``stage[0, 0]`` over the rounds."""
    check_run_args(idx, hbm, w, nl, reps)
    if idx.device.type == "cpu":
        return run_plain(idx, hbm, w, nl, reps)
    return launch(idx, hbm, w, nl, reps)


def launch(idx: torch.Tensor, hbm: torch.Tensor, w: int, nl: int,
           reps: int) -> torch.Tensor:
    """The kernel of ``run`` on CUDA tensors that ``check_run_args`` has
    passed: the range check reads ``idx`` from the card, so a timing loop
    checks once and launches here."""
    global launches
    lib = load_kernel()
    idx = idx.contiguous()
    hbm = hbm.contiguous()
    if hbm.data_ptr() % 16:
        hbm = hbm.clone()
    out = torch.empty((1, 1), dtype=torch.int32, device=idx.device)
    _build.check(lib.lz4t_probe_dma(
        hbm.data_ptr(), idx.data_ptr(), out.data_ptr(), hbm.shape[1], w, nl,
        reps, _build.stream(idx.device)), "probe_dma")
    launches += 1
    return out


def run_plain(idx: torch.Tensor, hbm: torch.Tensor, w: int, nl: int,
              reps: int) -> torch.Tensor:
    """Plain version: each round gathers every lane's ``w`` words into the
    staging block and adds ``stage[0, 0]`` (on the input's device)."""
    stage = torch.zeros((LANES, STAGE), dtype=torch.int32, device=idx.device)
    cols = torch.arange(w, device=idx.device)[None, :]
    start = idx[0, :nl, None].to(torch.int64)
    acc = torch.zeros((), dtype=torch.int64, device=idx.device)
    for r in range(reps):
        stage[:nl, :w] = torch.gather(hbm[:nl], 1, start + r * ROUND + cols)
        acc = acc + stage[0, 0]
    return wrap32(acc).reshape(1, 1)


def library_call(idx: torch.Tensor, hbm: torch.Tensor, w: int, nl: int):
    """The yardstick of a round: one ``torch.gather`` that copies round
    0's ``w`` words of each of the first ``nl`` lanes' rows from word
    ``idx[lane]`` of the tape, its ``(nl, w)`` index precomputed; ``(fn,
    label)``. ``fn()`` is round 0's staging block ``stage[:nl, :w]``.
    Only timings call it."""
    check_run_args(idx, hbm, w, nl, 1)
    index = idx[0, :nl, None].to(torch.int64) + torch.arange(
        w, device=idx.device)[None, :]
    rows = hbm[:nl]
    return (lambda: torch.gather(rows, 1, index)), \
        f"torch.gather(hbm[:{nl}], 1, idx) of {nl} x {w} words"


def inputs(seed: int = 5):
    """The tool's tape and indices (``dma_probe.py:88-92``): random words
    below 2^30, and idx = 128 * [0, 64), from one generator."""
    rng = np.random.default_rng(seed)
    hbm = rng.integers(0, 1 << 30, (LANES, TAPE), np.int64).astype(np.int32)
    idx = (rng.integers(0, 64, (1, LANES), np.int64) * ROUND).astype(
        np.int32)
    return idx, hbm


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("nl", nargs="?", type=int, default=128)
    p.add_argument("w", nargs="?", type=int, default=512)
    p.add_argument("--reps", nargs=2, type=int, default=(16, 48),
                   metavar=("LO", "HI"),
                   help="the two round counts to difference (the tool's 64 "
                        "reads past the tape at w = 512)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    idx_np, hbm_np = inputs()
    idx, hbm = torch.from_numpy(idx_np).to(dev), torch.from_numpy(hbm_np).to(dev)
    print(f"[dma] device {device_name(dev)}, {a.nl} lanes x {a.w} rows/DMA",
          flush=True)
    lo, hi = a.reps
    if not 0 <= lo < hi:
        p.error(f"--reps needs 0 <= LO < HI, got {lo} {hi}")
    want = int(wrap32(torch.tensor(sum(
        int(hbm_np[0, idx_np[0, 0] + r * ROUND]) for r in range(hi)))))
    got = int(run(idx, hbm, a.w, a.nl, hi)[0, 0])
    print(f"[dma] {hi} rounds: {got}, correct: {got == want}", flush=True)
    if got != want:
        return 1
    check_run_args(idx, hbm, a.w, a.nl, hi)    # and so lo's fewer rounds
    go = run if dev.type == "cpu" else launch
    per_round = per_iter(lambda n: go(idx, hbm, a.w, a.nl, n), lo, hi, dev)
    print(f"[dma] {per_round * 1e6:.3f} us per {a.nl}-copy round "
          f"({per_round / a.nl * 1e9:.1f} ns per issue+wait, "
          f"{a.nl * a.w * 4 / per_round / 1e9:.1f} GB/s effective)",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

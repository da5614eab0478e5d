"""T4, the bitonic column sort probe: each column of an ``(N, 128)``
int32 array sorted on its own (``np.sort(x, axis=0)``).

``device_sort`` launches ``csrc/probe_sort.cu`` (the port of
``tools/sort_probe.py:_sort_kernel``) on a CUDA tensor and runs
``device_sort_plain``, the tool's network of compare-exchange stages
with ``torch.roll`` and ``torch.where``, on a CPU tensor. The kernel
runs the network in the passes of ``plan`` (its launches, which
``passes`` reads from the kernel's own host code): tile passes on
4096-row tiles in shared memory, global passes of up to four stages in
registers, the first pass out of place. The enc3 pass-1 design question
it sizes: whether one sort by ``hash13 << 16 | pos16`` answers
"previous same-hash position" cheaper than a table walk.

    python -m lz4_sgori_torch.probes.sort_probe [logN] [reps] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import check_device, check_int32, device_name, parser, per_iter

LANES = 128
MAX_LOGN = 24
TILE_LOG = 12           # log2 of a tile's rows (csrc/probe_sort.cu kTileLog)
GLOBAL_STAGES = 4       # the most stages of a global pass
launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_sort.cu."""
    return _build.load("probe_sort", {"lz4t_probe_sort": "ppip",
                                      "lz4t_probe_sort_passes": "i"})


def bitonic_stages(n: int):
    """(j, k) stage list for a full ascending bitonic sort of n = 2^m."""
    logn = n.bit_length() - 1
    return [(j, k) for j in range(logn) for k in range(j, -1, -1)]


def plan(logn: int, tile_log: int = TILE_LOG) -> list[tuple]:
    """The kernel's passes for ``2^logn`` rows, in order: ``("tile", j0,
    j1)`` runs, for j = j0 .. j1, the stages (j, k) with k below the
    tile's ``t = min(logn, tile_log)``; ``("global", j, khi, klo)`` the
    stages (j, khi) .. (j, klo), all at k >= t. A tile pass over j = 0 ..
    t - 1 first, then for each j >= t its global passes, four stages at
    most each from the top, and a tile pass over j alone."""
    t = min(logn, tile_log)
    out: list[tuple] = [("tile", 0, t - 1)]
    for j in range(t, logn):
        for khi in range(j, t - 1, -GLOBAL_STAGES):
            out.append(("global", j, khi, max(t, khi - GLOBAL_STAGES + 1)))
        out.append(("tile", j, j))
    return out


def passes(n: int) -> int:
    """The launches of the kernel's sort of ``n`` rows, as its host code
    counts them (``lz4t_probe_sort_passes``); needs the built kernel."""
    got = load_kernel().lz4t_probe_sort_passes(n)
    if got < 0:
        raise ValueError(f"the kernel refuses N {n}")
    return got


def sort_stage(x: torch.Tensor, j: int, k: int, iota: torch.Tensor):
    """One compare-exchange stage: distance 2^k, the run's direction from
    bit j+1 of the row index (``tools/sort_probe.py:45``)."""
    n = x.shape[0]
    dist = 1 << k
    fwd = torch.roll(x, n - dist, 0)            # row i reads x[i + dist]
    mnf = torch.minimum(x, fwd)
    mxf = torch.maximum(x, fwd)
    asc = ((iota >> (j + 1)) & 1) == 0
    keepf = torch.where(asc, mnf, mxf)          # value for bit-0 rows
    sendf = torch.where(asc, mxf, mnf)          # value for bit-1 rows
    bit0 = (iota & dist) == 0
    return torch.where(bit0, keepf, torch.roll(sendf, dist, 0))


def check_sort_args(x: torch.Tensor) -> None:
    check_int32(x, "x", (None, LANES))
    n = x.shape[0]
    if n < 1 or n & (n - 1) or n > 1 << MAX_LOGN:
        raise ValueError(f"N must be a power of two in [1, 2^{MAX_LOGN}], "
                         f"got {n}")
    check_device(x)


def device_sort(x: torch.Tensor) -> torch.Tensor:
    """Each column of ``x`` (int32 ``(N, 128)``, N a power of two) sorted
    ascending, as a new tensor."""
    global launches
    check_sort_args(x)
    if x.device.type == "cpu":
        return device_sort_plain(x)
    lib = load_kernel()
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.check(lib.lz4t_probe_sort(x.data_ptr(), out.data_ptr(),
                                     x.shape[0], _build.stream(x.device)),
                 "probe_sort")
    launches += 1
    return out


def device_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the stages of ``bitonic_stages`` one after another
    (on the input's device)."""
    n = x.shape[0]
    iota = torch.arange(n, device=x.device)[:, None]
    for j, k in bitonic_stages(n):
        x = sort_stage(x, j, k, iota)
    return x


def keys(logn: int) -> np.ndarray:
    """The tool's keys (``sort_probe.py:88-91``): hash13 << 16 | pos16,
    seed 7."""
    n = 1 << logn
    rng = np.random.default_rng(7)
    return ((rng.integers(0, 8192, (n, LANES)) << 16)
            | rng.integers(0, 65536, (n, LANES))).astype(np.int32)


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("logn", nargs="?", type=int, default=16)
    p.add_argument("reps", nargs="?", type=int, default=8)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    x_np = keys(a.logn)
    n = x_np.shape[0]
    print(f"[sort] ({n},128) int32, device {device_name(dev)}", flush=True)
    x = torch.from_numpy(x_np).to(dev)
    ok = np.array_equal(device_sort(x).cpu().numpy(), np.sort(x_np, axis=0))
    print(f"[sort] correct: {ok}", flush=True)
    if not ok:
        return 1

    def run_n(c: int) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(c):
            y = device_sort(x)
            acc += y[0].sum() + y[-1].sum()
        return acc

    best = per_iter(run_n, 1, a.reps + 1, dev)
    stages = len(bitonic_stages(n))
    print(f"[sort] best {best * 1e3:.4f} ms for {n * LANES * 4 / 1e6:.0f} MB "
          f"({stages} stages, {best * 1e6 / max(stages, 1):.3f} us/stage, "
          f"{len(plan(a.logn))} passes)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

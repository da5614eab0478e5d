"""What sets the pace of T4's column sort (``csrc/probe_sort.cu``) on the
card: each of its kernels' device time in one sort of the tool's keys
(``torch.profiler`` over three sorts, by kernel: the tile passes and the
global passes of ``sort_probe.plan``), then variants of the source, each
built beside it and timed in turns with it (this, variant, variant,
this; ten sorts a timing, CUDA events), each variant's result held
against ``torch.sort``:

- ``held3``: 8 values a thread a tile round (up to three stages), not 16;
- ``t1024``: 1024 threads a tile, not 512;
- ``t256``: 256 threads a tile;
- ``io16``: 16 of a thread's 16-byte loads and stores in flight in a
  tile's load and store, not 4.

    python -m lz4_sgori_torch.probes.sort_pace [logN]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess

import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import device_name, parser, seconds
from . import sort_probe as P4

CALLS = 10           # sorts in a timing
PROFILED = 3         # sorts under the profiler
SOURCE = os.path.join(_build.CSRC, "probe_sort.cu")

# each variant: (pattern, replacement) pairs, every pattern found in the
# source (re.subn, every occurrence)
VARIANTS = {
    "held3": [(r"constexpr int kHeld = 4;", "constexpr int kHeld = 3;")],
    "t1024": [(r"constexpr int kTileThreads = 512;",
               "constexpr int kTileThreads = 1024;")],
    "t256": [(r"constexpr int kTileThreads = 512;",
              "constexpr int kTileThreads = 256;")],
    "io16": [(r"#pragma unroll 4\n(  for \(int e = threadIdx\.x; e < quads;)",
              r"#pragma unroll 16\n\1")],
}


def variant_source(source: str, name: str) -> str:
    """``source`` with variant ``name``'s replacements; raises where a
    pattern is not found (the source has moved on)."""
    for pattern, new in VARIANTS[name]:
        source, n = re.subn(pattern, new, source)
        if not n:
            raise ValueError(f"variant {name}: {pattern!r} is not in the "
                             "source")
    return source


def load_variant(name: str, source: str) -> ctypes.CDLL:
    """Build variant ``name`` of the source with the port's flags into
    the build directory and load it."""
    text = variant_source(source, name)
    digest = hashlib.sha1(text.encode()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"sort_pace_{name}.cu")
    so = os.path.join(_build.BUILD_DIR, f"libsort_pace_{name}_{digest}.so")
    if not os.path.exists(so):
        with open(cu, "w") as f:
            f.write(text)
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               so, cu], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n"
                               f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.lz4t_probe_sort.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.lz4t_probe_sort.restype = ctypes.c_int
    return lib


def kernel_times(x: torch.Tensor) -> dict[str, list[float]]:
    """Device ms of each launch of one sort of ``x``, by kernel name, in
    launch order, averaged over ``PROFILED`` sorts (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    P4.device_sort(x)
    torch.cuda.synchronize(x.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            P4.device_sort(x)
        torch.cuda.synchronize(x.device)
    runs: dict[str, list[float]] = {}
    for ev in prof.events():
        kernel = re.search(r"(\w+_kernel(?:<\d+>)?)", ev.name)
        if ev.device_time_total and kernel:
            runs.setdefault(kernel[1], []).append(ev.device_time_total / 1e3)
    out = {}
    for k, v in runs.items():
        n = len(v) // PROFILED
        out[k] = [sum(v[i::n]) / PROFILED for i in range(n)]
    return out


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("logn", nargs="?", type=int, default=16)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type != "cuda":
        p.error("the kernels' times need a CUDA card")
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() or "no power limit read"
    print(f"devices: {device_name(dev)} ({limit})", flush=True)
    x = torch.from_numpy(P4.keys(a.logn)).to(dev)
    want = torch.sort(x, dim=0).values
    print(f"T4 at logN {a.logn}: {len(P4.plan(a.logn))} passes "
          f"({P4.passes(x.shape[0])} by the kernel's count)", flush=True)
    for kernel, times in kernel_times(x).items():
        print(f"{kernel}: {len(times)} a sort, {sum(times):.4f} ms in all; "
              + " ".join(f"{t:.4f}" for t in times), flush=True)
    with open(SOURCE) as f:
        source = f.read()
    this = P4.load_kernel()
    differ = []
    for name in VARIANTS:
        other = load_variant(name, source)
        outs = [torch.empty_like(x), torch.empty_like(x)]

        def go(lib, out):
            return lambda: _build.check(lib.lz4t_probe_sort(
                x.data_ptr(), out.data_ptr(), x.shape[0], _build.stream(dev)),
                f"probe_sort {name}")
        go_t, go_v = go(this, outs[0]), go(other, outs[1])
        go_t(), go_v()      # warm-up
        t = [seconds(f, dev, CALLS) * 1e3 for f in (go_t, go_v, go_v, go_t)]
        same = torch.equal(outs[1], want)
        print(f"{name} at logN {a.logn} in turns (this, variant, variant, "
              f"this): this {t[0]:.4f} {t[3]:.4f} ms, variant {t[1]:.4f} "
              f"{t[2]:.4f} ms ({(t[1] + t[2]) / (t[0] + t[3]):.4f}x); the "
              f"variant equals torch.sort: {same}", flush=True)
        if not same:
            differ.append(name)
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())

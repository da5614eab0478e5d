"""The whole-card harness readings (``csrc/probe_harness_wg.cu``) on the
card, kernel by kernel: each reading's device time in each of its
kernels (the main kernel and, but for ``microbench2.RESIDENT``'s
readings, whose chains run in the main kernel, the one that adds rows
0-7 in iteration order), from ``torch.profiler`` over three calls at the card's
count (``Body.card``). With ``--against OTHER.cu``, another version of
the source (an earlier commit's, say) is built beside this one and
loaded in the same process; each reading the two share is timed in
turns (other, this, this, other; ten calls a timing, CUDA events) and
their ``out`` and ``sink`` bits compared (the exit code is 1 where any
differ), and each reading the other lacks is named on a line of its
own. The other source's body numbers are read from its switch.

    python -m lz4_sgori_torch.probes.wg_ab [--against OTHER.cu]
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
from . import microbench2 as P15

CALLS = 10           # calls in a timing
PROFILED = 3         # calls under the profiler


def body_ids(source: str) -> dict[str, int]:
    """A harness source's body numbers, by its switch's ``case k: return
    run_<name>(``."""
    return {name: int(k) for k, name in
            re.findall(r"case (\d+): return run_(\w+)\(", source)}


def lacking(name: str, path: str) -> str:
    """The line that names a reading the other source has no body for."""
    return f"{name}: not in {path}, so not timed against it"


def load_source(path: str) -> ctypes.CDLL:
    """Build another version of ``probe_harness_wg.cu`` with the port's
    flags into the build directory and load it."""
    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"libwg_other_{digest}.so")
    if not os.path.exists(so):
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               so, path], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "n": ctypes.c_size_t}
    lib.lz4t_probe_harness_wg.argtypes = [kinds[c] for c in "ippipppnip"]
    lib.lz4t_probe_harness_wg.restype = ctypes.c_int
    return lib


def launcher(entry, body: int, name: str, r: int, ins, dev):
    """``(go, out, sink)``: ``go()`` launches body ``body`` of ``entry`` as
    ``microbench2.harness`` does, into ``out`` and ``sink``."""
    spec = P15.BODIES[name]
    grid = P15.wg_grid(dev)
    ptrs = [t.data_ptr() for t in ins] + [None] * (2 - len(ins))
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    sink = torch.empty((), dtype=spec.sink, device=dev)
    scratch = torch.empty(P15.wg_scratch_bytes(name, r, grid),
                          dtype=torch.uint8, device=dev)

    def go():
        _build.check(entry(body, *ptrs, r, out.data_ptr(), sink.data_ptr(),
                           scratch.data_ptr(), scratch.numel(), grid,
                           _build.stream(dev)), f"probe_harness_wg {name}")
    return go, out, sink


def kernel_times(name: str, dev) -> dict[str, float]:
    """Device ms a call of each kernel of reading ``name`` at the card's
    count, from ``torch.profiler`` over ``PROFILED`` calls."""
    from torch.profiler import ProfilerActivity, profile
    ins = P15.body_inputs(name, dev)
    n = P15.BODIES[name].card[1]
    P15.harness(name, n, *ins)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            P15.harness(name, n, *ins)
        torch.cuda.synchronize(dev)
    times: dict[str, float] = {}
    for ev in prof.events():
        kernel = re.search(r"::(\w+)[<(]", ev.name)
        if ev.device_time_total and kernel:
            key = kernel[1]
            times[key] = times.get(key, 0.0) + ev.device_time_total / 1e3
    return {k: v / PROFILED for k, v in times.items()}


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--against", metavar="OTHER.cu",
                   help="another version of probe_harness_wg.cu to time "
                        "this one against, in one process")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type != "cuda":
        p.error("the kernels' times need a CUDA card")
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() or "no power limit read"
    print(f"devices: {device_name(dev)} ({limit})", flush=True)
    names = [n for n, b in P15.BODIES.items() if b.source == P15.WG]
    for name in names:
        split = kernel_times(name, dev)
        print(f"{name} at R {P15.BODIES[name].card[1]}: " + (", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items())
            or "no device time recorded"), flush=True)
    if not a.against:
        return 0
    with open(a.against) as f:
        other = body_ids(f.read())
    entry = load_source(a.against).lz4t_probe_harness_wg
    this = getattr(P15.load_harness_kernel(P15.WG), "lz4t_probe_harness_wg")
    differ = []
    for name in names:
        if name not in other:
            print(lacking(name, a.against), flush=True)
            continue
        ins = P15.body_inputs(name, dev)
        r = P15.BODIES[name].card[1]
        go_o, out_o, sink_o = launcher(entry, other[name], name, r, ins, dev)
        go_t, out_t, sink_t = launcher(this, P15.BODY_ID[name], name, r,
                                       ins, dev)
        go_o(), go_t()      # warm-up
        t = [seconds(go, dev, CALLS) * 1e3 for go in (go_o, go_t, go_t,
                                                      go_o)]
        same = torch.equal(out_o.view(torch.int32), out_t.view(torch.int32)) \
            and torch.equal(sink_o.reshape(1).view(torch.uint8),
                            sink_t.reshape(1).view(torch.uint8))
        print(f"{name} at R {r} in turns (other, this, this, other): other "
              f"{t[0]:.4f} {t[3]:.4f} ms, this {t[1]:.4f} {t[2]:.4f} ms "
              f"({(t[1] + t[2]) / (t[0] + t[3]):.4f}x); the same out and "
              f"sink bits: {same}", flush=True)
        if not same:
            differ.append(name)
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())

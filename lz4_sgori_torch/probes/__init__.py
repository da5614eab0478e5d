"""The design probes of ``tools/`` on the card: each computes a defined
int32 array from seeded inputs and a repeat count, and its ``main()``
reports ns per iteration by differencing two repeat counts, as the tool
does for the TPU.

- ``sort_probe`` (T4): bitonic sort of each column of ``(N, 128)`` int32;
- ``dma_probe`` (T5): rounds of per-lane async row copies;
- ``microbench6`` (T6): pass-1 GET / PUT rounds over a carry table;
- ``microbench4`` (T7, T8): K-batched table gets and puts, and the 26-word
  little-endian byte extract;
- ``microbench3`` (T9-T13): the per-lane word gather and scatter, the FIFO
  bitroll, the 30-op state step and the scratch capacity probe;
- ``microbench2`` (T14, T15): the primitive-rate harness's 20 readings
  and the dependent scalar walk over a 512-word table;
- ``wg_ab``: T14's whole-card readings kernel by kernel (device time a
  kernel), and an A/B against another version of their source.

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its CUDA kernel (``csrc/probe_*.cu``) on a CUDA tensor, or raises. All
int32 arithmetic wraps at 32 bits in both. Run a probe with
``python -m lz4_sgori_torch.probes.<module> [args] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import time

import torch

M32 = 0xFFFFFFFF
TRIES = 5             # timings of each repeat count; the best is kept
CALLS = 10            # calls in a row in each timing


def signed32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped modulo 2^32 into int32's range, still
    int64 (the value an int32 operation would leave)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor as int32, wrapping modulo 2^32."""
    return signed32(x).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2^32 for int64 ``x`` in [0, 2^32) and ``c`` in
    [0, 2^32), as a value in [0, 2^32), without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def check_device(*ts: torch.Tensor) -> torch.device:
    """The one device of ``ts``, which must be the CPU or a CUDA card."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("the inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_int32(t: torch.Tensor, name: str, shape) -> None:
    """``t`` is int32 with ``shape`` (None matches any length)."""
    if t.dtype != torch.int32 or t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise TypeError(f"{name} must be int32 {shape}, got {t.dtype} "
                        f"{tuple(t.shape)}")


def seconds(fn, device: torch.device, calls: int = CALLS) -> float:
    """Seconds per call of ``fn`` over ``calls`` calls in a row: CUDA
    events around them and one synchronise on a card, the host clock on
    the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls


def per_iter(run, lo: int, hi: int, device: torch.device,
             calls: int = CALLS) -> float:
    """Seconds per iteration: (best time of ``run(hi)`` - best time of
    ``run(lo)``) / (hi - lo), each the best of ``TRIES`` timings of
    ``calls`` calls, after a warm-up of each. ``run`` should not wait for
    the device, so that the calls queue up back to back and their launch
    costs cancel in the difference. (The best of each count, not the best
    difference, which would favour noise.) A call that runs for much
    longer than a launch needs no company: ``calls=1``."""
    run(lo)
    run(hi)
    t_lo = t_hi = float("inf")
    for _ in range(TRIES):
        t_lo = min(t_lo, seconds(lambda: run(lo), device, calls))
        t_hi = min(t_hi, seconds(lambda: run(hi), device, calls))
    return (t_hi - t_lo) / (hi - lo)


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel, the default) or cpu (the plain "
                        "version)")
    return p


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (the plain version)")

"""T6, the encoder-v2 pass-1 probe: ``n`` rounds of one body over a carry
table ``(R, 128)`` int32 (R a power of two), returning its rows
``[:8]``. With ``c0`` the carry's row 0 at the start of round ``i`` and
``h_k = (c0 * (k + 3) + i) & (R - 1)``:

- ``getk``: row 0 becomes the XOR of the K gets ``table[h_k]``;
- ``putk``: ``table[h_k] = c0 + k`` for k = 0..K-1 in order (the later
  put wins); every hash and value comes from the round's ``c0``;
- ``extract1``: row 0 becomes ``table[(c0 + i) & (R - 1)]``.

Lane L reads and writes only column L. ``rounds`` launches
``csrc/probe_table.cu`` (entry ``lz4t_probe_rounds``, the port of
``tools/microbench6.py:timed_kernel`` with the bodies of its ``main()``)
on a CUDA tensor and runs ``rounds_plain`` on a CPU tensor. The TPU
answers a get with a band select-scan over the table; the card with one
indexed load: the same function, not the same mechanism. No single
PyTorch call computes a round of ``getk`` (its K gets are XORed, and
torch has no XOR reduction), and each round's hashes come from the carry
the round before: ``chip_smoke.py`` prices no library call against T6.

    python -m lz4_sgori_torch.probes.microbench6 [K] [R] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import check_device, check_int32, device_name, parser, per_iter, \
    wrap32

L = 128
BODIES = ("getk", "putk", "extract1")
ITERS = (256, 4096)       # the tool's two round counts (run_case, :43)
launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_table.cu (T6's and T7's entries)."""
    return _build.load("probe_table", {"lz4t_probe_rounds": "ppiiiip",
                                       "lz4t_probe_kget": "pppiiip"})


def check_rounds_args(body: str, x: torch.Tensor, n: int, K: int) -> None:
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    check_int32(x, "x", (None, L))
    R = x.shape[0]
    if R < 8 or R & (R - 1):
        raise ValueError(f"R must be a power of two of at least 8, got {R}")
    if n < 0 or K < 0:
        raise ValueError(f"n and K must be >= 0, got {n} and {K}")
    check_device(x)


def rounds(body: str, x: torch.Tensor, n: int, K: int = 8) -> torch.Tensor:
    """``n`` rounds of ``body`` over a copy of ``x``; returns rows
    ``[:8]``, ``(8, 128)`` int32."""
    global launches
    check_rounds_args(body, x, n, K)
    if x.device.type == "cpu":
        return rounds_plain(body, x, n, K)
    lib = load_kernel()
    tbl = x.contiguous().clone()
    out = torch.empty((8, L), dtype=torch.int32, device=x.device)
    _build.check(lib.lz4t_probe_rounds(
        tbl.data_ptr(), out.data_ptr(), BODIES.index(body), tbl.shape[0], n,
        K, _build.stream(x.device)), "probe_table")
    launches += 1
    return out


def rounds_plain(body: str, x: torch.Tensor, n: int, K: int = 8
                 ) -> torch.Tensor:
    """Plain version: the rounds one after another, every lane at once
    (on the input's device)."""
    tbl = x.clone()
    mask = tbl.shape[0] - 1
    lanes = torch.arange(L, device=x.device)
    for i in range(n):
        c0 = tbl[0].to(torch.int64)
        if body == "getk":
            out = torch.zeros(L, dtype=torch.int32, device=x.device)
            for k in range(K):
                out ^= tbl[(c0 * (k + 3) + i) & mask, lanes]
            tbl[0] = out
        elif body == "putk":
            for k in range(K):
                tbl[(c0 * (k + 3) + i) & mask, lanes] = wrap32(c0 + k)
        else:
            tbl[0] = tbl[(c0 + i) & mask, lanes]
    return tbl[:8].clone()


def carry(R: int) -> np.ndarray:
    """The tool's carry (``run_case``, :44): RandomState(0) words below
    2^20."""
    return np.random.RandomState(0).randint(0, 1 << 20, (R, L)).astype(
        np.int32)


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("K", nargs="?", type=int, default=8)
    p.add_argument("R", nargs="?", type=int, default=8192)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"K={a.K}, R={a.R}, device {device_name(dev)}", flush=True)
    x = torch.from_numpy(carry(a.R)).to(dev)
    for body in BODIES:
        best = per_iter(lambda n: rounds(body, x, n, a.K), *ITERS, dev)
        name = {"getk": f"getK{a.K}", "putk": f"putK{a.K}"}.get(body, body)
        print(f"  {name + '_' + str(a.R):14s} {best * 1e9:9.1f} ns/iter",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

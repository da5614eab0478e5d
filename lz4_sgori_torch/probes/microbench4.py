"""T7 and T8, the v5-design probes: K-batched table gets (and puts) and
the 26-word little-endian byte extract. All arithmetic wraps at 32 bits.

T7, ``kget``: the ``(8192, 128)`` int32 table starts with every row equal
to ``seed`` ``(1, 128)``; each of ``reps`` rounds reads K gets at
``h_k = (((acc * (2k + 1) + r * 977 + seed * k) * -1640531535) >> 19) &
8191``, then, with ``puts``, writes ``acc + k`` at ``h_k`` in order;
then ``acc = (acc + sum of the gets) & 0xFFFF``. Returns ``acc (1, 128)``.
It launches ``csrc/probe_table.cu`` (entry ``lz4t_probe_kget``, the port
of ``tools/microbench4.py:kget_kernel``) on a CUDA tensor.

T8, ``banded``: each of ``reps`` rounds takes ``pos = (pos0 + (acc &
63)) & mask`` (``mask`` defaults to the tool's ``4R - 256``), reads the
26 words ``extract_bytes(tape, pos, 26)`` and sets ``acc = (acc + their
sum) & 0xFFFF``. Returns ``acc (1, 128)``. It launches
``csrc/probe_banded.cu`` (the port of ``tools/microbench4.py:
banded_kernel``) on a CUDA tensor. ``extract_bytes`` is the function of
``lockstep_v4.py:extract_bytes_banded``, written per lane: lane L's
bytes are column L of the tape, row r holding bytes 4r..4r+3.

Each runs its plain version on a CPU tensor. The TPU scans bands of the
table or tape with selects; the card loads the indexed words. No single
PyTorch call computes a round of either (T7: K gets, a sum and a mask;
T8: a 26-word extract and a sum), and each round's positions come from
the ``acc`` of the round before: ``chip_smoke.py`` prices no library
call against them.

    python -m lz4_sgori_torch.probes.microbench4 [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import M32, check_device, check_int32, device_name, mul32, parser, \
    per_iter, wrap32
from .microbench6 import load_kernel as load_table_kernel

L = 128
TROWS = 8192
HASH_MUL = -1640531535 & M32
WORDS = 26
KGET_CASES = ((1, False), (4, False), (8, False), (16, False), (1, True),
              (8, True), (16, True))
# the rounds differenced: the tool's 16 vs 64 and 64 vs 256 differ on the
# card by less than its call-to-call spread, so the port differences 1024
# and 2048 rounds
KGET_REPS = (64, 1088)
BANDED_ROWS = 16384
BANDED_SPANS = (1, 4, 16, 64, 128)    # 64-row slabs
BANDED_REPS = (256, 2304)
kget_launches = 0
banded_launches = 0


def load_kernel():
    """Build (once) and load csrc/probe_banded.cu (T8; T7's kernel is
    ``load_table_kernel``)."""
    return _build.load("probe_banded", {"lz4t_probe_banded": "pppiiip"})


# ---- T7: K-batched gets and puts ----

def check_kget_args(seed: torch.Tensor, reps: int, K: int) -> None:
    check_int32(seed, "seed", (1, L))
    check_device(seed)
    if reps < 0 or K < 0:
        raise ValueError(f"reps and K must be >= 0, got {reps} and {K}")


def kget(seed: torch.Tensor, reps: int, K: int, puts: bool = False
         ) -> torch.Tensor:
    """``reps`` rounds of K gets (and K ordered puts) on a table seeded
    from ``seed``; returns ``acc (1, 128)`` int32."""
    global kget_launches
    check_kget_args(seed, reps, K)
    if seed.device.type == "cpu":
        return kget_plain(seed, reps, K, puts)
    lib = load_table_kernel()
    seed = seed.contiguous()
    tbl = torch.empty((TROWS, L), dtype=torch.int32, device=seed.device)
    out = torch.empty((1, L), dtype=torch.int32, device=seed.device)
    _build.check(lib.lz4t_probe_kget(
        tbl.data_ptr(), seed.data_ptr(), out.data_ptr(), reps, K, int(puts),
        _build.stream(seed.device)), "probe_table")
    kget_launches += 1
    return out


def kget_hashes(acc: torch.Tensor, r: int, s: torch.Tensor, K: int):
    """The K rows of round r: int64 ``acc`` in [0, 2^16), ``s`` the seed
    as 32-bit values in [0, 2^32)."""
    return [mul32((acc * (2 * k + 1) + r * 977 + s * k) & M32, HASH_MUL)
            >> 19 & (TROWS - 1) for k in range(K)]


def kget_plain(seed: torch.Tensor, reps: int, K: int, puts: bool = False
               ) -> torch.Tensor:
    """Plain version: the rounds one after another, every lane at once
    (on the input's device)."""
    tbl = seed.expand(TROWS, L).clone()
    s = seed[0].to(torch.int64) & M32
    lanes = torch.arange(L, device=seed.device)
    acc = torch.zeros(L, dtype=torch.int64, device=seed.device)
    for r in range(reps):
        hs = kget_hashes(acc, r, s, K)
        total = sum((tbl[h, lanes].to(torch.int64) for h in hs),
                    torch.zeros_like(acc))
        if puts:
            for k, h in enumerate(hs):
                tbl[h, lanes] = (acc + k).to(torch.int32)
        acc = (acc + total) & 0xFFFF
    return acc.to(torch.int32).reshape(1, L)


# ---- T8: the 26-word byte extract ----

def extract_bytes(tape: torch.Tensor, pos: torch.Tensor, w: int
                  ) -> torch.Tensor:
    """``(w, 128)`` int32: row i, lane L holds the little-endian word of
    lane L's bytes ``pos[L] + 4i .. + 3``; bytes outside ``[0, 4R)`` read
    0 (``lockstep_v4.py:extract_bytes_banded``). ``pos`` is int64
    ``(128,)``, any value."""
    R = tape.shape[0]
    lanes = torch.arange(L, device=tape.device)
    b = pos[None, :] + torch.arange(4 * w, device=tape.device)[:, None]
    words = tape[(b >> 2).clamp(0, R - 1), lanes].to(torch.int64) & M32
    byte = (words >> ((b & 3) * 8)) & 0xFF
    byte = torch.where((b >= 0) & (b < 4 * R), byte, 0).reshape(w, 4, L)
    shifts = (torch.arange(4, device=tape.device) * 8)[None, :, None]
    return wrap32((byte << shifts).sum(1))


def check_banded_args(tape: torch.Tensor, pos0: torch.Tensor,
                      reps: int) -> None:
    check_int32(tape, "tape", (None, L))
    check_int32(pos0, "pos0", (1, L))
    check_device(tape, pos0)
    if tape.shape[0] < 1 or reps < 0:
        raise ValueError(f"the tape needs a row and reps must be >= 0, got "
                         f"{tape.shape[0]} rows and {reps}")


def int32(v: int) -> int:
    """A Python int as the int32 with the same low 32 bits."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def default_mask(rows: int) -> int:
    """The tool's mask, ``R * 4 - 256``: 256-byte aligned positions."""
    return int32(rows * 4 - 256)


def banded(tape: torch.Tensor, pos0: torch.Tensor, reps: int,
           mask: int | None = None) -> torch.Tensor:
    """``reps`` rounds of the 26-word extract at ``(pos0 + (acc & 63)) &
    mask``; returns ``acc (1, 128)`` int32."""
    global banded_launches
    check_banded_args(tape, pos0, reps)
    mask = default_mask(tape.shape[0]) if mask is None else int32(mask)
    if tape.device.type == "cpu":
        return banded_plain(tape, pos0, reps, mask)
    lib = load_kernel()
    tape, pos0 = tape.contiguous(), pos0.contiguous()
    out = torch.empty((1, L), dtype=torch.int32, device=tape.device)
    _build.check(lib.lz4t_probe_banded(
        tape.data_ptr(), pos0.data_ptr(), out.data_ptr(), tape.shape[0],
        reps, mask, _build.stream(tape.device)), "probe_banded")
    banded_launches += 1
    return out


def banded_plain(tape: torch.Tensor, pos0: torch.Tensor, reps: int,
                 mask: int | None = None) -> torch.Tensor:
    """Plain version: the rounds one after another, every lane at once
    (on the input's device)."""
    if mask is None:
        mask = default_mask(tape.shape[0])
    p0 = pos0[0].to(torch.int64)
    acc = torch.zeros(L, dtype=torch.int64, device=tape.device)
    for _ in range(reps):
        pos = wrap32(p0 + (acc & 63)).to(torch.int64) & mask
        w = extract_bytes(tape, pos, WORDS).to(torch.int64)
        acc = (acc + w.sum(0)) & 0xFFFF
    return acc.to(torch.int32).reshape(1, L)


def banded_inputs(rows: int, span_rows: int, seed: int = 5):
    """The tool's tape and positions (``make_banded``, :147-150): random
    words below 2^30, then byte positions in [0, 4 * span_rows)."""
    rng = np.random.default_rng(seed)
    tape = rng.integers(0, 1 << 30, (rows, L)).astype(np.int32)
    pos = rng.integers(0, max(span_rows * 4, 1), (1, L)).astype(np.int32)
    return tape, pos


def main(argv=None) -> int:
    a = parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    print(f"# device: {device_name(dev)}", flush=True)
    seed = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, L)
    for K, puts in KGET_CASES:
        best = per_iter(lambda n: kget(seed, n, K, puts), *KGET_REPS, dev)
        what = "K-get + K-put" if puts else "K-get"
        print(f"# {what} over ({TROWS},{L}), K={K}: {best * 1e9:.1f} ns",
              flush=True)
    for span in BANDED_SPANS:
        t_np, p_np = banded_inputs(BANDED_ROWS, span * 64)
        tape, pos = torch.from_numpy(t_np).to(dev), torch.from_numpy(p_np).to(
            dev)
        best = per_iter(lambda n: banded(tape, pos, n), *BANDED_REPS, dev)
        print(f"# banded {WORDS}-word extract, ({BANDED_ROWS},{L}) tape, "
              f"span={span} slabs: {best * 1e9:.1f} ns", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

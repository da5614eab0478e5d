"""T9-T13, the lockstep-design probes: the per-lane word gather and
scatter, the FIFO bitroll, the 30-op state step and the scratch capacity
probe. All arithmetic wraps at 32 bits; shifts, compares, ``min`` and
``max`` are those of signed int32.

Lane L of the 128 walks a row index ``idx``, starting at ``L mod R``, over
an ``(R, 128)`` int32 array (R a power of two of at least 8), stepping
``idx = (idx + L mod s + 1) mod R`` each round:

- T9, ``gather(tape, reps)``: ``s = 7``; each round adds ``tape[idx, L]``
  to a sum. Returns ``(8, 128)``: row 0 the sums.
- T10, ``scatter(R, reps)``: ``s = 5``; round i writes ``idx + i`` at
  ``out[idx, L]`` of an ``(R, 128)`` output. Returns its rows ``[:8]``.

The tool leaves the other cells (T9's rows 1-7, the cells T10's walk
never writes) as the TPU's memory held them; the port defines them as 0.

- T11, ``fifo(reps)``: an ``(8, 128)`` FIFO, starting as the row iota, and
  ``sh = L & 7``; each round rolls lane L's column down by ``sh`` (row r
  takes row ``(r - sh) mod 8``, in three stages of 1, 2 and 4 rows), adds
  1, and steps ``sh = (sh + 1) & 7``. Returns the FIFO.
- T12, ``state(reps)``: four ``(1, 128)`` states ``(z, z+1, z+2, z+3)``, z
  the lane iota, through the tool's body of about 30 ops a round
  (``state_step``). Returns ``(8, 128)``: row 0 ``a + b + c + d``. From
  the tool's start no state is negative before round 55,578; ``start``
  begins elsewhere, so that a few rounds reach the signed shifts and
  compares.
- T13, ``probe_vmem(rows, ring)``: does a scratch of ``(rows, 128)`` and
  ``(ring, 128)`` int32 fit one block? On the card that is shared memory,
  at most the opt-in limit a block (227 KiB on the H100), against the
  TPU's VMEM: every size the tool lists needs 10.5 MB or more, and is
  refused without a launch. A size that fits launches and writes ones
  into rows 0-7 of each scratch; ``vmem`` returns their sum (all 2s) or
  None where refused. The plain version has no limit.

Each launches its CUDA kernel on the card (``csrc/probe_lane.cu`` T9 and
T10, ``probe_step.cu`` T11 and T12, ``probe_smem.cu`` T13; ports of
``tools/microbench3.py``'s ``make_gather``, ``make_scatter``,
``make_fifo``, ``make_state`` and ``probe_vmem``) and runs its plain
version on the CPU. The TPU reads and writes a lane's row with a masked
reduce or where-write over the whole block; the card with one indexed
load or store.

``library_call`` gives the one PyTorch call that computes a round of T9
or T10 (the rounds' rows do not depend on the data): round 0's 128
reads as one ``torch.gather`` on the flat tape, or its 128 writes into
distinct cells as one ``index_put_``, the indices precomputed.
``chip_smoke.py`` times the kernels' rounds against them; the port never
calls them. T11 and T12 carry their state from round to round in several
operations a round, and T13 is a capacity probe: no single call computes
them.

    python -m lz4_sgori_torch.probes.microbench3 [--div D] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import M32, check_device, check_int32, device_name, parser, \
    per_iter, signed32, wrap32

L = 128
GATHER_R = (1024, 4096, 8192, 16384)
SCATTER_R = (1024, 4096, 16384)
GATHER_STRIDE = 7           # lane L steps L mod 7 + 1 rows a round
SCATTER_STRIDE = 5
STEP_REPS = (200_000, 1_000_000)  # T11's and T12's two round counts
VMEM_ROWS = (16384, 20480, 24576, 32768, 49152, 90112)
RING = 4096                 # the tool's second scratch, (4096, 128)
FIT_RING = 128              # the ring of the size that fits the card
CHUNK = 4096                # rounds a plain gather or scatter takes at once
INT32_MAX = (1 << 31) - 1
gather_launches = 0
scatter_launches = 0
fifo_launches = 0
state_launches = 0
vmem_launches = 0
_smem_limits: dict[int, int] = {}


def load_lane_kernel():
    """Build (once) and load csrc/probe_lane.cu (T9 and T10)."""
    return _build.load("probe_lane", {"lz4t_probe_gather": "ppiip",
                                      "lz4t_probe_scatter": "piip"})


def load_step_kernel():
    """Build (once) and load csrc/probe_step.cu (T11 and T12)."""
    return _build.load("probe_step", {"lz4t_probe_fifo": "pip",
                                      "lz4t_probe_state": "ppip"})


def load_smem_kernel():
    """Build (once) and load csrc/probe_smem.cu (T13)."""
    return _build.load("probe_smem", {"lz4t_probe_smem": "piiip",
                                      "lz4t_smem_optin": "i"})


def lane_reps(R: int) -> int:
    """The tool's lower round count of T9 and T10 at R (the higher is 5x)."""
    return max(20_000, 40_000_000 // R)


def check_rows(R: int) -> None:
    """The tool's ``% R`` walks a power of two; the kernels mask by R - 1,
    and T10 returns 8 rows."""
    if R < 8 or R & (R - 1):
        raise ValueError(f"R must be a power of two of at least 8, got {R}")


def check_reps(reps: int) -> None:
    if not 0 <= reps <= INT32_MAX:
        raise ValueError(f"reps must be in [0, 2^31), got {reps}")


def _rows8(row0: torch.Tensor) -> torch.Tensor:
    """``(8, 128)`` int32 with ``row0`` (int64, any value) wrapped into row
    0 and zeros below."""
    out = torch.zeros((8, L), dtype=torch.int32, device=row0.device)
    out[0] = wrap32(row0)
    return out


# ---- T9 and T10: the per-lane walks ----

def tape(R: int) -> np.ndarray:
    """The tool's tape: ``arange(R * 128) & 255`` as ``(R, 128)`` int32."""
    return (np.arange(R * L, dtype=np.int32) & 255).reshape(R, L)


def walk_rows(R: int, i0: int, i1: int, stride: int,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every lane's row in rounds ``i0 .. i1 - 1``, ``(i1 - i0, 128)``
    int64, and the rounds as a column."""
    lanes = torch.arange(L, device=device)
    i = torch.arange(i0, i1, device=device)[:, None]
    return (lanes % R + i * (lanes % stride + 1)) & (R - 1), i


def last_visit(R: int, reps: int, stride: int, device) -> torch.Tensor:
    """``(R, 128)`` int64: the last of ``reps`` rounds whose walk visits
    each cell, -1 where none does."""
    last = torch.full((R * L,), -1, dtype=torch.int64, device=device)
    lanes = torch.arange(L, device=device)
    for i0 in range(0, reps, CHUNK):
        idx, i = walk_rows(R, i0, min(reps, i0 + CHUNK), stride, device)
        last.scatter_reduce_(0, (idx * L + lanes).reshape(-1),
                             i.expand_as(idx).reshape(-1), "amax")
    return last.reshape(R, L)


def gather(tape: torch.Tensor, reps: int) -> torch.Tensor:
    """T9: ``reps`` rounds of per-lane gathers from ``tape (R, 128)``;
    returns ``(8, 128)`` int32, row 0 the wrapping sums."""
    global gather_launches
    check_int32(tape, "tape", (None, L))
    check_rows(tape.shape[0])
    check_reps(reps)
    dev = check_device(tape)
    if dev.type == "cpu":
        return gather_plain(tape, reps)
    lib = load_lane_kernel()
    tape = tape.contiguous()
    out = torch.empty((8, L), dtype=torch.int32, device=dev)
    _build.check(lib.lz4t_probe_gather(tape.data_ptr(), out.data_ptr(),
                                       tape.shape[0], reps,
                                       _build.stream(dev)), "probe_lane")
    gather_launches += 1
    return out


def gather_plain(tape: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version: the rounds ``CHUNK`` at a time, every lane at once
    (the walk does not depend on the data), on the input's device."""
    R = tape.shape[0]
    lanes = torch.arange(L, device=tape.device)
    acc = torch.zeros(L, dtype=torch.int64, device=tape.device)
    for i0 in range(0, reps, CHUNK):
        idx, _ = walk_rows(R, i0, min(reps, i0 + CHUNK), GATHER_STRIDE,
                           tape.device)
        acc = (acc + tape[idx, lanes].to(torch.int64).sum(0)) & M32
    return _rows8(acc)


def scatter(R: int, reps: int, device="cuda", whole: bool = False
            ) -> torch.Tensor:
    """T10: ``reps`` rounds of per-lane scatters into an ``(R, 128)``
    int32 output, zero where no round writes; returns its rows ``[:8]``
    (all of it with ``whole``)."""
    global scatter_launches
    check_rows(R)
    check_reps(reps)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return scatter_plain(R, reps, dev, whole)
    lib = load_lane_kernel()
    out = torch.zeros((R, L), dtype=torch.int32, device=dev)
    _build.check(lib.lz4t_probe_scatter(out.data_ptr(), R, reps,
                                        _build.stream(dev)), "probe_lane")
    scatter_launches += 1
    return out if whole else out[:8]


def scatter_plain(R: int, reps: int, device="cpu", whole: bool = False
                  ) -> torch.Tensor:
    """Plain version: a cell holds its row plus the last round that
    wrote it (the later write wins), 0 where none did."""
    last = last_visit(R, reps, SCATTER_STRIDE, device)
    rows = torch.arange(R, device=last.device)[:, None]
    out = torch.where(last >= 0, wrap32(rows + last), 0).to(torch.int32)
    return out if whole else out[:8].clone()


def library_call(name: str, tape: torch.Tensor):
    """The yardstick of a round of T9 (``"gather"``) or T10
    (``"scatter"``) on an ``(R, 128)`` int32 ``tape``: round 0's rows
    ``L mod R`` of the 128 lanes, precomputed, and one PyTorch call;
    ``(fn, label)``. T9's ``fn()`` reads ``tape[L mod R, L]`` (128 int32)
    by ``torch.gather`` on the flat tape; T10's writes ``idx + 0`` at
    ``tape[idx, L]`` by ``index_put_`` and returns ``tape``. Only timings
    call it."""
    check_int32(tape, "tape", (None, L))
    R = tape.shape[0]
    check_rows(R)
    if name not in ("gather", "scatter"):
        raise KeyError(f"no single PyTorch call computes a round of "
                       f"{name!r}")
    stride = GATHER_STRIDE if name == "gather" else SCATTER_STRIDE
    rows = walk_rows(R, 0, 1, stride, tape.device)[0][0]
    lanes = torch.arange(L, device=tape.device)
    if name == "gather":
        flat = tape.view(-1)
        at = rows * L + lanes
        return (lambda: torch.gather(flat, 0, at)), \
            f"torch.gather of 128 cells of the flat ({R}, 128) tape"
    vals = wrap32(rows)
    return (lambda: tape.index_put_((rows, lanes), vals)), \
        f"index_put_ of 128 cells of an ({R}, 128) output"


# ---- T11 and T12: the register-carried steps ----

def fifo(reps: int, device="cuda") -> torch.Tensor:
    """T11: ``reps`` rounds of the FIFO bitroll; returns the ``(8, 128)``
    int32 FIFO."""
    global fifo_launches
    check_reps(reps)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fifo_plain(reps, dev)
    lib = load_step_kernel()
    out = torch.empty((8, L), dtype=torch.int32, device=dev)
    _build.check(lib.lz4t_probe_fifo(out.data_ptr(), reps,
                                     _build.stream(dev)), "probe_step")
    fifo_launches += 1
    return out


def fifo_plain(reps: int, device="cpu") -> torch.Tensor:
    """Plain version: the rounds one after another, the three roll stages
    as selects between the column and its roll, every lane at once."""
    cur = torch.arange(8, device=device)[:, None].expand(8, L)
    sh = torch.arange(L, device=device) & 7
    for _ in range(reps):
        for bit in range(3):
            k = 1 << bit
            cur = torch.where((sh & k) != 0, torch.roll(cur, k, 0), cur)
        cur = signed32(cur + 1)
        sh = (sh + 1) & 7
    return cur.to(torch.int32)


def state_step(a, b, c, d):
    """The tool's body (``microbench3.py:190-205``) on int64 tensors that
    hold int32 values, every op as int32's."""
    e = signed32(a + b) ^ c
    f = torch.where(d > 0, e, a)
    g = signed32((f >> 3) + (b & 255))
    h = torch.minimum(g, c) | signed32(a << 1)
    a2 = torch.where((h & 1) != 0, signed32(a + 1), a)
    b2 = (b + g) & 0xFFFF
    c2 = torch.maximum(signed32(c - 1), h & 7)
    d2 = d ^ signed32(e + f)
    e2 = (a2 * 3 + b2) & 0xFFFFF
    f2 = torch.where(c2 > d2, e2, f)
    g2 = signed32(g + (f2 >> 2))
    h2 = h ^ g2
    a3 = signed32(a2 + (h2 & 3))
    b3 = torch.where(b2 < e2, b2 + 7, b2)
    c3 = c2 | (a3 & 1)
    d3 = signed32(d2 + g2)
    return a3, b3, c3, d3


def state_start(device) -> torch.Tensor:
    """The tool's start, ``(4, 128)`` int32: rows a, b, c, d."""
    z = torch.arange(L, dtype=torch.int32, device=device)
    return torch.stack([z, z + 1, z + 2, z + 3])


def state(reps: int, device="cuda", start: torch.Tensor | None = None
          ) -> torch.Tensor:
    """T12: ``reps`` rounds of the 30-op state step from the tool's start,
    or from ``start`` ``(4, 128)`` int32 (rows a, b, c, d) on its device;
    returns ``(8, 128)`` int32, row 0 ``a + b + c + d``."""
    global state_launches
    check_reps(reps)
    if start is None:
        dev = resolve_device(device)
    else:
        check_int32(start, "start", (4, L))
        dev = check_device(start)
    if dev.type == "cpu":
        return state_plain(reps, dev, start)
    lib = load_step_kernel()
    start = state_start(dev) if start is None else start.contiguous()
    out = torch.empty((8, L), dtype=torch.int32, device=dev)
    _build.check(lib.lz4t_probe_state(start.data_ptr(), out.data_ptr(), reps,
                                      _build.stream(dev)), "probe_step")
    state_launches += 1
    return out


def state_plain(reps: int, device="cpu", start: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Plain version: the rounds one after another, every lane at once."""
    if start is None:
        start = state_start(device)
    st = tuple(start.to(torch.int64))
    for _ in range(reps):
        st = state_step(*st)
    return _rows8(sum(st))


# ---- T13: the scratch capacity probe ----

def scratch_bytes(rows: int, ring: int = RING) -> int:
    return (rows + ring) * L * 4


def fit_rows(limit: int, ring: int) -> int:
    """The largest ``rows`` whose scratch, with ``ring``, fits ``limit``
    bytes."""
    return limit // (L * 4) - ring


def _card_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def smem_limit(device="cuda") -> int:
    """The card's opt-in shared memory a block, in bytes
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, read once a card)."""
    index = _card_index(resolve_device(device))
    if index not in _smem_limits:
        v = load_smem_kernel().lz4t_smem_optin(index)
        if v < 0:
            raise RuntimeError(f"reading the shared-memory limit failed: "
                               f"cudaError {-v}")
        _smem_limits[index] = v
    return _smem_limits[index]


def check_vmem_args(rows: int, ring: int) -> None:
    if rows < 8 or ring < 8 or scratch_bytes(rows, ring) > INT32_MAX:
        raise ValueError(f"rows and ring must be at least 8 and their "
                         f"scratch below 2^31 bytes, got {rows} and {ring}")


def vmem(rows: int, ring: int = RING, device="cuda") -> torch.Tensor | None:
    """T13: the scratch probe's ``(8, 128)`` int32 output (all 2s), or None
    where the scratch does not fit a block: then nothing launches."""
    global vmem_launches
    check_vmem_args(rows, ring)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return vmem_plain(rows, ring, dev)
    lib = load_smem_kernel()
    if scratch_bytes(rows, ring) > smem_limit(dev):
        return None
    out = torch.empty((8, L), dtype=torch.int32, device=dev)
    _build.check(lib.lz4t_probe_smem(out.data_ptr(), rows, ring,
                                     _card_index(dev), _build.stream(dev)),
                 "probe_smem")
    vmem_launches += 1
    return out


def vmem_plain(rows: int, ring: int = RING, device="cpu") -> torch.Tensor:
    """Plain version: the tool's kernel (``:235-238``) on scratch tensors,
    with no limit but the host's memory."""
    big = torch.zeros((rows, L), dtype=torch.int32, device=device)
    big2 = torch.zeros((ring, L), dtype=torch.int32, device=device)
    big[0:8] = 1
    big2[0:8] = 1
    return big[0:8] + big2[0:8]


def probe_vmem(rows: int, ring: int = RING, device="cuda") -> bool:
    """True where the scratch fits and the probe returns its 2s."""
    out = vmem(rows, ring, device)
    return out is not None and bool((out == 2).all())


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--div", type=int, default=1,
                   help="divide every round count by D (the tool's at 1; "
                        "the plain versions on the CPU want 1000 or more)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    if a.div < 1:
        p.error(f"--div must be at least 1, got {a.div}")

    def reps_of(n: int) -> int:
        return max(1, n // a.div)

    print(f"# device {device_name(dev)}", flush=True)
    for R in GATHER_R:
        t = torch.from_numpy(tape(R)).to(dev)
        n = reps_of(lane_reps(R))
        best = per_iter(lambda k: gather(t, k), n, 5 * n, dev)
        print(f"# per-lane gather (R={R}): {best * 1e9:.1f} ns/iter",
              flush=True)
    for R in SCATTER_R:
        n = reps_of(lane_reps(R))
        best = per_iter(lambda k: scatter(R, k, dev), n, 5 * n, dev)
        print(f"# per-lane scatter (R={R}): {best * 1e9:.1f} ns/iter",
              flush=True)
    lo, hi = (reps_of(n) for n in STEP_REPS)
    for label, fn in (("fifo 3-stage bitroll (8,128)", fifo),
                      ("30-op state step", state)):
        best = per_iter(lambda k: fn(k, dev), lo, hi, dev)
        print(f"# {label}: {best * 1e9:.1f} ns/iter", flush=True)
    for rows in VMEM_ROWS:
        ok = probe_vmem(rows, RING, dev)
        mb = scratch_bytes(rows) / 1e6
        print(f"# scratch probe rows={rows} (+{RING} ring): "
              + (f"OK ({mb:.1f} MB)" if ok else
                 f"FAIL ({mb:.1f} MB, above the {smem_limit(dev)} bytes a "
                 "block may opt in to)"), flush=True)
        if not ok:
            break
    if dev.type == "cuda":
        limit = smem_limit(dev)
        rows = fit_rows(limit, FIT_RING)
        ok = probe_vmem(rows, FIT_RING, dev) and not probe_vmem(
            rows + 1, FIT_RING, dev)
        print(f"# the card's opt-in shared memory a block: {limit} bytes; "
              f"the largest scratch that fits: rows={rows} (+{FIT_RING} "
              f"ring), {scratch_bytes(rows, FIT_RING)} bytes: "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The engine-routing table of the PyTorch port.

The same table as ``lz4_sgori_tpu/ops/routing.py``: the same engine names,
size-band edges and depth caps, so that a request picks the engine whose
byte contract it has to meet. The JAX table's ``on_tpu`` column becomes
the ``kernel`` column here: the hand-written kernels serve every device
(a CUDA tensor launches them, a CPU tensor runs their plain PyTorch
versions), so callers pass ``kernel=True`` for every device.

Every kernel engine runs at every depth its cap allows (the deep modes
are K8: ``seg``/``seg_big`` at depth 3, ``enc3`` at 3 and 5), and ``seg``
runs the mlen mode (K10) where the JAX package does. ``xla``, the
portable and exhaustive engine, serves ``impl="xla"`` on any device and
at every block size, as PyTorch tensor ops. Every engine of the JAX
table is ported, so ``UNPORTED`` is empty; ``require_ported`` stays the
one place that would refuse an engine the port lacked, naming its
ROADMAP item. Nothing reroutes silently.
"""

from __future__ import annotations

V7_MIN_BLOCK = 16384
V7_MAX_BLOCK = 131072
VMEM_MAX_BLOCK = 262144

ENCODE_IMPLS = ("auto", "xla", "enc3", "seg", "pallas")
DECODE_IMPLS = ("auto", "xla", "lockstep", "lockstep_v6", "lockstep_v7",
                "lockstep_v8")

# engine -> ROADMAP item that ports it (Queue 1 / Queue 2 numbering)
UNPORTED: dict[str, str] = {}


def seg_for(block_size: int) -> int | None:
    """Segment size for the big-block seg engine (as the JAX table)."""
    if block_size % 65536:
        return None
    for nseg in (128, 64, 32, 16, 8, 4, 2):
        if block_size % nseg == 0:
            seg = block_size // nseg
            if seg % 128 == 0 and seg >= 4096:
                return seg
    return None


def select_decode_engine(out_size: int, kernel: bool = True,
                         impl: str = "auto") -> str:
    """Return the decode engine name: 'xla' | 'v6' | 'v7' | 'v8'."""
    forced = {"xla": "xla", "lockstep_v6": "v6", "lockstep": "v7",
              "lockstep_v7": "v7", "lockstep_v8": "v8"}
    if impl != "auto":
        if impl not in forced:
            raise ValueError(
                f"unknown decode impl {impl!r}; expected one of "
                f"{DECODE_IMPLS}")
        return forced[impl]
    if not kernel:
        return "xla"
    if out_size > VMEM_MAX_BLOCK:
        return "v8"
    if V7_MIN_BLOCK <= out_size <= V7_MAX_BLOCK:
        return "v7"
    return "v6"


def select_encode_engine(block_size: int, depth: int, kernel: bool = True,
                         impl: str = "auto") -> str:
    """Return the encode engine name:
    'xla' | 'enc3' | 'seg' | 'seg_big' | 'seg_splice'."""
    if impl not in ENCODE_IMPLS:
        raise ValueError(
            f"unknown encode impl {impl!r}; expected one of {ENCODE_IMPLS}")
    if impl == "xla":
        return "xla"
    if impl in ("enc3", "pallas"):
        return "enc3"
    if impl == "seg":
        return "seg" if block_size <= 65536 else "seg_big"
    if not kernel:
        return "xla"
    if block_size > 65536:
        return "seg_big" if seg_for(block_size) is not None else "seg_splice"
    if 8192 <= block_size <= 65536 and block_size % 4096 == 0 and depth <= 3:
        return "seg"
    return "enc3"


def encode_depth_cap(engine: str, depth: int) -> int:
    """The depth an engine actually runs (as the JAX table)."""
    if engine in ("seg", "seg_big"):
        return min(depth, 3)
    if engine == "seg_splice":
        return 1
    if engine == "enc3":
        return 1 if depth <= 1 else (5 if depth >= 4 else 3)
    return depth


def require_ported(engine: str) -> None:
    """Raise NotImplementedError for an engine the port lacks."""
    if engine in UNPORTED:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: ROADMAP "
            f"{UNPORTED[engine]}")

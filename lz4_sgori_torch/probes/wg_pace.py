"""What sets the pace of the whole-card readings whose acc chains run in
the main kernel (``microbench2.RESIDENT``: ``transpose``, ``shiftsel``,
``red1``): variants of ``csrc/probe_harness_wg.cu``, each built beside it
(``wg_ab.load_source``) and timed in turns with it (this, variant,
variant, this; ten calls a timing, CUDA events) at the card's count and
twice it, with their ``out`` and ``sink`` bits compared:

- ``items``: no chain blocks, every block dealing the bands (acc is left
  unwritten): the items alone;
- ``chains``: no block takes an item: the chains alone;
- ``batch8``, ``batch32``: the chains' reads issued 8 or 32 iterations
  ahead of their adds, not 16 (``transpose``, ``shiftsel``; ``red1``'s
  chains take 32, a lane each);
- ``shared``: the chains on band 0's first 8 blocks, which also take 3
  items for every 4 of the band's other blocks (the bands dealt over all
  blocks), in place of chain blocks of their own.

    python -m lz4_sgori_torch.probes.wg_pace
"""

from __future__ import annotations

import os
import re

import torch

from ..blocks import resolve_device
from ..ops.kernels import _build
from . import device_name, parser, seconds
from . import microbench2 as P15
from . import wg_ab

CALLS = 10
SOURCE = os.path.join(_build.CSRC, "probe_harness_wg.cu")

_SHARED_DEAL = """struct Deal {
  int band, lo, hi, cell0, cells;
};

__device__ __forceinline__ Deal deal(int r) {
  const int band = blockIdx.x % rb::kBands, k = blockIdx.x / rb::kBands;
  const int blocks = ((int)gridDim.x - band + rb::kBands - 1) / rb::kBands;
  int chains = 0;
  if (band == 0)
    for (chains = 1; 2 * chains <= min(blocks, rb::kMaxChains);) chains *= 2;
  auto before = [&](int q) { return 4LL * q - min(q, chains); };
  Deal d;
  d.band = band;
  d.lo = (int)((long long)r * before(k) / before(blocks));
  d.hi = (int)((long long)r * before(k + 1) / before(blocks));
  d.cells = k < chains ? 1024 / chains : 0;
  d.cell0 = k * d.cells;
  return d;
}

"""

# each variant: (pattern, replacement) pairs, every pattern found in the
# source (re.subn, DOTALL)
VARIANTS = {
    "items": [(r"d\.cells = blk < chains \? 1024 / chains : 0;",
               "d.cells = 0;"),
              (r"const int first = grid - chains >= rb::kBands \? chains : 0;",
               "const int first = 0;")],
    "chains": [(r"const int n = \(d\.hi - d\.lo\)",
                "const int n = 0 * (d.hi - d.lo)")],
    "batch8": [(r"constexpr int kBatch = 16;", "constexpr int kBatch = 8;")],
    "batch32": [(r"constexpr int kBatch = 16;",
                 "constexpr int kBatch = 32;")],
    "shared": [(r"struct Deal \{.*?\n}\n\n(?=// the block's wrapping sink)",
                _SHARED_DEAL)],
}


def variant_source(source: str, name: str) -> str:
    """``source`` with variant ``name``'s replacements; raises where a
    pattern is not found (the source has moved on)."""
    for pattern, new in VARIANTS[name]:
        source, n = re.subn(pattern, new, source, flags=re.DOTALL)
        if not n:
            raise ValueError(f"variant {name}: {pattern!r} is not in the "
                             "source")
    return source


def main(argv=None) -> int:
    p = parser(__doc__)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type != "cuda":
        p.error("the kernels' times need a CUDA card")
    print(f"devices: {device_name(dev)}", flush=True)
    with open(SOURCE) as f:
        source = f.read()
    this = P15.load_harness_kernel(P15.WG).lz4t_probe_harness_wg
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    for vname in VARIANTS:
        path = os.path.join(_build.BUILD_DIR, f"wg_pace_{vname}.cu")
        with open(path, "w") as f:
            f.write(variant_source(source, vname))
        other = wg_ab.load_source(path).lz4t_probe_harness_wg
        for name in P15.RESIDENT:
            ins = P15.body_inputs(name, dev)
            for r in (P15.BODIES[name].card[1], 2 * P15.BODIES[name].card[1]):
                go_t, out_t, sink_t = wg_ab.launcher(
                    this, P15.BODY_ID[name], name, r, ins, dev)
                go_v, out_v, sink_v = wg_ab.launcher(
                    other, P15.BODY_ID[name], name, r, ins, dev)
                go_t(), go_v()      # warm-up
                t = [seconds(go, dev, CALLS) * 1e3
                     for go in (go_t, go_v, go_v, go_t)]
                same = torch.equal(out_t.view(torch.int32),
                                   out_v.view(torch.int32)) \
                    and torch.equal(sink_t, sink_v)
                print(f"{vname} {name} at R {r} in turns (this, variant, "
                      f"variant, this): this {t[0]:.4f} {t[3]:.4f} ms, "
                      f"variant {t[1]:.4f} {t[2]:.4f} ms "
                      f"({(t[1] + t[2]) / (t[0] + t[3]):.4f}x, "
                      f"{(t[1] + t[2]) / 2 / r * 1e6:.3f} ns an iteration "
                      f"against {(t[0] + t[3]) / 2 / r * 1e6:.3f}); the same "
                      f"out and sink bits: {same}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

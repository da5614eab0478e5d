"""Batched LZ4 block decode on a device.

Port of ``lz4_sgori_tpu/ops/decode.py:decompress_blocks_device``. The
engine comes from the routing table: the v7 band (16-128 KiB) runs K1
(``kernels/lockstep_v7.py``), the v6 bands (under 16 KiB and 132-256 KiB)
run K5 (``kernels/lockstep_v6.py``), and blocks above 256 KiB run K6
(``kernels/lockstep_v8.py``). The three kernels' plain version is the
port of the JAX package's portable decoder ``_decompress_blocks_impl``,
``kernels/lockstep_v7.py:decompress_blocks_plain``; ``impl="xla"`` runs
it as the ``xla`` engine, PyTorch tensor ops on the tensors' own device,
in runs of at most ``primitives.BATCH_POSITIONS`` compressed positions,
which bound its working set.
"""

from __future__ import annotations

import torch

from .. import routing
from .kernels.lockstep_v6 import decompress_blocks_v6
from .kernels.lockstep_v7 import (check_decode_args, decompress_blocks_plain,
                                  decompress_blocks_v7)
from .kernels.lockstep_v8 import decompress_blocks_v8
from .primitives import in_batches

_ENGINES = {"v6": decompress_blocks_v6, "v7": decompress_blocks_v7,
            "v8": decompress_blocks_v8}


def decompress_blocks_device(comp: torch.Tensor, comp_len: torch.Tensor,
                             out_size: int, max_sequences: int | None = None,
                             impl: str = "auto", cost_key=None):
    """Decode ``comp uint8 [B, slot]`` (zero past ``comp_len``, at least
    one pad byte) on its device.

    Returns (out uint8 [B, out_size], out_len int32 [B], err bool [B]).
    ``max_sequences`` bounds the sequences a block of the ``xla`` engine
    may hold (None: the format's worst case); as in the JAX package, the
    kernel engines ignore it. ``cost_key`` (the encoder's per-block
    sequence count, a lane-grouping hint for the TPU's lockstep engines)
    is accepted and not needed: each block runs on its own warp.
    """
    del cost_key
    engine = routing.select_decode_engine(out_size, True, impl)
    routing.require_ported(engine)
    comp_len = comp_len.to(torch.int32)
    if engine != "xla":
        return _ENGINES[engine](comp, comp_len, out_size)
    check_decode_args(comp, comp_len, out_size)
    return in_batches(
        lambda c, n: decompress_blocks_plain(c, n, out_size, max_sequences),
        comp, comp_len)

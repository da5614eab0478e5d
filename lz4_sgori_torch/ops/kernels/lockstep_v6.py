"""K5, the safe LZ4 block decoder of the v6 bands: CUDA kernel wrapper
and plain version.

``decompress_blocks_v6`` launches ``csrc/decode_v6.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_v6.py:_kernel``) for a CUDA tensor
and runs K1's plain decoder for a CPU tensor. The routing table sends
two bands here: blocks below 16 KiB (the 4 KiB block-device path) and
the 132-256 KiB band.

v6 computes the same function as v7: on the TPU only the staging
geometry differs (``lockstep_v6.py:1-25``). So the CUDA source runs K1's
walk (``csrc/lz4_decode_ring.cuh``) in geometries sized to the block,
from its own library, with its own launch counter, and the plain version
is K1's
(``lockstep_v7.decompress_blocks_plain``). The return contract is K1's:
``(out uint8 [B, out_size], out_len int32 [B], err bool [B])``, ``err``
exactly when ``golden.decompress`` raises.
"""

from __future__ import annotations

import torch

from . import _build
from .lockstep_v7 import (check_decode_args, decompress_blocks_plain,
                          launch_decode)

launches = 0
ENTRIES = {"lz4t_decode_v6": "pppppiiip"}   # the C entry's signature


def load_kernel():
    """Build (once) and load csrc/decode_v6.cu."""
    return _build.load("decode_v6", ENTRIES)


def decompress_blocks_v6(comp: torch.Tensor, comp_len: torch.Tensor,
                         out_size: int):
    """Decode a batch of LZ4 blocks (K5)."""
    global launches
    check_decode_args(comp, comp_len, out_size)
    if comp.device.type == "cpu":
        return decompress_blocks_plain(comp, comp_len, out_size)
    res = launch_decode(load_kernel().lz4t_decode_v6, comp, comp_len,
                        out_size)
    launches += 1
    return res

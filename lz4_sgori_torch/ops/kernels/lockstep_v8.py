"""K6, the safe LZ4 block decoder of the v8 band: CUDA kernel wrapper and
plain version.

``decompress_blocks_v8`` launches ``csrc/decode_v8.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_v8.py:_kernel``, wrapper
``decompress_blocks_lockstep_v8``) for a CUDA tensor and runs K1's plain
decoder for a CPU tensor. The routing table sends every block above
256 KiB here (512 KiB-4 MiB on the fio envelope).

v8 computes v7's function: on the TPU only the tapes' home differs (HBM
rings instead of VMEM, ``lockstep_v8.py:1-24``). The CUDA kernel
(``csrc/lz4_decode_ring.cuh``) walks each block with one warp of a CTA
of its own, through two rings in shared memory: the compressed stream
arrives in 8 KiB stages by ``cp.async.bulk``, three ahead of the walk,
and the last 128 KiB of output stay on chip, so that every match reads
its source there (LZ4's offsets reach 65,535 bytes back); the output
leaves in 16 KiB flushes of 16-byte stores. The lanes take up to 32
sequences a batch (a 256-byte window parsed at every position by the
CTA's four warps, the batch's tokens found by doubling the links, the
copies a lane a sequence or in dependency waves); the rest go one at a
time. The launch
asks for 169,536 bytes of shared memory a CTA; a card that refuses them
fails the launch, which raises. The plain version is K1's
(``lockstep_v7.decompress_blocks_plain``). The return contract is K1's:
``(out uint8 [B, out_size], out_len int32 [B], err bool [B])``, ``err``
exactly when ``golden.decompress`` raises. ``cost_key`` (the JAX
wrapper's ``sort_key``, which only orders the TPU's lanes) is accepted
and ignored.
"""

from __future__ import annotations

import torch

from . import _build
from .lockstep_v7 import (check_decode_args, decompress_blocks_plain,
                          launch_decode)

launches = 0
ENTRIES = {"lz4t_decode_v8": "pppppiiip"}   # the C entry's signature


def load_kernel():
    """Build (once) and load csrc/decode_v8.cu."""
    return _build.load("decode_v8", ENTRIES)


def decompress_blocks_v8(comp: torch.Tensor, comp_len: torch.Tensor,
                         out_size: int, cost_key=None):
    """Decode a batch of LZ4 blocks (K6)."""
    global launches
    del cost_key
    check_decode_args(comp, comp_len, out_size)
    if comp.device.type == "cpu":
        return decompress_blocks_plain(comp, comp_len, out_size)
    res = launch_decode(load_kernel().lz4t_decode_v8, comp, comp_len,
                        out_size)
    launches += 1
    return res

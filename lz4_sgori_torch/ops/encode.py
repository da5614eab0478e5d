"""Batched LZ4 block encode on a device.

Port of ``lz4_sgori_tpu/ops/encode.py:compress_blocks_device`` and
``compress_blocks_seg_dispatch``, restricted to what the port has: the
``seg`` engine at depth 1 (kernels K2-K4, ``ops/seg.py``). Every other
engine, depth and the mlen mode raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import os

import torch

from .. import routing
from .seg import compress_blocks_seg


def compress_blocks_device(raw: torch.Tensor, raw_len: torch.Tensor,
                           block_size: int, match_depth: int | None = None,
                           impl: str = "auto", acceleration: int = 1,
                           return_cost: bool = False):
    """Compress ``raw uint8 [nb, >= block_size]`` on its device.

    Returns (comp uint8 [nb, compress_bound(block_size) + 8], comp_len
    int32 [nb]) and, with ``return_cost``, the per-block sequence count.
    ``comp_len`` 0 marks a block the engine could not encode (see
    ``compress_blocks_seg_dispatch``).
    """
    md = match_depth or 1
    engine = routing.select_encode_engine(block_size, md, True, impl)
    depth = routing.encode_depth_cap(engine, md)
    routing.require_ported(engine, depth)
    comp, comp_len, cost = compress_blocks_seg_dispatch(
        raw, raw_len, block_size, acceleration, return_nseq=True)
    return (comp, comp_len, cost) if return_cost else (comp, comp_len)


def compress_blocks_seg_dispatch(raw, raw_len, block_size: int,
                                 acceleration: int = 1, seg: int = 4096,
                                 return_nseq: bool = False):
    """The seg engine, byte-exact to golden.compress_dense_seg. A parse
    error or an assembled block past COMPRESSBOUND (the reference's
    limited-output condition) folds into comp_len 0 for the framing
    layer's verify and host fallback."""
    if os.environ.get("LZ4J_ENC_MLEN") == "1":
        raise NotImplementedError(
            "LZ4J_ENC_MLEN=1 (mlen pass 1) is not ported yet: ROADMAP "
            "Queue 2 K10")
    comp, comp_len, _err, nseq = compress_blocks_seg(
        raw, raw_len, block_size, seg=seg, accel=acceleration)
    return (comp, comp_len, nseq) if return_nseq else (comp, comp_len)

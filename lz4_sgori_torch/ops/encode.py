"""Batched LZ4 block encode on a device.

Port of ``lz4_sgori_tpu/ops/encode.py:compress_blocks_device`` and its
kernel dispatches, restricted to the kernel engines:

- ``seg`` (8-64 KiB, 4 KiB multiples, depth <= 3): kernels K2-K4, at
  depth 2-3 K2, gaps, K8-seg and K4, and with ``LZ4J_ENC_MLEN=1`` at
  depth 1 (the mlen mode, the JAX package's switch) K2, K10a, K10b and
  K4, ``ops/seg.py``;
- ``seg_big`` (64 KiB multiples above 64 KiB, 128 KiB-4 MiB on the fio
  envelope; depth capped at 3): kernels K9, K3 and K4 with
  ``seg = routing.seg_for(bs)``, and at depth 2-3 K9, gaps, K8-seg and
  K4, ``ops/seg.py``;
- ``enc3`` (under 8 KiB, other sizes up to 64 KiB, and every size up to
  64 KiB at depth 4 and up): K2 and K7, and at depth 3 and 5 K2, gaps
  and K8-enc3, ``ops/enc3.py``;
- ``seg_splice`` (above 64 KiB, not 64 KiB multiples; depth capped at
  1): 64 KiB segments through ``enc3`` with tails, spliced on the host.

The ``xla`` engine raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import format as F
from .. import golden, routing
from .enc3 import compress_blocks_enc3
from .seg import compress_blocks_seg


def compress_blocks_device(raw: torch.Tensor, raw_len: torch.Tensor,
                           block_size: int, match_depth: int | None = None,
                           impl: str = "auto", acceleration: int = 1,
                           return_cost: bool = False):
    """Compress ``raw uint8 [nb, >= block_size]`` on its device.

    Returns (comp uint8 [nb, compress_bound(block_size) + 8], comp_len
    int32 [nb]) and, with ``return_cost``, the per-block sequence count
    (``comp_len`` for seg_splice, as in the JAX package). ``comp_len`` 0
    marks a block the engine could not encode: the framing layer
    re-encodes it on the host.
    """
    md = match_depth or 1
    engine = routing.select_encode_engine(block_size, md, True, impl)
    depth = routing.encode_depth_cap(engine, md)
    routing.require_ported(engine)
    if depth < md:
        import warnings
        warnings.warn(
            f"match_depth={md} exceeds the {engine} engine's depth cap; "
            f"running depth {depth} (see routing.py).", stacklevel=2)
    if engine == "seg_splice":
        comp, comp_len = _compress_blocks_segmented(raw, raw_len, block_size,
                                                    acceleration)
        cost = comp_len
    elif engine == "enc3":
        comp, comp_len, cost = compress_blocks_enc3_dispatch(
            raw, raw_len, block_size, acceleration, depth=depth)
    elif engine == "seg_big":
        comp, comp_len, cost = compress_blocks_seg_dispatch(
            raw, raw_len, block_size, acceleration, depth=depth,
            seg=routing.seg_for(block_size), return_nseq=True)
    else:
        comp, comp_len, cost = compress_blocks_seg_dispatch(
            raw, raw_len, block_size, acceleration, depth=depth,
            return_nseq=True)
    return (comp, comp_len, cost) if return_cost else (comp, comp_len)


def _compress_blocks_segmented(raw: torch.Tensor, raw_len: torch.Tensor,
                               block_size: int, acceleration: int = 1):
    """The seg_splice engine for blocks above 64 KiB: 64 KiB segments
    through ``enc3`` with their tails, then ``golden.splice_segments`` on
    the host into one LZ4 block per input block. Byte contract:
    ``golden.compress_segmented``. A segment error or a spliced block past
    ``compress_bound`` gives ``comp_len`` 0."""
    seg = 65536
    nb, slot = raw.shape
    dev = raw.device
    nseg = -(-block_size // seg)
    segslot = nseg * seg
    if slot < segslot:
        raw = torch.nn.functional.pad(raw, (0, segslot - slot))
    segs = raw[:, :segslot].reshape(nb * nseg, seg)
    sidx = torch.arange(nseg, dtype=torch.int32, device=dev)[None, :]
    seg_len = (raw_len.to(device=dev, dtype=torch.int32)[:, None]
               - sidx * seg).clamp(0, seg).reshape(-1)
    comp_s, clen_s, err_s, tail_s = compress_blocks_enc3(
        segs, seg_len, seg, accel=acceleration, return_tails=True)
    comp_s, clen_s, err_s, tail_s = (t.cpu().numpy() for t in
                                     (comp_s, clen_s, err_s, tail_s))
    rlen = raw_len.cpu().numpy()
    bound = F.compress_bound(block_size)
    out = np.zeros((nb, bound + 8), np.uint8)
    out_len = np.zeros(nb, np.int32)
    for b in range(nb):
        rows = range(b * nseg, b * nseg + max(1, -(-int(rlen[b]) // seg)))
        if any(err_s[r] for r in rows):
            continue
        blob = golden.splice_segments(
            [comp_s[r, :clen_s[r]].tobytes() for r in rows],
            [int(tail_s[r]) for r in rows])
        if len(blob) > bound:
            continue
        out[b, :len(blob)] = np.frombuffer(blob, np.uint8)
        out_len[b] = len(blob)
    return torch.from_numpy(out).to(dev), torch.from_numpy(out_len).to(dev)


def compress_blocks_enc3_dispatch(raw, raw_len, block_size: int,
                                  acceleration: int = 1, depth: int = 1):
    """The enc3 engine, byte-exact to golden.compress_dense(hashlog=16)
    at depth 1 and golden.compress_deep(hashlog=16, depth) at depth 3
    and 5: (comp, comp_len, nseq). A block past COMPRESSBOUND folds into
    comp_len 0 for the framing layer's verify and host fallback."""
    comp, comp_len, err, nseq = compress_blocks_enc3(
        raw, raw_len, block_size, accel=acceleration, return_nseq=True,
        depth=depth)
    return comp, torch.where(err, 0, comp_len), nseq


def compress_blocks_seg_dispatch(raw, raw_len, block_size: int,
                                 acceleration: int = 1, depth: int = 1,
                                 seg: int = 4096,
                                 return_nseq: bool = False):
    """The seg and seg_big engines, byte-exact to golden.compress_dense_seg
    (compress_dense_seg_big above 64 KiB) at ``depth``. A parse error or
    an assembled block past COMPRESSBOUND (the reference's limited-output
    condition) folds into comp_len 0 for the framing layer's verify and
    host fallback. ``LZ4J_ENC_MLEN=1`` runs the mlen mode (the same
    bytes) where the JAX package does: depth 1, blocks of at most
    64 KiB; elsewhere the JAX package ignores it, and so does the port."""
    mlen = (os.environ.get("LZ4J_ENC_MLEN") == "1" and depth == 1
            and block_size <= 65536)
    comp, comp_len, _err, nseq = compress_blocks_seg(
        raw, raw_len, block_size, seg=seg, accel=acceleration, depth=depth,
        mlen=mlen)
    return (comp, comp_len, nseq) if return_nseq else (comp, comp_len)

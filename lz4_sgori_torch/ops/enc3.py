"""The enc3 engine: block-per-lane compress (kernels K2 and K7 plus
PyTorch glue; K10a and K10c in the mlen mode).

Port of ``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:
compress_blocks_lockstep_enc3`` for blocks of at most 64 KiB. Byte
contract per block: ``golden.compress_dense(block, accel, hashlog=16)``
at depth 1 and ``golden.compress_deep(block, accel, hashlog=16, depth)``
at depth 3 and 5; the mlen mode (depth 1) gives golden.compress_dense's
bytes by another route. The routing table sends it blocks under 8 KiB (the
4 KiB block-device path), blocks of at most 64 KiB that are not 4 KiB
multiples, every block of at most 64 KiB at depth 4 and up, and the
64 KiB segments of the seg_splice engine. As in the JAX package, no
dispatch sets ``mlen`` here.

Pipeline: mask bytes past ``raw_len`` -> K2 candidates -> at depth 3 and
5 the chain gaps (the gaps kernel; g4 | g5 too at depth 5), in the mlen
mode the verified candidates and match codes (K10a) -> the whole-block
parse (K7, K8-enc3 at depth 3 and 5, K10c in the mlen mode). Each writes
each block whole, terminal sequence included, so no assembly pass
follows.
What only the TPU needed is left out: the 128-lane tape packing
(``pack_tapes``/``unpack_tapes``) and ``_pack_cand``'s two positions per
row, the density regrouping of blocks (a permutation that is inverted
again, so the bytes never change), the ``optimization_barrier`` chains,
and the per-group invocation when a grid does not fit VMEM.
"""

from __future__ import annotations

import torch

from .kernels.cand import dense_candidates
from .kernels.gaps import chain_gaps
from .kernels.mcode import dense_mcode
from .kernels.parse_enc3 import MAX_BLOCK, parse_blocks_enc3
from .kernels.parse_enc3_deep import parse_blocks_enc3_deep
from .kernels.parse_enc3_mlen import parse_blocks_enc3_mlen


def compress_blocks_enc3(raw: torch.Tensor, raw_len: torch.Tensor,
                         block_size: int, accel: int = 1,
                         return_tails: bool = False,
                         return_nseq: bool = False, depth: int = 1,
                         mlen: bool = False):
    """Compress ``[nb, >= block_size]`` uint8 blocks on their device;
    ``mlen`` runs the mlen mode (depth 1 only).

    Returns (comp uint8 [nb, compress_bound(block_size) + 8] zero past
    the length, comp_len int32 [nb], err bool [nb]), then ``tails`` (the
    terminal sequence's offset) with ``return_tails`` and ``nseq`` with
    ``return_nseq``, in that order. ``err`` marks a block past
    ``compress_bound`` (its ``comp_len`` is 0).
    """
    if depth not in (1, 3, 5):
        raise ValueError(f"enc3 runs depth 1, 3 or 5, not {depth} (see "
                         "routing.encode_depth_cap)")
    if mlen and depth > 1:
        raise ValueError("the mlen mode runs depth 1 only")
    if block_size > MAX_BLOCK:
        raise ValueError(
            f"enc3 serves blocks of at most {MAX_BLOCK} bytes (K2's "
            "candidate table and K7's 16-bit offsets); larger blocks go "
            "through seg_splice or seg_big")
    dev = raw.device
    raw_len = raw_len.to(device=dev, dtype=torch.int32)
    pos = torch.arange(block_size, device=dev)
    rawm = torch.where(pos[None, :] < raw_len[:, None],
                       raw[:, :block_size], 0).to(torch.uint8).contiguous()
    cand = dense_candidates(rawm, raw_len)
    if depth > 1:
        gaps, gaps2 = chain_gaps(cand, 4 if depth == 5 else 2)
        parts = parse_blocks_enc3_deep(rawm, cand, gaps, gaps2, raw_len,
                                       accel, depth)
    elif mlen:
        cand_v, mcode = dense_mcode(cand, rawm, raw_len)
        parts = parse_blocks_enc3_mlen(rawm, cand_v, mcode, raw_len, accel)
    else:
        parts = parse_blocks_enc3(rawm, cand, raw_len, accel)
    comp, comp_len, err, tails, nseq = parts
    res = (comp, comp_len, err)
    if return_tails:
        res += (tails,)
    if return_nseq:
        res += (nseq,)
    return res

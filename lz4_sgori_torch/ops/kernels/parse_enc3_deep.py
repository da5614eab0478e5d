"""K8-enc3, the whole-block deep parse of the enc3 engine: CUDA kernel
wrapper and plain version.

``parse_blocks_enc3_deep`` launches ``csrc/parse_enc3_deep.cu`` (the port
of ``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel`` in
block-per-lane mode at depth 3 and 5) for a CUDA tensor and runs
``parse_blocks_enc3_deep_plain`` for a CPU tensor.

Contract: per block, ``golden.compress_deep(block, accel, hashlog=16,
depth)`` (``lz4_sgori_tpu/golden.py:873-1025``) over K2's candidates and
``gaps.chain_gaps``'s tapes (``gaps2`` at depth 5 only), with K7's
outputs (``parse_enc3.py``): out, out_len, err, tails, nseq.

The CUDA kernel (``csrc/parse_enc3_warp.cuh``) parses a block with one
warp, the block resident in shared memory (one ``cp.async.bulk``), the
tapes streamed through a ring of ``cp.async`` chunks and the stream
staged on chip and stored once. The lanes split each step of the walk:
32 probes of the skip schedule a round (the first hit by ballot), the
previews of the hit probe's candidates and of the lazy step's together
(two lanes a candidate, 4-byte words), 32 bytes of catch-up and 128 of
extension a step. A 64 KiB block takes a CTA of its own (about 150 KiB
of shared memory); small blocks share a CTA, up to 8 a CTA. A card that
refuses the shared memory fails the launch, which raises.
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build
from .parse_enc3 import (block_outputs, check_block_size,
                         parse_blocks_enc3_plain)
from .parse_seg import check_parse_args

launches = 0
ENTRIES = {"lz4t_parse_enc3_deep": "ppppppppppiiiiiip"}  # the C entry


def load_kernel():
    """Build (once) and load csrc/parse_enc3_deep.cu."""
    return _build.load("parse_enc3_deep", ENTRIES)


def _check_depth(depth: int, gaps2) -> None:
    if depth not in (3, 5):
        raise ValueError(f"the enc3 deep parse runs depth 3 or 5, not "
                         f"{depth}")
    if (gaps2 is None) != (depth == 3):
        raise ValueError("depth 5 takes the gaps2 tape, depth 3 does not")


def parse_blocks_enc3_deep(raw: torch.Tensor, cand: torch.Tensor,
                           gaps: torch.Tensor, gaps2: torch.Tensor | None,
                           raw_len: torch.Tensor, accel: int = 1,
                           depth: int = 3):
    """Deep-parse every block whole (K8-enc3)."""
    global launches
    _check_depth(depth, gaps2)
    tapes = (gaps,) if gaps2 is None else (gaps, gaps2)
    check_parse_args(raw, cand, raw_len, *tapes)
    check_block_size(raw)
    accel = max(int(accel), 1)
    if raw.device.type == "cpu":
        return parse_blocks_enc3_deep_plain(raw, cand, gaps, gaps2, raw_len,
                                            accel, depth)
    raw, cand, gaps, raw_len = (t.contiguous() for t in
                                (raw, cand, gaps, raw_len))
    if gaps2 is not None:
        gaps2 = gaps2.contiguous()
    nb, bs = raw.shape
    cap = F.compress_bound(bs)
    lib = load_kernel()
    out, out_len, err, tails, nseq = block_outputs(nb, bs, raw.device)
    _build.check(lib.lz4t_parse_enc3_deep(
        raw.data_ptr(), cand.data_ptr(), gaps.data_ptr(),
        gaps2.data_ptr() if gaps2 is not None else None, raw_len.data_ptr(),
        out.data_ptr(), out_len.data_ptr(), err.data_ptr(), tails.data_ptr(),
        nseq.data_ptr(), nb, bs, cap + 8, cap, accel, depth,
        _build.stream(raw.device)), "parse_enc3_deep")
    launches += 1
    return out, out_len, err, tails, nseq


def parse_blocks_enc3_deep_plain(raw, cand, gaps, gaps2, raw_len,
                                 accel: int = 1, depth: int = 3):
    """Plain PyTorch K8-enc3: K7's plain version with the deep probe."""
    _check_depth(depth, gaps2)
    return parse_blocks_enc3_plain(raw, cand, raw_len, accel, gaps=gaps,
                                   gaps2=gaps2)

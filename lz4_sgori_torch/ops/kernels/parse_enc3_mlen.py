"""K10c, the whole-block parse of the enc3 engine in the mlen mode: CUDA
kernel wrapper and plain version.

``parse_blocks_enc3_mlen`` launches ``csrc/parse_enc3_mlen.cu`` (the port
of ``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel(mlen=True)``
in block-per-lane mode) for a CUDA tensor and runs
``parse_blocks_enc3_mlen_plain`` for a CPU tensor.

Contract: K7's (``parse_enc3.py``), per block
``golden.compress_dense(block, accel, hashlog=16)``, over the verified
candidates and match codes of ``mcode.dense_mcode``, with K7's outputs:
out, out_len, err, tails, nseq.

The CUDA kernel is K7's warp walk (``csrc/parse_enc3_warp.cuh`` at one
candidate) in the mlen mode, a CTA a block: the codes stream through the
``cp.async`` ring beside ``cand_v``; a probe hits on ``0 < cand_v``
with no read32, the catch-up goes back ``cu`` bytes from the hit's code
(the 32-byte steps only when ``cu`` is 4), and the extension starts
``lcp`` bytes on (the 128-byte steps only when ``lcp`` is 8).
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build
from .parse_enc3 import (block_outputs, check_block_size,
                         parse_blocks_enc3_plain)
from .parse_seg import check_parse_args

launches = 0
ENTRIES = {"lz4t_parse_enc3_mlen": "pppppppppiiiiip"}  # the C entry


def load_kernel():
    """Build (once) and load csrc/parse_enc3_mlen.cu."""
    return _build.load("parse_enc3_mlen", ENTRIES)


def parse_blocks_enc3_mlen(raw: torch.Tensor, cand_v: torch.Tensor,
                           mcode: torch.Tensor, raw_len: torch.Tensor,
                           accel: int = 1):
    """Parse every block whole in the mlen mode (K10c)."""
    global launches
    check_parse_args(raw, cand_v, raw_len, mcode, tape="mcode")
    check_block_size(raw)
    accel = max(int(accel), 1)
    if raw.device.type == "cpu":
        return parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, raw_len,
                                            accel)
    raw, cand_v, mcode, raw_len = (t.contiguous() for t in
                                   (raw, cand_v, mcode, raw_len))
    nb, bs = raw.shape
    cap = F.compress_bound(bs)
    lib = load_kernel()
    out, out_len, err, tails, nseq = block_outputs(nb, bs, raw.device)
    _build.check(lib.lz4t_parse_enc3_mlen(
        raw.data_ptr(), cand_v.data_ptr(), mcode.data_ptr(),
        raw_len.data_ptr(), out.data_ptr(), out_len.data_ptr(),
        err.data_ptr(), tails.data_ptr(), nseq.data_ptr(), nb, bs, cap + 8,
        cap, accel, _build.stream(raw.device)), "parse_enc3_mlen")
    launches += 1
    return out, out_len, err, tails, nseq


def parse_blocks_enc3_mlen_plain(raw, cand_v, mcode, raw_len,
                                 accel: int = 1):
    """Plain PyTorch K10c: K7's plain version reading the codes."""
    return parse_blocks_enc3_plain(raw, cand_v, raw_len, accel, mcode=mcode)

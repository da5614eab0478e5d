"""K10b, the segment-parallel parse of the mlen mode: CUDA kernel wrapper
and plain version.

``parse_segments_mlen`` launches ``csrc/parse_seg_mlen.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel(mlen=True)`` in
seg mode) for a CUDA tensor and runs ``parse_segments_mlen_plain`` for a
CPU tensor.

Contract: K3's (``parse_seg.py``), per segment
``golden.compress_dense_seg_parts`` at depth 1, over the verified
candidates and match codes of ``mcode.dense_mcode``: the parse reads the
probe's verify, the catch-up and the first extension bytes from the code
and writes the same stream. Returns K3's outputs: streams, slen, err,
last_end, nseq, p1, m1h.

The CUDA kernel is K3's warp walk (``csrc/parse_seg_warp.cuh``) in the
mlen mode: a warp a segment, K3's CTAs and bytes in shared memory; a
probe hits on ``0 < cand_v <= wlim`` with no read32, the hit's code
leaves its lane by a shuffle, the catch-up goes back ``cu`` bytes from
the code (the 32-byte steps only when ``cu`` is 4), and the extension
starts ``lcp`` bytes on (the 128-byte steps only when ``lcp`` is 8).
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build
from .parse_seg import (check_parse_args, check_seg, parse_segments_plain,
                        segment_outputs, window_limit)

launches = 0
ENTRIES = {"lz4t_parse_seg_mlen": "pppppppppppiiiiiip"}  # the C entry


def load_kernel():
    """Build (once) and load csrc/parse_seg_mlen.cu."""
    return _build.load("parse_seg_mlen", ENTRIES)


def parse_segments_mlen(raw: torch.Tensor, cand_v: torch.Tensor,
                        mcode: torch.Tensor, raw_len: torch.Tensor,
                        seg: int = 4096, window: int = 65536,
                        accel: int = 1):
    """Parse every segment of every block in the mlen mode (K10b)."""
    global launches
    check_parse_args(raw, cand_v, raw_len, mcode, tape="mcode")
    check_seg(raw, seg)
    nb, bs = raw.shape
    accel = max(int(accel), 1)
    if raw.device.type == "cpu":
        return parse_segments_mlen_plain(raw, cand_v, mcode, raw_len, seg,
                                         window, accel)
    raw, cand_v, mcode, raw_len = (t.contiguous() for t in
                                   (raw, cand_v, mcode, raw_len))
    lib = load_kernel()
    outs = segment_outputs(nb * (bs // seg), seg, raw.device)
    _build.check(lib.lz4t_parse_seg_mlen(
        raw.data_ptr(), cand_v.data_ptr(), mcode.data_ptr(),
        raw_len.data_ptr(), *(t.data_ptr() for t in outs), nb, bs, seg,
        F.compress_bound(seg), window_limit(window), accel,
        _build.stream(raw.device)), "parse_seg_mlen")
    launches += 1
    return outs


def parse_segments_mlen_plain(raw, cand_v, mcode, raw_len, seg: int = 4096,
                              window: int = 65536, accel: int = 1):
    """Plain PyTorch K10b: K3's lockstep plain parse reading the codes."""
    return parse_segments_plain(raw, cand_v, raw_len, seg, window, accel,
                                mcode=mcode)

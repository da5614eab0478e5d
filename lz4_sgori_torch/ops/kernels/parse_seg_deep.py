"""K8-seg, the segment-parallel deep parse: CUDA kernel wrapper and plain
version.

``parse_segments_deep`` launches ``csrc/parse_seg_deep.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel`` in seg mode at
depth 3) for a CUDA tensor and runs ``parse_segments_deep_plain`` for a
CPU tensor.

Contract: per segment, ``golden.compress_dense_seg_parts(..., depth=3)``
(``lz4_sgori_tpu/golden.py:455-518``) over K2's or K9's candidates and
the gaps tape of ``gaps.chain_gaps``, with K3's outputs
(``parse_seg.py``): streams, slen, err, last_end, nseq, p1, m1h. The seg
engines run every depth above 1 at three candidates a probe.

The CUDA kernel is K3's warp walk at three candidates a probe
(``csrc/parse_seg_warp.cuh``, N = 3): a warp a segment over bytes copied
into shared memory once a CTA, 32 probes a round with every chain
candidate's checks, the hit's and the lazy step's candidates previewed
together (two lanes a candidate, 32 bytes a lane, K8-enc3's), the
extension going on from the winner's preview.
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build
from .parse_seg import (check_parse_args, check_seg, parse_segments_plain,
                        segment_outputs, window_limit)

launches = 0
ENTRIES = {"lz4t_parse_seg_deep": "pppppppppppiiiiiip"}  # the C entry


def load_kernel():
    """Build (once) and load csrc/parse_seg_deep.cu."""
    return _build.load("parse_seg_deep", ENTRIES)


def parse_segments_deep(raw: torch.Tensor, cand: torch.Tensor,
                        gaps: torch.Tensor, raw_len: torch.Tensor,
                        seg: int = 4096, window: int = 65536,
                        accel: int = 1):
    """Deep-parse every segment of every block (K8-seg)."""
    global launches
    check_parse_args(raw, cand, raw_len, gaps)
    check_seg(raw, seg)
    nb, bs = raw.shape
    accel = max(int(accel), 1)
    if raw.device.type == "cpu":
        return parse_segments_deep_plain(raw, cand, gaps, raw_len, seg,
                                         window, accel)
    raw, cand, gaps, raw_len = (t.contiguous() for t in
                                (raw, cand, gaps, raw_len))
    outs = segment_outputs(nb * (bs // seg), seg, raw.device)
    lib = load_kernel()
    _build.check(lib.lz4t_parse_seg_deep(
        raw.data_ptr(), cand.data_ptr(), gaps.data_ptr(), raw_len.data_ptr(),
        *(t.data_ptr() for t in outs), nb, bs, seg, F.compress_bound(seg),
        window_limit(window), accel, _build.stream(raw.device)),
        "parse_seg_deep")
    launches += 1
    return outs


def parse_segments_deep_plain(raw, cand, gaps, raw_len, seg: int = 4096,
                              window: int = 65536, accel: int = 1):
    """Plain PyTorch K8-seg: K3's lockstep plain parse with the best-of-3
    probe and one-step lazy deferral."""
    return parse_segments_plain(raw, cand, raw_len, seg, window, accel,
                                gaps=gaps)

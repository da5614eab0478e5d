"""K7, the whole-block greedy parse of the enc3 engine: CUDA kernel
wrapper and plain version.

``parse_blocks_enc3`` launches ``csrc/parse_enc3.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel`` in
block-per-lane mode) for a CUDA tensor and runs ``parse_blocks_enc3_plain``
for a CPU tensor.

Contract: per block, ``golden.compress_dense(block, accel, hashlog=16)``
(``lz4_sgori_tpu/golden.py:1028-1141``) over K2's candidates. That equals
K3's parse over one segment spanning the whole block plus the terminal
literal-only sequence, which is how the plain version computes it. Both
return

  out uint8 [B, compress_bound(block_size) + 8] (zero past out_len),
  out_len int32 [B], err bool [B], tails int32 [B] (the stream offset
  of the terminal sequence, ``golden.tail_offset``), nseq int32 [B]
  (sequences with a match).

A block whose stream would pass ``compress_bound(block_size)`` sets
``err`` and has an all-zero row and 0 in ``out_len``, ``tails`` and
``nseq``. Blocks are at most 64 KiB (K2's limit).

The CUDA kernel is K8-enc3's warp walk (``csrc/parse_enc3_warp.cuh``) at
one candidate a probe: a warp a block, the block in shared memory by one
``cp.async.bulk``, the cand tape through a ring of ``cp.async`` chunks,
32 probes of the skip schedule a round (the first hit by ballot), 32
bytes of catch-up and 128 of extension a step, the stream staged on chip
and stored once into the zeroed row. Each block takes a CTA of its own
(one warp).
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build
from .cand import MAX_BLOCK
from .parse_seg import _lsic_len, check_parse_args, parse_segments_plain

launches = 0
ENTRIES = {"lz4t_parse_enc3": "ppppppppiiiiip"}   # the C entry


def load_kernel():
    """Build (once) and load csrc/parse_enc3.cu."""
    return _build.load("parse_enc3", ENTRIES)


def check_block_size(raw: torch.Tensor) -> None:
    if raw.shape[1] > MAX_BLOCK:
        raise ValueError(f"blocks above {MAX_BLOCK} bytes go through "
                         "seg_splice")


def block_outputs(nb: int, bs: int, dev):
    """The outputs of a whole-block parse kernel (K7, K8-enc3), allocated
    on ``dev``: out (zeroed), out_len, err, tails, nseq."""
    out = torch.zeros((nb, F.compress_bound(bs) + 8), dtype=torch.uint8,
                      device=dev)
    out_len, tails, nseq = (torch.empty(nb, dtype=torch.int32, device=dev)
                            for _ in range(3))
    err = torch.empty(nb, dtype=torch.bool, device=dev)
    return out, out_len, err, tails, nseq


def parse_blocks_enc3(raw: torch.Tensor, cand: torch.Tensor,
                      raw_len: torch.Tensor, accel: int = 1):
    """Parse every block whole (K7)."""
    global launches
    check_parse_args(raw, cand, raw_len)
    check_block_size(raw)
    accel = max(int(accel), 1)
    if raw.device.type == "cpu":
        return parse_blocks_enc3_plain(raw, cand, raw_len, accel)
    raw, cand, raw_len = raw.contiguous(), cand.contiguous(), \
        raw_len.contiguous()
    nb, bs = raw.shape
    cap = F.compress_bound(bs)
    lib = load_kernel()
    out, out_len, err, tails, nseq = block_outputs(nb, bs, raw.device)
    _build.check(lib.lz4t_parse_enc3(
        raw.data_ptr(), cand.data_ptr(), raw_len.data_ptr(), out.data_ptr(),
        out_len.data_ptr(), err.data_ptr(), tails.data_ptr(),
        nseq.data_ptr(), nb, bs, cap + 8, cap, accel,
        _build.stream(raw.device)), "parse_enc3")
    launches += 1
    return out, out_len, err, tails, nseq


def parse_blocks_enc3_plain(raw, cand, raw_len, accel: int = 1, gaps=None,
                            gaps2=None, mcode=None):
    """Plain PyTorch K7: K3's plain parse at ``seg = block_size``, then the
    terminal sequence placed by a per-byte select. With ``gaps`` (and
    ``gaps2``) the parse is K8's deep parse (depth 3, or 5); with
    ``mcode`` it is K10's mlen parse."""
    nb, bs = raw.shape
    dev = raw.device
    i64 = torch.int64
    cap = F.compress_bound(bs)
    streams, slen, serr, last_end, nseq, _, _ = parse_segments_plain(
        raw, cand, raw_len, seg=bs, window=65536, accel=accel, gaps=gaps,
        gaps2=gaps2, mcode=mcode)
    n = raw_len.to(i64).clamp(0, bs)
    tpos = slen.to(i64)[:, None]
    anchor = last_end.to(i64)[:, None]
    lit = n[:, None] - anchor
    hlen = 1 + _lsic_len(lit)
    total = tpos + hlen + lit
    err = (serr != 0) | (total[:, 0] > cap)

    o = torch.arange(cap + 8, dtype=i64, device=dev)[None, :]
    rel = o - tpos
    hdr = torch.where(rel == 0, lit.clamp(max=15) << 4,
                      torch.where(rel < hlen - 1, 255, (lit - 15) % 255))
    lit_b = torch.gather(raw.to(i64), 1,
                         (anchor + rel - hlen).clamp(0, bs - 1))
    body = torch.gather(streams.to(i64), 1, o.clamp(max=cap - 1).expand(
        nb, -1))
    val = torch.where(o < tpos, body,
                      torch.where(rel < hlen, hdr,
                                  torch.where(o < total, lit_b, 0)))
    keep = ~err[:, None]
    out = torch.where(keep, val, 0).to(torch.uint8)
    zero = torch.zeros_like(slen)
    return (out, torch.where(err, zero, total[:, 0].to(torch.int32)), err,
            torch.where(err, zero, slen), torch.where(err, zero, nseq))

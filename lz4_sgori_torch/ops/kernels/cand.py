"""K2, pass-1 dense candidates: CUDA kernel wrapper and plain version.

``dense_candidates`` launches ``csrc/cand.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel``, greedy mode)
for a CUDA tensor and runs ``dense_candidates_plain`` for a CPU tensor.

Contract: ``golden.dense_candidates(block, hashlog=16,
val16_filter=False)`` for every row, as plain int32 offsets
``cand [B, block_size]`` (the TPU packs ``p << 16 | d16``; positions are
implicit here). Blocks are at most 64 KiB.
"""

from __future__ import annotations

import torch

from lz4_sgori_tpu import format as F

from . import _build

launches = 0
MAX_BLOCK = 65536


def load_kernel():
    """Build (once) and load csrc/cand.cu."""
    return _build.load("cand", {"lz4t_cand": "pppiip"})


def _check(raw: torch.Tensor, raw_len: torch.Tensor) -> None:
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise TypeError("raw must be uint8 [B, block_size]")
    if raw_len.dtype != torch.int32 or raw_len.shape != raw.shape[:1]:
        raise TypeError("raw_len must be int32 [B]")
    if raw_len.device != raw.device:
        raise ValueError("raw and raw_len must be on one device")
    if raw.shape[1] > MAX_BLOCK:
        raise ValueError(f"blocks above {MAX_BLOCK} bytes need the "
                         "piecewise pass 1 (ROADMAP Queue 2 K9)")


def dense_candidates(raw: torch.Tensor, raw_len: torch.Tensor):
    """Per-position offset to the latest earlier equal-hash16 position."""
    global launches
    _check(raw, raw_len)
    if raw.device.type == "cpu":
        return dense_candidates_plain(raw, raw_len)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    raw = raw.contiguous()
    raw_len = raw_len.contiguous()
    nb, bs = raw.shape
    cand = torch.empty((nb, bs), dtype=torch.int32, device=raw.device)
    lib = load_kernel()
    _build.check(lib.lz4t_cand(raw.data_ptr(), raw_len.data_ptr(),
                               cand.data_ptr(), nb, bs,
                               _build.stream(raw.device)), "cand")
    launches += 1
    return cand


def hash16(v: torch.Tensor) -> torch.Tensor:
    """``format.hash4(v, 16)`` on int64 words in [0, 2^32), without
    overflowing int64: (v * prime) mod 2^32 from its 16-bit halves."""
    lo = v & 0xFFFF
    hi = v >> 16
    prod = lo * F.HASH4_PRIME + (((hi * F.HASH4_PRIME) & 0xFFFF) << 16)
    return (prod & 0xFFFFFFFF) >> 16


def dense_candidates_plain(raw: torch.Tensor, raw_len: torch.Tensor):
    """Plain PyTorch pass 1: a stable sort of (hash, position) keys per
    block; a position's candidate is its predecessor in the same bucket."""
    nb, bs = raw.shape
    dev = raw.device
    b = raw.to(torch.int64)
    pad = torch.zeros((nb, 3), dtype=torch.int64, device=dev)
    bp = torch.cat([b, pad], dim=1)
    v = bp[:, :bs] | (bp[:, 1:bs + 1] << 8) | (bp[:, 2:bs + 2] << 16) \
        | (bp[:, 3:bs + 3] << 24)
    pos = torch.arange(bs, dtype=torch.int64, device=dev).expand(nb, bs)
    act = pos < (raw_len.to(torch.int64)[:, None] - 3)
    h = torch.where(act, hash16(v), 1 << 16)        # inactive: own bucket
    key = (h << 17) | pos
    skey, _ = torch.sort(key, dim=1)
    sh = skey >> 17
    sp = skey & 0x1FFFF
    same = torch.zeros_like(sh, dtype=torch.bool)
    same[:, 1:] = sh[:, 1:] == sh[:, :-1]
    prev = torch.zeros_like(sp)
    prev[:, 1:] = sp[:, :-1]
    d_sorted = torch.where(same & (sh < (1 << 16)), sp - prev, 0)
    cand = torch.zeros((nb, bs), dtype=torch.int64, device=dev)
    cand.scatter_(1, sp, d_sorted)
    return cand.to(torch.int32)

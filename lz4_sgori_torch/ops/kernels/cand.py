"""K2, pass-1 dense candidates: CUDA kernel wrapper and plain version.

``dense_candidates`` launches ``csrc/cand.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel``, greedy mode)
for a CUDA tensor and runs ``dense_candidates_plain`` for a CPU tensor.

Contract: ``golden.dense_candidates(block, hashlog=16,
val16_filter=False)`` for every row, as plain int32 offsets
``cand [B, block_size]`` (the TPU packs ``p << 16 | d16``; positions are
implicit here). Blocks are at most 64 KiB.

The CUDA kernel (``csrc/cand_part.cuh``) copies a block into shared
memory with one ``cp.async.bulk`` and splits the 2^16-entry table (128
KiB of shared memory) by bucket over a CTA of 8 warps: every warp hashes
the whole block, queues the positions of its own buckets in order and
steps the table 32 of them at a time, so a position's candidate still
comes from the latest earlier position of its bucket. One CTA an SM takes
blocks in turn, the next block's copy in flight for blocks of 32 KiB and
less, and clears between blocks only the buckets the last one used (16
KiB and less) or the whole table. A card that refuses the shared memory
fails the launch, which raises.
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build

launches = 0
MAX_BLOCK = 65536
ENTRIES = {"lz4t_cand": "pppiip"}   # the C entry


def load_kernel():
    """Build (once) and load csrc/cand.cu."""
    return _build.load("cand", ENTRIES)


def check_cand_args(raw: torch.Tensor, raw_len: torch.Tensor) -> None:
    """The input checks of both pass-1 wrappers (K2 and K9)."""
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise TypeError("raw must be uint8 [B, block_size]")
    if raw_len.dtype != torch.int32 or raw_len.shape != raw.shape[:1]:
        raise TypeError("raw_len must be int32 [B]")
    if raw_len.device != raw.device:
        raise ValueError("raw and raw_len must be on one device")
    if raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {raw.device}")


def dense_candidates(raw: torch.Tensor, raw_len: torch.Tensor):
    """Per-position offset to the latest earlier equal-hash16 position."""
    global launches
    check_cand_args(raw, raw_len)
    if raw.shape[1] > MAX_BLOCK:
        raise ValueError(f"blocks above {MAX_BLOCK} bytes need the "
                         "piecewise pass 1: cand_piecewise."
                         "dense_candidates_piecewise (K9)")
    if raw.device.type == "cpu":
        return dense_candidates_plain(raw, raw_len)
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


def read32_words(b: torch.Tensor, width: int) -> torch.Tensor:
    """Little-endian read32 at positions [0, width) of int64 byte rows
    ``b [R, >= width + 3]``."""
    return b[:, :width] | (b[:, 1:width + 1] << 8) \
        | (b[:, 2:width + 2] << 16) | (b[:, 3:width + 3] << 24)


def bucket_offsets(v: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Per row of read32 words ``v int64 [R, W]`` (W <= 2^17), the offset
    of each active position to the latest earlier active position of the
    same hash16 bucket, else 0: a stable sort of (hash, position) keys,
    where a position's candidate is its predecessor in the same bucket."""
    pos = torch.arange(v.shape[1], dtype=torch.int64,
                       device=v.device).expand_as(v)
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
    return torch.zeros_like(sp).scatter_(1, sp, d_sorted)


def dense_candidates_plain(raw: torch.Tensor, raw_len: torch.Tensor):
    """Plain PyTorch pass 1: ``bucket_offsets`` over each whole block."""
    nb, bs = raw.shape
    bp = torch.nn.functional.pad(raw.to(torch.int64), (0, 3))
    pos = torch.arange(bs, dtype=torch.int64, device=raw.device)
    act = pos[None, :] < (raw_len.to(torch.int64)[:, None] - 3)
    return bucket_offsets(read32_words(bp, bs), act).to(torch.int32)

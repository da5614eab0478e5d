"""T1, the retired greedy level-1 LZ4 block encoder: CUDA kernel wrapper
and plain version.

``compress_blocks_retired`` launches ``csrc/retired_encode.cu`` (the port
of ``tools/retired/encode_kernel.py:_encode_kernel``) for a CUDA tensor
and runs ``compress_blocks_retired_plain`` for a CPU tensor.

Contract: row j of ``comp uint8 [B, compress_bound(block_size)]`` holds
``golden.compress(raw[j, :n], acceleration)`` and is zero past
``comp_len[j]``, where n is ``raw_len[j]`` clamped to ``[0,
block_size]``. Blocks are at most 64 KiB, where golden's table is the
13-bit hash4 table of ``LZ4_compress_default``, so every row is liblz4's
``LZ4_compress_fast(acceleration)`` byte for byte. No read reaches past
``raw_len``: the caller's bytes there never matter.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import format as F
from .. import golden
from ..ops.kernels import _build
from ..ops.kernels.cand import check_cand_args

launches = 0
# LZ4_compress_fast's ceiling. Any acceleration above 65,536 gives a step
# that passes the end of a 64 KiB block after the first probe, so the
# clamp changes no byte.
MAX_ACCELERATION = 65537


def load_kernel():
    """Build (once) and load csrc/retired_encode.cu."""
    return _build.load("retired_encode", {"lz4t_retired_encode": "ppppiiiip"})


def compress_blocks_retired(raw: torch.Tensor, raw_len: torch.Tensor,
                            block_size: int, acceleration: int = 1):
    """Encode a batch of LZ4 blocks with the retired greedy encoder (T1).
    Returns ``(comp uint8 [B, compress_bound(block_size)], comp_len int32
    [B])``."""
    global launches
    if not 0 < block_size <= F.RETIRED_MAX_BLOCK:
        raise ValueError(f"block_size must be in [1, {F.RETIRED_MAX_BLOCK}] "
                         f"(the retired encoder's bound), got {block_size}")
    check_cand_args(raw, raw_len)
    if raw.shape[1] != block_size:
        raise TypeError(f"raw must be uint8 [B, {block_size}], got "
                        f"{tuple(raw.shape)}")
    acceleration = min(max(1, int(acceleration)), MAX_ACCELERATION)
    if raw.device.type == "cpu":
        return compress_blocks_retired_plain(raw, raw_len, block_size,
                                             acceleration)
    lib = load_kernel()
    raw = raw.contiguous()
    raw_len = raw_len.contiguous()
    nb = raw.shape[0]
    cb = F.compress_bound(block_size)
    comp = torch.empty((nb, cb), dtype=torch.uint8, device=raw.device)
    comp_len = torch.empty(nb, dtype=torch.int32, device=raw.device)
    _build.check(lib.lz4t_retired_encode(
        raw.data_ptr(), raw_len.data_ptr(), comp.data_ptr(),
        comp_len.data_ptr(), nb, block_size, cb, acceleration,
        _build.stream(raw.device)), "retired_encode")
    launches += 1
    return comp, comp_len


def compress_blocks_retired_plain(raw: torch.Tensor, raw_len: torch.Tensor,
                                  block_size: int, acceleration: int = 1):
    """Plain version: ``golden.compress`` one row at a time, packed into
    the kernel's tensors (on the input's device)."""
    rows = raw.cpu().numpy()
    lens = raw_len.clamp(0, block_size).tolist()
    comp = np.zeros((len(lens), F.compress_bound(block_size)), np.uint8)
    comp_len = np.zeros(len(lens), np.int32)
    for j, n in enumerate(lens):
        c = golden.compress(rows[j, :n].tobytes(), acceleration)
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        comp_len[j] = len(c)
    return (torch.from_numpy(comp).to(raw.device),
            torch.from_numpy(comp_len).to(raw.device))

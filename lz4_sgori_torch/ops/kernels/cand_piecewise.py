"""K9, piecewise pass-1 candidates for blocks above 64 KiB: CUDA kernel
wrapper and plain version.

``dense_candidates_piecewise`` launches ``csrc/cand_piecewise.cu`` (the
port of ``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_piecewise_cand``,
which drives ``_cand_kernel``) for a CUDA tensor and runs
``dense_candidates_piecewise_plain`` for a CPU tensor.

Contract: ``golden.dense_candidates_piecewise(block, piece, hashlog=16)``
for every row, as int32 offsets ``cand [B, block_size]``. With
``H = piece // 2``, that is, for p in half-piece ``h = p // H``, the
offset to the latest earlier equal-hash16 position in
``[max(0, (h - 1) * H), p)`` (positions with a full read32 only): the
piece pass and the half-shifted straddle pass of the TPU engine, merged
nearer-first, in one window per position (``csrc/cand_piecewise.cu``).
``piece`` is 65,536 on the engine's path; tests pass smaller pieces to
cross many boundaries on small inputs.

The CUDA kernel (``csrc/cand_part.cuh``, K2's split table) gives a CTA a
run of consecutive half-pieces of one block: each half-piece's bytes are
staged in shared memory by a bulk copy, every position of the run (and
of the half-piece before it) is hashed once, and a sweep at each
half-piece boundary rebases the table and empties it below the next
window's floor. The run length comes from the grid's waves on the card
(``run_length``): a CTA a 1 MiB block over 128 MiB, a CTA a half-piece
for a single request. A card that refuses the shared memory fails the
launch, which raises.
"""

from __future__ import annotations

import torch

from . import _build
from .cand import bucket_offsets, check_cand_args, read32_words

launches = 0
PIECE = 65536
ENTRIES = {"lz4t_cand_piecewise": "pppiiip"}   # the launch's C entry


def load_kernel():
    """Build (once) and load csrc/cand_piecewise.cu."""
    return _build.load("cand_piecewise",
                       {**ENTRIES, "lz4t_cand_piecewise_run": "iii"})


def run_length(nb: int, bs: int, piece: int = PIECE) -> int:
    """The half-pieces a CTA walks in a launch over ``nb`` blocks of
    ``bs`` bytes on this card (``cand_part::Runs``)."""
    _check_piece(piece)
    r = load_kernel().lz4t_cand_piecewise_run(nb, bs, piece // 2)
    if r < 1:
        _build.check(-r or 1, "cand_piecewise_run")
    return r


def _check_piece(piece: int) -> None:
    if piece % 64 or not 64 <= piece <= PIECE:
        raise ValueError(f"piece {piece} must be a multiple of 64 in "
                         f"[64, {PIECE}]")


def dense_candidates_piecewise(raw: torch.Tensor, raw_len: torch.Tensor,
                               piece: int = PIECE):
    """Per-position offset to the latest equal-hash16 position of the
    position's piecewise window (K9)."""
    global launches
    check_cand_args(raw, raw_len)
    _check_piece(piece)
    if raw.device.type == "cpu":
        return dense_candidates_piecewise_plain(raw, raw_len, piece)
    raw = raw.contiguous()
    raw_len = raw_len.contiguous()
    nb, bs = raw.shape
    cand = torch.empty((nb, bs), dtype=torch.int32, device=raw.device)
    lib = load_kernel()
    _build.check(lib.lz4t_cand_piecewise(
        raw.data_ptr(), raw_len.data_ptr(), cand.data_ptr(), nb, bs,
        piece // 2, _build.stream(raw.device)), "cand_piecewise")
    launches += 1
    return cand


def dense_candidates_piecewise_plain(raw: torch.Tensor, raw_len: torch.Tensor,
                                     piece: int = PIECE):
    """Plain PyTorch version: one row per (block, half-piece h), the bytes
    ``raw[(h-1)*H : (h+1)*H + 3]`` (zero outside the block), through K2's
    plain sort (``cand.bucket_offsets``); the second half of each row is
    half-piece h's output. A position is active when it lies in the block
    and has a full read32 (``p < raw_len - 3``, the JAX pass's clipped
    length): the ``+ 3`` suffix keeps the row's last three positions off
    the zero padding."""
    _check_piece(piece)
    nb, bs = raw.shape
    dev = raw.device
    half = piece // 2
    nh = -(-bs // half)
    b = torch.nn.functional.pad(raw.to(torch.int64),
                                (half, nh * half + 3 - bs))
    rows = b.unfold(1, 2 * half + 3, half).reshape(nb * nh, 2 * half + 3)
    g = ((torch.arange(nh, dtype=torch.int64, device=dev)[:, None] - 1)
         * half + torch.arange(2 * half, dtype=torch.int64, device=dev))
    act = (g >= 0) & (g < raw_len.to(torch.int64)[:, None, None] - 3)
    d = bucket_offsets(read32_words(rows, 2 * half),
                       act.reshape(nb * nh, 2 * half))
    return d[:, half:].reshape(nb, nh * half)[:, :bs].to(torch.int32)

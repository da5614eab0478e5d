"""Shared vector primitives of the plain PyTorch codec paths.

Port of ``lz4_sgori_tpu/ops/primitives.py``: clipped gathers, prefix and
suffix scans, little-endian word assembly and segment expansion. All
functions work on the last axis, broadcast over leading axes, and take
and return int64 tensors (torch gathers index with int64).
"""

from __future__ import annotations

import torch


def take1(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``arr[..., idx]`` along the last axis with index clipping."""
    idx = idx.clamp(0, arr.shape[-1] - 1)
    if idx.shape[:-1] != arr.shape[:-1]:
        idx = idx.expand(*arr.shape[:-1], idx.shape[-1])
    return torch.gather(arr, -1, idx)


def shift_left(arr: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``out[..., i] = arr[..., i + k]``, filling the tail with `fill`."""
    if k == 0:
        return arr
    pad = torch.full(arr.shape[:-1] + (k,), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr[..., k:], pad], dim=-1)


def next_false_index(mask: torch.Tensor) -> torch.Tensor:
    """``nn[..., i]`` = smallest ``j >= i`` with ``mask[..., j] == False``;
    ``M`` (one past the end) where the mask is True through the end."""
    m = mask.shape[-1]
    idx = torch.arange(m, dtype=torch.int64, device=mask.device)
    cand = torch.where(mask, torch.full_like(idx, m), idx)
    rev = torch.flip(cand, dims=[-1])
    return torch.flip(torch.cummin(rev, dim=-1).values, dims=[-1])


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis."""
    return torch.cumsum(x, dim=-1) - x


def le_word(b: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Little-endian word starting at every byte position (zeros read
    past the end)."""
    w = b
    for k in range(1, nbytes):
        w = w | (shift_left(b, k, 0) << (8 * k))
    return w


def segment_ids(starts: torch.Tensor, valid: torch.Tensor,
                n: int) -> torch.Tensor:
    """Map each position ``o in [0, n)`` to the index of its segment:
    ``max{k valid : starts[k] <= o}``, by a scatter-add at segment heads
    and a prefix sum."""
    lead = starts.shape[:-1]
    counts = torch.zeros(lead + (n + 1,), dtype=torch.int64,
                         device=starts.device)
    clipped = torch.where(valid, starts.clamp(0, n), n)
    counts.scatter_add_(-1, clipped, valid.to(torch.int64))
    seg = torch.cumsum(counts[..., :n], dim=-1) - 1
    return seg.clamp(min=0)



# Positions (rows x row width) a batched plain engine takes at a time: the
# xla encode's int64 temporaries peak near 300 bytes a position (some 2.4
# GB a batch), its decode's near 170.
BATCH_POSITIONS = 1 << 23


def in_batches(fn, *tensors):
    """``fn(*tensors)`` on runs of rows of at most ``BATCH_POSITIONS``
    positions of ``tensors[0]`` (one row at least), its outputs (a tuple
    of tensors) concatenated along dim 0."""
    nb, width = tensors[0].shape[:2]
    rows = max(1, BATCH_POSITIONS // max(1, width))
    if nb <= rows:
        return fn(*tensors)
    parts = [fn(*(t[s:s + rows] for t in tensors))
             for s in range(0, nb, rows)]
    return tuple(torch.cat(ts) for ts in zip(*parts))

"""The chain-gaps tapes of the deep modes (K8's pass 1): CUDA kernel
wrapper and plain version.

``chain_gaps`` launches ``csrc/gaps.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_cand_kernel`` with
``depth > 1`` and ``gaps2_only``, and of ``_piecewise_cand``'s gaps) for a
CUDA tensor and runs ``chain_gaps_plain`` for a CPU tensor.

Both follow the candidate tape itself along one hash chain instead of
sorting: q1 = p - cand[p], g2 = cand[q1], q2 = q1 - g2, g3 = cand[q2],
and so on. A link is kept only while every link so far lies in
[1, 254] and at or above the floor of the pass that supplied cand[p]
(see ``csrc/gaps.cu``). The kernel takes four positions a thread and
issues their four chains' gathers together, a link step at a time.
Contract:

- ``half = 0``, over K2's tape: ``golden.dense_gaps`` (g2 | g3 << 8) and,
  with ``links = 4``, ``golden.dense_gaps2`` (g4 | g5 << 8);
- ``half = piece // 2``, over K9's tape: the gaps of
  ``golden.dense_candidates_piecewise(..., with_gaps=True)``.

Returns ``(gaps, gaps2)``, int32 ``[B, block_size]`` each; ``gaps2`` is
None unless ``links = 4``.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0
MAX_GAP = 254
ENTRIES = {"lz4t_gaps": "pppiiip"}     # the C entry


def load_kernel():
    """Build (once) and load csrc/gaps.cu."""
    return _build.load("gaps", ENTRIES)


def chain_gaps(cand: torch.Tensor, links: int = 2, half: int = 0):
    """Chain gaps of every position (``links`` 2: gaps; 4: gaps and
    gaps2) over K2's (``half`` 0) or K9's (``half`` = piece // 2) tape."""
    global launches
    if cand.dtype != torch.int32 or cand.dim() != 2:
        raise TypeError("cand must be int32 [B, block_size]")
    if links not in (2, 4):
        raise ValueError(f"links must be 2 or 4, got {links}")
    if half < 0:
        raise ValueError(f"half must be >= 0, got {half}")
    if cand.device.type == "cpu":
        return chain_gaps_plain(cand, links, half)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    cand = cand.contiguous()
    nb, bs = cand.shape
    gaps = torch.empty_like(cand)
    gaps2 = torch.empty_like(cand) if links == 4 else None
    lib = load_kernel()
    _build.check(lib.lz4t_gaps(
        cand.data_ptr(), gaps.data_ptr(),
        gaps2.data_ptr() if gaps2 is not None else None, nb, bs, half,
        _build.stream(cand.device)), "gaps")
    launches += 1
    return gaps, gaps2


def chain_floor(cand: torch.Tensor, half: int) -> torch.Tensor:
    """The lowest position a chain link may reach, per position: 0 on
    K2's tape; on K9's, the base of the pass that supplied cand[p] (for p
    in half-piece h: 0 for h = 0, (h-1)*half for odd h, and for even h the
    piece pass's h*half when q1 = p - cand[p] lies in it, which wins the
    tie, else the straddle pass's (h-1)*half)."""
    nb, bs = cand.shape
    if half == 0:
        return torch.zeros((1, bs), dtype=torch.int64, device=cand.device)
    p = torch.arange(bs, dtype=torch.int64, device=cand.device)[None, :]
    h = p // half
    q1 = p - cand.to(torch.int64)
    below = (h - 1).clamp(min=0) * half
    return torch.where((h % 2 == 0) & (q1 >= h * half), h * half, below)


def chain_gaps_plain(cand: torch.Tensor, links: int = 2, half: int = 0):
    """Plain PyTorch version: ``links`` gathers along the tape."""
    nb, bs = cand.shape
    c = cand.to(torch.int64)
    floor = chain_floor(cand, half)
    p = torch.arange(bs, dtype=torch.int64, device=cand.device)[None, :]
    q = p - c
    alive = (c > 0) & (q >= 0)
    g = []
    for _ in range(links):
        gk = torch.gather(c, 1, torch.where(alive, q, 0))
        qn = q - gk
        alive &= (gk >= 1) & (gk <= MAX_GAP) & (qn >= floor)
        g.append(torch.where(alive, gk, 0))
        q = torch.where(alive, qn, q)
    gaps = (g[0] | (g[1] << 8)).to(torch.int32)
    gaps2 = (g[2] | (g[3] << 8)).to(torch.int32) if links == 4 else None
    return gaps, gaps2

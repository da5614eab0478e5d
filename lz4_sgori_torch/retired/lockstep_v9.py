"""T3, the retired chained decoder (v9): CUDA kernel wrapper and plain
version.

``decompress_blocks_lockstep_v9`` deals the blocks into chains of
``chain`` (torch ops), decodes them with ``csrc/decode_v9.cu`` (the port
of ``tools/retired/lockstep_v9.py:_kernel``: one warp a chain, K1's walk
for each block in turn), and undoes the deal, for a CUDA tensor; for a
CPU tensor it runs ``decompress_blocks_lockstep_v9_plain``, which decodes
the dealt rows with K1's plain decoder.

Contract, per block: K1's ``(out uint8 [B, out_size], out_len int32 [B],
err bool [B])``, ``golden.decompress`` with an error row all zero (the
TPU leaves an error row's bytes unspecified). The deal changes no
result, only how evenly the chains are loaded: sort the blocks by cost,
``-comp_len`` or ``-sort_key``, with a stable argsort (``sort=False``:
input order); lay the order out as ``chain`` rows, reverse every odd
row (the snake); then column c is chain c. As on the TPU, ``out_size``
must be a multiple of ``format.V9_OUT_ALIGN``.
"""

from __future__ import annotations

import torch

from .. import format as F
from ..ops.kernels import _build
from ..ops.kernels.lockstep_v7 import (check_decode_args,
                                      decompress_blocks_plain)

launches = 0


def load_kernel():
    """Build (once) and load csrc/decode_v9.cu."""
    return _build.load("decode_v9", {"lz4t_decode_v9": "pppppiiiip"})


def deal(comp_len: torch.Tensor, chain: int, sort: bool = True,
         sort_key: torch.Tensor | None = None):
    """The snake deal of ``lockstep_v9.py:440-454``. The batch is padded
    to a multiple of ``chain`` with empty blocks (ids ``B`` and up; cost
    1, or 0 under a ``sort_key``, as the TPU pads). Returns ``(flat,
    inv)``: row i of the dealt batch is block ``flat[i]`` (chain c is rows
    ``c * chain`` to ``c * chain + chain - 1``), and ``inv`` undoes it."""
    nb = comp_len.shape[0]
    cols = -(-nb // chain)
    pad = cols * chain - nb
    dev = comp_len.device
    if sort:
        key = comp_len if sort_key is None else sort_key
        key = torch.cat([key.to(torch.int64), torch.full(
            (pad,), 1 if sort_key is None else 0, dtype=torch.int64,
            device=dev)])
        order = torch.argsort(-key, stable=True)
    else:
        order = torch.arange(nb + pad, device=dev)
    mat = order.reshape(chain, cols).clone()
    mat[1::2] = mat[1::2].flip(1)
    flat = mat.T.reshape(-1)
    return flat, torch.argsort(flat)


def _dealt(comp: torch.Tensor, comp_len: torch.Tensor, chain: int,
           sort: bool, sort_key: torch.Tensor | None):
    """The dealt batch (padded with empty blocks) and the rows of the
    dealt results that hold blocks 0 to B - 1."""
    nb, slot = comp.shape
    flat, inv = deal(comp_len, chain, sort, sort_key)
    pad = flat.shape[0] - nb
    comp = torch.cat([comp, comp.new_zeros((pad, slot))])[flat]
    comp_len = torch.cat([comp_len, comp_len.new_ones(pad)])[flat]
    return comp, comp_len, inv[:nb]


def decompress_blocks_lockstep_v9(comp: torch.Tensor, comp_len: torch.Tensor,
                                  out_size: int, chain: int = 4,
                                  sort: bool = True,
                                  sort_key: torch.Tensor | None = None):
    """Decode a batch of LZ4 blocks, ``chain`` blocks per warp (T3)."""
    global launches
    check_decode_args(comp, comp_len, out_size)
    if out_size % F.V9_OUT_ALIGN:
        raise ValueError("chained decode needs out_size aligned to the "
                         f"hot/flush bands ({F.V9_OUT_ALIGN}), got {out_size}")
    if chain < 1:
        raise ValueError(f"chain must be at least 1, got {chain}")
    if sort_key is not None and (
            sort_key.dtype not in (torch.int32, torch.int64)
            or sort_key.shape != comp_len.shape
            or sort_key.device != comp.device):
        raise TypeError("sort_key must be an integer [B] tensor on comp's "
                        "device")
    if comp.device.type == "cpu":
        return decompress_blocks_lockstep_v9_plain(comp, comp_len, out_size,
                                                   chain, sort, sort_key)
    lib = load_kernel()
    comp, comp_len, keep = _dealt(comp, comp_len, chain, sort, sort_key)
    rows, slot = comp.shape
    out = torch.empty((rows, out_size), dtype=torch.uint8, device=comp.device)
    out_len = torch.empty(rows, dtype=torch.int32, device=comp.device)
    err = torch.empty(rows, dtype=torch.bool, device=comp.device)
    _build.check(lib.lz4t_decode_v9(
        comp.data_ptr(), comp_len.data_ptr(), out.data_ptr(),
        out_len.data_ptr(), err.data_ptr(), rows // chain, chain, slot,
        out_size, _build.stream(comp.device)), "decode_v9")
    launches += 1
    return out[keep], out_len[keep], err[keep]


def decompress_blocks_lockstep_v9_plain(comp: torch.Tensor,
                                        comp_len: torch.Tensor, out_size: int,
                                        chain: int = 4, sort: bool = True,
                                        sort_key: torch.Tensor | None = None):
    """Plain version (on the input's device): the deal, K1's plain
    decoder over the dealt rows, then the inverse permutation."""
    comp, comp_len, keep = _dealt(comp, comp_len, chain, sort, sort_key)
    out, out_len, err = decompress_blocks_plain(comp, comp_len, out_size)
    return out[keep], out_len[keep], err[keep]

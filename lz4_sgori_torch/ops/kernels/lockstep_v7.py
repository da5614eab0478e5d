"""K1, the safe LZ4 block decoder: CUDA kernel wrapper and plain version.

``decompress_blocks_v7`` launches ``csrc/decode_v7.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_v7.py:_kernel``) for a CUDA tensor
and runs ``decompress_blocks_plain`` for a CPU tensor. The kernel is
K6's walk (``csrc/lz4_decode_ring.cuh``): a CTA a block, the stream
staged into shared memory by ``cp.async.bulk``, up to 32 sequences a
batch; at ``out_size`` 64 KiB and below the block's whole output stays in
shared memory and the CTA writes the row once at the end (two CTAs an
SM), above it K6's 128 KiB history ring.

``decompress_blocks_plain`` is the port of the JAX package's portable
decoder ``lz4_sgori_tpu/ops/decode.py:_decompress_blocks_impl``: a
speculative parse at every byte position, the sequence chain by pointer
doubling, literal placement by segment expansion, and match resolution
to a fixpoint (see that module's docstring).

Both return ``(out uint8 [B, out_size], out_len int32 [B], err bool
[B])``; ``err`` is set exactly when ``golden.decompress`` raises, and an
erroneous block has ``out_len`` 0 and an all-zero row. ``comp`` is
zero-padded past ``comp_len``; a ``comp_len`` outside ``[1, slot]`` is an
error.
"""

from __future__ import annotations

import torch

from ... import format as F
from ..primitives import (exclusive_cumsum, next_false_index, segment_ids,
                          shift_left, take1)
from . import _build

launches = 0
ENTRIES = {"lz4t_decode_v7": "pppppiiip"}   # the C entry's signature


def load_kernel():
    """Build (once) and load csrc/decode_v7.cu."""
    return _build.load("decode_v7", ENTRIES)


def check_decode_args(comp: torch.Tensor, comp_len: torch.Tensor,
                      out_size: int) -> None:
    """The input checks of the decode wrappers (K1, K5 and K6)."""
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise TypeError(f"comp must be uint8 [B, slot], got {comp.dtype} "
                        f"{tuple(comp.shape)}")
    if comp_len.dtype != torch.int32 or comp_len.shape != comp.shape[:1]:
        raise TypeError("comp_len must be int32 [B]")
    if comp_len.device != comp.device:
        raise ValueError("comp and comp_len must be on one device")
    if not 0 < out_size <= F.MAX_INPUT_SIZE:
        raise ValueError(f"out_size out of range: {out_size}")
    if comp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {comp.device}")


def launch_decode(entry, comp: torch.Tensor, comp_len: torch.Tensor,
                  out_size: int):
    """Launch a decode kernel's C entry (the ``lz4t_decode_*`` signature)
    on CUDA tensors."""
    comp = comp.contiguous()
    comp_len = comp_len.contiguous()
    nb, slot = comp.shape
    out = torch.empty((nb, out_size), dtype=torch.uint8, device=comp.device)
    out_len = torch.empty(nb, dtype=torch.int32, device=comp.device)
    err = torch.empty(nb, dtype=torch.bool, device=comp.device)
    _build.check(entry(comp.data_ptr(), comp_len.data_ptr(), out.data_ptr(),
                       out_len.data_ptr(), err.data_ptr(), nb, slot,
                       out_size, _build.stream(comp.device)), entry.__name__)
    return out, out_len, err


def decompress_blocks_v7(comp: torch.Tensor, comp_len: torch.Tensor,
                         out_size: int):
    """Decode a batch of LZ4 blocks (K1)."""
    global launches
    check_decode_args(comp, comp_len, out_size)
    if comp.device.type == "cpu":
        return decompress_blocks_plain(comp, comp_len, out_size)
    res = launch_decode(load_kernel().lz4t_decode_v7, comp, comp_len,
                        out_size)
    launches += 1
    return res


def _parse_all_positions(b: torch.Tensor, comp_len: torch.Tensor):
    """Speculative sequence parse at every byte position.
    b: [B, M] int64 bytes; comp_len: [B, 1]."""
    m = b.shape[-1]
    i = torch.arange(m, dtype=torch.int64, device=b.device).expand_as(b)
    nn = next_false_index(b == 255)

    lit_nib = b >> 4
    ml_nib = b & 15

    nn1 = shift_left(nn, 1, m)
    k1 = nn1 - (i + 1)
    last1 = take1(b, nn1)
    lit15 = lit_nib == F.RUN_MASK
    lit_len = torch.where(lit15, F.RUN_MASK + 255 * k1 + last1, lit_nib)
    lit_hdr = torch.where(lit15, 1 + k1, 0)

    ls = i + 1 + lit_hdr
    le = ls + lit_len
    off = take1(b, le) | (take1(b, le + 1) << 8)

    q2 = le + 2
    nn2 = take1(nn, q2)
    k2 = nn2 - q2
    last2 = take1(b, nn2)
    ml15 = ml_nib == F.ML_MASK
    ml_len = F.MINMATCH + torch.where(ml15, F.ML_MASK + 255 * k2 + last2,
                                      ml_nib)
    ml_hdr = torch.where(ml15, 1 + k2, 0)
    nxt = q2 + ml_hdr

    terminal = le == comp_len
    lit_overrun = le > comp_len
    tail_overrun = ~terminal & (nxt > comp_len)
    return dict(lit_len=lit_len, ls=ls, le=le, off=off, ml_len=ml_len,
                nxt=nxt, terminal=terminal,
                parse_err=lit_overrun | tail_overrun)


def _sequence_chain(nxt: torch.Tensor, terminal: torch.Tensor, s_max: int):
    """Token positions by pointer doubling: [B, s_max], parked at the
    sentinel M-1 after the terminal sequence."""
    m = nxt.shape[-1]
    sent = m - 1
    i = torch.arange(m, dtype=torch.int64, device=nxt.device)
    f = torch.where(terminal, sent, nxt.clamp(max=sent))
    f = torch.where(i == sent, sent, f)
    p = torch.zeros(nxt.shape[:-1] + (1,), dtype=torch.int64,
                    device=nxt.device)
    while p.shape[-1] < s_max:
        p = torch.cat([p, take1(f, p)], dim=-1)
        if p.shape[-1] < s_max:
            f = take1(f, f)
    return p[..., :s_max]


def decompress_blocks_plain(comp: torch.Tensor, comp_len: torch.Tensor,
                            out_size: int, max_sequences: int | None = None):
    """Plain PyTorch decoder (port of ``_decompress_blocks_impl``)."""
    if max_sequences is None:
        max_sequences = F.worst_case_sequences(out_size)
    n = out_size
    b = comp.to(torch.int64)
    clen = comp_len.to(torch.int64)[:, None]
    dev = b.device

    fields = _parse_all_positions(b, clen)
    p = _sequence_chain(fields["nxt"], fields["terminal"], max_sequences)
    s = p.shape[-1]
    k = torch.arange(s, dtype=torch.int64, device=dev).expand_as(p)

    term_k = take1(fields["terminal"].to(torch.int64), p) == 1
    lit_len_k = take1(fields["lit_len"], p)
    ls_k = take1(fields["ls"], p)
    off_k = take1(fields["off"], p)
    ml_len_k = take1(fields["ml_len"], p)
    perr_k = take1(fields["parse_err"].to(torch.int64), p) == 1

    has_term = term_k.any(dim=-1)
    kstar = term_k.to(torch.int64).argmax(dim=-1)[:, None]

    live = k <= kstar
    mid = k < kstar
    adv = torch.where(mid, lit_len_k + ml_len_k,
                      torch.where(live, lit_len_k, 0))
    od = exclusive_cumsum(adv)
    out_len = adv.sum(dim=-1)

    mstart_k = od + lit_len_k
    err = (~has_term
           | (live & perr_k).any(dim=-1)
           | (live & (p >= clen)).any(dim=-1)
           | (mid & (off_k == 0)).any(dim=-1)
           | (mid & (off_k > mstart_k)).any(dim=-1)
           | (out_len > n)
           | (clen[:, 0] < 1) | (clen[:, 0] > comp.shape[1]))

    seg = segment_ids(od, live, n)
    o = torch.arange(n, dtype=torch.int64, device=dev).expand_as(seg)
    od_o = take1(od, seg)
    lit_len_o = take1(lit_len_k, seg)
    ls_o = take1(ls_k, seg)
    off_o = take1(off_k, seg).clamp(min=1)
    rel = o - od_o
    valid_o = o < out_len[:, None]
    in_lit = valid_o & (rel < lit_len_o)
    in_match = valid_o & ~in_lit
    out = torch.where(in_lit, take1(b, ls_o + rel), 0)

    # self-overlap collapses through the modulo form, so esrc always points
    # strictly before the match start; iterate to the fixpoint
    mstart_o = od_o + lit_len_o
    esrc = (mstart_o - off_o + torch.remainder(o - mstart_o, off_o)).clamp(
        0, n - 1)
    if bool(in_match.any()):
        while True:
            nxt = torch.where(in_match, take1(out, esrc), out)
            if not bool((nxt != out).any()):
                break
            out = nxt
    out = torch.where(valid_o & ~err[:, None], out, 0).to(torch.uint8)
    out_len = torch.where(err, 0, out_len).to(torch.int32)
    return out, out_len, err

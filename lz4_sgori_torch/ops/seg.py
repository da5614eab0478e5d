"""The seg and seg_big engines: segment-parallel block compress (kernels
K2 or K9, K3, K4 plus PyTorch glue; K10a and K10b in the mlen mode).

Port of ``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:
compress_blocks_lockstep_seg``. Byte contract per block:
``golden.compress_dense_seg(block, seg, window, hashlog=16,
acceleration, depth)`` for blocks of at most 64 KiB (engine seg), and
``golden.compress_dense_seg_big(block, seg, acceleration=..., depth)``
for blocks above 64 KiB, which must be 64 KiB multiples (engine
seg_big). Every depth above 1 is the deep parse at three candidates a
probe, as in golden. The mlen mode (depth 1, blocks of at most 64 KiB)
gives the same bytes by another route.

Pipeline: mask bytes past ``raw_len`` -> pass-1 candidates (K2 over the
whole block up to 64 KiB, K9's piecewise windows above) -> at depth > 1
the chain gaps of those candidates (the gaps kernel), in the mlen mode
the verified candidates and match codes (K10a) -> the per-segment parse
(K3, K8-seg at depth > 1, K10b in the mlen mode) -> owner run headers
and the assembly plan (glue) -> K4 assembly -> error fold. What only
the TPU needed is left out: the 128-lane group packing and tape layouts, the density
regrouping of segments (a permutation that is inverted again, so the
bytes never change), the VMEM-fit checks and barrier chains, the padded
piece and straddle copies of pass 1, the bitonic sort behind the gaps
tapes, and the dynamic_update_slice assembly fallback.
"""

from __future__ import annotations

import torch

from .. import format as F
from .kernels.asm_seg import assemble_segments
from .kernels.cand import dense_candidates
from .kernels.cand_piecewise import PIECE, dense_candidates_piecewise
from .kernels.gaps import chain_gaps
from .kernels.mcode import dense_mcode
from .kernels.parse_seg import parse_segments
from .kernels.parse_seg_deep import parse_segments_deep
from .kernels.parse_seg_mlen import parse_segments_mlen


def header_max(block_size: int) -> int:
    """Longest owner header: a literal run can span every bodiless
    segment of the block (260 bytes at 64 KiB)."""
    return 1 + max(block_size, 65536) // 255 + 2


def run_headers(p1, m1h, last_end, raw_len, block_size: int):
    """Owner run headers (token' + literal LSIC) of every segment
    (``lockstep_enc3.py:2197-2234``).

    p1, m1h, last_end: int32 [nb, nseg] from the parse; raw_len int32 [nb].
    Returns (hdr uint8 [nb*nseg, header_max], hlen int64 [nb, nseg]).
    The header bytes are built in uint8 (at 4 MiB, ``header_max`` is
    16,451 bytes for each of 128 segments a block).
    """
    nb, nseg = p1.shape
    dev = p1.device
    i64 = torch.int64
    p1, m1h, le = p1.to(i64), m1h.to(i64), last_end.to(i64)
    hasm = (m1h >> 16) != 0
    m1 = m1h & 0xFFFF
    kk = torch.arange(nseg, dtype=i64, device=dev).expand(nb, nseg)
    big = 1 << 20
    # the next segment with a match ends this segment's literal run
    idx = torch.where(hasm, kk, big)
    suf = torch.flip(torch.cummin(torch.flip(idx, [1]), dim=1).values, [1])
    nxt = torch.cat([suf[:, 1:], torch.full((nb, 1), big, dtype=i64,
                                            device=dev)], dim=1)
    has_nxt = nxt < big
    nxt_c = nxt.clamp(max=nseg - 1)
    run_end = torch.where(has_nxt, torch.gather(p1, 1, nxt_c),
                          raw_len.to(i64)[:, None])
    mcn = torch.where(has_nxt, torch.gather(m1, 1, nxt_c).clamp(max=15), 0)
    owner = hasm | (kk == 0)
    lrun = (run_end - le).clamp(min=0)
    q = lrun - F.RUN_MASK
    nff = q.clamp(min=0) // 255
    remb = q.clamp(min=0) - 255 * nff
    hlen = torch.where(owner, 1 + torch.where(q >= 0, nff + 1, 0), 0)
    tokp = (lrun.clamp(max=F.RUN_MASK) << F.ML_BITS) | mcn
    # byte j of a header: the token at 0, 255 in [1, nff], the LSIC
    # remainder at nff + 1, cut at hlen
    i32, u8 = torch.int32, torch.uint8
    hj = torch.arange(header_max(block_size), dtype=i32, device=dev)
    nff3 = nff.to(i32)[..., None]
    live = hj < hlen.to(i32)[..., None]
    hdr = ((hj <= nff3) & live).to(u8) * 255
    hdr = torch.where((hj == nff3 + 1) & live, remb.to(u8)[..., None], hdr)
    hdr[..., 0] = torch.where(hlen > 0, tokp, 0).to(u8)
    return hdr.reshape(nb * nseg, -1), hlen


def assembly_plan(slen, hlen, last_end, raw_len, seg: int):
    """K4's plan int32 [nb, nseg, 4]: per segment the stream length, the
    header length, and the raw tail [last_end, segment end) as start and
    length (``lockstep_enc3.py:2236-2267``)."""
    nseg = slen.shape[1]
    le = last_end.to(torch.int64)
    kk = torch.arange(nseg, dtype=torch.int64, device=le.device)[None, :]
    s1 = kk * seg + (raw_len.to(torch.int64)[:, None] - kk * seg).clamp(
        0, seg)
    return torch.stack([slen.to(torch.int64), hlen.to(torch.int64), le,
                        s1 - le], dim=2).to(torch.int32)


def assembly_inputs(raw: torch.Tensor, raw_len: torch.Tensor,
                    block_size: int, seg: int = 4096, window: int = 65536,
                    accel: int = 1, depth: int = 1, mlen: bool = False):
    """Every step of ``compress_blocks_seg`` before K4: the candidates,
    the parse, the run headers and the plan.

    Returns (streams, hdr, rawm, plan, ocap, serr, nseq): K4's arguments
    (``assemble_segments(streams, hdr, rawm, plan, ocap)``) and the
    parse's per-segment error flags and sequence counts.
    """
    if block_size % seg or block_size // seg > 128:
        raise ValueError("seg must divide block_size into at most 128 "
                         "segments")
    big = block_size > 65536
    if big and block_size % 65536:
        raise ValueError("blocks above 64 KiB must be multiples of 64 KiB "
                         "(piecewise pass-1 stretches)")
    if mlen and (depth > 1 or big):
        raise ValueError("the mlen mode runs depth 1 on blocks of at most "
                         "64 KiB")
    nb = raw.shape[0]
    nseg = block_size // seg
    dev = raw.device
    raw_len = raw_len.to(device=dev, dtype=torch.int32)
    rawm = raw[:, :block_size]
    cpos = torch.arange(block_size, device=dev)
    rawm = torch.where(cpos[None, :] < raw_len[:, None], rawm, 0).to(
        torch.uint8).contiguous()

    cand = (dense_candidates_piecewise(rawm, raw_len) if big
            else dense_candidates(rawm, raw_len))
    if depth > 1:
        gaps, _ = chain_gaps(cand, 2, PIECE // 2 if big else 0)
        parts = parse_segments_deep(rawm, cand, gaps, raw_len, seg=seg,
                                    window=window, accel=accel)
    elif mlen:
        cand_v, mcode = dense_mcode(cand, rawm, raw_len)
        parts = parse_segments_mlen(rawm, cand_v, mcode, raw_len, seg=seg,
                                    window=window, accel=accel)
    else:
        parts = parse_segments(rawm, cand, raw_len, seg=seg, window=window,
                               accel=accel)
    streams, slen, serr, last_end, nseq, p1, m1h = parts

    shp = (nb, nseg)
    le = last_end.reshape(shp).to(torch.int64)
    hdr, hlen = run_headers(p1.reshape(shp), m1h.reshape(shp), le,
                            raw_len, block_size)
    plan = assembly_plan(slen.reshape(shp), hlen, le, raw_len, seg)
    ocap = F.compress_bound(block_size) + 8
    return streams, hdr, rawm, plan, ocap, serr.reshape(shp), \
        nseq.reshape(shp)


def compress_blocks_seg(raw: torch.Tensor, raw_len: torch.Tensor,
                        block_size: int, seg: int = 4096,
                        window: int = 65536, accel: int = 1,
                        depth: int = 1, mlen: bool = False):
    """Compress ``[nb, >= block_size]`` uint8 blocks on their device;
    ``mlen`` runs the mlen mode (depth 1, blocks of at most 64 KiB).

    Returns (comp uint8 [nb, compress_bound(block_size) + 8] zero past the
    length, comp_len int32 [nb], err bool [nb], nseq int32 [nb]). A block
    whose parse failed or whose assembly passed COMPRESSBOUND has
    ``comp_len`` 0 and ``err`` set (the reference's limited-output
    failure): the framing layer re-encodes it on the host.
    """
    streams, hdr, rawm, plan, ocap, serr, nseq = assembly_inputs(
        raw, raw_len, block_size, seg, window, accel, depth, mlen)
    comp, comp_len = assemble_segments(streams, hdr, rawm, plan, ocap)
    err = (serr != 0).any(dim=1) | (comp_len > ocap - 8)
    comp_len = torch.where(err, 0, comp_len)
    return comp, comp_len, err, nseq.sum(dim=1, dtype=torch.int32)

"""K3, the segment-parallel greedy parse: CUDA kernel wrapper and plain
version.

``parse_segments`` launches ``csrc/parse_seg.cu`` (the port of
``lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:_parse_kernel`` in seg mode)
for a CUDA tensor and runs ``parse_segments_plain`` for a CPU tensor.

Contract: per segment, ``golden.compress_dense_seg_parts`` at depth 1
(``lz4_sgori_tpu/golden.py:481-583``), in global byte coordinates. Both
return, for the ``nb * nseg`` segments in block-major order:

  streams uint8 [nb*nseg, compress_bound(seg)], slen, err, last_end,
  nseq (sequences with a match), p1, m1h = m1 | has_match << 16
  (int32 [nb*nseg]).

A segment whose stream would pass ``compress_bound(seg)`` sets ``err``;
its other outputs are then unspecified. Segments at or past ``raw_len``
parse nothing.

The CUDA kernel (``csrc/parse_seg_warp.cuh``) walks a segment with one
warp, CTAs of 2 consecutive segments of 4 KiB, one of 8 KiB (or of
whole small blocks), over
bytes copied into shared memory once per CTA (one ``cp.async.bulk`` a
block: the CTA's segments; an older match
source is read from the row), the cand tape read from global memory. The
lanes split each step of the walk: 32 probes of the skip schedule a
round (the first hit by ballot), 32 bytes of catch-up and 128 of
extension a step, the literals a byte a lane. A card that refuses the
shared memory fails the launch, which raises.
"""

from __future__ import annotations

import torch

from ... import format as F
from . import _build

launches = 0
ENTRIES = {"lz4t_parse_seg": "ppppppppppiiiiiip"}  # the C entry


def load_kernel():
    """Build (once) and load csrc/parse_seg.cu."""
    return _build.load("parse_seg", ENTRIES)


def check_parse_args(raw: torch.Tensor, cand: torch.Tensor,
                     raw_len: torch.Tensor, *tapes: torch.Tensor,
                     tape: str = "gaps") -> None:
    """The input checks of the parse wrappers (K3, K7, both K8s and both
    K10 parses): ``tapes`` are the deep modes' gaps tapes or the mlen
    mode's mcode tape (named by ``tape``), shaped as ``cand``."""
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise TypeError("raw must be uint8 [B, block_size]")
    for name, t in (("cand", cand),) + tuple((tape, t) for t in tapes):
        if t.dtype != torch.int32 or t.shape != raw.shape:
            raise TypeError(f"{name} must be int32 [B, block_size]")
        if t.device != raw.device:
            raise ValueError(f"raw, cand, {tape} and raw_len must be on "
                             "one device")
    if raw_len.dtype != torch.int32 or raw_len.shape != raw.shape[:1]:
        raise TypeError("raw_len must be int32 [B]")
    if raw_len.device != raw.device:
        raise ValueError(f"raw, cand, {tape} and raw_len must be on one "
                         "device")
    if raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {raw.device}")


def window_limit(window: int) -> int:
    """Largest usable match distance (golden.py:450)."""
    return F.DISTANCE_MAX if window >= 65536 else window - 64


def check_seg(raw: torch.Tensor, seg: int) -> None:
    if seg < 1 or raw.shape[1] % seg:
        raise ValueError(f"seg {seg} must divide the block size "
                         f"{raw.shape[1]}")


def parse_segments(raw: torch.Tensor, cand: torch.Tensor,
                   raw_len: torch.Tensor, seg: int = 4096,
                   window: int = 65536, accel: int = 1):
    """Parse every segment of every block (K3)."""
    global launches
    check_parse_args(raw, cand, raw_len)
    check_seg(raw, seg)
    nb, bs = raw.shape
    accel = max(int(accel), 1)
    if raw.device.type == "cpu":
        return parse_segments_plain(raw, cand, raw_len, seg, window, accel)
    raw, cand, raw_len = raw.contiguous(), cand.contiguous(), \
        raw_len.contiguous()
    outs = segment_outputs(nb * (bs // seg), seg, raw.device)
    lib = load_kernel()
    _build.check(lib.lz4t_parse_seg(
        raw.data_ptr(), cand.data_ptr(), raw_len.data_ptr(),
        *(t.data_ptr() for t in outs), nb, bs, seg, F.compress_bound(seg),
        window_limit(window), accel, _build.stream(raw.device)), "parse_seg")
    launches += 1
    return outs


def segment_outputs(ns: int, seg: int, dev):
    """The outputs of a segment parse kernel (K3, K8-seg) for ``ns``
    segments, allocated on ``dev``: streams, then slen, err, last_end,
    nseq, p1 and m1h."""
    streams = torch.empty((ns, F.compress_bound(seg)), dtype=torch.uint8,
                          device=dev)
    return (streams, *(torch.empty(ns, dtype=torch.int32, device=dev)
                       for _ in range(6)))


def _lsic_len(x: torch.Tensor) -> torch.Tensor:
    """Bytes of the LSIC extension of a 4-bit length field."""
    return torch.where(x >= 15, (x - 15) // 255 + 1, 0)


def parse_segments_plain(raw, cand, raw_len, seg: int = 4096,
                         window: int = 65536, accel: int = 1, gaps=None,
                         gaps2=None, mcode=None):
    """Plain PyTorch parse: all segments step in lockstep, one search
    probe per round; the lanes that find a match emit their whole
    sequence in the same round. With ``gaps`` (and ``gaps2``) it is the
    deep parse of K8 at three (five) candidates a probe: the best
    preview, nearest on a tie, and one-step lazy deferral. With
    ``mcode`` (and ``cand`` the verified candidates of
    ``mcode.dense_mcode``) it is the mlen parse of K10: no read32 at the
    probe, the catch-up and the first extension bytes from the code
    (``parse_seg_warp.cuh``'s and ``parse_enc3_warp.cuh``'s ``Mlen``)."""
    nb, bs = raw.shape
    dev = raw.device
    nseg = bs // seg
    L = nb * nseg
    scap = F.compress_bound(seg)
    wlim = window_limit(window)
    i64 = torch.int64

    srcf = torch.cat([raw.reshape(-1).to(i64),
                      torch.zeros(8, dtype=i64, device=dev)])
    candf = cand.reshape(-1).to(i64)
    lane = torch.arange(L, dtype=i64, device=dev)
    blk = lane // nseg
    k = lane % nseg
    base = blk * bs
    n = raw_len.to(i64).clamp(0, bs)[blk]
    s0 = k * seg
    s1 = s0 + (n - s0).clamp(0, seg)
    mfl = torch.minimum(s1 - F.MINMATCH, n - F.MFLIMIT)
    mlim = torch.minimum(s1, n - F.LASTLITERALS)

    def byte(idx, at):             # src byte at block-relative index
        return srcf[base[idx] + at]

    def rd32(idx, at):
        g = base[idx] + at
        return srcf[g] | (srcf[g + 1] << 8) | (srcf[g + 2] << 16) \
            | (srcf[g + 3] << 24)

    if gaps is not None:
        gapsf = gaps.reshape(-1).to(i64)
        gaps2f = gaps2.reshape(-1).to(i64) if gaps2 is not None else None
    if mcode is not None:
        mcodef = mcode.reshape(-1).to(i64)
    jj64 = torch.arange(64, dtype=i64, device=dev)

    def best_of(idx, p):
        """(best preview, match position) of the chain candidates at p,
        -1 for none (golden.compress_dense_seg_parts' preview)."""
        at = base[idx] + p
        d1 = candf[at]
        g = gapsf[at]
        ds = [d1, d1 + (g & 255)]
        live = [(d1 > 0) & (d1 <= wlim)]
        live.append(live[0] & ((g & 255) != 0))
        ds.append(ds[1] + (g >> 8))
        live.append(live[1] & ((g >> 8) != 0))
        if gaps2f is not None:
            g2 = gaps2f[at]
            ds.append(ds[2] + (g2 & 255))
            live.append(live[2] & ((g2 & 255) != 0))
            ds.append(ds[3] + (g2 >> 8))
            live.append(live[3] & ((g2 >> 8) != 0))
        ds, live = torch.stack(ds, 1), torch.stack(live, 1)
        m = p[:, None] - ds
        mc0 = m.clamp(min=0)
        ok = live & (m >= 0) & (ds <= wlim)
        ok &= rd32(idx[:, None], mc0) == rd32(idx, p)[:, None]
        cl = (mlim[idx] - p - F.MINMATCH).clamp(max=64)
        ia = (p[:, None, None] + F.MINMATCH + jj64).clamp(max=bs - 1)
        ib = (mc0[:, :, None] + F.MINMATCH + jj64).clamp(max=bs - 1)
        eq = byte(idx[:, None, None], ia) == byte(idx[:, None, None], ib)
        eq &= jj64 < cl[:, None, None]
        mc = torch.where(ok, torch.cumprod(eq.to(i64), dim=2).sum(dim=2), -1)
        # the longest preview, the nearest (first) candidate on a tie
        k = (mc * 8 - torch.arange(mc.shape[1], device=dev)).argmax(dim=1)
        return (torch.gather(mc, 1, k[:, None]).squeeze(1),
                torch.gather(m, 1, k[:, None]).squeeze(1))

    anchor = s0.clone()
    pos = s0.clamp(min=1)
    frag = k > 0
    p1 = torch.zeros(L, dtype=i64, device=dev)
    m1 = torch.zeros_like(p1)
    nseq = torch.zeros_like(p1)
    o = torch.zeros_like(p1)
    has_match = torch.zeros(L, dtype=torch.bool, device=dev)
    bad = torch.zeros_like(has_match)
    searching = torch.ones_like(has_match)
    fpos = pos.clone()
    step = torch.ones_like(p1)
    smn = torch.full_like(p1, accel << F.SKIPTRIGGER)
    streams = torch.zeros(L * scap, dtype=torch.uint8, device=dev)

    while bool(searching.any()):
        can = searching & (fpos + step <= mfl + 1)
        searching &= can
        idx = can.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        pos[idx] = fpos[idx]
        fpos[idx] += step[idx]
        step[idx] = smn[idx] >> F.SKIPTRIGGER
        smn[idx] += 1
        pp = pos[idx]
        if gaps is None:
            d = candf[base[idx] + pp]
            ok = (d > 0) & (d <= wlim) & (d <= pp)
            mp = (pp - d).clamp(min=0)
            if mcode is None:
                ok &= rd32(idx, mp) == rd32(idx, pp)
        else:
            mca, mp = best_of(idx, pp)
            ok = mca >= 0
            mcb, mpb = best_of(idx, pp + 1)
            lazy = ok & (pp + 1 <= mfl[idx]) & (mcb > mca)
            pos[idx] = pp + lazy.to(i64)
            mp = torch.where(lazy, mpb, mp)
        idx = idx[ok]
        if idx.numel() == 0:
            continue
        pp, mp = pos[idx], mp[ok]
        anc = anchor[idx]

        # catch-up, capped at the anchor; with mcode the code's (capped at
        # 4) first, then byte by byte only where it reached its cap
        p0 = pp
        bytewise = torch.ones_like(pp, dtype=torch.bool)
        if mcode is not None:
            code = mcodef[base[idx] + pp]
            delta = torch.minimum(torch.minimum((code >> 6) & 7, pp - anc),
                                  mp)
            pp, mp = pp - delta, mp - delta
            bytewise = delta == 4
        while True:
            c = bytewise & (pp > anc) & (mp > 0)
            c &= byte(idx, (pp - 1).clamp(min=0)) == byte(
                idx, (mp - 1).clamp(min=0))
            if not bool(c.any()):
                break
            pp, mp = pp - c.to(i64), mp - c.to(i64)

        # forward extension to the segment's match limit; with mcode from
        # the known run (the catch-up, then lcp bytes), byte by byte only
        # where lcp reached its cap
        p4, m4 = pp + F.MINMATCH, mp + F.MINMATCH
        lim = mlim[idx] - p4
        mc = torch.zeros_like(pp)
        j = torch.arange(64, dtype=i64, device=dev)
        more = torch.ones_like(pp, dtype=torch.bool)
        if mcode is not None:
            lcp = (code >> 1) & 15
            mc = torch.minimum(p0 - pp + lcp, lim)
            more = lcp == 8
        while bool(more.any()):
            at = (mc[:, None] + j).clamp(max=bs - 1)
            eq = (byte(idx[:, None], (p4[:, None] + at).clamp(max=bs - 1))
                  == byte(idx[:, None], (m4[:, None] + at).clamp(max=bs - 1)))
            eq &= (mc[:, None] + j) < lim[:, None]
            run = torch.cumprod(eq.to(i64), dim=1).sum(dim=1)
            mc = torch.where(more, mc + run, mc)
            more &= run == 64

        # the sequence's bytes: [token + literal LSIC] literals offset
        # [match LSIC]; the first sequence of k > 0 has no header
        fr = frag[idx]
        lit = pp - anc
        hl = torch.where(fr, 0, 1 + _lsic_len(lit))
        mlx = _lsic_len(mc)
        total = hl + lit + 2 + mlx
        o0 = o[idx]
        over = o0 + total > scap
        token = (lit.clamp(max=15) << 4) | mc.clamp(max=15)
        w = int(total.max())
        jj = torch.arange(w, dtype=i64, device=dev)[None, :]
        hlc, litc = hl[:, None], lit[:, None]
        t_lit = jj - hlc
        t_off = t_lit - litc
        t_ml = t_off - 2
        hdr_b = torch.where(jj == 0, token[:, None],
                            torch.where(jj < hlc - 1, 255,
                                        ((lit[:, None] - 15) % 255)))
        lit_b = byte(idx[:, None], (anc[:, None] + t_lit).clamp(0, bs - 1))
        d_all = (pp - mp)[:, None]
        off_b = torch.where(t_off == 0, d_all & 255, d_all >> 8)
        ml_b = torch.where(t_ml < mlx[:, None] - 1, 255,
                           (mc[:, None] - 15) % 255)
        val = torch.where(jj < hlc, hdr_b,
                          torch.where(t_off < 0, lit_b,
                                      torch.where(t_ml < 0, off_b, ml_b)))
        keep = (jj < total[:, None]) & ~over[:, None]
        dst = (idx[:, None] * scap + o0[:, None] + jj)[keep]
        streams[dst] = val[keep].to(torch.uint8)

        o[idx] = o0 + total
        bad[idx] |= over
        p1[idx] = torch.where(fr, pp, p1[idx])
        m1[idx] = torch.where(fr, mc, m1[idx])
        frag[idx] = False
        has_match[idx] = True
        nseq[idx] += 1
        end = p4 + mc
        anchor[idx] = end
        pos[idx] = end
        fpos[idx] = end
        step[idx] = 1
        smn[idx] = accel << F.SKIPTRIGGER
        searching[idx] = ~over & (end <= mfl[idx])

    i32 = torch.int32
    return (streams.reshape(L, scap), o.to(i32), bad.to(i32),
            anchor.to(i32), nseq.to(i32), p1.to(i32),
            (m1 | (has_match.to(i64) << 16)).to(i32))

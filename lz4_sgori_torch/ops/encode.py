"""Batched LZ4 block encode on a device.

Port of ``lz4_sgori_tpu/ops/encode.py:compress_blocks_device`` and its
kernel dispatches, restricted to the kernel engines:

- ``seg`` (8-64 KiB, 4 KiB multiples, depth <= 3): kernels K2-K4, at
  depth 2-3 K2, gaps, K8-seg and K4, and with ``LZ4J_ENC_MLEN=1`` at
  depth 1 (the mlen mode, the JAX package's switch) K2, K10a, K10b and
  K4, ``ops/seg.py``;
- ``seg_big`` (64 KiB multiples above 64 KiB, 128 KiB-4 MiB on the fio
  envelope; depth capped at 3): kernels K9, K3 and K4 with
  ``seg = routing.seg_for(bs)``, and at depth 2-3 K9, gaps, K8-seg and
  K4, ``ops/seg.py``;
- ``enc3`` (under 8 KiB, other sizes up to 64 KiB, and every size up to
  64 KiB at depth 4 and up): K2 and K7, and at depth 3 and 5 K2, gaps
  and K8-enc3, ``ops/enc3.py``;
- ``seg_splice`` (above 64 KiB, not 64 KiB multiples; depth capped at
  1): 64 KiB segments through ``enc3`` with tails, spliced on the host;
- ``xla`` (``impl="xla"``, every block size, any depth): the portable,
  exhaustive max-ratio engine, ``_compress_blocks_impl`` below, the port
  of the JAX package's plain XLA program of the same name. No Pallas
  kernel backs it there, so here it is PyTorch tensor ops on the
  tensors' own device, with no hand-written kernel.

The ``xla`` engine keeps the JAX program's structure (see
``lz4_sgori_tpu/ops/encode.py``'s module docstring): the nearest previous
occurrence of every 4-byte word from one stable sort, match lengths by a
binary search over two polynomial prefix hashes mod 2^32, an exact
16-byte backward catch-up, a one-step lazy deferral, the greedy parse by
pointer doubling, and the emission of every output byte by segment
expansion. torch has no 32-bit unsigned arithmetic for all of this, so
the hashes are int64 tensors masked to 32 bits, and every product of two
32-bit values goes through ``mul32``, which keeps it under 2^48.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .. import format as F
from .. import golden, routing
from .enc3 import compress_blocks_enc3
from .primitives import (exclusive_cumsum, in_batches, le_word, segment_ids,
                         take1)
from .seg import compress_blocks_seg

# Two independent odd multipliers for the polynomial range hashes.
_HA = (0x9E3779B1, 0x85EBCA77)
_CATCHUP_MAX = 16  # exact backward-extension bound
# Look-ahead span for lazy deferral: 1 = classic one-step lazy (defer when
# the very next position has a strictly longer match).
_LAZY_WINDOW = 1
_M32 = (1 << 32) - 1


def compress_blocks_device(raw: torch.Tensor, raw_len: torch.Tensor,
                           block_size: int, match_depth: int | None = None,
                           impl: str = "auto", acceleration: int = 1,
                           return_cost: bool = False):
    """Compress ``raw uint8 [nb, >= block_size]`` on its device.

    Returns (comp uint8 [nb, compress_bound(block_size) + 8], comp_len
    int32 [nb]) and, with ``return_cost``, the per-block sequence count
    (``comp_len`` for seg_splice and xla, as in the JAX package).

    ``match_depth`` None runs each engine's default: depth 1 on the
    kernel engines, depth 3 on ``xla``, where it is the exhaustive
    lookback depth. ``acceleration`` applies to the kernel engines; the
    ``xla`` engine has no skip loop and warns that it ignores it.
    ``comp_len`` 0
    marks a block the engine could not encode: the framing layer
    re-encodes it on the host.
    """
    md = match_depth or 1
    engine = routing.select_encode_engine(block_size, md, True, impl)
    depth = routing.encode_depth_cap(engine, md)
    routing.require_ported(engine)
    if depth < md:
        warnings.warn(
            f"match_depth={md} exceeds the {engine} engine's depth cap; "
            f"running depth {depth} (see routing.py).", stacklevel=2)
    if engine == "xla":
        if acceleration > 1:
            warnings.warn(
                f"acceleration={acceleration} applies to the greedy kernel "
                "path; the exhaustive engine evaluates every position and "
                "ignores it.", stacklevel=2)
        depth = 3 if match_depth is None else md
        comp, comp_len = in_batches(
            lambda r, n: _compress_blocks_impl(r, n, block_size, depth),
            raw[:, :block_size], raw_len)
        comp = torch.nn.functional.pad(comp, (0, 8))
        cost = comp_len
    elif engine == "seg_splice":
        comp, comp_len = _compress_blocks_segmented(raw, raw_len, block_size,
                                                    acceleration)
        cost = comp_len
    elif engine == "enc3":
        comp, comp_len, cost = compress_blocks_enc3_dispatch(
            raw, raw_len, block_size, acceleration, depth=depth)
    elif engine == "seg_big":
        comp, comp_len, cost = compress_blocks_seg_dispatch(
            raw, raw_len, block_size, acceleration, depth=depth,
            seg=routing.seg_for(block_size), return_nseq=True)
    else:
        comp, comp_len, cost = compress_blocks_seg_dispatch(
            raw, raw_len, block_size, acceleration, depth=depth,
            return_nseq=True)
    return (comp, comp_len, cost) if return_cost else (comp, comp_len)


def _compress_blocks_segmented(raw: torch.Tensor, raw_len: torch.Tensor,
                               block_size: int, acceleration: int = 1):
    """The seg_splice engine for blocks above 64 KiB: 64 KiB segments
    through ``enc3`` with their tails, then ``golden.splice_segments`` on
    the host into one LZ4 block per input block. Byte contract:
    ``golden.compress_segmented``. A segment error or a spliced block past
    ``compress_bound`` gives ``comp_len`` 0."""
    seg = 65536
    nb, slot = raw.shape
    dev = raw.device
    nseg = -(-block_size // seg)
    segslot = nseg * seg
    if slot < segslot:
        raw = torch.nn.functional.pad(raw, (0, segslot - slot))
    segs = raw[:, :segslot].reshape(nb * nseg, seg)
    sidx = torch.arange(nseg, dtype=torch.int32, device=dev)[None, :]
    seg_len = (raw_len.to(device=dev, dtype=torch.int32)[:, None]
               - sidx * seg).clamp(0, seg).reshape(-1)
    comp_s, clen_s, err_s, tail_s = compress_blocks_enc3(
        segs, seg_len, seg, accel=acceleration, return_tails=True)
    comp_s, clen_s, err_s, tail_s = (t.cpu().numpy() for t in
                                     (comp_s, clen_s, err_s, tail_s))
    rlen = raw_len.cpu().numpy()
    bound = F.compress_bound(block_size)
    out = np.zeros((nb, bound + 8), np.uint8)
    out_len = np.zeros(nb, np.int32)
    for b in range(nb):
        rows = range(b * nseg, b * nseg + max(1, -(-int(rlen[b]) // seg)))
        if any(err_s[r] for r in rows):
            continue
        blob = golden.splice_segments(
            [comp_s[r, :clen_s[r]].tobytes() for r in rows],
            [int(tail_s[r]) for r in rows])
        if len(blob) > bound:
            continue
        out[b, :len(blob)] = np.frombuffer(blob, np.uint8)
        out_len[b] = len(blob)
    return torch.from_numpy(out).to(dev), torch.from_numpy(out_len).to(dev)


def compress_blocks_enc3_dispatch(raw, raw_len, block_size: int,
                                  acceleration: int = 1, depth: int = 1):
    """The enc3 engine, byte-exact to golden.compress_dense(hashlog=16)
    at depth 1 and golden.compress_deep(hashlog=16, depth) at depth 3
    and 5: (comp, comp_len, nseq). A block past COMPRESSBOUND folds into
    comp_len 0 for the framing layer's verify and host fallback."""
    comp, comp_len, err, nseq = compress_blocks_enc3(
        raw, raw_len, block_size, accel=acceleration, return_nseq=True,
        depth=depth)
    return comp, torch.where(err, 0, comp_len), nseq


def compress_blocks_seg_dispatch(raw, raw_len, block_size: int,
                                 acceleration: int = 1, depth: int = 1,
                                 seg: int = 4096,
                                 return_nseq: bool = False):
    """The seg and seg_big engines, byte-exact to golden.compress_dense_seg
    (compress_dense_seg_big above 64 KiB) at ``depth``. A parse error or
    an assembled block past COMPRESSBOUND (the reference's limited-output
    condition) folds into comp_len 0 for the framing layer's verify and
    host fallback. ``LZ4J_ENC_MLEN=1`` runs the mlen mode (the same
    bytes) where the JAX package does: depth 1, blocks of at most
    64 KiB; elsewhere the JAX package ignores it, and so does the port."""
    mlen = (os.environ.get("LZ4J_ENC_MLEN") == "1" and depth == 1
            and block_size <= 65536)
    comp, comp_len, _err, nseq = compress_blocks_seg(
        raw, raw_len, block_size, seg=seg, accel=acceleration, depth=depth,
        mlen=mlen)
    return (comp, comp_len, nseq) if return_nseq else (comp, comp_len)


def mul32(x, y):
    """``x * y mod 2^32`` for int64 tensors (or ints) in [0, 2^32): ``y``
    in two 16-bit halves, so that no product passes 2^48."""
    return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) & _M32


def _powers(mult: int, m: int, device) -> torch.Tensor:
    """``mult^k mod 2^32`` for k in [0, m), by doubling on ``device``."""
    p = torch.ones(1, dtype=torch.int64, device=device)
    while p.shape[0] < m:
        p = torch.cat([p, mul32(p, pow(mult, p.shape[0], 1 << 32))])
    return p[:m]


def _prefix_hashes(b32: torch.Tensor, mult: int) -> torch.Tensor:
    """H[x] = b[0]*A^(x-1) + ... + b[x-1] (mod 2^32); H has width M+1.

    A is odd, so it has an inverse mod 2^32 and H[x] = A^(x-1) *
    sum_{j<x} b[j]*A^-j: one cumsum of terms under 2^32 (under 2^54 in
    all, even at 4 MiB) and two products mod 2^32. Arithmetic mod 2^32
    is associative, so this gives the JAX scan's bits."""
    m = b32.shape[-1]
    dev = b32.device
    terms = (b32 * _powers(pow(mult, -1, 1 << 32), m, dev)) & _M32
    h = mul32(torch.cumsum(terms, dim=-1) & _M32, _powers(mult, m, dev))
    return torch.nn.functional.pad(h, (1, 0))


def _range_eq(h, al, x1, x2, span) -> torch.Tensor:
    """hash-equality of b[x1:x1+span) and b[x2:x2+span) for one prefix
    hash, where span = 2^k and al = A^span mod 2^32 (ints): JAX's
    ``h1b - h1a*al == h2b - h2a*al`` mod 2^32, rearranged to one
    product, ``h1b - h2b == (h1a - h2a)*al``."""
    h1a, h1b = take1(h, x1), take1(h, x1 + span)
    h2a, h2b = take1(h, x2), take1(h, x2 + span)
    return ((h1b - h2b) & _M32) == mul32((h1a - h2a) & _M32, al)


def _prev_occurrence(w32: torch.Tensor) -> torch.Tensor:
    """Nearest previous position with an identical 4-byte word, else -1.
    One stable sort: equal words become neighbours in position order."""
    m = w32.shape[-1]
    key_sorted, order = torch.sort(w32, dim=-1, stable=True)
    lead = w32.shape[:-1] + (1,)
    prev_sorted = torch.cat(
        [torch.full(lead, -1, dtype=torch.int64, device=w32.device),
         order[..., :-1]], dim=-1)
    same = torch.cat(
        [torch.zeros(lead, dtype=torch.bool, device=w32.device),
         key_sorted[..., 1:] == key_sorted[..., :-1]], dim=-1)
    prev_sorted = torch.where(same, prev_sorted, -1)
    # scatter back to positional order: prev[order[k]] = prev_sorted[k]
    prev = torch.empty_like(order).scatter_(-1, order, prev_sorted)
    idx = torch.arange(m, device=w32.device)
    return torch.where(idx >= 1, prev, -1)


def _match_lengths(b, prev, raw_len, n, hashes):
    """Forward LCP beyond the guaranteed 4 bytes, via an MSB-first binary
    search on hash range equality; returns ml[i] = full match length at
    i. ``hashes`` holds (H, apow) pairs, apow[k] = A^(2^k) mod 2^32."""
    i = torch.arange(b.shape[-1], device=b.device)
    matchlimit = raw_len - F.LASTLITERALS
    lim = (matchlimit - (i + F.MINMATCH)).clamp(min=0)
    bits = max(1, (n - 1).bit_length())
    x1 = i + F.MINMATCH
    x2 = prev + F.MINMATCH
    cur = torch.zeros_like(prev)
    for j in range(bits):
        k = bits - 1 - j
        span = 1 << k
        ok = (cur + span) <= lim
        y1, y2 = x1 + cur, x2 + cur
        for h, apow in hashes:
            ok = ok & _range_eq(h, apow[k], y1, y2, span)
        cur = cur + torch.where(ok, span, 0)
    return F.MINMATCH + cur


def _best_candidates(b, w32, raw_len, n, depth: int):
    """Evaluate the `depth` nearest previous occurrences of each position's
    4-byte word and keep the one with the longest exact match (ties keep
    the nearer candidate; candidates past DISTANCE_MAX are invalid).
    Returns (best_prev, best_ml, any_valid)."""
    i = torch.arange(n, device=b.device)
    hashes = [(_prefix_hashes(b, mult),
               [pow(mult, 1 << k, 1 << 32) for k in range(24)])
              for mult in _HA]
    prev = _prev_occurrence(w32)
    best_prev = torch.full_like(prev, -1)
    best_ml = torch.zeros_like(prev)
    for _ in range(depth):
        valid = (prev >= 0) & (i - prev <= F.DISTANCE_MAX)
        ml = _match_lengths(b, prev.clamp(min=0), raw_len, n, hashes)
        ml = torch.where(valid, ml, 0)
        better = ml > best_ml  # strict: ties keep the nearer candidate
        best_prev = torch.where(better, prev, best_prev)
        best_ml = torch.where(better, ml, best_ml)
        prev = torch.where(prev >= 0, take1(prev, prev.clamp(min=0)), -1)
    return best_prev, best_ml, best_ml >= F.MINMATCH


def _backward_runs(b, prev):
    """Exact bounded catch-up: rl[i] = #t<CATCHUP_MAX with
    b[i-1-t] == b[prev-1-t]."""
    i = torch.arange(b.shape[-1], device=b.device)
    rl = torch.zeros_like(b)
    for t in range(_CATCHUP_MAX):
        lhs_idx = i - 1 - t
        rhs_idx = prev - 1 - t
        ok = (lhs_idx >= 0) & (rhs_idx >= 0) & \
            (take1(b, lhs_idx) == take1(b, rhs_idx))
        rl = rl + ((rl == t) & ok).to(rl.dtype)
    return rl


def _compress_blocks_impl(raw: torch.Tensor, raw_len: torch.Tensor,
                          block_size: int, match_depth: int = 3):
    """Encode a batch of independent LZ4 blocks on their device (port of
    ``lz4_sgori_tpu/ops/encode.py:_compress_blocks_impl``).

    raw: uint8 [nb, block_size], zero-padded past raw_len; raw_len: [nb].
    Returns (comp uint8 [nb, compress_bound(block_size)], zero past
    comp_len; comp_len int32 [nb]). No host sync: every loop runs a
    number of steps that the shapes fix."""
    if raw.dtype != torch.uint8:
        raise TypeError(f"raw must be uint8, got {raw.dtype}")
    n = block_size
    cb = F.compress_bound(n)
    dev = raw.device
    b = raw.to(torch.int64)
    nblk = b.shape[0]
    rlen = raw_len.to(device=dev, dtype=torch.int64)[:, None]
    i = torch.arange(n, device=dev)

    w32 = le_word(b, 4)
    prev, ml, valid = _best_candidates(b, w32, rlen, n, depth=match_depth)
    rl = _backward_runs(b, prev.clamp(min=0))
    rl = torch.minimum(rl, prev.clamp(min=0))  # not before position 0

    mflimit = rlen - F.MFLIMIT
    has_match = valid & (i <= mflimit) & (i >= 1)

    # lazy deferral: skip the match at t when a strictly longer match
    # starts within the next _LAZY_WINDOW bytes
    best_alt = torch.zeros_like(ml)
    for d in range(1, _LAZY_WINDOW + 1):
        hm_d = torch.nn.functional.pad(has_match, (0, d))[..., d:]
        ml_d = torch.nn.functional.pad(ml, (0, d))[..., d:]
        best_alt = torch.maximum(best_alt, torch.where(hm_d, ml_d, 0))
    has_match = has_match & ~(best_alt > ml)

    # next match position at or after every position (width n+2: the
    # anchor domain is [0, n+1] with sentinel n+1)
    sent = n + 1
    cand = torch.where(has_match, i, sent)
    nm = torch.flip(torch.cummin(torch.flip(cand, [-1]), dim=-1).values,
                    [-1])
    nm = torch.nn.functional.pad(nm, (0, 2), value=sent)

    # anchor-advance function g over the anchor domain [0, n+1]
    a_dom = torch.arange(n + 2, device=dev)
    t_a = take1(nm, a_dom.clamp(min=1))
    ml_t = take1(ml, t_a.clamp(max=n - 1))
    g = torch.where(t_a < sent, t_a + ml_t, sent)
    g = torch.where(a_dom == sent, sent, g)

    # pointer doubling over the anchor chain; the shapes end the loop
    s_max = F.worst_case_sequences(n)
    p = torch.zeros((nblk, 1), dtype=torch.int64, device=dev)
    while p.shape[-1] < s_max:
        p = torch.cat([p, take1(g, p)], dim=-1)
        if p.shape[-1] < s_max:
            g = take1(g, g)
    p = p[..., :s_max]
    k = torch.arange(p.shape[-1], device=dev)

    # per-sequence records
    a_k = p
    t_k = take1(nm, a_k.clamp(min=1))
    term_k = (t_k >= sent) | (a_k >= sent)
    t_k = t_k.clamp(max=n - 1)
    prev_k = take1(prev, t_k)
    ml_k = take1(ml, t_k)
    rl_k = torch.minimum(take1(rl, t_k), t_k - a_k)  # anchor-bounded
    kstar = term_k.to(torch.int64).argmax(dim=-1)[:, None]
    live = k <= kstar
    mid = k < kstar

    lit_len = torch.where(mid, t_k - rl_k - a_k,
                          rlen - torch.minimum(a_k, rlen)).clamp(min=0)
    off_k = t_k - prev_k
    mlc = torch.where(mid, rl_k + ml_k - F.MINMATCH, 0)  # match code

    lit_ext = torch.where(lit_len >= F.RUN_MASK,
                          1 + (lit_len - F.RUN_MASK) // 255, 0)
    ml_ext = torch.where(mid & (mlc >= F.ML_MASK),
                         1 + (mlc - F.ML_MASK) // 255, 0)
    seq_bytes = torch.where(
        mid, 1 + lit_ext + lit_len + 2 + ml_ext,
        torch.where(live, 1 + lit_ext + lit_len, 0))
    so = exclusive_cumsum(seq_bytes)  # sequence start offsets in output
    comp_len = seq_bytes.sum(dim=-1)

    # byte-level emission over the output slot
    seg = segment_ids(so, live, cb)
    o = torch.arange(cb, device=dev)
    r = o - take1(so, seg)
    lit_ext_o = take1(lit_ext, seg)
    lit_len_o = take1(lit_len, seg)
    ml_ext_o = take1(ml_ext, seg)
    mlc_o = take1(mlc, seg)
    off_o = take1(off_k, seg)
    a_o = take1(a_k, seg)
    is_mid_o = take1(mid.to(torch.int64), seg) == 1

    token = (lit_len_o.clamp(max=F.RUN_MASK) << F.ML_BITS) | \
        torch.where(is_mid_o, mlc_o.clamp(max=F.ML_MASK), 0)

    lit_rem = lit_len_o - F.RUN_MASK
    ml_rem = mlc_o - F.ML_MASK

    r_lit0 = 1 + lit_ext_o                     # literals region start
    r_off0 = r_lit0 + lit_len_o                # offset region start
    r_mle0 = r_off0 + 2                        # match-LSIC region start

    in_litext = (r >= 1) & (r < r_lit0)
    in_lit = (r >= r_lit0) & (r < r_off0)
    in_off = is_mid_o & (r >= r_off0) & (r < r_mle0)
    in_mlext = is_mid_o & (r >= r_mle0)

    # LSIC extension: (count-1) bytes of 255, then rem - 255*(count-1)
    litext_val = torch.where(r < lit_ext_o, 255,
                             lit_rem - 255 * (lit_ext_o - 1))
    mlext_val = torch.where(r - r_mle0 < ml_ext_o - 1, 255,
                            ml_rem - 255 * (ml_ext_o - 1))

    lit_val = take1(b, a_o + (r - r_lit0))
    off_val = torch.where(r == r_off0, off_o & 255, off_o >> 8)

    val = torch.where(in_lit, lit_val, token)
    val = torch.where(in_litext, litext_val, val)
    val = torch.where(in_off, off_val, val)
    val = torch.where(in_mlext, mlext_val, val)
    val = torch.where(o < comp_len[:, None], val, 0)
    return val.to(torch.uint8), comp_len.to(torch.int32)

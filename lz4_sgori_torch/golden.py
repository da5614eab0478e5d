"""Golden scalar LZ4 block codec (pure Python).

The port's own copy of ``lz4_sgori_tpu/golden.py``, unchanged but for
importing the port's ``format``: the port's host encoder and splice, and
the byte oracle of every kernel in ``chip_smoke.py``.

This is the framework's layer-1 oracle: a reference-semantic greedy LZ4
level-1 encoder and a safe decoder, used to validate every TPU kernel stage
and cross-checked against the system liblz4 (the same way the reference
validates its SG compressor against stock kernel LZ4, lz4e_bdev/lz4e_chunk.c:119-137).

Encoder semantics follow the reference's greedy match finder
(lz4e/lz4e_compress.c:218-534): single-probe multiplicative hash table,
skip-accelerated candidate search, backward match extension ("catch up"),
LSIC length encoding, the two-byte-rollback table refill, and the
immediate-rematch fast path. It is written from the algorithm, not the code.

Not performance-critical — the TPU kernels and the native C library are the
fast paths.
"""

from __future__ import annotations

from . import format as F


class DecodeError(ValueError):
    """Malformed compressed block. `position` mirrors the reference's
    negative-return convention (lz4e/lz4e_decompress.c:458-459)."""

    def __init__(self, message: str, position: int):
        super().__init__(f"{message} (at input byte {position})")
        self.position = position


def compress(src: bytes | bytearray | memoryview, acceleration: int = 1,
             max_output: int | None = None) -> bytes:
    """Greedy LZ4 block compress. Returns the compressed block.

    If `max_output` is given and the block does not fit, raises ValueError
    (the analog of the reference's limited-output 0 return,
    lz4e_compress.c:358-363,425-430,505-509).
    """
    src = bytes(src)
    n = len(src)
    if n > F.MAX_INPUT_SIZE:
        raise ValueError(f"input too large: {n} > {F.MAX_INPUT_SIZE}")
    if acceleration < 1:
        acceleration = F.ACCELERATION_DEFAULT

    limit = max_output if max_output is not None else F.compress_bound(n)
    limited = max_output is not None and max_output < F.compress_bound(n)
    dst = bytearray()

    def rd32(i: int) -> int:
        return int.from_bytes(src[i:i + 4], "little")

    hashlog = F.hashlog_for_input(n)
    small = n < F.SMALL_INPUT_LIMIT
    if small:
        def hpos(i: int) -> int:
            return F.hash4(rd32(i), hashlog)
    else:
        def hpos(i: int) -> int:
            return F.hash5(int.from_bytes(src[i:i + 8], "little"), hashlog)

    anchor = 0
    pos = 0

    if n >= F.MIN_LENGTH:
        # Last searchable match start is n - MFLIMIT inclusive (the format
        # allows matches starting up to 12 bytes before the end); the search
        # loop exits when the *next* forward position passes this limit.
        # (The reference's kernel-style bound is one position more
        # conservative, lz4e_compress.c:300-301; we use the exact format
        # limit, which can only shrink output.)
        mflimit = n - F.MFLIMIT
        matchlimit = n - F.LASTLITERALS
        table = [0] * (1 << hashlog)

        # First byte
        table[hpos(0)] = 0
        pos = 1
        fh = hpos(1)

        while True:
            # --- Find a match (skip-accelerated search) ---
            fpos = pos
            step = 1
            search_match_nb = acceleration << F.SKIPTRIGGER
            found = False
            while True:
                h = fh
                if fpos + step > mflimit + 1:
                    break  # -> last literals
                pos = fpos
                fpos += step
                step = search_match_nb >> F.SKIPTRIGGER
                search_match_nb += 1
                mpos = table[h]
                fh = hpos(fpos)
                table[h] = pos
                if (small or mpos + F.DISTANCE_MAX >= pos) and rd32(mpos) == rd32(pos):
                    found = True
                    break
            if not found:
                break  # no match found before mflimit -> last literals

            # --- Catch up (backward extension) ---
            while pos > anchor and mpos > 0 and src[pos - 1] == src[mpos - 1]:
                pos -= 1
                mpos -= 1

            # --- Encode literals ---
            lit_len = pos - anchor
            token_at = len(dst)
            dst.append(0)
            if limited and len(dst) + lit_len + (2 + 1 + F.LASTLITERALS) + lit_len // 255 > limit:
                raise ValueError("output buffer too small (literals)")
            if lit_len >= F.RUN_MASK:
                token = F.RUN_MASK << F.ML_BITS
                rem = lit_len - F.RUN_MASK
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)
            else:
                token = lit_len << F.ML_BITS
            dst += src[anchor:pos]

            # --- Encode match(es) ---
            while True:  # _next_match
                offset = pos - mpos
                dst += offset.to_bytes(2, "little")

                # match length beyond MINMATCH, capped at matchlimit
                p = pos + F.MINMATCH
                m = mpos + F.MINMATCH
                count_limit = matchlimit - p
                match_code = 0
                while match_code < count_limit and src[p + match_code] == src[m + match_code]:
                    match_code += 1
                pos = p + match_code

                if limited and len(dst) + 1 + F.LASTLITERALS + (match_code >> 8) > limit:
                    raise ValueError("output buffer too small (match)")
                if match_code >= F.ML_MASK:
                    token += F.ML_MASK
                    rem = match_code - F.ML_MASK
                    while rem >= 255:
                        dst.append(255)
                        rem -= 255
                    dst.append(rem)
                else:
                    token += match_code
                dst[token_at] = token

                anchor = pos
                if pos > mflimit:
                    break

                # Refill table at pos-2 (lz4e_compress.c:459-464)
                table[hpos(pos - 2)] = pos - 2

                # Immediate re-match test at the new position
                h = hpos(pos)
                mpos = table[h]
                table[h] = pos
                if (small or mpos + F.DISTANCE_MAX >= pos) and rd32(mpos) == rd32(pos):
                    token = 0
                    token_at = len(dst)
                    dst.append(0)
                    continue
                break

            if pos > mflimit:
                break
            pos += 1
            fh = hpos(pos)

    # --- Last literals ---
    last_run = n - anchor
    if limited and len(dst) + last_run + 1 + (last_run + 255 - F.RUN_MASK) // 255 > limit:
        raise ValueError("output buffer too small (last literals)")
    if last_run >= F.RUN_MASK:
        dst.append(F.RUN_MASK << F.ML_BITS)
        rem = last_run - F.RUN_MASK
        while rem >= 255:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst.append(last_run << F.ML_BITS)
    dst += src[anchor:]
    return bytes(dst)


def decompress(src: bytes | bytearray | memoryview, max_output: int) -> bytes:
    """Safe LZ4 block decode: bounds-checked, raises DecodeError on malformed
    input (semantics of lz4e/lz4e_decompress.c:62-460, noDict/decode_full_block)."""
    src = bytes(src)
    ilen = len(src)
    if ilen == 0:
        raise DecodeError("empty input", 0)
    out = bytearray()
    ip = 0

    while True:
        if ip >= ilen:
            raise DecodeError("truncated block: missing token", ip)
        token = src[ip]
        ip += 1

        # literal length
        lit_len = token >> F.ML_BITS
        if lit_len == F.RUN_MASK:
            while True:
                if ip >= ilen:
                    raise DecodeError("truncated LSIC literal length", ip)
                b = src[ip]
                ip += 1
                lit_len += b
                if b != 255:
                    break
        if ip + lit_len > ilen:
            raise DecodeError("literal run exceeds input", ip)
        if len(out) + lit_len > max_output:
            raise DecodeError("literal run exceeds output capacity", ip)
        out += src[ip:ip + lit_len]
        ip += lit_len

        if ip == ilen:
            # Block termination: last sequence is literal-only
            # (doc/BlockFormat.md:17-21).
            break

        # offset
        if ip + 2 > ilen:
            raise DecodeError("truncated offset", ip)
        offset = int.from_bytes(src[ip:ip + 2], "little")
        ip += 2
        match = len(out) - offset
        if offset == 0 or match < 0:
            raise DecodeError(f"offset {offset} outside output", ip - 2)

        # match length
        match_len = (token & F.ML_MASK) + F.MINMATCH
        if (token & F.ML_MASK) == F.ML_MASK:
            while True:
                if ip >= ilen:
                    raise DecodeError("truncated LSIC match length", ip)
                b = src[ip]
                ip += 1
                match_len += b
                if b != 255:
                    break
        if len(out) + match_len > max_output:
            raise DecodeError("match exceeds output capacity", ip)

        # overlap-safe copy (offset may be < match_len)
        for _ in range(match_len):
            out.append(out[match])
            match += 1

    return bytes(out)


def tail_offset(stream: bytes) -> int:
    """Byte offset of an LZ4 block stream's terminal literal-only
    sequence (the token after the last match). Walks the sequence
    structure; raises DecodeError on malformed input."""
    ip = 0
    n = len(stream)
    last = 0
    while True:
        last = ip
        if ip >= n:
            raise DecodeError("missing terminal sequence", ip)
        token = stream[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise DecodeError("truncated literal LSIC", ip)
                b = stream[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        ip += lit
        if ip == n:
            return last                  # terminal: input ends here
        if ip + 2 > n:
            raise DecodeError("truncated offset", ip)
        ip += 2
        if (token & 15) == 15:
            while True:
                if ip >= n:
                    raise DecodeError("truncated match LSIC", ip)
                b = stream[ip]
                ip += 1
                if b != 255:
                    break


def _lit_header(lit_len: int, ml_nibble: int) -> bytes:
    """Token + literal-LSIC bytes for a sequence header."""
    out = bytearray()
    if lit_len >= F.RUN_MASK:
        out.append((F.RUN_MASK << F.ML_BITS) | ml_nibble)
        rem = lit_len - F.RUN_MASK
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    else:
        out.append((lit_len << F.ML_BITS) | ml_nibble)
    return bytes(out)


def splice_segments(streams: list, tails: list) -> bytes:
    """Splice per-segment LZ4 block streams into ONE valid block stream.

    Each streams[k] is a complete LZ4 block for one consecutive segment
    of the input; tails[k] is the offset of its terminal literal-only
    sequence (tail_offset / the encoder's tail output). The terminal run
    of segment k cannot stand mid-block (every non-final sequence needs
    a match, doc/BlockFormat.md), so it is carried forward and absorbed
    into the first sequence of the next segment that has one: only that
    sequence's token + literal-LSIC are re-encoded, every other byte is
    copied verbatim. Matches never cross segments (each segment was
    encoded standalone), so all offsets stay valid in the merged stream.
    """
    out = bytearray()
    carry = bytearray()                  # pending literal run (bytes)
    for k, s in enumerate(streams):
        t = tails[k]
        body = s[:t]
        # parse the tail sequence's literal bytes
        ip = t
        token = s[ip]
        ip += 1
        lit = token >> 4
        if lit == F.RUN_MASK:
            while True:
                b = s[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        tail_lits = s[ip:ip + lit]
        if body:
            if carry:
                # absorb the carry into body's first sequence header
                bp = 0
                tok0 = body[bp]
                bp += 1
                lit0 = tok0 >> 4
                if lit0 == F.RUN_MASK:
                    while True:
                        b = body[bp]
                        bp += 1
                        lit0 += b
                        if b != 255:
                            break
                out += _lit_header(len(carry) + lit0, tok0 & F.ML_MASK)
                out += carry
                out += body[bp:]
                carry = bytearray()
            else:
                out += body
            carry += tail_lits
        else:
            carry += tail_lits
    out += _lit_header(len(carry), 0)
    out += carry
    return bytes(out)


def compress_segmented(src: bytes | bytearray | memoryview,
                       acceleration: int = 1, hashlog: int = 16,
                       seg: int = 65536) -> bytes:
    """Oracle of the TPU large-block encode path: compress 64 KiB
    segments independently with the dense rule, then splice into one
    block stream (ops/encode.py routes TPU blocks > 64 KiB here — the
    pos16 sort keys and VMEM residency cap the kernel at 64 KiB, and
    the reference's own window never exceeds 64 KiB either, lz4e.h:53-55,
    so the only loss is candidates that would cross a segment boundary).
    """
    src = bytes(src)
    streams = []
    tails = []
    for p in range(0, max(len(src), 1), seg):
        s = compress_dense(src[p:p + seg], acceleration=acceleration,
                           hashlog=hashlog)
        streams.append(s)
        tails.append(tail_offset(s))
    return splice_segments(streams, tails)


def compress_dense_seg_parts(src: bytes | bytearray | memoryview,
                             seg: int = 4096, window: int = 65536,
                             hashlog: int = 16, acceleration: int = 1,
                             cand_d=None, gaps=None, depth: int = 1):
    """Segment-parallel greedy parse of ONE block — the oracle of the TPU
    enc4 segmented-lane engine (ops/pallas/lockstep_enc3.py seg mode).

    The block is cut into `seg`-byte segments that are parsed
    INDEPENDENTLY (one TPU lane each) against the shared global dense
    candidates: matches reach backward across segment boundaries through
    the full `window`, but a match never extends past its own segment
    end, and each segment's parse starts fresh at its boundary. Unlike
    compress_segmented (independent sub-BLOCKS spliced by host byte
    patching), the per-segment streams here concatenate into one valid
    LZ4 block with NO patching:

      block = for each segment k, in order:
                [stream_k]                 (kernel lane output)
                [header_k]   if owner_k    (token'+literal-LSIC of the
                                            literal run that starts at
                                            last_end_k)
                [src[last_end_k : seg_end_k]]   (raw tail literals)

    where stream_k's FIRST sequence is emitted HEADERLESS for k > 0
    (its token + literal-LSIC belong to the nearest previous owner's
    header_k — the run's literal bytes span the intervening raw tails),
    and owner_k = (segment k has a match) or k == 0. All header_k fields
    derive from per-segment scalars (last_end, first match pos/len), so
    the host assembles blocks from raw slices + tiny headers only.

    Per-segment parse bounds (vs lz4e_compress.c:234-235): a match must
    END within the segment — matchlimit_k = min(seg_end, n-5) and the
    search limit mfl_k = min(seg_end - MINMATCH, n - MFLIMIT); backward
    catch-up stops at the segment start (the run anchor never re-enters
    a previous segment). depth > 1 selects the deep candidate rule
    (best-of-3 chain + one-step lazy, compress_deep semantics).

    Returns a list of per-segment dicts:
      stream (bytes), last_end, p1, m1, has_match
    (p1 = first match position post-catch-up, m1 = its match code).
    """
    src = bytes(src)
    n = len(src)
    if acceleration < 1:
        acceleration = F.ACCELERATION_DEFAULT
    if cand_d is None:
        cand_d = dense_candidates(src, hashlog, val16_filter=False) \
            if n >= 4 else [0] * n
    if depth > 1 and gaps is None:
        gaps = dense_gaps(src, hashlog) if n >= 4 else [0] * n
    # restricted windows drop a 64-byte guard band so every kernel-side
    # match/catch-up window read stays inside the per-lane tape
    wlim = F.DISTANCE_MAX if window >= 65536 else window - 64

    def rd32(i: int) -> int:
        return int.from_bytes(src[i:i + 4], "little")

    def preview(p, mlim):
        """Deep mode: (best preview mc, d) over <=3 chain candidates at
        p; previews cap at 64 B, nearest wins ties (compress_deep)."""
        d1 = cand_d[p]
        if not d1 or d1 > wlim:
            return -1, 0
        ds = [d1]
        g = gaps[p]
        if g & 255:
            ds.append(d1 + (g & 255))
            if g >> 8:
                ds.append(d1 + (g & 255) + (g >> 8))
        best_mc, best_d = -1, 0
        for d in ds:
            m = p - d
            if m < 0 or d > wlim or rd32(m) != rd32(p):
                continue
            p_, m_ = p + F.MINMATCH, m + F.MINMATCH
            cl = min(mlim - p_, 64)
            mc = 0
            while mc < cl and src[p_ + mc] == src[m_ + mc]:
                mc += 1
            if mc > best_mc:
                best_mc, best_d = mc, d
        return best_mc, best_d

    nseg = max(1, -(-n // seg))
    parts = []
    for k in range(nseg):
        s0 = k * seg
        s1 = min(s0 + seg, n)
        mfl = min(s1 - F.MINMATCH, n - F.MFLIMIT)
        mlim = min(s1, n - F.LASTLITERALS)
        dst = bytearray()
        anchor = s0
        pos = max(s0, 1)
        frag = k > 0
        p1 = m1 = 0
        has_match = False
        while True:
            # --- skip-accelerated search (fresh schedule per sequence) ---
            fpos = pos
            step = 1
            smn = acceleration << F.SKIPTRIGGER
            found = False
            while True:
                if fpos + step > mfl + 1:
                    break
                pos = fpos
                fpos += step
                step = smn >> F.SKIPTRIGGER
                smn += 1
                if depth > 1:
                    mc_a, d_a = preview(pos, mlim)
                    if mc_a < 0:
                        continue
                    if pos + 1 <= mfl:
                        mc_b, d_b = preview(pos + 1, mlim)
                        if mc_b > mc_a:
                            pos += 1
                            d_a = d_b
                    mpos = pos - d_a
                    found = True
                    break
                d = cand_d[pos]
                if d and d <= wlim and rd32(pos - d) == rd32(pos):
                    mpos = pos - d
                    found = True
                    break
            if not found:
                break

            # --- catch-up, capped at the segment start (== anchor for
            # the first sequence) ---
            while pos > anchor and mpos > 0 and src[pos - 1] == src[mpos - 1]:
                pos -= 1
                mpos -= 1

            lit_len = pos - anchor
            if frag:
                # headerless first sequence: literal share + offset +
                # match-LSIC; token + literal-LSIC live in the previous
                # owner's header
                dst += src[anchor:pos]
                token_at = None
            else:
                token_at = len(dst)
                dst.append(0)
                if lit_len >= F.RUN_MASK:
                    token = F.RUN_MASK << F.ML_BITS
                    rem = lit_len - F.RUN_MASK
                    while rem >= 255:
                        dst.append(255)
                        rem -= 255
                    dst.append(rem)
                else:
                    token = lit_len << F.ML_BITS
                dst += src[anchor:pos]

            offset = pos - mpos
            dst += offset.to_bytes(2, "little")
            p = pos + F.MINMATCH
            m = mpos + F.MINMATCH
            count_limit = mlim - p
            mc = 0
            while mc < count_limit and src[p + mc] == src[m + mc]:
                mc += 1
            pos = p + mc
            if mc >= F.ML_MASK:
                if not frag:
                    token += F.ML_MASK
                rem = mc - F.ML_MASK
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)
            elif not frag:
                token += mc
            if frag:
                p1, m1 = p - F.MINMATCH, mc
                frag = False
            else:
                dst[token_at] = token
            has_match = True
            anchor = pos
            if pos > mfl:
                break
        parts.append(dict(stream=bytes(dst), last_end=anchor,
                          p1=p1, m1=m1, has_match=has_match))
    return parts


def assemble_seg_parts(src: bytes, parts, seg: int) -> bytes:
    """Concatenate per-segment parse pieces into one LZ4 block stream
    (see compress_dense_seg_parts). Mirrors the device assembly:
    stream_k + (owner? token'/LSIC header) + raw tail slice."""
    src = bytes(src)
    n = len(src)
    nseg = len(parts)
    out = bytearray()
    for k, pt in enumerate(parts):
        s1 = min((k + 1) * seg, n)
        out += pt["stream"]
        if pt["has_match"] or k == 0:
            # the run starting at last_end: ends at the next segment's
            # first match (post catch-up), else terminal
            nxt = next((parts[j] for j in range(k + 1, nseg)
                        if parts[j]["has_match"]), None)
            run_end = nxt["p1"] if nxt is not None else n
            mcn = min(nxt["m1"], F.ML_MASK) if nxt is not None else 0
            out += _lit_header(run_end - pt["last_end"], mcn)
        out += src[pt["last_end"]:s1]
    return bytes(out)


def compress_dense_seg(src: bytes | bytearray | memoryview,
                       seg: int = 4096, window: int = 65536,
                       hashlog: int = 16, acceleration: int = 1,
                       depth: int = 1) -> bytes:
    """One-call segmented-parse compress (parts + assembly)."""
    src = bytes(src)
    return assemble_seg_parts(
        src, compress_dense_seg_parts(src, seg, window, hashlog,
                                      acceleration, depth=depth), seg)


def dense_candidates(src: bytes, hashlog: int = 13,
                     val16_filter: bool = True):
    """Pass-1 oracle of the TPU lane-lockstep encoders: the
    parse-independent dense candidate rule.

    Every position q in [0, n-4] is inserted in order into a hash4 table
    whose entries pack ((q+1) & 0xFFFF) | (low16 of read32(q)) << 16.
    Returns cand_d: cand_d[p] = offset to the latest prior position with
    the same hash (0 = no candidate). The 16-bit packing makes the
    offset window <= 65535 structural (no separate DISTANCE_MAX check),
    at the cost of missing the vanishing set of candidates whose packed
    position is 0 mod 2^16. Unlike the reference's table (insert only at
    probed positions, lz4e_compress.c:291-336,459-464), insertion
    density does not depend on the parse, which is what lets the TPU
    engines batch pass 1.

    val16_filter drops candidates whose stored low-16 word bits differ
    from the probe's — a probe-economy knob only: compress_dense
    re-verifies every candidate with a full read32, so the compressed
    BYTES are identical either way. The enc2 sweep kernel filtered
    (hashlog 13, packed val16); the enc3 sort kernel does not
    (hashlog 16, pure (hash,pos) keys).
    """
    n = len(src)
    cand_d = [0] * n
    if n < 4:
        return cand_d
    table = [0] * (1 << hashlog)
    rd32 = [int.from_bytes(src[i:i + 4], "little") for i in range(n - 3)]
    for p in range(n - 3):
        v = rd32[p]
        h = F.hash4(v, hashlog)
        s = table[h]
        table[h] = ((p + 1) & 0xFFFF) | ((v & 0xFFFF) << 16)
        if s == 0:
            continue
        d = (p + 1 - (s & 0xFFFF)) & 0xFFFF
        if d != 0 and (not val16_filter or (s >> 16) == (v & 0xFFFF)):
            cand_d[p] = d
    return cand_d


def dense_gaps(src: bytes, hashlog: int = 16, max_gap: int = 254):
    """Pass-1 deep-mode oracle: chain gaps to the 2nd and 3rd most
    recent same-hash positions, packed as g2 | g3 << 8.

    For position p with bucket chain ...q3 < q2 < q1 < p (q1 is the
    dense candidate, d1 = (p-q1) & 0xFFFF): g2 = (p-q2) - (p-q1) and
    g3 = (p-q3) - (p-q2), each stored only while every gap so far is in
    [1, max_gap] (the 8-bit packing; a break truncates the chain). The
    TPU kernel reads q2/q3 as rolled rows 2 and 3 after the bucket sort.
    """
    n = len(src)
    out = [0] * n
    if n < 4:
        return out
    rd32 = [int.from_bytes(src[i:i + 4], "little") for i in range(n - 3)]
    chains: dict = {}
    for p in range(n - 3):
        h = F.hash4(rd32[p], hashlog)
        ch = chains.setdefault(h, [])
        if len(ch) >= 2:
            q1, q2 = ch[-1], ch[-2]
            d1 = (p - q1) & 0xFFFF
            g2 = (p - q2) - (p - q1)
            if d1 and 1 <= g2 <= max_gap:
                v = g2
                if len(ch) >= 3:
                    g3 = (q2 - ch[-3])
                    if 1 <= g3 <= max_gap:
                        v |= g3 << 8
                out[p] = v
        ch.append(p)
    return out


def dense_gaps2(src: bytes, hashlog: int = 16, max_gap: int = 254):
    """Second gaps tape for deep chains past depth 3: gaps to the 4th
    and 5th most recent same-hash positions, packed as g4 | g5 << 8.

    Stored only while the WHOLE chain is alive (d1 != 0 and g2..gk each
    in [1, max_gap] — a break truncates, matching dense_gaps). The TPU
    kernel reads q4/q5 as rolled rows 4 and 5 after the bucket sort;
    this tape is the packing contract for the planned depth-5 kernel
    mode (docs/Performance.md round-4 deep-depth sweep: every chain
    step past 3 keeps buying ~1% size).
    """
    n = len(src)
    out = [0] * n
    if n < 4:
        return out
    rd32 = [int.from_bytes(src[i:i + 4], "little") for i in range(n - 3)]
    chains: dict = {}
    for p in range(n - 3):
        h = F.hash4(rd32[p], hashlog)
        ch = chains.setdefault(h, [])
        if len(ch) >= 4:
            q1, q2, q3, q4 = ch[-1], ch[-2], ch[-3], ch[-4]
            d1 = (p - q1) & 0xFFFF
            g2 = q1 - q2
            g3 = q2 - q3
            g4 = q3 - q4
            if (d1 and 1 <= g2 <= max_gap and 1 <= g3 <= max_gap
                    and 1 <= g4 <= max_gap):
                v = g4
                if len(ch) >= 5:
                    g5 = q4 - ch[-5]
                    if 1 <= g5 <= max_gap:
                        v |= g5 << 8
                out[p] = v
        ch.append(p)
    return out


def dense_mcode(src: bytes, hashlog: int = 16):
    """Pass-1.5 oracle: verified candidates + exact capped match
    precompute (the round-5 wb-walk-elimination design,
    docs/Performance.md round-5 encode section).

    For each position p with a dense candidate d (dense_candidates
    semantics, hashlog 16, no val16 filter), q = p - d:

      * vr:   read32(p) == read32(q) (exact verify — kills the ~9%
              hash16 false probes at the source);
      * mlen: exact forward match length CAPPED at 12 (4 + byte-exact
              lcp of src[p+4..] vs src[q+4..] over 8 bytes, compared
              against the zero-padded tape exactly as the kernel
              does); more_f set when all 8 extension bytes match
              (true length >= 12 — the parse continues in EXT);
      * cu:   exact backward catch-up CAPPED at 4 (trailing equality
              of src[p-4..p) vs src[q-4..q), bytes before position 0
              reading 0 on both sides); more_b set at cu == 4.
              Consumers clamp by anchors, exactly like the parse.

    Returns (cand_d2, mcode): cand_d2 is dense_candidates with
    UNVERIFIED candidates zeroed (parse-byte-neutral: the parse
    re-verifies with read32 and treats a failed probe as no-match);
    mcode[p] packs more_f | (mlen - 4) << 1 | more_b << 5 | cu << 6,
    zero where cand_d2[p] == 0.
    """
    n = len(src)
    cand = dense_candidates(src, hashlog=hashlog, val16_filter=False)
    padded = bytes(4) + src + bytes(12)     # index shift +4; zero pads

    def rd(i, k):
        return padded[i + 4:i + 4 + k]

    d2 = [0] * n
    mc = [0] * n
    for p_pos in range(n):
        d = cand[p_pos]
        if not d:
            continue
        q = p_pos - d
        if rd(p_pos, 4) != rd(q, 4):
            continue                         # vr fail: candidate zeroed
        d2[p_pos] = d
        a = rd(p_pos + 4, 8)
        b = rd(q + 4, 8)
        lcp = 0
        while lcp < 8 and a[lcp] == b[lcp]:
            lcp += 1
        more_f = 1 if lcp == 8 else 0
        ab = rd(p_pos - 4, 4)
        bb = rd(q - 4, 4)
        cu = 0
        while cu < 4 and ab[3 - cu] == bb[3 - cu]:
            cu += 1
        more_b = 1 if cu == 4 else 0
        mc[p_pos] = more_f | ((4 + lcp - 4) << 1) | (more_b << 5) \
            | (cu << 6)
    return d2, mc


def dense_candidates_piecewise(src: bytes, piece: int = 65536,
                               hashlog: int = 16, max_gap: int = 254,
                               with_gaps: bool = False):
    """Dense candidates for inputs beyond the pos16 sort range — the
    pass-1 oracle of the TPU big-block seg engine (> 64 KiB blocks).

    The kernel's bitonic-sort pass 1 packs positions into 16 bits
    (lockstep_enc3.py), so inputs above 64 KiB run pass 1 per PIECE and
    once more over half-piece-shifted STRADDLE stretches; each pass
    yields "latest prior same-bucket occurrence within the stretch" and
    the merge keeps the nearer (most recent) candidate. Cross-piece
    matches therefore reach at least piece/2 backward everywhere (the
    reference's own window is 64 KiB, lz4e.h:53-55; positions deep in a
    piece see the full window within it).

    Returns cand_d (gaps too when with_gaps: chain gaps of the pass
    that supplied the winning candidate, dense_gaps packing).
    """
    n = len(src)
    cand = [0] * n
    gaps = [0] * n
    if n < 4:
        return (cand, gaps) if with_gaps else cand
    rd32 = [int.from_bytes(src[i:i + 4], "little") for i in range(n - 3)]

    def one_pass(base: int):
        table: dict = {}
        chains: dict = {}
        for p in range(max(base, 0), min(base + piece, n - 3)):
            h = F.hash4(rd32[p], hashlog)
            q = table.get(h)
            if q is not None:
                d = p - q
                if 0 < d <= F.DISTANCE_MAX and (cand[p] == 0
                                                or d < cand[p]):
                    cand[p] = d
                    if with_gaps:
                        gaps[p] = 0
                        ch = chains.get(h)
                        if ch and len(ch) >= 2:
                            g2 = ch[-1] - ch[-2]
                            if 1 <= g2 <= max_gap:
                                v = g2
                                if len(ch) >= 3:
                                    g3 = ch[-2] - ch[-3]
                                    if 1 <= g3 <= max_gap:
                                        v |= g3 << 8
                                gaps[p] = v
            table[h] = p
            if with_gaps:
                chains.setdefault(h, []).append(p)

    for b in range(0, n, piece):
        one_pass(b)
    for b in range(piece // 2, max(n - 3, 0), piece):
        one_pass(b)
    return (cand, gaps) if with_gaps else cand


def compress_dense_seg_big(src: bytes | bytearray | memoryview,
                           seg: int, piece: int = 65536,
                           hashlog: int = 16, acceleration: int = 1,
                           depth: int = 1) -> bytes:
    """One-call segmented compress for blocks > 64 KiB: piecewise
    candidates + the segmented-lane parse + assembly. The byte oracle
    of ops/encode.py's big-block TPU path."""
    src = bytes(src)
    if depth > 1:
        cand, gaps = dense_candidates_piecewise(
            src, piece, hashlog, with_gaps=True)
    else:
        cand, gaps = dense_candidates_piecewise(src, piece, hashlog), None
    parts = compress_dense_seg_parts(
        src, seg=seg, window=65536, hashlog=hashlog,
        acceleration=acceleration, cand_d=cand, gaps=gaps, depth=depth)
    return assemble_seg_parts(src, parts, seg)


def compress_deep(src: bytes | bytearray | memoryview,
                  acceleration: int = 1, hashlog: int = 16,
                  depth: int = 3) -> bytes:
    """Deep-match greedy compress — the byte-exact oracle of the TPU
    enc3 depth-3 mode (the HC-analog; BASELINE.json config 5).

    Same skip-schedule parse as compress_dense, but each probe evaluates
    up to `depth` candidates (the dense candidate plus chain entries
    from dense_gaps, and past depth 3 the dense_gaps2 tape — depth <= 5)
    and takes the one with the longest forward match preview (capped at
    64 B; nearest wins ties), with ONE-STEP LAZY deferral: if position
    pos+1's best preview is strictly longer, the match accepts at pos+1
    instead (its extra literal is covered by the longer match). Catch-up
    runs on the winner. Measured at depth 3: 0.9260x
    LZ4_compress_default aggregate on the config-5 corpus (the XLA
    engine's exhaustive-depth lazy parse reaches 0.9141x and stays
    available via impl='xla')."""
    src = bytes(src)
    n = len(src)
    if n > F.MAX_INPUT_SIZE:
        raise ValueError(f"input too large: {n} > {F.MAX_INPUT_SIZE}")
    if acceleration < 1:
        acceleration = F.ACCELERATION_DEFAULT
    if not 2 <= depth <= 5:
        raise ValueError(f"depth must be in [2, 5], got {depth}")
    dst = bytearray()

    def rd32(i: int) -> int:
        return int.from_bytes(src[i:i + 4], "little")

    anchor = 0
    if n >= F.MIN_LENGTH:
        cand_d = dense_candidates(src, hashlog, val16_filter=False)
        gaps = dense_gaps(src, hashlog)
        gaps2 = dense_gaps2(src, hashlog) if depth > 3 else None
        mflimit = n - F.MFLIMIT
        matchlimit = n - F.LASTLITERALS

        def best_at(p):
            """(preview_mc, match_pos) of the best of <= depth
            candidates; preview capped at 64 B (the kernel compares
            within its verify window; ties at the cap go to the
            nearest)."""
            d1 = cand_d[p]
            if not d1:
                return -1, -1
            g = gaps[p]
            ds = [d1]
            if g & 255:
                ds.append(d1 + (g & 255))
                if depth > 2 and g >> 8:
                    ds.append(d1 + (g & 255) + (g >> 8))
                    if depth > 3 and gaps2[p] & 255:
                        ds.append(ds[-1] + (gaps2[p] & 255))
                        if depth > 4 and gaps2[p] >> 8:
                            ds.append(ds[-1] + (gaps2[p] >> 8))
            best_mc = -1
            mp = -1
            for d in ds:
                m = p - d
                if m < 0 or rd32(m) != rd32(p):
                    continue
                p_, m_ = p + F.MINMATCH, m + F.MINMATCH
                cl = min(matchlimit - p_, 64)
                mc = 0
                while mc < cl and src[p_ + mc] == src[m_ + mc]:
                    mc += 1
                if mc > best_mc:           # strict: nearest wins ties
                    best_mc = mc
                    mp = m
            return best_mc, mp

        pos = 1
        while True:
            fpos = pos
            step = 1
            search_match_nb = acceleration << F.SKIPTRIGGER
            found = False
            while True:
                if fpos + step > mflimit + 1:
                    break
                pos = fpos
                fpos += step
                step = search_match_nb >> F.SKIPTRIGGER
                search_match_nb += 1
                mc_a, mpos = best_at(pos)
                if mpos < 0:
                    continue
                # one-step lazy: accept at pos+1 when its preview is
                # strictly longer
                if pos + 1 <= mflimit:
                    mc_b, mp_b = best_at(pos + 1)
                    if mp_b >= 0 and mc_b > mc_a:
                        pos += 1
                        mpos = mp_b
                found = True
                break
            if not found:
                break

            while pos > anchor and mpos > 0 and src[pos - 1] == src[mpos - 1]:
                pos -= 1
                mpos -= 1

            lit_len = pos - anchor
            token_at = len(dst)
            dst.append(0)
            if lit_len >= F.RUN_MASK:
                token = F.RUN_MASK << F.ML_BITS
                rem = lit_len - F.RUN_MASK
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)
            else:
                token = lit_len << F.ML_BITS
            dst += src[anchor:pos]

            offset = pos - mpos
            dst += offset.to_bytes(2, "little")
            p = pos + F.MINMATCH
            m = mpos + F.MINMATCH
            count_limit = matchlimit - p
            mc = 0
            while mc < count_limit and src[p + mc] == src[m + mc]:
                mc += 1
            pos = p + mc
            if mc >= F.ML_MASK:
                token += F.ML_MASK
                rem = mc - F.ML_MASK
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)
            else:
                token += mc
            dst[token_at] = token
            anchor = pos
            if pos > mflimit:
                break

    last_run = n - anchor
    if last_run >= F.RUN_MASK:
        dst.append(F.RUN_MASK << F.ML_BITS)
        rem = last_run - F.RUN_MASK
        while rem >= 255:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst.append(last_run << F.ML_BITS)
    dst += src[anchor:]
    return bytes(dst)


def compress_dense(src: bytes | bytearray | memoryview,
                   acceleration: int = 1, hashlog: int = 13) -> bytes:
    """Greedy LZ4 compress with the DENSE candidate rule — the byte-exact
    oracle of the TPU lockstep encoders: hashlog=16 is the enc3 contract
    (ops/pallas/lockstep_enc3.py), hashlog=13 the superseded enc2 one.

    Parse structure (skip-accelerated search, backward catch-up, forward
    extension to matchlimit, immediate rematch, mflimit/LASTLITERALS
    bounds, LSIC emission) mirrors compress()/lz4e_compress.c:218-534;
    only the candidate source differs: dense_candidates() above instead
    of the parse-coupled single-probe table. Output decodes with any LZ4
    decoder; measured aggregate size vs LZ4_compress_default on the
    bench corpus: 0.995x at hashlog 13, 0.990x at hashlog 16 (0.964x on
    text — finer buckets lose fewer candidates to collisions).
    """
    src = bytes(src)
    n = len(src)
    if n > F.MAX_INPUT_SIZE:
        raise ValueError(f"input too large: {n} > {F.MAX_INPUT_SIZE}")
    if acceleration < 1:
        acceleration = F.ACCELERATION_DEFAULT
    dst = bytearray()

    def rd32(i: int) -> int:
        return int.from_bytes(src[i:i + 4], "little")

    anchor = 0
    if n >= F.MIN_LENGTH:
        cand_d = dense_candidates(src, hashlog)
        mflimit = n - F.MFLIMIT
        matchlimit = n - F.LASTLITERALS
        pos = 1
        while True:
            # --- skip-accelerated search over precomputed candidates ---
            fpos = pos
            step = 1
            search_match_nb = acceleration << F.SKIPTRIGGER
            found = False
            while True:
                if fpos + step > mflimit + 1:
                    break
                pos = fpos
                fpos += step
                step = search_match_nb >> F.SKIPTRIGGER
                search_match_nb += 1
                d = cand_d[pos]
                if d and rd32(pos - d) == rd32(pos):
                    mpos = pos - d
                    found = True
                    break
            if not found:
                break

            while pos > anchor and mpos > 0 and src[pos - 1] == src[mpos - 1]:
                pos -= 1
                mpos -= 1

            lit_len = pos - anchor
            token_at = len(dst)
            dst.append(0)
            if lit_len >= F.RUN_MASK:
                token = F.RUN_MASK << F.ML_BITS
                rem = lit_len - F.RUN_MASK
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)
            else:
                token = lit_len << F.ML_BITS
            dst += src[anchor:pos]

            while True:  # _next_match
                offset = pos - mpos
                dst += offset.to_bytes(2, "little")
                p = pos + F.MINMATCH
                m = mpos + F.MINMATCH
                count_limit = matchlimit - p
                mc = 0
                while mc < count_limit and src[p + mc] == src[m + mc]:
                    mc += 1
                pos = p + mc
                if mc >= F.ML_MASK:
                    token += F.ML_MASK
                    rem = mc - F.ML_MASK
                    while rem >= 255:
                        dst.append(255)
                        rem -= 255
                    dst.append(rem)
                else:
                    token += mc
                dst[token_at] = token
                anchor = pos
                break
            if pos > mflimit:
                break
            # No separate immediate-rematch probe (lz4e_compress.c:486-493):
            # the next search starts AT pos with a fresh schedule, so its
            # first probe IS the rematch (the dense sweep already inserted
            # every in-match position, a superset of the reference's pos-2
            # refill at lz4e_compress.c:459-464). A rematch hit emits the
            # same zero-literal token through the normal sequence path.

    last_run = n - anchor
    if last_run >= F.RUN_MASK:
        dst.append(F.RUN_MASK << F.ML_BITS)
        rem = last_run - F.RUN_MASK
        while rem >= 255:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst.append(last_run << F.ML_BITS)
    dst += src[anchor:]
    return bytes(dst)

"""LZ4 block-format constants and bounds.

The port's own copy of ``lz4_sgori_tpu/format.py`` (same names and
values; the port imports nothing of the JAX package), plus the constants
of the retired engines under ``tools/retired/`` at the end.

This is the TPU-native analog of the reference codec's public constants
(reference: lz4e/include/lz4e.h:9-28,53-55 and lz4e/include/lz4e_defs.h:83-110).
The *format contract* is what carries over from the reference — the token
layout (4-bit literal run | 4-bit match length), LSIC length extension bytes,
little-endian 16-bit offsets, the 64 KB window, the block termination rules,
and the COMPRESSBOUND worst-case output size. Everything else (iterators,
scatter-gather address codecs) was kernel-memory plumbing and intentionally
does not exist here: TPU blocks are dense arrays.
"""

from __future__ import annotations

# --- Match/sequence geometry (lz4e_defs.h:83-92) ---
MINMATCH = 4
WILDCOPYLENGTH = 8
LASTLITERALS = 5  # the last 5 bytes of a block are always literals
MFLIMIT = WILDCOPYLENGTH + MINMATCH  # 12: last match starts >= 12 bytes before end
MIN_LENGTH = MFLIMIT + 1  # 13: inputs shorter than this are stored as literals
MATCH_SAFEGUARD_DISTANCE = 2 * WILDCOPYLENGTH - MINMATCH

# --- Token layout (lz4e_defs.h:107-110) ---
ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1  # 15
RUN_BITS = 8 - ML_BITS
RUN_MASK = (1 << RUN_BITS) - 1  # 15

# --- Window / sizes (lz4e.h:24-28,53-55) ---
DISTANCE_MAX = 65535  # LE16 offsets; history window
MAX_INPUT_SIZE = 0x7E000000  # 2 113 929 216 bytes

# --- Hash table (lz4e.h:11-14, lz4e_compress.c:48-57) ---
MEMORY_USAGE = 14
HASHLOG = MEMORY_USAGE - 2  # 12 -> 4096-entry u32 table
ACCELERATION_DEFAULT = 1
SKIPTRIGGER = 6  # lz4e_defs.h:96

# Inputs below this threshold use the small-input hash configuration
# (hashlog + 1), mirroring the reference's widest table for small layouts
# (lz4e_compress.c:48-57) and stock LZ4's byU16 mode. Offsets of such inputs
# always fit the 64 KB window, so no window check is needed.
SMALL_INPUT_LIMIT = 65536 + (MFLIMIT - 1)  # 65547

HASH4_PRIME = 2654435761  # Knuth multiplicative (lz4e_compress.c:59-66)
HASH5_PRIME = 889523592379  # 40-bit prime (lz4e_compress.c:68-83)

# --- The retired round-1 engines (tools/retired/; not in the JAX package's
# format.py) ---
# PALLAS_MAX_BLOCK of encode_kernel.py and decode_kernel.py. Below it the
# encoder's 13-bit hash4 table (_HASHLOG) is golden's small-input table,
# hashlog_for_input(n), hence byte parity with LZ4_compress_default.
RETIRED_MAX_BLOCK = 65536
# lockstep_v9.py: out_size must be a multiple of max(HSPAN, 4 * FBAND)
V9_OUT_ALIGN = 1024

_U32 = (1 << 32) - 1
_U64 = (1 << 64) - 1


def compress_bound(isize: int) -> int:
    """Worst-case compressed size: isize + isize/255 + 16 (lz4e.h:25-28).

    Returns 0 for inputs above MAX_INPUT_SIZE, like the reference macro.
    """
    if isize > MAX_INPUT_SIZE or isize < 0:
        return 0
    return isize + isize // 255 + 16


def hash4(value32: int, hashlog: int = HASHLOG) -> int:
    """32-bit multiplicative hash of a 4-byte little-endian word."""
    return ((value32 * HASH4_PRIME) & _U32) >> (32 - hashlog)


def hash5(value64: int, hashlog: int = HASHLOG) -> int:
    """Hash of the low 5 bytes of an 8-byte little-endian word.

    ((v << 24) * prime5) >> (64 - hashlog) on the 64-bit ring — the shift
    discards the top 3 input bytes so only 5 bytes participate.
    """
    return (((value64 << 24) & _U64) * HASH5_PRIME & _U64) >> (64 - hashlog)


def hashlog_for_input(isize: int) -> int:
    """Hash-table log2 size used for a given input size."""
    return HASHLOG + 1 if isize < SMALL_INPUT_LIMIT else HASHLOG


def worst_case_sequences(isize: int) -> int:
    """Upper bound on the number of sequences in a block of `isize` bytes.

    Every non-final sequence advances the input by at least 1 literal-free
    match of MINMATCH bytes or 1 literal byte; the tightest packing is
    back-to-back MINMATCH matches with zero literals.
    """
    return isize // MINMATCH + 2

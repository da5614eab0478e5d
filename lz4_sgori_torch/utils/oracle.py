"""ctypes binding to the system liblz4 — the cross-implementation parity oracle.

The port's own copy of ``lz4_sgori_tpu/utils/oracle.py``.

The reference validates its SG compressor by decompressing every write with
*stock* kernel LZ4 (lz4e_bdev/lz4e_chunk.c:119-137); cross-implementation
compatibility is therefore a tested contract. This module provides the same
oracle role in userspace: anything our encoders produce must be decodable by
liblz4, and anything liblz4 produces must be decodable by our decoders.

Gracefully degrades to unavailable if liblz4 is not installed.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.LZ4_compress_default.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.LZ4_compress_default.restype = ctypes.c_int
        lib.LZ4_compress_fast.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.LZ4_compress_fast.restype = ctypes.c_int
        lib.LZ4_decompress_safe.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        lib.LZ4_compressBound.argtypes = [ctypes.c_int]
        lib.LZ4_compressBound.restype = ctypes.c_int
        _lib = lib
        return lib
    return None


def available() -> bool:
    return _load() is not None


def version() -> str:
    """liblz4 version string (pins the bench baseline's provenance)."""
    lib = _load()
    if lib is None:
        return "unavailable"
    try:
        lib.LZ4_versionNumber.restype = ctypes.c_int
        v = lib.LZ4_versionNumber()
        return f"{v // 10000}.{(v // 100) % 100}.{v % 100}"
    except Exception:
        return "unknown"


def compress(data: bytes) -> bytes:
    """LZ4_compress_default via liblz4. Raises RuntimeError if unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available")
    bound = lib.LZ4_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = lib.LZ4_compress_default(data, dst, len(data), bound)
    if n <= 0:
        raise RuntimeError(f"LZ4_compress_default failed: {n}")
    return dst.raw[:n]


def compress_fast(data: bytes, acceleration: int = 1) -> bytes:
    """LZ4_compress_fast via liblz4 — the acceleration-knob parity oracle
    (lz4e.h:9 LZ4E_ACCELERATION_DEFAULT; skip scaling lz4e_compress.c:296-307).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available")
    bound = lib.LZ4_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = lib.LZ4_compress_fast(data, dst, len(data), bound, acceleration)
    if n <= 0:
        raise RuntimeError(f"LZ4_compress_fast failed: {n}")
    return dst.raw[:n]


def decompress(data: bytes, max_output: int) -> bytes:
    """LZ4_decompress_safe via liblz4. Raises ValueError on malformed input."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available")
    dst = ctypes.create_string_buffer(max(1, max_output))
    n = lib.LZ4_decompress_safe(data, dst, len(data), max_output)
    if n < 0:
        raise ValueError(f"LZ4_decompress_safe failed: {n}")
    return dst.raw[:n]

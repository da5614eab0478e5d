"""Native host codec: lazy-built C++ library + ctypes binding.

The port's own copy of ``lz4_sgori_tpu/native`` (the same C++ source);
it builds into ``lz4_sgori_torch/_build/``.

The reference's entire runtime is native (kernel C); this module is the
framework's native host-runtime piece — a clean-room C++ implementation of
the same block codec (src/lz4j_codec.cc) used for:

- the fast host-side fallback encoder in the write-verify path
  (blocks.compress_to_blocks), replacing the slow pure-Python golden
  encoder when available;
- host container IO where device round trips would waste PCIe/ICI;
- a third cross-implementation oracle in tests (golden == native == liblz4
  byte parity for the encoder).

Built on demand with g++ (the environment bakes the toolchain but not
pybind11, so the binding is plain ctypes over a C ABI). Degrades gracefully
to unavailable if no compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "lz4j_codec.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD_DIR, "liblz4j.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    tmp = f"{_SO}.{os.getpid()}.tmp"     # concurrent builds never share it
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.lz4j_compress_bound.argtypes = [ctypes.c_int]
        lib.lz4j_compress_bound.restype = ctypes.c_int
        for fn in (lib.lz4j_compress_default, lib.lz4j_decompress_safe):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def compress(data: bytes, max_output: int | None = None) -> bytes:
    """Native greedy block compress (LZ4_compress_default semantics).
    Raises ValueError on limited-output overflow (0 return)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable (no g++?)")
    cap = max_output if max_output is not None else \
        lib.lz4j_compress_bound(len(data))
    dst = ctypes.create_string_buffer(max(1, cap))
    n = lib.lz4j_compress_default(data, dst, len(data), cap)
    if n <= 0:
        raise ValueError("output buffer too small")
    return dst.raw[:n]


def decompress(data: bytes, max_output: int) -> bytes:
    """Native safe block decode. Raises ValueError on malformed input."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable (no g++?)")
    dst = ctypes.create_string_buffer(max(1, max_output))
    n = lib.lz4j_decompress_safe(data, dst, len(data), max_output)
    if n < 0:
        raise ValueError(f"malformed block (native code {n})")
    return dst.raw[:n]

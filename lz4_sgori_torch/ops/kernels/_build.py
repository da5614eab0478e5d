"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library under ``lz4_sgori_torch/_build/`` at first use (never at
import: machines without ``nvcc`` import every module). The headers
``csrc/*.cuh`` enter every library's cache key. Different kernels build
concurrently (one nvcc each), so a caller that loads them from a thread
pool builds them all in the time of the slowest. Every C entry
takes pointers and the stream as ``void*`` and lengths as ``int``, and
returns ``cudaGetLastError()`` after its launch; ``check`` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}      # ptxas register / shared-memory report


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(h for h in os.listdir(CSRC) if h.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stderr
    os.replace(tmp, so)
    return so


def load(name: str, entries: dict[str, str]) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.cu. ``entries`` maps each C entry
    point to its signature, one letter per argument: ``p`` for a pointer
    or the stream (``c_void_p``), ``i`` for a length (``c_int``), ``n``
    for a byte count (``c_size_t``)."""
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "n": ctypes.c_size_t}
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            for fn, sig in entries.items():
                f = getattr(lib, fn)
                f.argtypes = [kinds[c] for c in sig]
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


def stream(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

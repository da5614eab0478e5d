"""Chunk stores on PyTorch devices.

Port of ``lz4_sgori_tpu/store.py``: the verifying ``ProxyStore`` (the
reference's lz4e_bdev proxy block device: every write is compressed,
decode-verified and written through as the original bytes; reads pass
through) and the ``CompressedStore`` (chunks persist compressed, reads
decompress). Both take an explicit ``device``, default ``"cuda"``, which
raises without CUDA instead of falling back to the CPU, and a
``match_depth`` for their writes (None: greedy; 3 and 5: the deep modes,
as ``blocks.compress``).

``ProxyStore.write`` also counts the request's host re-encodes in the
store's ``Stats.encode_fallbacks``, so a run can show that no block left
the device path.

The admin surface (``map_store``/``unmap_store``/``get_store``/
``stats_text``/``stats_reset``) keeps one store in a singleton registry,
under a lock.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from . import blocks as B
from .utils.stats import Stats

__all__ = ["ProxyStore", "CompressedStore", "StoreError", "map_store",
           "unmap_store", "get_store", "stats_text", "stats_reset"]


class StoreError(RuntimeError):
    """I/O failure (the analog of BLK_STS_* error propagation)."""


class ProxyStore:
    """Verifying pass-through store over a backing file; writes run the
    compress + decode-verify pipeline on ``device``, reads pass through."""

    def __init__(self, backing_path: str, chunk_size: int = 4096,
                 capacity: int | None = None, *, device="cuda",
                 match_depth: int | None = None):
        self.device = B.resolve_device(device)
        self.match_depth = match_depth
        if chunk_size < 1:
            raise StoreError("chunk_size must be positive")
        self.backing_path = backing_path
        self.chunk_size = chunk_size
        self.stats = Stats()
        mode = "r+b" if os.path.exists(backing_path) else "w+b"
        self._f = open(backing_path, mode)
        if capacity is not None:
            self._f.truncate(capacity)
        self._f.seek(0, os.SEEK_END)
        self.capacity = self._f.tell()
        self._lock = threading.Lock()

    def write(self, offset: int, data: bytes) -> None:
        """Compress + verify + write-through. Raises StoreError if the
        codec pipeline fails (a failed request, counted)."""
        self._check_range(offset, len(data))
        req = Stats()
        try:
            cb = B.compress_to_blocks(data, self.chunk_size, verify=True,
                                      stats=req, device=self.device,
                                      match_depth=self.match_depth)
        except Exception as e:
            self.stats.update(is_write=True, ok=False, blocks=0, nbytes=0)
            raise StoreError(f"compress pipeline failed: {e}") from e
        for _ in range(req.encode_fallbacks):
            self.stats.record_fallback()
        # the round trip held (verify=True): write the original bytes
        with self._lock:
            self._f.seek(offset)
            self._f.write(data)
            self._f.flush()
        self.stats.update(is_write=True, ok=True, blocks=cb.num_blocks,
                          nbytes=len(data))

    def read(self, offset: int, size: int) -> bytes:
        self._check_range(offset, size)
        with self._lock:
            self._f.seek(offset)
            data = self._f.read(size)
        nblocks = max(1, -(-size // self.chunk_size))
        self.stats.update(is_write=False, ok=True, blocks=nblocks,
                          nbytes=len(data))
        return data

    def close(self) -> None:
        self._f.close()

    def info(self) -> str:
        return f"proxy over {self.backing_path}"

    def _check_range(self, offset: int, size: int) -> None:
        if offset < 0 or size < 0 or offset + size > self.capacity:
            raise StoreError(
                f"range [{offset}, {offset + size}) outside capacity "
                f"{self.capacity}")


class CompressedStore:
    """Chunk store that persists compressed containers, one file per
    chunk index; reads decompress on ``device``. Absent chunks read as
    zeros."""

    def __init__(self, root: str, chunk_size: int = 65536, *,
                 device="cuda", match_depth: int | None = None):
        self.device = B.resolve_device(device)
        self.match_depth = match_depth
        self.root = root
        self.chunk_size = chunk_size
        self.stats = Stats()
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, f"chunk_{idx:08d}.lz4j")

    def write_chunk(self, idx: int, data: bytes) -> int:
        """Store one chunk compressed; returns the compressed size."""
        if len(data) > self.chunk_size:
            raise StoreError(
                f"chunk {idx}: {len(data)} > chunk_size {self.chunk_size}")
        container = B.compress(data, self.chunk_size, verify=True,
                               stats=self.stats, device=self.device,
                               match_depth=self.match_depth)
        with self._lock:
            tmp = self._path(idx) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(container)
            os.replace(tmp, self._path(idx))
        return len(container)

    def read_chunk(self, idx: int) -> bytes:
        path = self._path(idx)
        if not os.path.exists(path):
            self.stats.update(is_write=False, ok=True, blocks=1, nbytes=0)
            return bytes(self.chunk_size)
        with open(path, "rb") as f:
            container = f.read()
        data = B.decompress(container, stats=self.stats, device=self.device)
        if len(data) < self.chunk_size:
            data = data + bytes(self.chunk_size - len(data))
        return data

    def close(self) -> None:
        pass

    def info(self) -> str:
        return f"compressed store at {self.root} (chunk {self.chunk_size})"


# -- module-level admin surface (sysfs analog) ----------------------------

@dataclass
class _Registry:
    store: ProxyStore | CompressedStore | None = None


_registry = _Registry()
_registry_lock = threading.Lock()


def map_store(backing_path: str, chunk_size: int = 4096,
              capacity: int | None = None, *, compressed: bool = False,
              device="cuda"):
    """Create the singleton store; EBUSY if one exists."""
    with _registry_lock:
        if _registry.store is not None:
            raise StoreError("store already mapped (EBUSY)")
        if compressed:
            _registry.store = CompressedStore(backing_path, chunk_size,
                                              device=device)
        else:
            _registry.store = ProxyStore(backing_path, chunk_size, capacity,
                                         device=device)
        return _registry.store


def unmap_store() -> None:
    """Tear the store down; ENODEV if none is mapped."""
    with _registry_lock:
        if _registry.store is None:
            raise StoreError("no store mapped (ENODEV)")
        _registry.store.close()
        _registry.store = None


def get_store():
    with _registry_lock:
        if _registry.store is None:
            raise StoreError("no store mapped (ENODEV)")
        return _registry.store


def stats_text() -> str:
    """The stats text (analog of reading the reference's stats param)."""
    return get_store().stats.render()


def stats_reset() -> None:
    get_store().stats.reset()

"""Chunk stores on PyTorch devices.

Port of ``lz4_sgori_tpu/store.py``: the verifying ``ProxyStore`` (the
reference's lz4e_bdev proxy block device: every write is compressed,
decode-verified and written through as the original bytes; reads pass
through) and the ``CompressedStore`` (chunks persist compressed, reads
decompress). Both subclass the JAX package's stores and bind this
package's ``blocks``; they take an explicit ``device``, default
``"cuda"``, which raises without CUDA instead of falling back to the
CPU. ``StoreError`` and ``Stats`` are the JAX package's own (neither
imports jax).

``ProxyStore.write`` also counts the request's host re-encodes in the
store's ``Stats.encode_fallbacks``, so a run can show that no block left
the device path.

The admin surface (``map_store``/``unmap_store``/``get_store``/
``stats_text``/``stats_reset``) keeps this package's own singleton (the
JAX package's ``_Registry``), under a lock.
"""

from __future__ import annotations

import os
import threading

from lz4_sgori_tpu import store as _jax_store
from lz4_sgori_tpu.store import StoreError
from lz4_sgori_tpu.utils.stats import Stats

from . import blocks as B

__all__ = ["ProxyStore", "CompressedStore", "StoreError", "map_store",
           "unmap_store", "get_store", "stats_text", "stats_reset"]


class ProxyStore(_jax_store.ProxyStore):
    """Verifying pass-through store over a backing file; writes run the
    compress + decode-verify pipeline on ``device``."""

    def __init__(self, backing_path: str, chunk_size: int = 4096,
                 capacity: int | None = None, *, device="cuda"):
        self.device = B.resolve_device(device)
        super().__init__(backing_path, chunk_size, capacity)

    def write(self, offset: int, data: bytes) -> None:
        """Compress + verify + write-through. Raises StoreError if the
        codec pipeline fails (a failed request, counted)."""
        self._check_range(offset, len(data))
        req = Stats()
        try:
            cb = B.compress_to_blocks(data, self.chunk_size, verify=True,
                                      stats=req, device=self.device)
        except Exception as e:
            self.stats.update(is_write=True, ok=False, blocks=0, nbytes=0)
            raise StoreError(f"compress pipeline failed: {e}") from e
        for _ in range(req.encode_fallbacks):
            self.stats.record_fallback()
        with self._lock:
            self._f.seek(offset)
            self._f.write(data)
            self._f.flush()
        self.stats.update(is_write=True, ok=True, blocks=cb.num_blocks,
                          nbytes=len(data))


class CompressedStore(_jax_store.CompressedStore):
    """Chunk store that persists compressed containers; reads decompress
    on ``device``. Absent chunks read as zeros."""

    def __init__(self, root: str, chunk_size: int = 65536, *,
                 device="cuda"):
        self.device = B.resolve_device(device)
        super().__init__(root, chunk_size)

    def write_chunk(self, idx: int, data: bytes) -> int:
        """Store one chunk compressed; returns the compressed size."""
        if len(data) > self.chunk_size:
            raise StoreError(
                f"chunk {idx}: {len(data)} > chunk_size {self.chunk_size}")
        container = B.compress(data, self.chunk_size, verify=True,
                               stats=self.stats, device=self.device)
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
        return data + bytes(self.chunk_size - len(data))


# -- module-level admin surface (sysfs analog) ----------------------------

_registry = _jax_store._Registry()
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

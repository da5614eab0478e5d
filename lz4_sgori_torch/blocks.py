"""Chunked block framing on PyTorch devices.

Port of ``lz4_sgori_tpu/blocks.py``: ``compress``, ``compress_to_blocks``
and ``decompress``, and the port's own copies of the container pieces
(``split_blocks``, ``join_blocks``, ``CompressedBlocks`` and its
(de)serialisation, ``VerifyError``, ``_pad_slot``). The container bytes
are the JAX package's, so containers move freely between the two
packages.

The write path keeps the reference's contract: a block the device
engine could not encode (``comp_len`` 0) is re-encoded on the host, every
block is decoded back and compared before it is accepted (one batched
device decode), and a block that fails is re-encoded on the host. Each
such host re-encode is counted through ``Stats.record_fallback``.

Functions take an explicit ``device``; the top-level ones default to
``"cuda"`` and raise when CUDA is absent instead of falling back to the
CPU. ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from . import format as F
from . import golden, native
from .ops.decode import decompress_blocks_device
from .ops.encode import compress_blocks_device
from .utils.stats import Stats

__all__ = ["compress", "compress_to_blocks", "decompress", "to_device",
           "from_device", "CompressedBlocks", "VerifyError"]

MAGIC = b"LZ4J"
VERSION = 1
_HEADER = struct.Struct("<4sBBHIIQ")  # magic ver flags pad bs nblocks rawsz
FLAG_CRC = 1  # per-block crc32 of the raw bytes follows the size table

DEFAULT_BLOCK_SIZE = 65536


def split_blocks(data: bytes, block_size: int):
    """Frame a byte stream into padded dense blocks.

    Returns (raw uint8 [num_blocks, block_size], raw_len int32 [num_blocks]).
    An empty stream is one empty block.
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    n = len(data)
    num = max(1, -(-n // block_size))
    raw = np.zeros((num, block_size), np.uint8)
    raw.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    raw_len = np.full(num, block_size, np.int32)
    if n % block_size or n == 0:
        raw_len[-1] = n - (num - 1) * block_size
    return raw, raw_len


def join_blocks(out: np.ndarray, out_len: np.ndarray) -> bytes:
    """Inverse of split_blocks: concatenate valid prefixes."""
    return b"".join(out[j, :out_len[j]].tobytes() for j in range(out.shape[0]))


@dataclass
class CompressedBlocks:
    """Compressed framing: COMPRESSBOUND-padded slots plus a size vector
    and, per block, the crc32 of its raw bytes (None: no crc table)."""

    comp: np.ndarray          # uint8 [num_blocks, slot]
    comp_len: np.ndarray      # int32 [num_blocks]
    block_size: int
    raw_size: int
    raw_crc: np.ndarray | None = None

    @property
    def num_blocks(self) -> int:
        return self.comp.shape[0]

    @property
    def compressed_size(self) -> int:
        return int(self.comp_len.sum())

    @property
    def ratio(self) -> float:
        c = self.compressed_size
        return self.raw_size / c if c else 0.0

    def to_container(self) -> bytes:
        """Serialize: header | u32 sizes | [u32 raw crcs] | packed payloads."""
        flags = FLAG_CRC if self.raw_crc is not None else 0
        head = _HEADER.pack(MAGIC, VERSION, flags, 0, self.block_size,
                            self.num_blocks, self.raw_size)
        sizes = self.comp_len.astype("<u4").tobytes()
        crcs = (self.raw_crc.astype("<u4").tobytes()
                if self.raw_crc is not None else b"")
        payload = b"".join(
            self.comp[j, :self.comp_len[j]].tobytes()
            for j in range(self.num_blocks))
        return head + sizes + crcs + payload

    @classmethod
    def from_container(cls, blob: bytes) -> "CompressedBlocks":
        if len(blob) < _HEADER.size:
            raise ValueError("container too short")
        magic, ver, flags, _pad, block_size, nblocks, raw_size = \
            _HEADER.unpack_from(blob, 0)
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        if ver != VERSION:
            raise ValueError(f"unsupported container version {ver}")
        # range-check the header before any allocation sized from it
        if not (1 <= block_size <= F.MAX_INPUT_SIZE):
            raise ValueError(f"container corrupt (block_size {block_size})")
        if nblocks < 0 or raw_size < 0 or raw_size > nblocks * block_size:
            raise ValueError("container corrupt (block count / raw size)")
        off = _HEADER.size
        ntab = 2 if flags & FLAG_CRC else 1
        if len(blob) < off + 4 * nblocks * ntab:
            raise ValueError("container truncated (size table)")
        sizes = np.frombuffer(blob, "<u4", nblocks, off).astype(np.int64)
        off += 4 * nblocks
        raw_crc = None
        if flags & FLAG_CRC:
            raw_crc = np.frombuffer(blob, "<u4", nblocks, off).copy()
            off += 4 * nblocks
        slot = F.compress_bound(block_size) + 8
        if sizes.min() < 0 or sizes.max() > slot:
            raise ValueError("container corrupt (block size out of range)")
        if off + int(sizes.sum()) > len(blob):
            raise ValueError("container truncated (payload)")
        comp = np.zeros((nblocks, slot), np.uint8)
        for j in range(nblocks):
            c = int(sizes[j])
            comp[j, :c] = np.frombuffer(blob, np.uint8, c, off)
            off += c
        return cls(comp=comp, comp_len=sizes.astype(np.int32),
                   block_size=block_size, raw_size=raw_size,
                   raw_crc=raw_crc)


class VerifyError(RuntimeError):
    """A compressed block failed decode-verify."""


def _pad_slot(comp: np.ndarray, slot: int) -> np.ndarray:
    if comp.shape[1] >= slot:
        return comp
    out = np.zeros((comp.shape[0], slot), np.uint8)
    out[:, :comp.shape[1]] = comp
    return out


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(cb: CompressedBlocks, device):
    """(comp uint8 [B, slot], comp_len int32 [B]) on ``device``, with the
    slot padded to ``compress_bound(block_size) + 8`` so every block has
    the decoder's pad bytes (containers from either package)."""
    dev = resolve_device(device)
    comp = _pad_slot(np.ascontiguousarray(cb.comp, np.uint8),
                     F.compress_bound(cb.block_size) + 8)
    return (torch.from_numpy(comp).to(dev),
            torch.from_numpy(np.asarray(cb.comp_len, np.int32)).to(dev))


def from_device(comp: torch.Tensor, comp_len: torch.Tensor, block_size: int,
                raw_size: int, raw_crc=None) -> CompressedBlocks:
    """A host ``CompressedBlocks`` (numpy) from device tensors."""
    return CompressedBlocks(comp=comp.cpu().numpy().copy(),
                            comp_len=comp_len.cpu().numpy().astype(np.int32),
                            block_size=block_size, raw_size=raw_size,
                            raw_crc=raw_crc)


def compress(data: bytes, block_size: int = DEFAULT_BLOCK_SIZE, *,
             verify: bool = True, stats: Stats | None = None,
             match_depth: int | None = None, acceleration: int = 1,
             size_dominance: bool = False, device="cuda") -> bytes:
    """Compress a byte stream into a container on ``device``."""
    return compress_to_blocks(
        data, block_size, verify=verify, stats=stats,
        match_depth=match_depth, acceleration=acceleration,
        size_dominance=size_dominance, device=device).to_container()


def _host_encoder():
    return native.compress if native.available() else golden.compress


def _put(comp: np.ndarray, comp_len: np.ndarray, j: int, blob: bytes):
    comp[j, :] = 0
    comp[j, :len(blob)] = np.frombuffer(blob, np.uint8)
    comp_len[j] = len(blob)


def compress_to_blocks(data: bytes, block_size: int = DEFAULT_BLOCK_SIZE, *,
                       verify: bool = True, stats: Stats | None = None,
                       match_depth: int | None = None,
                       acceleration: int = 1, size_dominance: bool = False,
                       device="cuda") -> CompressedBlocks:
    dev = resolve_device(device)
    raw, raw_len = split_blocks(data, block_size)
    raw_t = torch.from_numpy(raw).to(dev)
    rlen_t = torch.from_numpy(raw_len).to(dev)
    comp_t, clen_t = compress_blocks_device(
        raw_t, rlen_t, block_size, match_depth=match_depth,
        acceleration=acceleration)
    comp = comp_t.cpu().numpy().copy()
    comp_len = clen_t.cpu().numpy().copy()
    changed = False

    # comp_len == 0 for a nonempty block is the device encoder's failure
    # signal; re-encode on the host even with verify=False
    for j in np.nonzero((comp_len == 0) & (raw_len > 0))[0]:
        _put(comp, comp_len, j,
             _host_encoder()(raw[j, :raw_len[j]].tobytes()))
        changed = True
        if stats is not None:
            stats.record_fallback()

    if size_dominance and not native.available():
        import warnings
        warnings.warn(
            "size_dominance requested but the native reference codec "
            "is unavailable; the LZ4_compress_default size bound is "
            "NOT being enforced on this call.", stacklevel=2)
    if size_dominance and native.available():
        for j in np.nonzero(comp_len > 0)[0]:
            ref = native.compress(raw[j, :raw_len[j]].tobytes())
            if len(ref) < comp_len[j]:
                _put(comp, comp_len, j, ref)
                changed = True

    if verify:
        # batched decode-verify: one device decode for the whole container
        if changed:
            comp_t = torch.from_numpy(comp).to(dev)
            clen_t = torch.from_numpy(comp_len).to(dev)
        out, out_len, err = decompress_blocks_device(comp_t, clen_t,
                                                     block_size)
        pos = torch.arange(block_size, device=dev)[None, :]
        same = ((pos >= rlen_t[:, None]) | (out == raw_t)).all(dim=1)
        ok = (~err & (out_len == rlen_t) & same).cpu().numpy()
        for j in np.nonzero(~ok)[0]:
            _put(comp, comp_len, j,
                 _host_encoder()(raw[j, :raw_len[j]].tobytes()))
            if stats is not None:
                stats.record_fallback()
    if stats is not None:
        stats.update(is_write=True, ok=True, blocks=raw.shape[0],
                     nbytes=len(data))
    raw_crc = np.array(
        [zlib.crc32(raw[j, :raw_len[j]].tobytes()) & 0xFFFFFFFF
         for j in range(raw.shape[0])], dtype=np.uint32)
    return CompressedBlocks(comp=comp, comp_len=comp_len,
                            block_size=block_size, raw_size=len(data),
                            raw_crc=raw_crc)


def decompress(container: bytes, *, stats: Stats | None = None,
               device="cuda") -> bytes:
    """Decompress a container back into the original byte stream."""
    dev = resolve_device(device)
    cb = CompressedBlocks.from_container(container)
    comp, comp_len = to_device(cb, dev)
    out, out_len, err = decompress_blocks_device(comp, comp_len,
                                                 cb.block_size)
    err = err.cpu().numpy()
    if err.any():
        bad = int(np.argmax(err))
        if stats is not None:
            stats.update(is_write=False, ok=False, blocks=cb.num_blocks,
                         nbytes=0)
        raise golden.DecodeError(f"malformed block {bad}", bad)
    out = out.cpu().numpy()
    out_len = out_len.cpu().numpy()
    data = join_blocks(out, out_len)
    if len(data) != cb.raw_size:
        raise golden.DecodeError(
            f"container raw size {cb.raw_size} != decoded {len(data)}", 0)
    if cb.raw_crc is not None:
        for j in range(cb.num_blocks):
            got = zlib.crc32(out[j, :out_len[j]].tobytes()) & 0xFFFFFFFF
            if got != int(cb.raw_crc[j]):
                if stats is not None:
                    stats.update(is_write=False, ok=False,
                                 blocks=cb.num_blocks, nbytes=0)
                raise golden.DecodeError(
                    f"checksum mismatch in block {j}", j)
    if stats is not None:
        stats.update(is_write=False, ok=True, blocks=cb.num_blocks,
                     nbytes=len(data))
    return data

"""The port's framing layer (the whole slice) on CPU tensors: containers
against golden seg bytes, cross-decode with the JAX package, native and
liblz4, write-verify fallbacks, crc and corrupt-container errors."""

import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import lz4_sgori_torch
from lz4_sgori_torch import blocks as TB
from lz4_sgori_torch.golden import DecodeError
from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
from lz4_sgori_tpu import blocks as JB
from lz4_sgori_tpu import golden, native
from lz4_sgori_tpu.utils import oracle
from lz4_sgori_tpu.utils.stats import Stats

BS = 16384          # the smallest block of the seg engine's v7 decode band


def _golden_container(data: bytes, bs: int) -> bytes:
    raw, rlen = JB.split_blocks(data, bs)
    comps = [golden.compress_dense_seg(raw[j, :rlen[j]].tobytes(), 4096,
                                       65536, 16)
             for j in range(raw.shape[0])]
    slot = max(map(len, comps))
    comp = np.zeros((len(comps), slot), np.uint8)
    for j, c in enumerate(comps):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
    crc = np.array([zlib.crc32(raw[j, :rlen[j]].tobytes())
                    for j in range(raw.shape[0])], np.uint32)
    return JB.CompressedBlocks(
        comp=comp, comp_len=np.array(list(map(len, comps)), np.int32),
        block_size=bs, raw_size=len(data), raw_crc=crc).to_container()


@pytest.mark.parametrize("name", ["mixed", "text_large", "zeros_64k",
                                  "random_jpeg_scale", "empty", "tiny"])
def test_container_equals_golden_seg_and_roundtrips(fixtures, name):
    data = fixtures[name]
    if name == "random_jpeg_scale":
        data = data[:3 * BS + 77]
    stats = Stats()
    container = lz4_sgori_torch.compress(data, BS, stats=stats,
                                         device="cpu")
    assert container == _golden_container(data, BS)
    assert lz4_sgori_torch.decompress(container, stats=stats,
                                      device="cpu") == data
    assert stats.encode_fallbacks == 0
    d = stats.as_dict()
    assert d["write"]["reqs_total"] == 1 and d["read"]["data_bytes"] == \
        len(data)


def test_port_container_decodes_under_jax_native_and_liblz4(fixtures):
    data = fixtures["mixed"]
    container = lz4_sgori_torch.compress(data, BS, device="cpu")
    assert JB.decompress(container) == data
    cb = JB.CompressedBlocks.from_container(container)
    for j in range(cb.num_blocks):
        c = cb.comp[j, :cb.comp_len[j]].tobytes()
        want = data[j * BS:(j + 1) * BS]
        if native.available():
            assert native.decompress(c, BS) == want
        if oracle.available():
            assert oracle.decompress(c, BS) == want


def test_jax_container_decodes_under_port(fixtures):
    data = fixtures["text_large"] + fixtures["structured"][:20000]
    container = JB.compress(data, BS)
    assert lz4_sgori_torch.decompress(container, device="cpu") == data
    comp, clen = TB.to_device(JB.CompressedBlocks.from_container(container),
                              "cpu")
    out, out_len, err = K1.decompress_blocks_v7(comp, clen, BS)
    assert not err.any()
    back = TB.from_device(comp, clen, BS, len(data))
    assert np.array_equal(back.comp_len, clen.numpy())


def test_corrupt_container_errors(fixtures):
    data = fixtures["text_large"]
    container = lz4_sgori_torch.compress(data, BS, device="cpu")
    with pytest.raises(ValueError, match="magic"):
        lz4_sgori_torch.decompress(b"XXXX" + container[4:], device="cpu")
    with pytest.raises(ValueError, match="too short"):
        lz4_sgori_torch.decompress(b"LZ4J", device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        lz4_sgori_torch.decompress(container[:-10], device="cpu")
    cb = JB.CompressedBlocks.from_container(container)
    cb.raw_crc = cb.raw_crc.copy()
    cb.raw_crc[0] ^= 1
    with pytest.raises(DecodeError, match="checksum"):
        lz4_sgori_torch.decompress(cb.to_container(), device="cpu")
    cb = JB.CompressedBlocks.from_container(container)
    cb.comp[1, :4] = 0xF0                      # literal run past the input
    with pytest.raises(DecodeError, match="malformed block 1"):
        lz4_sgori_torch.decompress(cb.to_container(), device="cpu")


def test_encoder_failure_and_verify_failure_fall_back_counted(
        fixtures, monkeypatch):
    """comp_len 0 from the engine and a block that fails decode-verify are
    both re-encoded on the host, and both are counted."""
    from lz4_sgori_torch.ops import encode as E
    real = E.compress_blocks_seg_dispatch

    def broken(raw, raw_len, block_size, acceleration=1, **kw):
        comp, comp_len, nseq = real(raw, raw_len, block_size, acceleration,
                                    **kw)
        comp_len = comp_len.clone()
        comp_len[0] = 0                        # engine failure signal
        comp = comp.clone()
        comp[1, 0] ^= 0x10                     # a block that fails verify
        return comp, comp_len, nseq

    monkeypatch.setattr(E, "compress_blocks_seg_dispatch", broken)
    data = fixtures["mixed"]
    stats = Stats()
    container = lz4_sgori_torch.compress(data, BS, stats=stats,
                                         device="cpu")
    assert stats.encode_fallbacks == 2
    assert lz4_sgori_torch.decompress(container, device="cpu") == data


def test_size_dominance_keeps_blocks_at_most_lz4(fixtures):
    if not native.available():
        pytest.skip("native codec unavailable")
    data = fixtures["random_jpeg_scale"][:2 * BS] + fixtures["text_large"]
    cb = TB.compress_to_blocks(data, BS, size_dominance=True, device="cpu")
    for j in range(cb.num_blocks):
        assert cb.comp_len[j] <= len(native.compress(data[j * BS:
                                                          (j + 1) * BS]))
    assert TB.decompress(cb.to_container(), device="cpu") == data


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lz4_sgori_torch.compress(b"hello", BS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lz4_sgori_torch.decompress(b"", device="cuda")


def test_import_leaves_jax_out():
    code = ("import sys, lz4_sgori_torch, lz4_sgori_torch.blocks, "
            "lz4_sgori_torch.ops.seg, lz4_sgori_torch.ops.enc3, "
            "lz4_sgori_torch.ops.kernels.cand_piecewise, "
            "lz4_sgori_torch.ops.kernels.lockstep_v8, "
            "lz4_sgori_torch.store, lz4_sgori_torch.cli; "
            "sys.exit(1 if 'jax' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code],
                          timeout=120).returncode == 0

"""The port's routing table against the JAX package's, on the kernel
column (the JAX table's TPU column), across the fio block-size envelope;
every engine is ported (an engine the port lacked would raise
NotImplementedError instead of rerouting), the xla engine gives JAX's
bytes, and every depth of the kernel engines and the mlen mode run."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch import routing as R
from lz4_sgori_torch.ops.decode import decompress_blocks_device
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_tpu.ops import routing as J
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

FIO_SIZES = [4096, 8192, 16384, 32768, 65536, 131072, 262144,
             524288, 1048576, 2097152, 4194304, 96 * 1024, 65536 + 4096]


@pytest.mark.parametrize("kernel", [True, False])
def test_decode_table_matches_jax(kernel):
    for n in FIO_SIZES:
        for impl in J.DECODE_IMPLS:
            assert R.select_decode_engine(n, kernel, impl) == \
                J.select_decode_engine(n, kernel, impl), (n, impl)
    assert R.select_decode_engine(65536) == "v7"


@pytest.mark.parametrize("kernel", [True, False])
def test_encode_table_matches_jax(kernel):
    for n in FIO_SIZES:
        for d in (1, 3, 5):
            for impl in J.ENCODE_IMPLS:
                e = R.select_encode_engine(n, d, kernel, impl)
                assert e == J.select_encode_engine(n, d, kernel, impl)
                assert R.encode_depth_cap(e, d) == J.encode_depth_cap(e, d)
    for n in FIO_SIZES:
        assert R.seg_for(n) == J.seg_for(n)
    assert R.select_encode_engine(65536, 1) == "seg"


def test_unknown_impls_raise():
    with pytest.raises(ValueError, match="unknown decode impl"):
        R.select_decode_engine(65536, True, "scalar")
    with pytest.raises(ValueError, match="unknown encode impl"):
        R.select_encode_engine(65536, 1, True, "scalar")


@pytest.mark.parametrize("engine", ["xla"])
def test_unported_engines_raise(monkeypatch, engine):
    """The table of unported engines is empty, and an engine entered in
    it (here by monkeypatch) is refused with its ROADMAP item."""
    assert R.UNPORTED == {}
    for ported in ("xla", "enc3", "seg", "seg_big", "seg_splice", "v6",
                   "v7", "v8"):
        R.require_ported(ported)
    monkeypatch.setitem(R.UNPORTED, engine, "Queue 1 item 7")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        R.require_ported(engine)
    raw = torch.zeros((1, 4096), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compress_blocks_device(raw, torch.tensor([4096]), 4096, impl=engine)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decompress_blocks_device(raw, torch.tensor([1], dtype=torch.int32),
                                 4096, impl=engine)


def test_unported_requests_raise_end_to_end(monkeypatch):
    """impl="xla" runs the xla engine (Queue 1 item 7): JAX's bytes, and
    its xla decode equals the routed one (K1). The
    deep modes (K8) route, run and equal golden: seg_big, seg and enc3 at
    depth 3, enc3 at depth 5, and a depth past seg_big's cap warns and
    runs depth 3. LZ4J_ENC_MLEN=1 at depth 1 and 64 KiB runs the mlen
    mode (K10) and equals golden."""
    from lz4_sgori_tpu import golden
    block = (b"the deep modes weigh three candidates a probe. " * 200)[:5000]
    raw = torch.zeros((1, 131072), dtype=torch.uint8)
    raw[0, :len(block)] = torch.frombuffer(bytearray(block), dtype=torch.uint8)
    rl = torch.tensor([len(block)], dtype=torch.int32)
    comp, clen = compress_blocks_device(raw, rl, 131072)  # seg_big band
    assert comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg_big(block, 4096)
    comp, clen = compress_blocks_device(raw, rl, 131072, match_depth=3)
    assert comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg_big(block, 4096, depth=3)
    with pytest.warns(UserWarning, match="depth cap"):
        c5, l5 = compress_blocks_device(raw, rl, 131072, match_depth=5)
    assert torch.equal(c5, comp) and torch.equal(l5, clen)
    for bs, md, engine, want in [
            (8192, 3, "seg", golden.compress_dense_seg(block, 4096, 65536,
                                                       16, depth=3)),
            (4096, 3, "enc3", golden.compress_deep(block[:4096], depth=3)),
            (65536, 5, "enc3", golden.compress_deep(block, depth=5))]:
        assert R.select_encode_engine(bs, md) == engine
        r = raw[:, :bs].contiguous()
        comp, clen = compress_blocks_device(r, rl.clamp(max=bs), bs,
                                            match_depth=md)
        assert comp[0, :clen[0]].numpy().tobytes() == want, (bs, md)
    from lz4_sgori_torch.ops import seg as S
    mlen_calls = []
    real = S.parse_segments_mlen
    monkeypatch.setattr(S, "parse_segments_mlen",
                        lambda *a, **k: mlen_calls.append(1) or real(*a, **k))
    raw = raw[:, :65536].contiguous()
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    comp, clen = compress_blocks_device(raw, rl, 65536)
    assert mlen_calls and comp[0, :clen[0]].numpy().tobytes() == \
        golden.compress_dense_seg(block, 4096, 65536, 16)
    from lz4_sgori_tpu.ops.encode import compress_blocks_device as jax_enc
    monkeypatch.delenv("LZ4J_ENC_MLEN")
    comp, clen = compress_blocks_device(raw, rl, 65536, impl="xla")
    jc, jl = jax_enc(raw.numpy(), rl.numpy(), 65536, impl="xla")
    assert int(clen[0]) == int(jl[0]) and \
        comp[0, :clen[0]].numpy().tobytes() == \
        np.asarray(jc)[0, :int(jl[0])].tobytes()
    for a, b in zip(decompress_blocks_device(comp, clen, 65536, impl="xla"),
                    decompress_blocks_device(comp, clen, 65536)):
        assert torch.equal(a, b)
    out, out_len, err = decompress_blocks_device(comp, clen, 65536,
                                                 impl="xla")
    assert out[0, :out_len[0]].numpy().tobytes() == block
    comp = torch.from_numpy(np.zeros((1, 64), np.uint8))
    clen = torch.tensor([1], dtype=torch.int32)
    out, out_len, err = decompress_blocks_device(comp, clen, 1 << 20)  # v8
    assert not bool(err[0]) and int(out_len[0]) == 0
    for a, b in zip(decompress_blocks_device(comp, clen, 65536, impl="xla"),
                    decompress_blocks_device(comp, clen, 65536)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("block_size,encode,decode", [
    (1, "enc3", "v6"), (4, "enc3", "v6"), (1024, "enc3", "v6"),
    (4096, "enc3", "v6"), (5000, "enc3", "v6"),
    (96 * 1024, "seg_splice", "v7"), (128 * 1024, "seg_big", "v7"),
    (512 * 1024, "seg_big", "v8")])
def test_ported_requests_route_through_the_port(fixtures, block_size,
                                                encode, decode):
    """Requests in the enc3, v6, seg_splice, seg_big and v8 bands run on
    the port: a container round trip on CPU tensors with no host
    fallback."""
    import lz4_sgori_torch
    from lz4_sgori_tpu.utils.stats import Stats
    assert R.select_encode_engine(block_size, 1) == encode
    assert R.select_decode_engine(block_size) == decode
    R.require_ported(encode)
    R.require_ported(decode)
    data = fixtures["text_small"][:min(3 * block_size + 1, 6000)]
    stats = Stats()
    container = lz4_sgori_torch.compress(data, block_size, stats=stats,
                                         device="cpu")
    assert lz4_sgori_torch.decompress(container, device="cpu") == data
    assert stats.encode_fallbacks == 0

"""The port's store layer on CPU tensors: the five cases of
tests/test_store.py (lifecycle, proxy round trip, range errors, stats,
compressed store), chunk sizes 1 and 4 KiB through the enc3 and v6
engines, and containers moving between the port's and the JAX package's
CompressedStore."""

import pytest

from lz4_sgori_torch import store as S
from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
from lz4_sgori_tpu import blocks as JB
from lz4_sgori_tpu import store as JS
from test_torch_threads import one_thread  # noqa: F401 (a fixture)


@pytest.fixture
def backing(tmp_path):
    return str(tmp_path / "ram0.img")


def test_lifecycle_map_unmap(backing):
    S.map_store(backing, chunk_size=1024, capacity=64 * 1024, device="cpu")
    assert "proxy over" in S.get_store().info()
    with pytest.raises(S.StoreError, match="EBUSY"):
        S.map_store(backing, device="cpu")
    S.unmap_store()
    with pytest.raises(S.StoreError, match="ENODEV"):
        S.get_store()
    with pytest.raises(S.StoreError, match="ENODEV"):
        S.unmap_store()


@pytest.mark.parametrize("chunk_size", [1024, 4096])
def test_proxy_roundtrip_multiple_block_sizes(backing, fixtures,
                                              monkeypatch, chunk_size):
    """Writes at 1 and 4 KiB chunks run the enc3 encode and the v6
    decode-verify, then read back as the original bytes."""
    from lz4_sgori_torch.ops import decode as D
    from lz4_sgori_torch.ops import enc3 as E3
    used = set()
    real_parse, real_v6 = E3.parse_blocks_enc3, D._ENGINES["v6"]

    def parse(*a):
        used.add("enc3")
        return real_parse(*a)

    def v6(*a):
        used.add("v6")
        return real_v6(*a)

    monkeypatch.setattr(E3, "parse_blocks_enc3", parse)
    monkeypatch.setitem(D._ENGINES, "v6", v6)
    st = S.ProxyStore(backing, chunk_size=chunk_size, capacity=1 << 20,
                      device="cpu")
    payloads = [fixtures["text_small"], fixtures["zeros_4k"],
                fixtures["random_4k"]]
    off = 0
    spans = []
    for p in payloads:
        st.write(off, p)
        spans.append((off, len(p)))
        off += len(p)
    for (o, n), p in zip(spans, payloads):
        assert st.read(o, n) == p
    d = st.stats.as_dict()
    assert d["write"]["reqs_total"] == len(payloads)
    assert d["write"]["reqs_failed"] == 0
    assert d["write"]["data_bytes"] == sum(len(p) for p in payloads)
    assert st.stats.encode_fallbacks == 0
    assert used == {"enc3", "v6"}
    st.close()


def test_proxy_range_errors(backing):
    st = S.ProxyStore(backing, chunk_size=1024, capacity=4096, device="cpu")
    with pytest.raises(S.StoreError, match="outside capacity"):
        st.write(4000, b"x" * 200)
    with pytest.raises(S.StoreError, match="outside capacity"):
        st.read(-1, 10)
    st.close()


def test_stats_reset(backing):
    st = S.map_store(backing, chunk_size=1024, capacity=1 << 16,
                     device="cpu")
    try:
        st.write(0, b"hello" * 100)
        st.read(0, 500)
        text = S.stats_text()
        assert "write stats:" in text and "reqs_total: 1" in text
        S.stats_reset()
        d = st.stats.as_dict()
        assert d["write"]["reqs_total"] == 0 and d["read"]["reqs_total"] == 0
    finally:
        S.unmap_store()


def test_compressed_store_roundtrip(tmp_path, fixtures):
    st = S.CompressedStore(str(tmp_path / "cstore"), chunk_size=4096,
                           device="cpu")
    st.write_chunk(0, fixtures["zeros_4k"])
    st.write_chunk(3, fixtures["random_4k"])
    st.write_chunk(7, fixtures["text_small"][:4096])
    assert st.read_chunk(0) == fixtures["zeros_4k"]
    assert st.read_chunk(3) == fixtures["random_4k"]
    assert st.read_chunk(7) == fixtures["text_small"][:4096]
    assert st.read_chunk(5) == bytes(4096)
    with pytest.raises(S.StoreError):
        st.write_chunk(1, b"x" * 5000)
    assert st.stats.encode_fallbacks == 0


def test_compressed_store_containers_cross_packages(tmp_path, fixtures):
    """A chunk the port's CompressedStore wrote decodes under the JAX
    package's blocks.decompress and its store, and the reverse."""
    root = str(tmp_path / "cstore")
    port = S.CompressedStore(root, chunk_size=4096, device="cpu")
    jax_st = JS.CompressedStore(root, chunk_size=4096)
    text = fixtures["text_small"][:4096]
    port.write_chunk(0, text)
    with open(port._path(0), "rb") as f:
        assert JB.decompress(f.read()) == text
    assert jax_st.read_chunk(0) == text
    jax_st.write_chunk(1, fixtures["structured"][:3000])
    assert port.read_chunk(1) == fixtures["structured"][:3000] + bytes(1096)


def test_compressed_store_pads_only_a_short_chunk(tmp_path, fixtures):
    """A chunk written at 16 KiB and read back through a store reopened
    at 4 KiB comes back whole, as the JAX store returns it: the port pads
    only a chunk shorter than chunk_size."""
    root = str(tmp_path / "cstore")
    data = (fixtures["text_small"] * 8)[:16384]
    S.CompressedStore(root, chunk_size=16384, device="cpu").write_chunk(
        0, data)
    want = JS.CompressedStore(root, chunk_size=4096).read_chunk(0)
    got = S.CompressedStore(root, chunk_size=4096, device="cpu").read_chunk(0)
    assert got == want == data


def test_cuda_store_without_cuda_raises(backing, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.ProxyStore(backing)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.CompressedStore(backing + ".d")


def test_cpu_writes_launch_no_kernel(backing, fixtures):
    before = (K5.launches, K7.launches)
    st = S.ProxyStore(backing, chunk_size=4096, capacity=8192, device="cpu")
    st.write(0, fixtures["text_small"][:8192])
    st.close()
    assert (K5.launches, K7.launches) == before

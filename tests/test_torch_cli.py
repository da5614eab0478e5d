"""The port's CLI on CPU tensors (``--device cpu``): the three cases of
tests/test_cli.py, the verify sweep across the ported engines (enc3 and
v6 at 1 and 4 KiB, seg at 8 and 64 KiB, seg_splice at 96 KiB, seg_big at
128 KiB with v7 and at 512 KiB with v8), compress at match depth 3 and
5, LZ4J_ENC_MLEN=1 (the mlen mode), and the clean error of a request the
port does not serve."""

import pytest

from lz4_sgori_torch import cli
from test_torch_threads import one_thread  # noqa: F401 (a fixture)


def test_compress_decompress_files(tmp_path, fixtures, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(fixtures["mixed"][:32768])
    dst = tmp_path / "out.lz4j"
    back = tmp_path / "back.bin"
    assert cli.main(["--device", "cpu", "compress", str(src), str(dst),
                     "--block-size", "4096"]) == 0
    assert cli.main(["--device", "cpu", "decompress", str(dst),
                     str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()
    assert "ratio" in capsys.readouterr().out


def test_verify_sweep(tmp_path, fixtures, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(fixtures["text_large"])
    assert cli.main(["verify", str(src), "--block-sizes", "1", "4", "8",
                     "64", "96", "128", "512", "--json", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    for kib in (1, 4, 8, 64, 96, 128, 512):
        assert f"bs={kib}k: ok" in out


def test_docstring_says_every_engine_runs():
    """The module's own account of what it serves is true: the routing
    table leaves nothing unported (the xla engine included), and the
    docstring no longer sends an xla request to the ROADMAP."""
    from lz4_sgori_torch import routing
    assert not routing.UNPORTED
    assert "ROADMAP" not in cli.__doc__
    assert "``xla`` included" in " ".join(cli.__doc__.split())


def test_verify_unported_size_is_a_clean_error(tmp_path, fixtures, capsys,
                                               monkeypatch):
    """Every fio size, depth and mode is ported: LZ4J_ENC_MLEN=1 at
    depth 1 and 64 KiB runs the mlen mode (K10) and writes golden's
    bytes. A request for an engine the port lacks (here seg, marked
    unported for the test) ends with the ROADMAP message and exit 1,
    without a traceback, and writes nothing."""
    from lz4_sgori_torch import blocks, golden, routing
    from lz4_sgori_torch.ops import seg as S
    data = fixtures["text_small"]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    dst = tmp_path / "out.lz4j"
    monkeypatch.setenv("LZ4J_ENC_MLEN", "1")
    calls = []
    real = S.dense_mcode
    monkeypatch.setattr(S, "dense_mcode",
                        lambda *a: calls.append(1) or real(*a))
    assert cli.main(["--device", "cpu", "compress", str(src), str(dst),
                     "--block-size", "65536"]) == 0
    cb = blocks.CompressedBlocks.from_container(dst.read_bytes())
    assert calls and cb.comp[0, :cb.comp_len[0]].tobytes() == \
        golden.compress_dense_seg(data, 4096, 65536, 16)
    dst.unlink()
    capsys.readouterr()
    monkeypatch.setitem(routing.UNPORTED, "seg", "Queue 1 item 7")
    assert cli.main(["--device", "cpu", "compress", str(src), str(dst),
                     "--block-size", "65536"]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and not dst.exists()
    assert cap.err.startswith("lz4j: error:") and "ROADMAP" in cap.err


@pytest.mark.parametrize("block_size,depth", [(65536, 3), (4096, 5)])
def test_compress_at_match_depth(tmp_path, fixtures, block_size, depth):
    """``compress --match-depth`` runs the deep modes (seg at depth 3,
    enc3 at depth 5): golden's bytes, and the container round-trips."""
    from lz4_sgori_torch import blocks, golden
    data = fixtures["text_large"][:12000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    dst = tmp_path / "out.lz4j"
    back = tmp_path / "back.bin"
    assert cli.main(["--device", "cpu", "compress", str(src), str(dst),
                     "--block-size", str(block_size), "--match-depth",
                     str(depth)]) == 0
    cb = blocks.CompressedBlocks.from_container(dst.read_bytes())
    for j in range(cb.num_blocks):
        b = data[j * block_size:(j + 1) * block_size]
        want = (golden.compress_dense_seg(b, 4096, 65536, 16, depth=3)
                if depth == 3 else golden.compress_deep(b, depth=5))
        assert cb.comp[j, :cb.comp_len[j]].tobytes() == want, j
    assert cli.main(["--device", "cpu", "decompress", str(dst),
                     str(back)]) == 0
    assert back.read_bytes() == data


def test_admin_commands(tmp_path, capsys):
    backing = str(tmp_path / "ram0.img")
    assert cli.main(["--device", "cpu", "map", backing, "--chunk-size",
                     "1024", "--capacity", "65536"]) == 0
    try:
        assert cli.main(["info"]) == 0
        assert "proxy over" in capsys.readouterr().out
        assert cli.main(["stats"]) == 0
        assert "write stats:" in capsys.readouterr().out
        assert cli.main(["stats", "--reset"]) == 0
    finally:
        assert cli.main(["unmap"]) == 0

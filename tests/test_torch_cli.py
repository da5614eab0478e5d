"""The port's CLI on CPU tensors (``--device cpu``): the three cases of
tests/test_cli.py, the verify sweep across the ported engines (enc3 and
v6 at 1 and 4 KiB, seg at 8 and 64 KiB, seg_splice at 96 KiB, seg_big at
128 KiB with v7 and at 512 KiB with v8), and the clean error of a
request the port does not serve yet."""

from lz4_sgori_torch import cli


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


def test_verify_unported_size_is_a_clean_error(tmp_path, fixtures, capsys):
    """Every fio size is ported; a request that is not (match depth 3:
    the deep modes) ends with the ROADMAP message and exit 1, without a
    traceback, and writes nothing."""
    src = tmp_path / "in.bin"
    src.write_bytes(fixtures["text_small"])
    dst = tmp_path / "out.lz4j"
    assert cli.main(["--device", "cpu", "compress", str(src), str(dst),
                     "--block-size", "65536", "--match-depth", "3"]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and not dst.exists()
    assert cap.err.startswith("lz4j: error:") and "ROADMAP" in cap.err
    assert "K8" in cap.err


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

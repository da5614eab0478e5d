"""The port's CLI on CPU tensors (``--device cpu``): the three cases of
tests/test_cli.py, the verify sweep across the ported engines (enc3 and
v6 at 1 and 4 KiB, seg at 8 and 64 KiB, seg_splice at 96 KiB), and the
clean error of a size whose engine is not ported yet."""

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
                     "64", "96", "--json", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for kib in (1, 4, 8, 64, 96):
        assert f"bs={kib}k: ok" in out


def test_verify_unported_size_is_a_clean_error(tmp_path, fixtures, capsys):
    """128 KiB is the seg_big engine (not ported yet): the sweep stops
    there with the ROADMAP message and exit 1, without a traceback."""
    src = tmp_path / "in.bin"
    src.write_bytes(fixtures["text_small"])
    assert cli.main(["--device", "cpu", "verify", str(src), "--block-sizes",
                     "4", "128", "8"]) == 1
    cap = capsys.readouterr()
    assert "bs=4k: ok" in cap.out and "bs=8k" not in cap.out
    assert cap.err.startswith("lz4j: error:") and "ROADMAP" in cap.err
    assert "K9" in cap.err


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

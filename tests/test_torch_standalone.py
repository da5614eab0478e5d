"""The port stands alone: no module of ``lz4_sgori_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, and the port's own
copies of the backend-neutral modules (``format``, ``golden``, ``native``,
``utils.stats``, the container of ``blocks``) equal the JAX package's on
seeded inputs. Containers are byte-identical across the two packages and
decode in both directions."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import lz4_sgori_torch
from lz4_sgori_torch import blocks as TB
from lz4_sgori_torch import format as TF
from lz4_sgori_torch import golden as TG
from lz4_sgori_torch import native as TN
from lz4_sgori_torch.utils import oracle as TO
from lz4_sgori_torch.utils.stats import Stats as TStats
from lz4_sgori_tpu import blocks as JB
from lz4_sgori_tpu import format as JF
from lz4_sgori_tpu import golden as JG
from lz4_sgori_tpu import native as JN
from lz4_sgori_tpu.utils import oracle as JO
from lz4_sgori_tpu.utils.stats import Stats as JStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lz4_sgori_torch")
BANNED = ("jax", "jaxlib", "lz4_sgori_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _port_modules():
    mods = []
    for rel in _port_sources():
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                    else mod)
    return mods


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


@pytest.mark.parametrize("rel", _port_sources())
def test_source_imports_nothing_of_jax(rel):
    """An AST walk: no import statement anywhere in the file (top level or
    inside a function) names jax or the JAX package."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                found.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _banned(node.args[0].value)):
            found.append(node.args[0].value)
    assert not found, f"{rel} imports {found}"


def test_every_port_module_imports_with_jax_blocked():
    """In a fresh interpreter whose import system refuses jax and the JAX
    package, every module of the port and chip_smoke import."""
    hook = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BANNED!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BANNED!r}]\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", hook], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# the constants of the retired engines (tools/retired/), which the JAX
# package's format.py does not hold
PORT_ONLY = ("RETIRED_MAX_BLOCK", "V9_OUT_ALIGN")


def test_format_copy_equals_the_jax_package(monkeypatch):
    names = [n for n in dir(JF) if n.isupper()]
    assert names and names == [n for n in dir(TF)
                               if n.isupper() and n not in PORT_ONLY]
    for n in names:
        assert getattr(TF, n) == getattr(JF, n), n
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools", "retired"))
    import decode_kernel
    import encode_kernel
    from lz4_sgori_tpu.ops.pallas.lockstep_v6 import FBAND
    from lz4_sgori_tpu.ops.pallas.lockstep_v7 import HSPAN
    assert TF.RETIRED_MAX_BLOCK == encode_kernel.PALLAS_MAX_BLOCK \
        == decode_kernel.PALLAS_MAX_BLOCK
    assert TF.hashlog_for_input(TF.RETIRED_MAX_BLOCK) == encode_kernel._HASHLOG
    assert TF.V9_OUT_ALIGN == max(HSPAN, 4 * FBAND)
    rng = np.random.default_rng(1)
    for v in rng.integers(0, 1 << 32, 200, dtype=np.uint64).tolist():
        for hl in (12, 13, 16):
            assert TF.hash4(v, hl) == JF.hash4(v, hl)
    for n in (0, 1, 4096, 65536, 1 << 22):
        assert TF.compress_bound(n) == JF.compress_bound(n)


def _inputs(seed: int, n: int):
    from __graft_entry__ import _synth_corpus
    rng = np.random.default_rng(seed)
    return [_synth_corpus(n, seed=seed), rng.integers(0, 4, n, dtype=np.uint8)
            .tobytes(), rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
            (b"motif-%d " % seed) * (n // 8), bytes(n // 2), b"abc"]


def test_every_kernel_source_has_a_wrapper_in_the_walk():
    """Each ``csrc/*.cu`` is built by a wrapper module that the import
    walk above covers, the mlen mode's three (mcode, parse_seg_mlen and
    parse_enc3_mlen) and the retired engines' three (retired_encode,
    retired_decode and decode_v9) among them."""
    import re
    kernels = {f[:-3] for f in os.listdir(os.path.join(PKG, "csrc"))
               if f.endswith(".cu")}
    loaded = set()
    for rel in _port_sources():
        with open(os.path.join(ROOT, rel)) as f:
            loaded |= set(re.findall(r'_build\.load\(\s*"(\w+)"', f.read()))
    assert loaded == kernels
    assert {"mcode", "parse_seg_mlen", "parse_enc3_mlen"} <= kernels
    mods = _port_modules()
    for name in ("mcode", "parse_seg_mlen", "parse_enc3_mlen"):
        assert f"lz4_sgori_torch.ops.kernels.{name}" in mods
    assert {"retired_encode", "retired_decode", "decode_v9"} <= kernels
    for name in ("encode_kernel", "decode_kernel", "lockstep_v9"):
        assert f"lz4_sgori_torch.retired.{name}" in mods


@pytest.mark.parametrize("fn,args", [
    ("dense_candidates", dict(hashlog=16, val16_filter=False)),
    ("dense_candidates", dict(hashlog=13)),
    ("dense_gaps", dict(hashlog=16)),
    ("dense_gaps2", dict(hashlog=16)),
    ("dense_candidates_piecewise", dict(piece=1024, with_gaps=True)),
    ("dense_mcode", dict()),
    ("compress", dict()),
    ("compress_dense", dict(hashlog=16)),
    ("compress_dense", dict(acceleration=8, hashlog=16)),
    ("compress_deep", dict(depth=3)),
    ("compress_deep", dict(depth=5)),
    ("compress_dense_seg", dict(seg=1024)),
    ("compress_dense_seg", dict(seg=1024, depth=3)),
    ("compress_dense_seg_big", dict(seg=1024, piece=2048, depth=3)),
    ("compress_segmented", dict(seg=1500)),
])
def test_golden_copy_equals_the_jax_package(fn, args):
    for j, src in enumerate(_inputs(7, 5000)):
        assert getattr(TG, fn)(src, **args) == getattr(JG, fn)(src, **args), j


def test_golden_decode_splice_and_errors_equal_the_jax_package():
    for src in _inputs(8, 4000):
        c = JG.compress_dense(src, hashlog=16)
        assert TG.decompress(c, len(src)) == JG.decompress(c, len(src))
        assert TG.tail_offset(c) == JG.tail_offset(c)
        parts = TG.compress_dense_seg_parts(src, 1024, depth=3)
        assert parts == JG.compress_dense_seg_parts(src, 1024, depth=3)
    streams = [JG.compress_dense(s, hashlog=16) for s in _inputs(9, 3000)]
    tails = [JG.tail_offset(s) for s in streams]
    assert TG.splice_segments(streams, tails) == \
        JG.splice_segments(streams, tails)
    for bad in (b"\xf0", b"\x11a\x05\x00", b"\x10a\x00\x00"):
        with pytest.raises(TG.DecodeError):
            TG.decompress(bad, 100)
        with pytest.raises(JG.DecodeError):
            JG.decompress(bad, 100)


def test_native_copy_equals_the_jax_package():
    if not (TN.available() and JN.available()):
        pytest.skip("the native codec did not build (no C++ compiler)")
    assert os.path.dirname(TN._SO) == os.path.join(PKG, "_build")
    for src in _inputs(10, 20000):
        c = TN.compress(src)
        assert c == JN.compress(src)
        assert TN.decompress(c, len(src)) == src
        if TO.available() and JO.available():
            assert TO.compress(src) == JO.compress(src)


def test_stats_copy_equals_the_jax_package():
    t, j = TStats(), JStats()
    for s in (t, j):
        s.update(is_write=True, ok=True, blocks=3, nbytes=12000)
        s.update(is_write=False, ok=False, blocks=1, nbytes=0)
        s.update(is_write=False, ok=True, blocks=2, nbytes=8192)
        s.record_fallback()
    assert t.as_dict() == j.as_dict() and t.render() == j.render()
    t.reset()
    j.reset()
    assert t.as_dict() == j.as_dict()


@pytest.mark.parametrize("bs,crc", [(4096, True), (65536, False),
                                    (131072, True)])
def test_containers_are_byte_identical_across_packages(bs, crc):
    data = b"".join(_inputs(11, 6000))
    for split in (TB.split_blocks, JB.split_blocks):
        raw, rlen = split(data, bs)
        jraw, jrlen = JB.split_blocks(data, bs)
        assert np.array_equal(raw, jraw) and np.array_equal(rlen, jrlen)
        assert TB.join_blocks(raw, rlen) == JB.join_blocks(raw, rlen) == data
    raw, rlen = TB.split_blocks(data, bs)
    comps = [JG.compress_dense(raw[j, :rlen[j]].tobytes(), hashlog=16)
             for j in range(raw.shape[0])]
    slot = max(map(len, comps)) + 3
    comp = np.zeros((len(comps), slot), np.uint8)
    for j, c in enumerate(comps):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
    import zlib
    fields = dict(comp=comp, comp_len=np.array(list(map(len, comps)),
                                               np.int32),
                  block_size=bs, raw_size=len(data),
                  raw_crc=(np.array([zlib.crc32(raw[j, :rlen[j]].tobytes())
                                     for j in range(raw.shape[0])], np.uint32)
                           if crc else None))
    blob = TB.CompressedBlocks(**fields).to_container()
    assert blob == JB.CompressedBlocks(**fields).to_container()
    t, j = TB.CompressedBlocks.from_container(blob), \
        JB.CompressedBlocks.from_container(blob)
    assert t.to_container() == j.to_container() == blob
    assert (t.num_blocks, t.compressed_size, t.ratio) == \
        (j.num_blocks, j.compressed_size, j.ratio)
    assert JB.decompress(blob) == data
    assert lz4_sgori_torch.decompress(blob, device="cpu") == data
    port = lz4_sgori_torch.compress(data, bs, device="cpu")
    assert JB.decompress(port) == data
    for bad in (b"XXXX" + blob[4:], blob[:10], blob[:-5]):
        for cls in (TB.CompressedBlocks, JB.CompressedBlocks):
            with pytest.raises(ValueError):
                cls.from_container(bad)

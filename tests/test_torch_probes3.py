"""T14a, the primitive-rate harness of the port (``lz4_sgori_torch.probes
.microbench2.harness``) on CPU tensors, that is its plain versions,
against the tool's own ``_harness`` (``tools/microbench2.py``) around
each of its 15 vector-unit bodies, copied here as written, in TPU
interpret mode on the tool's inputs. Every body is held bit for bit: its
int32 arithmetic wraps in both, and its float32 adds into ``acc`` run in
iteration order in both.

The tool sets ``JAX_COMPILATION_CACHE_DIR`` and
``jax_compilation_cache_dir`` and puts the repository on ``sys.path`` when
imported; the ``tool`` fixture puts them back."""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lz4_sgori_torch import probes
from lz4_sgori_torch.ops.kernels import _build
from lz4_sgori_torch.probes import microbench2 as T14
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_compile_time_secs")
ENV = "JAX_COMPILATION_CACHE_DIR"
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def tool():
    """``tools/microbench2.py``, imported by path, with the jax settings,
    the environment variable and ``sys.path`` it changes put back."""
    saved = {k: getattr(jax.config, k) for k in CONFIG}
    env = os.environ.get(ENV)
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_tool_microbench2", os.path.join(ROOT, "tools", "microbench2.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = env
        sys.path[:] = path
    return mod


# ---- the tool's bodies, as written (tools/microbench2.py:95-337) ----

def lcg(x):
    return x * jnp.int32(1664525) + jnp.int32(1013904223)


def body_vpu(i, acc, ins):
    x = ins[0][...] + i
    for _ in range(8):
        x = (x ^ (x + 1)) + (x >> 1)
    return acc + x[0:8, :].astype(jnp.float32)


def body_ohbuild(i, acc, ins):
    ids = ins[0]
    idv = (lcg(ids[...] + i) >> 7) & 511
    cols = jax.lax.broadcasted_iota(jnp.int32, (2048, 512), 1)
    oh = (cols == idv).astype(jnp.bfloat16)
    return acc + oh[0:8, 0:128].astype(jnp.float32)


def body_extract(i, acc, ins):
    g, ids = ins[0], ins[1]
    idv = lcg(ids[...] + i) & 127
    cols = jax.lax.broadcasted_iota(jnp.int32, (2048, 128), 1)
    m = (cols == idv).astype(jnp.float32)
    v = jnp.sum(g[...] * m, axis=1, keepdims=True)
    return acc + v[0:8, 0:1]


def body_red1(i, acc, ins):
    x = ins[0][...] + i
    v = jnp.sum(x, axis=1, keepdims=True)  # lanes
    return acc + v[0:8, 0:1].astype(jnp.float32)


def body_red0(i, acc, ins):
    x = ins[0][...] + i
    v = jnp.sum(x, axis=0, keepdims=True)  # sublanes
    return acc + v[0:1, 0:128].astype(jnp.float32)


def body_bitroll(i, acc, ins):
    x, amt = ins[0][...], ins[1][...]
    av = lcg(amt + i) & 127
    for j in range(7):
        sh = 1 << j
        r = pltpu.roll(x, 128 - sh, 1)
        x = jnp.where((av & sh) != 0, r, x)
    return acc + x[0:8, :].astype(jnp.float32)


def body_sroll(i, acc, ins):
    x = ins[0][...] + i
    for j in range(8):
        x = x + pltpu.roll(x, 1, 0)
    return acc + x[0:8, :].astype(jnp.float32)


def body_lroll(i, acc, ins):
    x = ins[0][...] + i
    for j in range(8):
        x = x + pltpu.roll(x, 1, 1)
    return acc + x[0:8, :].astype(jnp.float32)


def body_vlookup(i, acc, ins):
    tbl, idx = ins[0][...], ins[1][...]
    idv = lcg(idx + i) & 127
    rows = jax.lax.broadcasted_iota(jnp.int32, (128, 512), 0)
    m = (rows == idv).astype(jnp.int32)
    v = jnp.sum(tbl * m, axis=0, keepdims=True)
    return acc + v[0:1, 0:128].astype(jnp.float32)


def body_fori(i, acc, ins):
    return acc + ins[0][...].astype(jnp.float32)


def body_dynrow(i, acc, ins):
    x = ins[0]
    row = (i * 37) & 255
    v = x[pl.ds(row, 8), :]
    return acc + v.astype(jnp.float32)


def body_statrow(i, acc, ins):
    x = ins[0]
    v = x[8:16, :]
    return acc + (v + i).astype(jnp.float32)


def body_cumsum_shift(i, acc, ins):
    x = ins[0][...] + i
    rows = jax.lax.broadcasted_iota(jnp.int32, (512, 1), 0)
    for j in range(9):
        sh = 1 << j
        r = pltpu.roll(x, sh, 0)
        x = x + jnp.where(rows >= sh, r, 0)
    return acc + x[0:8, :].astype(jnp.float32)


def body_transpose(i, acc, ins):
    x = ins[0][...] + i
    t = jnp.transpose(x, (1, 0))
    return acc + t[0:8, :].astype(jnp.float32)


def body_shiftsel(i, acc, ins):
    x, amt = ins[0][...], ins[1][...]
    d = lcg(amt + i) & 31
    sel = jnp.zeros_like(x)
    for j in range(32):
        r = x if j == 0 else pltpu.roll(x, 512 - j, 0)
        sel = jnp.where(d == j, r, sel)
    return acc + sel[0:8, :].astype(jnp.float32)


TOOL_BODIES = {
    "vpu": body_vpu, "ohbuild": body_ohbuild, "extract": body_extract,
    "red1": body_red1, "red0": body_red0, "bitroll": body_bitroll,
    "sroll": body_sroll, "lroll": body_lroll, "vlookup": body_vlookup,
    "fori": body_fori, "dynrow": body_dynrow, "statrow": body_statrow,
    "cumsum_shift": body_cumsum_shift, "transpose": body_transpose,
    "shiftsel": body_shiftsel,
}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(TOOL_BODIES))
def test_t14a_equals_the_tool(tool, name):
    """The tool's ``_harness(body)`` in interpret mode and the port's
    plain version on the tool's inputs: ``out`` equal bit for bit at R 0,
    3 and 40."""
    ins = T14.tool_inputs()
    keys = T14.BODIES[name].inputs
    run = tool._harness(TOOL_BODIES[name])
    for r in (0, 3, 40):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(run(r, *[jnp.asarray(ins[k]) for k in keys]))
        out, sink = T14.harness(name, r, *[torch.from_numpy(ins[k])
                                           for k in keys])
        assert out.dtype == torch.float32 and out.shape == (8, 128)
        assert sink.dtype == torch.int32 and sink.shape == ()
        assert np.array_equal(_bits(out.numpy()), _bits(want)), r
        if r == 0:
            assert int(sink) == 0 and not want.any()


def test_t14a_bodies_are_the_tools():
    """The table lists the tool's 15 vector-unit readings, with its repeat
    counts, every line it cites opens a body of that name, ``ohbuild``,
    ``transpose``, ``shiftsel`` and ``red1`` run on every SM
    (``probe_harness_wg``), and ``probe_harness.cu``'s switch takes the
    other 11 in the table's order, which is the tool's."""
    with open(os.path.join(ROOT, "tools", "microbench2.py")) as f:
        lines = f.read().splitlines()
    t14a = {n: T14.BODIES[n] for n in T14.T14A}
    assert set(t14a) == set(TOOL_BODIES)
    assert [n for n, b in t14a.items() if b.source != T14.VPU] == [
        "ohbuild", "transpose", "shiftsel", "red1"]
    assert all(t14a[n].source == T14.WG
               for n in ("ohbuild", "transpose", "shiftsel", "red1"))
    one_sm = [n for n, b in t14a.items() if b.source == T14.VPU]
    assert [n for n in T14.ORDER if n in one_sm] == one_sm
    assert sorted(T14.ORDER) == sorted(T14.BODIES)
    for name, body in t14a.items():
        assert lines[body.line - 1].strip().startswith(f"def body_{name}(")
        assert f'"{body.reading}"' in "\n".join(lines[body.line:body.line + 15])
        assert body.card[0] < body.card[1] and body.tool[0] < body.tool[1]
    assert len(T14.ORDER) == 20 and len(t14a) == 15
    with open(os.path.join(ROOT, "lz4_sgori_torch", "csrc",
                           "probe_harness.cu")) as f:
        cases = re.findall(r"case (\d+): return launch<(\w+)>", f.read())
    assert [(int(k), s.lower()) for k, s in cases] == [
        (T14.BODY_ID[n], n.replace("_", "")) for n, b in t14a.items()
        if b.source == T14.VPU]


# ---- sink: numpy models of three bodies ----

def _numpy_sink(name: str, r: int, ins) -> int:
    total = 0
    with np.errstate(over="ignore"):
        for i in range(r):
            i32 = np.int32(i)
            if name == "vpu":
                x = ins["a512"] + i32
                for _ in range(8):
                    x = (x ^ (x + np.int32(1))) + (x >> np.int32(1))
                total += int(x.astype(np.int64).sum())
            elif name == "ohbuild":
                v = (ins["ids"][:, 0] + i32) * np.int32(1664525) \
                    + np.int32(1013904223)
                one = (v >> np.int32(7)) & np.int32(511)
                total += int((512 * np.arange(2048) + one).sum())
            else:
                v = (ins["ids"][:, 0] + i32) * np.int32(1664525) \
                    + np.int32(1013904223)
                g = ins["g2048"][np.arange(2048), v & np.int32(127)]
                total += int(g.view(np.int32).astype(np.int64).sum())
    return int(np.uint32(total & M32).view(np.int32))


@pytest.mark.parametrize("name", ["vpu", "ohbuild", "extract"])
def test_t14a_sink_equals_numpy(name):
    """numpy's int32 wraps as the card's does: the sum of every element of
    the whole result, the one-hot's as the flat index of each one, the
    extract's float32 by its bits."""
    ins = T14.tool_inputs()
    _, sink = T14.harness(name, 5, device="cpu")
    assert int(sink) == _numpy_sink(name, 5, ins)


def test_tool_inputs_replay_the_tool():
    """``default_rng(0)``'s draws of the tool's ``main()``, replayed afresh
    in its order (``microbench2.py:101-323``), with the tool's conversions;
    the walk's table is the same one as before."""
    key = np.random.default_rng(0)
    want = {"a512": jnp.asarray(key.integers(0, 1 << 20, (512, 128)),
                                jnp.int32)}
    key.normal(size=(512, 512))
    key.normal(size=(512, 128))
    want["ids"] = jnp.asarray(key.integers(0, 1 << 20, (2048, 1)), jnp.int32)
    key.normal(size=(512, 128))
    want["g2048"] = jnp.asarray(key.normal(size=(2048, 128)), jnp.float32)
    want["amt"] = jnp.asarray(key.integers(0, 128, (512, 1)), jnp.int32)
    want["tbl"] = jnp.asarray(key.integers(0, 1 << 20, (128, 512)), jnp.int32)
    want["idx1"] = jnp.asarray(key.integers(0, 128, (1, 512)), jnp.int32)
    want["tblv"] = jnp.asarray(key.integers(0, 512, (512,)), jnp.int32)
    want["small"] = jnp.asarray(key.integers(0, 100, (8, 128)), jnp.int32)
    want["x128"] = jnp.asarray(key.integers(0, 1 << 20, (128, 512)),
                               jnp.int32)
    got = T14.tool_inputs()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert np.array_equal(T14.walk_table(), got["tblv"])
    assert T14.walk_table().dtype == np.int32


# ---- the wrapper ----

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to send the wrapper down
    its kernel branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cpu_runs_the_plain_version():
    T14.harness_launches.update(dict.fromkeys(T14.BODIES, 0))
    for name in T14.BODIES:
        out, sink = T14.harness(name, 2, device="cpu")
        assert out.device.type == "cpu" and sink.device.type == "cpu"
        assert sink.dtype == T14.BODIES[name].sink
        want = T14.harness_plain(name, 2, *T14.body_inputs(name, "cpu"))
        assert torch.equal(out, want[0]) and torch.equal(sink, want[1])
    assert not any(T14.harness_launches.values())


def test_failed_build_raises_and_never_falls_back(monkeypatch):
    """On the card's branch the wrapper builds its kernel; when the build
    fails it raises, and no plain result comes back."""
    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    T14.harness_launches["red1"] = 0
    a = torch.from_numpy(T14.tool_inputs()["a512"]).as_subclass(_OnCuda)
    with pytest.raises(RuntimeError, match="nvcc"):
        T14.harness("red1", 3, a)
    assert T14.harness_launches["red1"] == 0


def test_harness_argument_checks():
    a = torch.zeros((512, 128), dtype=torch.int32)
    amt = torch.zeros((512, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown body"):
        T14.harness("nonesuch", 1, a)
    with pytest.raises(TypeError, match="takes 2 inputs"):
        T14.harness("bitroll", 1, a)
    with pytest.raises(TypeError, match="a512"):
        T14.harness("vpu", 1, a.to(torch.int64))
    with pytest.raises(TypeError, match="a512"):
        T14.harness("vpu", 1, a[:, :64])
    with pytest.raises(TypeError, match="amt"):
        T14.harness("shiftsel", 1, a, amt.T)
    with pytest.raises(TypeError, match="g2048"):
        T14.harness("extract", 1, a, torch.zeros((2048, 1),
                                                 dtype=torch.int32))
    for r in (-1, 1 << 31):
        with pytest.raises(ValueError, match="r must be"):
            T14.harness("vpu", r, a)


def test_main_on_the_cpu(monkeypatch, capsys):
    """``main()`` with the counts divided and one timing of each: the
    tool's 20 readings in its order, each timed, then the walk's."""
    monkeypatch.setattr(probes, "TRIES", 1)
    assert T14.main(["--div", "4096", "--steps", "16", "64",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "devices: cpu (the plain version)"
    readings = [line.split(":")[0] for line in out[1:]]
    want = [T14.BODIES[n].reading for n in T14.ORDER]
    assert len(want) == 20
    assert readings == want + ["smem_scalar_walk (dependent)"]
    for line in out[1:]:
        assert " us/iter (" in line and line.endswith(" ns/item)")
        assert "not ported" not in line
    with pytest.raises(SystemExit):
        T14.main(["--div", "0", "--device", "cpu"])

"""The lockstep-design probes of the port (``lz4_sgori_torch.probes``
``microbench3``, T9-T13, and ``microbench2``, T15) on CPU tensors, that is
their plain versions, against the tools' own Pallas kernels under
``tools/`` in TPU interpret mode, on the same numpy-seeded inputs. Every
result is int32 (T15's the float32 of an int32), so every comparison is
exact.

Interpret mode fills an output cell the kernel never writes with
2147483647, where the port writes 0: T9's and T12's rows 1-7 and the cells
T10's walk misses. Those are compared by the port alone.

The tools set ``jax_compilation_cache_dir`` (and microbench3
``jax_persistent_cache_min_compile_time_secs``) and put the repository on
``sys.path`` when imported; the ``tools`` fixture puts them back."""

import importlib.util
import os
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
from lz4_sgori_torch.probes import microbench2 as T15
from lz4_sgori_torch.probes import microbench3 as T3
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("microbench3", "microbench2")
CONFIG = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_compile_time_secs")
UNWRITTEN = 2147483647
COUNTERS = ("gather_launches", "scatter_launches", "fifo_launches",
            "state_launches", "vmem_launches")


@pytest.fixture(scope="module")
def tools():
    """The two tool modules, imported by path, with the jax settings and
    ``sys.path`` they change put back at once."""
    saved = {k: getattr(jax.config, k) for k in CONFIG}
    path = list(sys.path)
    mods = {}
    try:
        for name in TOOLS:
            spec = importlib.util.spec_from_file_location(
                f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mods


def test_the_tools_leave_no_setting_behind(tools):
    assert callable(tools["microbench3"].make_gather)
    assert jax.config.jax_compilation_cache_dir != "/tmp/lz4j_jax_cache"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- T9 and T10: the per-lane gather and scatter ----

@pytest.mark.parametrize("R,reps", [(16, 5), (64, 9)])
def test_t9_equals_the_tool(tools, R, reps):
    """``make_gather(R)(reps)`` on the tool's tape: row 0 equal, and a sum
    of the tape's cells along the replayed walk."""
    with pltpu.force_tpu_interpret_mode():
        f, tape = tools["microbench3"].make_gather(R)(reps)
        want = np.asarray(f(tape)[0])
    assert np.array_equal(np.asarray(tape), T3.tape(R))
    got = T3.gather(_t(T3.tape(R)), reps).numpy()
    assert np.array_equal(got[0], want[0])
    assert (want[1:] == UNWRITTEN).all() and not got[1:].any()
    lanes = np.arange(128)
    idx = [(lanes % R + i * (lanes % 7 + 1)) % R for i in range(reps)]
    assert got[0].tolist() == sum(T3.tape(R)[r, lanes] for r in idx).tolist()


@pytest.mark.parametrize("R,reps", [(16, 7), (64, 40)])
def test_t10_equals_the_tool(tools, R, reps):
    """``make_scatter(R)(reps)``: the cells of rows [:8] that the walk
    writes are equal, and the others are the interpreter's fill and the
    port's 0; the mask comes from replaying the walk."""
    with pltpu.force_tpu_interpret_mode():
        (f,) = tools["microbench3"].make_scatter(R)(reps)
        want = np.asarray(f()[0])
    got = T3.scatter(R, reps, "cpu").numpy()
    written = T3.last_visit(R, reps, T3.SCATTER_STRIDE, "cpu")[:8].numpy() >= 0
    assert got.shape == want.shape == (8, 128)
    assert written.any() and not written.all()
    assert np.array_equal(got[written], want[written])
    assert (want[~written] == UNWRITTEN).all() and not got[~written].any()


def test_t10_later_writes_win():
    """Replayed by hand: lane 1 steps 2 rows a round from row 1 at R = 8,
    so rows 1, 3, 5, 7 are written in rounds 0-3 and again in 4-7."""
    got = T3.scatter(8, 8, "cpu", whole=True)[:, 1].tolist()
    assert got == [0, 1 + 4, 0, 3 + 5, 0, 5 + 6, 0, 7 + 7]
    assert torch.equal(T3.scatter(8, 8, "cpu"),
                       T3.scatter_plain(8, 8, whole=True)[:8])


# ---- T11 and T12: the register-carried steps ----

@pytest.mark.parametrize("reps", range(10))
def test_t11_equals_the_tool(tools, reps):
    """``make_fifo()(reps)``: reps 0-9 take every shift of every lane."""
    with pltpu.force_tpu_interpret_mode():
        (f,) = tools["microbench3"].make_fifo()(reps)
        want = np.asarray(f()[0])
    assert np.array_equal(T3.fifo(reps, "cpu").numpy(), want)


def test_t11_rolls_down():
    """One round: lane L's column rolled down by L & 7, then + 1: row r
    holds (r - (L & 7)) mod 8 + 1."""
    got = T3.fifo(1, "cpu").numpy()
    r, lane = np.arange(8)[:, None], np.arange(128)[None, :]
    assert np.array_equal(got, (r - (lane & 7)) % 8 + 1)


@pytest.mark.parametrize("reps", [1, 37])
def test_t12_equals_the_tool(tools, reps):
    with pltpu.force_tpu_interpret_mode():
        (f,) = tools["microbench3"].make_state()(reps)
        want = np.asarray(f()[0])
    got = T3.state(reps, "cpu").numpy()
    assert np.array_equal(got[0], want[0])
    assert (want[1:] == UNWRITTEN).all() and not got[1:].any()


def _numpy_state(reps: int, start: np.ndarray):
    """The tool's body in numpy int32, which wraps as the TPU does, from
    ``start`` (rows a, b, c, d); also whether any value went negative."""
    a, b, c, d = start
    neg = False
    with np.errstate(over="ignore"):
        for _ in range(reps):
            e = (a + b) ^ c
            f = np.where(d > 0, e, a)
            g = (f >> 3) + (b & 255)
            h = np.minimum(g, c) | (a << 1)
            a2 = np.where((h & 1) != 0, a + 1, a)
            b2 = (b + g) & 0xFFFF
            c2 = np.maximum(c - 1, h & 7)
            d2 = d ^ (e + f)
            e2 = (a2 * np.int32(3) + b2) & 0xFFFFF
            f2 = np.where(c2 > d2, e2, f)
            g2 = g + (f2 >> 2)
            h2 = h ^ g2
            a, b = a2 + (h2 & 3), np.where(b2 < e2, b2 + 7, b2)
            c, d = c2 | (a & 1), d2 + g2
            neg |= any(bool((v < 0).any()) for v in (a, c, d, e, f, g, h))
        return a + b + c + d, neg


def test_t12_against_numpy_int32():
    """10^4 rounds from the tool's start against numpy's int32 (no value
    is negative there before round 55,578), then 300 from random int32
    states, where negative values come at once, so that the arithmetic
    shifts and the signed compares and ``min``/``max`` matter."""
    start = T3.state_start("cpu")
    want, neg = _numpy_state(10_000, start.numpy())
    assert not neg
    assert np.array_equal(T3.state(10_000, "cpu").numpy()[0], want)
    wide = np.random.default_rng(12).integers(
        -(1 << 31), 1 << 31, (4, 128)).astype(np.int32)
    want, neg = _numpy_state(300, wide)
    assert neg
    got = T3.state(300, "cpu", start=_t(wide)).numpy()
    assert np.array_equal(got[0], want) and not got[1:].any()


# ---- T13: the scratch capacity probe ----

def _tool_vmem_kernel(out_ref, big, big2):
    """``probe_vmem``'s kernel as written (``microbench3.py:235-238``)."""
    big[0:8, :] = jnp.ones((8, 128), jnp.int32)
    big2[0:8, :] = jnp.ones((8, 128), jnp.int32)
    out_ref[:, :] = big[0:8, :] + big2[0:8, :]


@pytest.mark.parametrize("rows,ring", [(8, 8), (326, 128), (16384, 4096)])
def test_t13_equals_the_tool(tools, rows, ring):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            _tool_vmem_kernel,
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
            out_specs=pl.BlockSpec((8, 128), lambda *_: (0, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((rows, 128), jnp.int32),
                            pltpu.VMEM((ring, 128), jnp.int32)],
        )())
        if ring == T3.RING:
            assert tools["microbench3"].probe_vmem(rows)
    assert np.array_equal(T3.vmem(rows, ring, "cpu").numpy(), want)
    assert T3.probe_vmem(rows, ring, "cpu")


def test_t13_sizes():
    """The H100's opt-in limit, 232448 bytes, holds 326 rows beside a
    128-row ring; the tool's smallest size needs 10.5 MB."""
    assert T3.fit_rows(232448, 128) == 326
    assert T3.scratch_bytes(326, 128) == 232448
    assert T3.scratch_bytes(327, 128) > 232448
    assert min(T3.scratch_bytes(r) for r in T3.VMEM_ROWS) == 20480 * 512


class _FakeSmemLib:
    """Stands for csrc/probe_smem.cu: its limit is the H100's, and a
    launch fails the test."""

    @staticmethod
    def lz4t_smem_optin(device):
        return 232448

    @staticmethod
    def lz4t_probe_smem(*_a):
        pytest.fail("a refused size was launched")


def test_t13_refuses_every_size_of_the_tool_without_a_launch(monkeypatch):
    """On the card's branch (a fake card and library), each size of the
    tool is above the opt-in limit: False, and nothing launches."""
    monkeypatch.setattr(T3, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "load", lambda *_a, **_k: _FakeSmemLib)
    monkeypatch.setattr(T3, "_smem_limits", {})
    T3.vmem_launches = 0
    for rows in T3.VMEM_ROWS:
        assert T3.vmem(rows) is None and not T3.probe_vmem(rows)
    assert T3.vmem(327, 128) is None
    assert T3.smem_limit() == 232448
    assert T3.vmem_launches == 0


# ---- T15: the dependent scalar walk ----

def _tool_walk_kernel(r_ref, tbl_ref, out_ref):
    """``walk_kernel`` as written (``microbench2.py:230-237``)."""
    out_ref[...] = jnp.zeros_like(out_ref)

    def step(j, x):
        return tbl_ref[x & 511] + x + 1

    x = jax.lax.fori_loop(0, r_ref[0], step, jnp.int32(1))
    out_ref[...] = out_ref[...] + x.astype(jnp.float32)


def _tool_walk(r: int, tbl: np.ndarray) -> np.ndarray:
    """``run_walk`` as written (``microbench2.py:239-251``)."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(1,), in_specs=[],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            _tool_walk_kernel, grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        )(jnp.asarray([r], jnp.int32), jnp.asarray(tbl)))


def _wide_table():
    """Entries near 2^30: the walk passes 2^31 and wraps within 3 steps."""
    return np.random.default_rng(15).integers(
        (1 << 30) - 4096, 1 << 30, 512).astype(np.int32)


@pytest.mark.parametrize("table", ["tool", "wide"])
@pytest.mark.parametrize("r", [0, 3, 500])
def test_t15_equals_the_tool(table, r):
    tbl = T15.walk_table() if table == "tool" else _wide_table()
    want = _tool_walk(r, tbl)
    got = T15.walk(_t(tbl), r).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    if table == "wide" and r == 3:
        assert want[0, 0] < 0                      # the int32 wrapped


def test_walk_table_replays_the_tool():
    """``default_rng(0)``'s draws of the tool's ``main()``, replayed
    afresh in its order (``microbench2.py:101-253``); a Python-int walk of
    70,000 steps over the table ends at 20906226."""
    key = np.random.default_rng(0)
    key.integers(0, 1 << 20, (512, 128))
    key.normal(size=(512, 512))
    key.normal(size=(512, 128))
    key.integers(0, 1 << 20, (2048, 1))
    key.normal(size=(512, 128))
    key.normal(size=(2048, 128))
    key.integers(0, 128, (512, 1))
    key.integers(0, 1 << 20, (128, 512))
    key.integers(0, 128, (1, 512))
    want = key.integers(0, 512, (512,))
    tbl = T15.walk_table()
    assert tbl.dtype == np.int32 and np.array_equal(tbl, want)
    x = 1
    for _ in range(70_000):
        x = (int(tbl[x & 511]) + x + 1) & 0xFFFFFFFF
    assert x == 20906226
    assert T15.walk(_t(tbl), 1000)[0, 0] == _python_walk(tbl, 1000)


def _python_walk(tbl, r):
    x = 1
    for _ in range(r):
        x = (int(tbl[x & 511]) + x + 1) & 0xFFFFFFFF
    return np.float32(np.uint32(x).view(np.int32))


# ---- the wrappers ----

def _calls():
    tape = _t(T3.tape(16))
    tbl = _t(T15.walk_table())
    return {
        "T9": (T3, "gather_launches", lambda d: T3.gather(
            tape.as_subclass(_OnCuda) if d == "cuda" else tape, 5)),
        "T10": (T3, "scatter_launches", lambda d: T3.scatter(16, 5, d)),
        "T11": (T3, "fifo_launches", lambda d: T3.fifo(5, d)),
        "T12": (T3, "state_launches", lambda d: T3.state(5, d)),
        "T13": (T3, "vmem_launches", lambda d: T3.vmem(8, 8, d)),
        "T15": (T15, "launches", lambda d: T15.walk(
            tbl.as_subclass(_OnCuda) if d == "cuda" else tbl, 5)),
    }


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to send a wrapper down
    its kernel branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("name", ["T9", "T10", "T11", "T12", "T13", "T15"])
def test_cpu_runs_the_plain_version(name):
    mod, counter, call = _calls()[name]
    setattr(mod, counter, 0)
    res = call("cpu")
    assert res.device.type == "cpu" and res.shape == (8, 128)
    assert res.dtype == (torch.float32 if name == "T15" else torch.int32)
    assert getattr(mod, counter) == 0


@pytest.mark.parametrize("name", ["T9", "T10", "T11", "T12", "T13", "T15"])
def test_failed_build_raises_and_never_falls_back(monkeypatch, name):
    """On the card's branch the wrapper builds its kernel; when the build
    fails it raises, and no plain result comes back."""
    mod, counter, call = _calls()[name]

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(mod, "resolve_device", lambda d: torch.device(d))
    setattr(mod, counter, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        call("cuda")
    assert getattr(mod, counter) == 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises; nothing runs on the
    CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: T3.scatter(16, 1), lambda: T3.fifo(1),
                 lambda: T3.state(1), lambda: T3.vmem(8, 8),
                 lambda: T3.main([]), lambda: T15.main([]),
                 lambda: T15.harness("vpu", 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_argument_checks():
    tape = torch.zeros((16, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        T3.gather(tape.to(torch.int64), 1)
    with pytest.raises(TypeError):
        T3.gather(tape[:, :64], 1)
    for R in (12, 48, 4, 0):
        with pytest.raises(ValueError, match="power of two"):
            T3.gather(torch.zeros((R, 128), dtype=torch.int32), 1)
        with pytest.raises(ValueError, match="power of two"):
            T3.scatter(R, 1, "cpu")
    with pytest.raises(ValueError, match="reps"):
        T3.gather(tape, -1)
    for fn in (T3.fifo, T3.state):
        with pytest.raises(ValueError, match="reps"):
            fn(-1, "cpu")
        with pytest.raises(ValueError, match="reps"):
            fn(1 << 31, "cpu")
    for rows, ring in ((7, 8), (8, 0), (1 << 22, 8)):
        with pytest.raises(ValueError, match="rows and ring"):
            T3.vmem(rows, ring, "cpu")
    with pytest.raises(TypeError):
        T15.walk(torch.zeros(511, dtype=torch.int32), 1)
    with pytest.raises(TypeError):
        T15.walk(torch.zeros(512, dtype=torch.float32), 1)
    with pytest.raises(ValueError, match="r must be"):
        T15.walk(torch.zeros(512, dtype=torch.int32), -1)


def test_main_on_the_cpu(monkeypatch, capsys):
    """Both ``main()``s with small counts and one timing of each: the
    tools' lines, each R, and every scratch size of the tool fitting the
    plain version (``microbench2``'s harness readings in
    ``test_torch_probes3.py``)."""
    monkeypatch.setattr(probes, "TRIES", 1)
    for c in COUNTERS:
        setattr(T3, c, 0)
    assert T3.main(["--div", "20000", "--device", "cpu"]) == 0
    assert T15.main(["--div", "1000000", "--steps", "16", "64",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for R in T3.GATHER_R:
        assert f"per-lane gather (R={R}):" in out
    for R in T3.SCATTER_R:
        assert f"per-lane scatter (R={R}):" in out
    assert "fifo 3-stage bitroll (8,128):" in out
    assert "30-op state step:" in out
    assert out.count("(+4096 ring): OK") == len(T3.VMEM_ROWS)
    assert "smem_scalar_walk (dependent):" in out
    assert "not ported" not in out
    assert all(getattr(T3, c) == 0 for c in COUNTERS)

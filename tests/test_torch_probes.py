"""The design probes of the port (``lz4_sgori_torch.probes``, T4-T8) on
CPU tensors, that is their plain versions, against the tools' own Pallas
kernels under ``tools/`` in TPU interpret mode, on the same numpy-seeded
inputs. Every result is int32, so every comparison is exact.

The tools set ``jax_compilation_cache_dir`` and
``jax_persistent_cache_min_compile_time_secs`` and put the repository on
``sys.path`` when imported; the ``tools`` fixture puts all three back."""

import functools
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

from lz4_sgori_torch.ops.kernels import _build
from lz4_sgori_torch.probes import dma_probe as T5
from lz4_sgori_torch.probes import microbench4 as T78
from lz4_sgori_torch.probes import microbench6 as T6
from lz4_sgori_torch.probes import mul32, sort_probe as T4, wrap32
from lz4_sgori_tpu.ops.pallas import lockstep as LK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("sort_probe", "dma_probe", "microbench6", "microbench4")
CONFIG = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def tools():
    """The four tool modules, imported by path, with the jax settings
    and ``sys.path`` they change put back at once."""
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
    assert tools["sort_probe"].LANES == 128
    assert jax.config.jax_compilation_cache_dir != "/tmp/lz4j_jax_cache"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- T4: the bitonic column sort ----

def test_t4_equals_the_tool(tools):
    """The tool's keys at (16, 128) through ``device_sort`` in interpret
    mode, the port's network and np.sort; and the network's stage list."""
    tool = tools["sort_probe"]
    x = T4.keys(4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tool.device_sort(jnp.asarray(x)))
    got = T4.device_sort(_t(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.sort(x, axis=0))
    for n in (1, 2, 16, 1024):
        assert T4.bitonic_stages(n) == tool.bitonic_stages(n)


def test_t4_stage_equals_the_tool(tools):
    """Every stage of the network alone, on random int32 with negatives
    and repeats, equals the tool's ``sort_stage``."""
    tool = tools["sort_probe"]
    rng = np.random.default_rng(41)
    x = rng.integers(-50, 50, (32, 128)).astype(np.int32)
    iota_j = jax.lax.broadcasted_iota(jnp.int32, (32, 128), 0)
    iota_t = torch.arange(32)[:, None]
    for j, k in T4.bitonic_stages(32):
        want = np.asarray(tool.sort_stage(jnp.asarray(x), j, k, iota_j))
        assert np.array_equal(T4.sort_stage(_t(x), j, k, iota_t).numpy(),
                              want), (j, k)


@pytest.mark.parametrize("logn", [0, 1, 10])
def test_t4_sorts_like_numpy(logn):
    rng = np.random.default_rng(logn)
    x = rng.integers(-(1 << 31), 1 << 31, (1 << logn, 128)).astype(np.int32)
    x[:, 5] = 7                                      # a constant column
    assert np.array_equal(T4.device_sort(_t(x)).numpy(), np.sort(x, axis=0))


# ---- T5: per-lane async copies ----

@pytest.mark.parametrize("w,nl,reps", [(64, 8, 4), (128, 1, 3), (16, 128, 2)])
def test_t5_equals_the_tool(tools, w, nl, reps):
    tool = tools["dma_probe"]
    idx, hbm = T5.inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tool.run(jnp.asarray(idx), jnp.asarray(hbm), w, nl,
                                   reps))
    got = T5.run(_t(idx), _t(hbm), w, nl, reps).numpy()
    assert got.shape == (1, 1) and np.array_equal(got, want)
    total = sum(int(hbm[0, idx[0, 0] + r * 128]) for r in range(reps))
    assert got[0, 0] == np.int64(total).astype(np.int32)   # wraps


def test_t5_refuses_reads_past_the_tape(tools):
    """The tool's defaults (idx up to 63 * 128, w = 512, 64 rounds) read
    past the 16,384-word row: the interpreter raises, the port refuses
    before any copy. 62 rounds fit such a lane, and both agree there;
    the tool's own draw (max idx 62 * 128) fits 63 rounds, not 64."""
    tool = tools["dma_probe"]
    idx, hbm = T5.inputs()
    far = idx.copy()
    far[0, 0] = 63 * 128
    args = (jnp.asarray(far), jnp.asarray(hbm), 512, 4)
    with pytest.raises(jax.errors.JaxRuntimeError,
                       match="IndexError: Out-of-bounds read"), \
            pltpu.force_tpu_interpret_mode():
        tool.run(*args, 64)
    with pytest.raises(ValueError, match="reads words up to 16640 "):
        T5.run(_t(far), _t(hbm), 512, 4, 64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tool.run(*args, 62))
    assert np.array_equal(T5.run(_t(far), _t(hbm), 512, 4, 62).numpy(), want)
    assert idx.max() == 62 * 128
    T5.run(_t(idx), _t(hbm), 512, 128, 63)
    with pytest.raises(ValueError, match="reads words up to 16512 "):
        T5.run(_t(idx), _t(hbm), 512, 128, 64)
    for w in (1025, 0):
        with pytest.raises(ValueError, match="w must be"):
            T5.run(_t(idx), _t(hbm), w, 8, 1)
    with pytest.raises(ValueError, match="multiple"):
        T5.run(_t(idx), _t(hbm), 66, 8, 1)
    bad = idx.copy()
    bad[0, 3] += 2
    with pytest.raises(ValueError, match="multiple"):
        T5.run(_t(bad), _t(hbm), 64, 8, 1)
    assert int(T5.run(_t(idx), _t(hbm), 64, 8, 0)[0, 0]) == 0


# ---- T6: pass-1 GET / PUT rounds ----

def _tool_bodies(mb6, R: int, K: int):
    """The three bodies of ``microbench6.py:main`` (:93-117), as written
    there (they are closures of main)."""
    def getk(c, i):
        hs = [(c[:1] * (k + 3) + i) & (R - 1) for k in range(K)]
        accs = mb6.fused_getK(c, hs, R, K)
        out = accs[0]
        for a in accs[1:]:
            out = out ^ a
        return jnp.concatenate([out, c[1:]], axis=0)

    def putk(c, i):
        ii = mb6.LK._iota_rows(R)
        t = c
        for k in range(K):
            h = (c[:1] * (k + 3) + i) & (R - 1)
            m = ii == mb6.LK._bcast(h, R)
            t = jnp.where(m, mb6.LK._bcast(c[:1] + k, R), t)
        return t

    def extract1(c, i):
        h = (c[:1] + i) & (R - 1)
        v = mb6.LK.extract_rows(c, h, 1)
        return jnp.concatenate([v, c[1:]], axis=0)

    return {"getk": getk, "putk": putk, "extract1": extract1}


@pytest.mark.parametrize("body", T6.BODIES)
def test_t6_equals_the_tool(tools, body):
    """``timed_kernel`` with the tool's body at R = 256, K = 8, on the
    tool's carry, as ``run_case`` calls it (n as a runtime scalar)."""
    mb6 = tools["microbench6"]
    R, K, n = 256, 8, 7
    x = T6.carry(R)
    fn = _tool_bodies(mb6, R, K)[body]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            functools.partial(mb6.timed_kernel, fn),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec()],
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        )(jnp.asarray([n], jnp.int32), jnp.asarray(x)))
    got = T6.rounds(body, _t(x), n, K).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, x[:8])            # the rounds did work


def test_t6_puts_hash_from_the_rounds_row_0():
    """A put that lands on row 0 must not move the round's later hashes
    or values: with c0 = 1 and R = 8 the puts of round 0 are rows 3..7,
    0, 1, 2 (h_k = (k + 3) & 7), so row 0 gets 1 + 5 = 6, and row 2 gets
    c0 + 7 = 8 although row 0 changed before it."""
    x = torch.zeros((8, 128), dtype=torch.int32)
    x[0] = 1
    got = T6.rounds("putk", x, 1, 8)
    assert got[:, 0].tolist() == [6, 7, 8, 1, 2, 3, 4, 5]


# ---- T7: K-batched gets and puts ----

@pytest.mark.parametrize("K,puts", [(1, True), (4, True), (4, False)])
def test_t7_equals_the_tool(tools, K, puts):
    mb4 = tools["microbench4"]
    reps = 5
    with pltpu.force_tpu_interpret_mode():
        f, seed = mb4.make_kget(K, puts)(reps)
        want = np.asarray(f(seed)[0])
    got = T78.kget(_t(np.asarray(seed)), reps, K, puts).numpy()
    assert np.array_equal(got, want)


def test_t7_hash_is_the_wrapping_int32_product():
    """The hash against numpy's int32 arithmetic, which wraps."""
    rng = np.random.default_rng(7)
    acc = rng.integers(0, 1 << 16, 128)
    s = rng.integers(-(1 << 31), 1 << 31, 128)
    with np.errstate(over="ignore"):
        for r, k in ((0, 0), (3, 5), (1000, 15)):
            x = (acc.astype(np.int32) * np.int32(2 * k + 1)
                 + np.int32(r * 977) + s.astype(np.int32) * np.int32(k))
            want = (x * np.int32(-1640531535)) >> 19 & 8191
            got = T78.kget_hashes(torch.from_numpy(acc), r,
                                  torch.from_numpy(s) & 0xFFFFFFFF, k + 1)[k]
            assert np.array_equal(got.numpy(), want), (r, k)
    big = [0, 1, 0xFFFFFFFF, 0x89ABCDEF]
    assert mul32(torch.tensor(big), 0x9E3779B1).tolist() == [
        (v * 0x9E3779B1) & 0xFFFFFFFF for v in big]
    assert wrap32(torch.tensor([1 << 31, -(1 << 31) - 1])).tolist() == [
        -(1 << 31), (1 << 31) - 1]


# ---- T8: the banded byte extract ----

@pytest.mark.parametrize("span_rows", [64, 512])
def test_t8_equals_the_tool(tools, span_rows):
    """``banded_kernel`` over ``extract_bytes_banded`` at R = 512."""
    mb4 = tools["microbench4"]
    R, reps = 512, 3
    with pltpu.force_tpu_interpret_mode():
        f, tape, pos = mb4.make_banded(R, span_rows)(reps)
        want = np.asarray(f(tape, pos)[0])
    t_np, p_np = T78.banded_inputs(R, span_rows)
    assert np.array_equal(t_np, np.asarray(tape))
    assert np.array_equal(p_np, np.asarray(pos))
    got = T78.banded(_t(t_np), _t(p_np), reps).numpy()
    assert np.array_equal(got, want)


def _numpy_words(tape: np.ndarray, lane: int, pos: int, w: int):
    """A reader of lane ``lane``'s bytes: column ``lane`` of the tape,
    little-endian, bytes outside it read 0."""
    stream = tape[:, lane].astype("<i4").tobytes()
    out = []
    for i in range(w):
        b = [stream[p] if 0 <= p < len(stream) else 0
             for p in range(pos + 4 * i, pos + 4 * i + 4)]
        out.append(np.int64(int.from_bytes(bytes(b), "little")).astype(
            np.uint32).view(np.int32))
    return out


def test_t8_extract_at_unaligned_positions():
    """``extract_bytes`` at every byte offset, below the tape and across
    its end, against a numpy reader of the column's bytes and against the
    JAX package's ``extract_bytes`` (the same function without bands)."""
    rng = np.random.default_rng(8)
    R, w = 48, 26
    tape = rng.integers(-(1 << 31), 1 << 31, (R, 128)).astype(np.int32)
    pos = rng.integers(-40, 4 * R + 8, 128)
    pos[:8] = [0, 1, 2, 3, -1, -5, 4 * R - 1, 4 * R - 105]
    got = T78.extract_bytes(_t(tape), torch.from_numpy(pos), w).numpy()
    for lane in range(128):
        assert got[:, lane].tolist() == _numpy_words(tape, lane,
                                                     int(pos[lane]), w), lane
    want = np.asarray(LK.extract_bytes(jnp.asarray(tape),
                                       jnp.asarray(pos[None].astype(np.int32)),
                                       w))
    assert np.array_equal(got, want)


def test_t8_rounds_at_unaligned_positions():
    """With the mask all ones the rounds visit unaligned positions; the
    result equals a numpy loop over the byte reader."""
    rng = np.random.default_rng(9)
    R, reps = 40, 6
    tape = rng.integers(-(1 << 31), 1 << 31, (R, 128)).astype(np.int32)
    pos0 = rng.integers(-30, 4 * R, (1, 128)).astype(np.int32)
    acc = np.zeros(128, np.int64)
    seen = set()
    for _ in range(reps):
        for lane in range(128):
            p = int(pos0[0, lane]) + int(acc[lane] & 63)
            seen.add(p & 3)
            acc[lane] = (acc[lane] + sum(
                int(v) for v in _numpy_words(tape, lane, p, 26))) & 0xFFFF
    assert seen == {0, 1, 2, 3}
    got = T78.banded(_t(tape), _t(pos0), reps, mask=-1).numpy()
    assert got[0].tolist() == acc.tolist()
    assert T78.default_mask(R) == 4 * R - 256
    assert T78.default_mask(16384) == 0xFF00


# ---- the wrappers ----

def _calls():
    idx, hbm = T5.inputs()
    x6 = _t(T6.carry(64))
    seed = torch.arange(128, dtype=torch.int32).reshape(1, 128)
    tape, pos = (_t(a) for a in T78.banded_inputs(256, 64))
    return {
        "T4": (T4, "launches", lambda f: T4.device_sort(f(_t(T4.keys(3))))),
        "T5": (T5, "launches", lambda f: T5.run(f(_t(idx)), f(_t(hbm)), 64, 8,
                                                 2)),
        "T6": (T6, "launches", lambda f: T6.rounds("getk", f(x6), 3)),
        "T7": (T78, "kget_launches", lambda f: T78.kget(f(seed), 3, 4, True)),
        "T8": (T78, "banded_launches", lambda f: T78.banded(f(tape), f(pos),
                                                            3)),
    }


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to send a wrapper down
    its kernel branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("name", ["T4", "T5", "T6", "T7", "T8"])
def test_cpu_tensor_runs_the_plain_version(name):
    mod, counter, call = _calls()[name]
    setattr(mod, counter, 0)
    res = call(lambda t: t)
    assert res.device.type == "cpu" and res.dtype == torch.int32
    assert getattr(mod, counter) == 0


@pytest.mark.parametrize("name", ["T4", "T5", "T6", "T7", "T8"])
def test_failed_build_raises_and_never_falls_back(monkeypatch, name):
    """On a CUDA tensor the wrapper builds its kernel; when the build
    fails it raises, and no plain result comes back."""
    mod, counter, call = _calls()[name]

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    setattr(mod, counter, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        call(lambda t: t.as_subclass(_OnCuda))
    assert getattr(mod, counter) == 0


def test_t5_refusal_comes_before_the_kernel(monkeypatch):
    """On the card's branch a read past the tape is a ValueError before
    any build or launch."""
    monkeypatch.setattr(_build, "load", lambda *_a, **_k: pytest.fail(
        "the kernel was built for a refused call"))
    idx, hbm = T5.inputs()
    T5.launches = 0
    with pytest.raises(ValueError, match="reads words up to"):
        T5.run(_t(idx).as_subclass(_OnCuda), _t(hbm).as_subclass(_OnCuda),
               512, 128, 64)
    assert T5.launches == 0


def test_argument_checks():
    x = torch.zeros((16, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        T4.device_sort(x.to(torch.int64))
    with pytest.raises(TypeError):
        T4.device_sort(torch.zeros((16, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        T4.device_sort(torch.zeros((12, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="nl"):
        T5.run(x[:1], x.repeat(8, 1)[:128], 16, 0, 1)
    with pytest.raises(ValueError, match="body"):
        T6.rounds("getx", x, 1)
    with pytest.raises(ValueError, match="power of two"):
        T6.rounds("getk", torch.zeros((12, 128), dtype=torch.int32), 1)
    with pytest.raises(TypeError):
        T78.kget(x[:1, :64], 1, 1)
    with pytest.raises(ValueError, match="reps"):
        T78.banded(x, x[:1], -1)


@pytest.mark.parametrize("mod,argv", [
    (T4, ["4", "2"]),
    (T5, ["8", "64", "--reps", "2", "4"]),
])
def test_main_on_the_cpu(capsys, mod, argv):
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cpu (the plain version)" in out and "correct: True" in out

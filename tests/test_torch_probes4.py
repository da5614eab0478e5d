"""T14b, the tensor-core readings of the primitive-rate harness
(``lz4_sgori_torch.probes.microbench2.harness``) on CPU tensors, that is
their plain versions, against the tool's own ``_harness``
(``tools/microbench2.py``) around its four MXU bodies, copied here as
written, in TPU interpret mode on the tool's inputs, and against a
float64 reference.

The order in which a product's terms are summed is left to the matrix
unit, so ``mxu_bf16``, ``mxu_f32`` and ``cumsum_mxu_lane`` are held
within ``harness_reference``'s bound E of the float64 value (the tool's
output and the port's plain version alike), never to each other's bits.
``gather`` (one non-zero term a row) and ``cumsum_mxu``'s rows 0-7 (sums
of at most 8 integers below 2^21) are exact in any order: their ``out``
is held bit for bit, ``gather``'s ``sink`` exactly."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lz4_sgori_torch.ops.kernels import _build
from lz4_sgori_torch.probes import microbench2 as T14
from test_torch_probes3 import _OnCuda, tool  # noqa: F401 (a fixture)
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC = ("mxu_bf16", "mxu_f32", "gather", "cumsum_mxu", "cumsum_mxu_lane")
M32 = 0xFFFFFFFF


# ---- the tool's bodies, as written (tools/microbench2.py:115-315) ----

def lcg(x):
    return x * jnp.int32(1664525) + jnp.int32(1013904223)


def body_mxu(i, acc, ins):
    a, b = ins[0][...], ins[1][...]
    a = a * ((i & 1) + 1).astype(a.dtype)
    c = jnp.dot(a, b, preferred_element_type=jnp.float32)
    return acc + c[0:8, :]


def body_gather(i, acc, ins):
    ids, data = ins[0], ins[1]
    idv = (lcg(ids[...] + i) >> 7) & 511  # (2048, 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (2048, 512), 1)
    oh = (cols == idv).astype(jnp.bfloat16)
    g = jnp.dot(oh, data[...], preferred_element_type=jnp.float32)
    return acc + g[0:8, :]


def body_cumsum_mxu(i, acc, ins):
    x = (ins[0][...] + i).astype(jnp.float32)
    tri = ins[1][...]
    c = jnp.dot(tri, x, preferred_element_type=jnp.float32)
    return acc + c[0:8, :]


def body_cumsum_mxu_lane(i, acc, ins):
    x = (ins[0][...] + i).astype(jnp.float32)
    triu = ins[1][...]  # (128,128) upper-tri
    c = jnp.dot(x, triu, preferred_element_type=jnp.float32)
    return acc + c[0:8, :]


def _tool_args(name):
    """The tool's own arrays of a reading (``main()``'s conversions)."""
    ins = T14.tool_inputs()
    mA = jnp.asarray(ins["mA"], jnp.bfloat16)
    mB = jnp.asarray(ins["mB"], jnp.bfloat16)
    return {
        "mxu_bf16": (body_mxu, (mA, mB)),
        "mxu_f32": (body_mxu, (mA.astype(jnp.float32),
                               mB.astype(jnp.float32))),
        "gather": (body_gather, (jnp.asarray(ins["ids"], jnp.int32),
                                 jnp.asarray(ins["data_bf"], jnp.bfloat16))),
        "cumsum_mxu": (body_cumsum_mxu, (
            jnp.asarray(ins["a512"], jnp.int32),
            jnp.asarray(np.tril(np.ones((512, 512), np.float32))))),
        "cumsum_mxu_lane": (body_cumsum_mxu_lane, (
            jnp.asarray(ins["a512"], jnp.int32),
            jnp.asarray(np.triu(np.ones((128, 128), np.float32))))),
    }[name]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _within(got, ref, e) -> float:
    """The worst cell of ``got`` in units of its bound (at most 1)."""
    d = (torch.as_tensor(np.asarray(got, np.float64)) - ref).abs()
    return float((d / e.clamp_min(1e-300)).max()) if d.any() else 0.0


def _gather_sink(r: int) -> int:
    """numpy's model of ``gather``'s sink: the wrapping sum of the float32
    bits of ``data_bf[idv]`` over every iteration."""
    ins = T14.tool_inputs()
    data = torch.from_numpy(ins["data_bf"]).to(torch.bfloat16).to(
        torch.float32).numpy()
    total = 0
    with np.errstate(over="ignore"):
        for i in range(r):
            v = (ins["ids"][:, 0] + np.int32(i)) * np.int32(1664525) \
                + np.int32(1013904223)
            idv = (v >> np.int32(7)) & np.int32(511)
            total += int(data[idv].view(np.int32).astype(np.int64).sum())
    return int(np.uint32(total & M32).view(np.int32))


@pytest.mark.parametrize("name", TC)
def test_t14b_tool_and_plain_within_the_reference(tool, name):
    """At R 0, 3, 40 and 300 on the tool's inputs: the tool's
    ``_harness(body)`` in interpret mode and the port's plain version each
    within E of the float64 reference (``out`` in every cell, ``sink``
    within the summed bound), or, for ``gather`` and ``cumsum_mxu``'s
    ``out``, equal bit for bit (``gather``'s ``sink`` equal to numpy's)."""
    body, args = _tool_args(name)
    run = tool._harness(body)
    ins = T14.body_inputs(name, "cpu")
    for r in (0, 3, 40, 300):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(run(r, *args))
        out, sink = T14.harness(name, r, *ins)
        assert out.dtype == torch.float32 and out.shape == (8, 128)
        body_ = T14.BODIES[name]
        assert sink.dtype == body_.sink and sink.shape == ()
        if body_.sink == torch.int32:
            assert np.array_equal(_bits(out.numpy()), _bits(want)), r
            assert int(sink) == _gather_sink(r), r
            continue
        ref, e_out, ref_sink, e_sink = T14.harness_reference(name, r, *ins)
        assert _within(want, ref, e_out) <= 1.0, r
        assert _within(out.numpy(), ref, e_out) <= 1.0, r
        assert abs(float(sink) - ref_sink) <= e_sink, r
        if body_.exact:
            assert np.array_equal(_bits(out.numpy()), _bits(want)), r
        if r == 0:
            assert float(sink) == 0.0 and not want.any()


def test_t14b_bodies_are_the_tools():
    """The five readings with the tool's names, lines and repeat counts,
    each kernel source's switch in the order of its bodies in the table
    (``probe_harness_tc``: ``mxu_bf16``, ``cumsum_mxu_lane``;
    ``probe_harness_wg``: T14a's ``ohbuild``, then ``mxu_f32``, ``gather``,
    ``cumsum_mxu``), the rates an SM, the card counts of ``cumsum_mxu``
    below 2^20 (its rows 0-7 exact), and the tool's 20 readings named
    through ``BODIES``."""
    with open(os.path.join(ROOT, "tools", "microbench2.py")) as f:
        lines = f.read().splitlines()
    assert T14.T14B == TC
    assert [n for n in TC if T14.BODIES[n].source == T14.WG] == [
        "mxu_f32", "gather", "cumsum_mxu"]
    assert [n for n in TC if T14.BODIES[n].source == T14.TC] == [
        "mxu_bf16", "cumsum_mxu_lane"]
    tool_counts = {"mxu_bf16": (8192, 524288), "mxu_f32": (8192, 524288),
                   "gather": (4096, 262144), "cumsum_mxu": (4096, 131072),
                   "cumsum_mxu_lane": (2048, 65536)}
    for name in TC:
        body = T14.BODIES[name]
        fn = "mxu" if name.startswith("mxu") else name
        assert lines[body.line - 1].strip().startswith(f"def body_{fn}(")
        text = "\n".join(lines[body.line:body.line + 15])
        assert f'"{body.reading}"' in text
        assert body.tool == tool_counts[name]
        assert body.card[0] < body.card[1]
        assert body.rate == (T14.BF16 if name in ("mxu_bf16", "gather")
                             else T14.TF32)
    assert T14.BODIES["cumsum_mxu"].card[1] < 1 << 20
    assert [n for n in TC if T14.BODIES[n].exact] == ["gather", "cumsum_mxu"]
    assert [n for n in TC if T14.BODIES[n].sink == torch.int32] == ["gather"]
    assert sorted(T14.ORDER) == sorted(T14.BODIES)
    # each source's switch: case k runs the body whose BODY_ID is k
    for source, pattern in ((T14.TC, r"case (\d+): return launch<(\w+)>"),
                            (T14.WG, r"case (\d+): return run_(\w+)\(")):
        with open(os.path.join(ROOT, "lz4_sgori_torch", "csrc",
                               f"{source}.cu")) as f:
            cases = re.findall(pattern, f.read())
        assert [(int(k), s.lower().replace("_", "")) for k, s in cases] == [
            (T14.BODY_ID[n], n.replace("_", "")) for n in T14.BODIES
            if T14.BODIES[n].source == source]


def test_t14b_inputs_are_the_tools():
    """``body_inputs`` gives the tool's arrays: torch's float64 -> bfloat16
    cast rounds as ``jnp.asarray(..., jnp.bfloat16)`` does, the f32
    reading takes the same values, the triangles are built."""
    for name in TC:
        _, args = _tool_args(name)
        for got, want in zip(T14.body_inputs(name, "cpu"), args):
            want = np.asarray(want)
            if got.dtype == torch.bfloat16:
                assert np.array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16)), name
            else:
                assert got.numpy().dtype == want.dtype
                assert np.array_equal(got.numpy(), want), name


def _tool_operands(name, i):
    """The tool's two operands of iteration ``i``'s product, as its body
    forms them."""
    _, (p, q) = _tool_args(name)
    if name.startswith("mxu"):
        return p * jnp.asarray((i & 1) + 1).astype(p.dtype), q
    if name == "gather":
        idv = (lcg(p + i) >> 7) & 511
        cols = jax.lax.broadcasted_iota(jnp.int32, (2048, 512), 1)
        return (cols == idv).astype(jnp.bfloat16), q
    x = (p + i).astype(jnp.float32)
    return (q, x) if name == "cumsum_mxu" else (x, q)


@pytest.mark.parametrize("name", TC)
def test_t14b_tool_operands_are_the_tools(name):
    """``tool_operands`` (the library timing's product and the float64
    reference's operands) gives the tool's operands bit for bit in the
    tool's types, at iterations where the factor is 1 and 2."""
    ins = T14.body_inputs(name, "cpu")
    for i in (0, 1, 5):
        for got, want in zip(T14.tool_operands(name, i, *ins),
                             _tool_operands(name, i)):
            want = np.asarray(want)
            if got.dtype == torch.bfloat16:
                got, want = got.view(torch.int16), want.view(np.int16)
            assert got.numpy().dtype == want.dtype, (name, i)
            assert np.array_equal(got.numpy(), want), (name, i)


# ---- the arithmetic traps ----

def _bits_as_float(b: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns, taken modulo 2^32, as float32."""
    return (((b + (1 << 31)) & M32) - (1 << 31)).to(torch.int32).view(
        torch.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to TF32, rounded to nearest with ties away (cvt.rna)."""
    b = x.view(torch.int32).to(torch.int64)
    return _bits_as_float((b + 0x1000) & ~0x1FFF)


def _lane_in(r: int, x_of):
    """``cumsum_mxu_lane`` at R ``r`` with ``x`` (float32) replaced by
    ``x_of(x)`` (float64): its out, and the reference's bound."""
    a, triu = T14.body_inputs("cumsum_mxu_lane", "cpu")
    acc = torch.zeros((8, 128), dtype=torch.float32)
    for i in range(r):
        x = (a.to(torch.int64) + i).to(torch.float32)
        acc = acc + (x_of(x) @ triu.double()).to(torch.float32)[:8]
    ref, e, _, _ = T14.harness_reference("cumsum_mxu_lane", r, a, triu)
    return acc, ref, e


def test_trap_single_pass_tf32_misses_e():
    """Plain TF32 keeps 11 significant bits and ``a512 + i`` needs up to 21:
    one TF32 pass misses E for ``cumsum_mxu_lane`` (8x at R 300), while
    the kernel's split (hi = x with its 13 low mantissa bits cleared, lo =
    x - hi rounded to TF32) sums back to x exactly, so its result is the
    exact product's and within E."""
    r = 300
    one, ref, e = _lane_in(r, lambda x: _tf32(x).double())
    assert _within(one.numpy(), ref, e) > 1.0

    def split(x):
        hi = _bits_as_float(x.view(torch.int32).to(torch.int64) & 0xFFFFE000)
        lo = _tf32(x - hi)
        assert torch.equal(hi.double() + lo.double(), x.double())
        return hi.double() + lo.double()

    two, ref, e = _lane_in(r, split)
    assert _within(two.numpy(), ref, e) <= 1.0
    # the split is exact for every float32 below 2^22
    x = torch.arange(0, 1 << 22, 4099, dtype=torch.float32)
    split(x)


def test_trap_bf16_inputs_stay_floats_in_the_plain_version():
    """``harness_plain`` turns integer inputs into int64 but keeps bf16 and
    float32 values as they are: a product of halves is not truncated."""
    a = torch.full((512, 512), 0.5, dtype=torch.bfloat16)
    b = torch.full((512, 128), 0.25, dtype=torch.bfloat16)
    out, sink = T14.harness_plain("mxu_bf16", 1, a, b)
    assert torch.equal(out, torch.full((8, 128), 64.0))
    assert float(sink) == 64.0 * 512 * 128
    out, _ = T14.harness_plain("mxu_f32", 2, a.float(), b.float())
    assert torch.equal(out, torch.full((8, 128), 64.0 + 128.0))


def test_trap_bf16_product_is_taken_in_float32():
    """bf16 @ bf16 in torch returns bf16, rounding the product; the tool
    asks for float32 (``preferred_element_type``), and the plain version
    rounds the float64 product once to float32."""
    a, b = T14.body_inputs("mxu_bf16", "cpu")
    part, _ = T14.BODIES["mxu_bf16"].step(0, a, b)
    exact = (a.double() @ b.double())[:8].to(torch.float32)
    assert torch.equal(part, exact)
    assert (a @ b).dtype == torch.bfloat16
    assert not torch.equal((a @ b)[:8].to(torch.float32), part)


# ---- the wrapper ----

def test_t14b_argument_checks():
    mA, mB = T14.body_inputs("mxu_bf16", "cpu")
    a512, tri = T14.body_inputs("cumsum_mxu", "cpu")
    ids, data = T14.body_inputs("gather", "cpu")
    with pytest.raises(TypeError, match="mA "):
        T14.harness("mxu_bf16", 1, mA.float(), mB)
    with pytest.raises(TypeError, match="mB "):
        T14.harness("mxu_bf16", 1, mA, mB[:, :64])
    with pytest.raises(TypeError, match="mA32"):
        T14.harness("mxu_f32", 1, mA, mB.float())
    with pytest.raises(TypeError, match="data_bf"):
        T14.harness("gather", 1, ids, data.float())
    with pytest.raises(TypeError, match="tri "):
        T14.harness("cumsum_mxu", 1, a512, tri.double())
    with pytest.raises(TypeError, match="triu"):
        T14.harness("cumsum_mxu_lane", 1, a512, tri)
    with pytest.raises(TypeError, match="takes 2 inputs"):
        T14.harness("gather", 1, ids)
    with pytest.raises(ValueError, match="bit for bit"):
        T14.harness_reference("gather", 1, ids, data)
    with pytest.raises(ValueError, match="r must be"):
        T14.harness("mxu_bf16", -1, mA, mB)


def test_t14b_failed_build_raises_and_never_falls_back(monkeypatch):
    """On the card's branch a tensor-core reading builds
    ``probe_harness_tc``; when the build fails it raises, and no plain
    result comes back."""
    built = []

    def no_nvcc(name, *_a, **_k):
        built.append(name)
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    T14.harness_launches["mxu_bf16"] = 0
    args = [t.as_subclass(_OnCuda)
            for t in T14.body_inputs("mxu_bf16", "cpu")]
    with pytest.raises(RuntimeError, match="nvcc"):
        T14.harness("mxu_bf16", 3, *args)
    assert built == ["probe_harness_tc"]
    assert T14.harness_launches["mxu_bf16"] == 0


def test_t14b_wg_failed_build_raises_and_never_falls_back(monkeypatch):
    """A whole-card reading builds ``probe_harness_wg``; when the build
    fails it raises, and no plain result comes back."""
    built = []

    def no_nvcc(name, *_a, **_k):
        built.append(name)
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    T14.harness_launches["gather"] = 0
    args = [t.as_subclass(_OnCuda) for t in T14.body_inputs("gather", "cpu")]
    with pytest.raises(RuntimeError, match="nvcc"):
        T14.harness("gather", 3, *args)
    assert built == ["probe_harness_wg"]
    assert T14.harness_launches["gather"] == 0


def _wg_emulated(name, r, ins, grid, rng):
    """``probe_harness_wg``'s reduction contract on the CPU: the items
    (iteration, row band) of a static list dealt to ``grid`` blocks, run in
    a shuffled order; band 0's rows [:8] to a per-iteration buffer, added
    into acc in iteration order; a sink partial a block, summed in block
    order."""
    rows = 64 if name == "gather" else 128
    bands = 2048 // rows if name == "gather" else 512 // rows
    wraps = T14.BODIES[name].sink == torch.int32
    scratch = torch.full((r, 8, 128), float("nan"))
    part = [0] * grid if wraps else [0.0] * grid
    for w in rng.permutation(r * bands):
        i, band = divmod(int(w), bands)
        a, b = T14.tool_operands(name, i, *ins)
        c = (a[band * rows:(band + 1) * rows].double() @ b.double()).to(
            torch.float32)
        if wraps:
            part[w % grid] += int(c.view(torch.int32).to(torch.int64).sum())
        else:
            part[w % grid] += float(c.double().sum())
        if band == 0:
            scratch[i] = c[:8]
    acc = torch.zeros((8, 128), dtype=torch.float32)
    for i in range(r):
        acc = acc + scratch[i]
    sink = 0 if wraps else 0.0
    for p in part:
        sink += p
    if wraps:
        return acc, torch.tensor(((sink + (1 << 31)) & M32) - (1 << 31),
                                 dtype=torch.int32)
    return acc, torch.tensor(sink, dtype=torch.float64)


@pytest.mark.parametrize("name", ["gather", "cumsum_mxu"])
def test_t14b_wg_reduction_contract(name):
    """Items in a shuffled order, rows 0-7 through a per-iteration buffer
    added in iteration order, sink partials a block summed in block order:
    at R 0, 1, 3 and 40 ``out`` equals ``harness_plain`` bit for bit
    (``gather``'s ``sink`` too), ``cumsum_mxu``'s ``sink`` within the
    summed bound."""
    rng = np.random.default_rng(12)
    ins = T14.body_inputs(name, "cpu")
    for r in (0, 1, 3, 40):
        out, sink = _wg_emulated(name, r, ins, 7, rng)
        want_out, want_sink = T14.harness_plain(name, r, *ins)
        assert np.array_equal(_bits(out.numpy()), _bits(want_out.numpy())), r
        if name == "gather":
            assert torch.equal(sink, want_sink), r
        else:
            _, _, ref_sink, e_sink = T14.harness_reference(name, r, *ins)
            assert abs(float(sink) - ref_sink) <= e_sink, r
            assert abs(float(want_sink) - ref_sink) <= e_sink, r

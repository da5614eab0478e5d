"""The xla engine (the portable, exhaustive max-ratio encode and its decode
route) against the JAX package's, and the port's ``utils.logging`` and
``config`` against the JAX modules.

Each helper of the encode (``_prefix_hashes``, ``_prev_occurrence``,
``_match_lengths``, ``_best_candidates``, ``_backward_runs``) is held bit
for bit against its JAX function on seeded numpy inputs, then the whole
engine against JAX ``_compress_blocks_impl`` on the CPU: ``comp_len`` and
the first ``compress_bound(bs)`` columns, at 4 KiB (depths 1, 3, 5), 64
KiB (1, 3) and 128 KiB (1). JAX compiles once for each (batch shape,
block size, depth), so every case of a block size shares one batch
shape."""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from lz4_sgori_torch import config as TC
from lz4_sgori_torch import format as F
from lz4_sgori_torch import golden
from lz4_sgori_torch.ops import encode as E
from lz4_sgori_torch.ops.decode import decompress_blocks_device
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.utils import logging as TL
from lz4_sgori_torch.utils import oracle
from lz4_sgori_tpu import config as JC
from lz4_sgori_tpu.ops import decode as JD
from lz4_sgori_tpu.ops import encode as JE
from lz4_sgori_tpu.ops.primitives import le_word as j_le_word
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

NB = 8   # one batch shape a block size: one JAX compile a (size, depth)

# the JAX helpers, compiled (eager JAX runs them op by op, for seconds)
j_prefix_hashes = jax.jit(JE._prefix_hashes, static_argnums=1)
j_prev_occurrence = jax.jit(JE._prev_occurrence)
j_match_lengths = jax.jit(JE._match_lengths, static_argnums=3)
j_best_candidates = jax.jit(JE._best_candidates, static_argnums=(3, 4))
j_backward_runs = jax.jit(JE._backward_runs)


def _blocks(bs: int, seed: int) -> list[bytes]:
    """NB blocks of ``bs``: three full ones (heavy word repeats, random,
    zeros), a short one of text and runs of 0xFF, and the lengths 0, 1,
    12 (all literals) and 13 (the first that may hold a match)."""
    rng = np.random.default_rng(seed)
    text = (b"lorem ipsum dolor sit amet, consectetur adipiscing elit; "
            * (bs // 40 + 2))
    words = [rng.integers(0, 256, int(rng.integers(3, 12)),
                          np.uint8).tobytes() for _ in range(24)]
    repeats = b"".join(words[j] for j in rng.integers(0, 24, bs))[:bs]
    ff = (text[:300] + b"\xff" * 300
          + bytes(rng.integers(0, 256, 40, np.uint8))) * (bs // 640 + 1)
    short = int(rng.integers(14, bs))
    return [repeats, rng.integers(0, 256, bs, np.uint8).tobytes(),
            bytes(bs), ff[:short], b"", b"q", text[7:19], text[5:18]]


def _pack(blocks, bs: int):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for j, b in enumerate(blocks):
        raw[j, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[j] = len(b)
    return raw, rlen


def _far_block() -> bytes:
    """128 KiB of noise with a 200-byte run repeated at distance 65535
    (a valid match, reached at depth 2 and up: a 10-byte copy of its
    head 500 bytes nearer is the nearest candidate) and another at
    distance 65536, one past the window (never a match)."""
    rng = np.random.default_rng(77)
    b = bytearray(rng.integers(0, 256, 131072, np.uint8).tobytes())
    b[FAR:FAR + 200] = b[1000:1200]
    b[FAR - 500:FAR - 490] = b[1000:1010]
    b[PAST:PAST + 200] = b[5000:5200]
    return bytes(b)


FAR, PAST = 1000 + 65535, 5000 + 65536


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))


def _helper_inputs(bs: int, seed: int):
    raw, rlen = _pack(_blocks(bs, seed), bs)
    b = raw.astype(np.int32)
    return raw, rlen, b, np.asarray(j_le_word(jnp.asarray(b), 4))


def _hashes_j(b):
    return [(j_prefix_hashes(jnp.asarray(b), m),
             jnp.array([pow(m, 1 << k, 1 << 32) for k in range(24)],
                       dtype=jnp.uint32)) for m in JE._HA]


def _hashes_t(b):
    return [(E._prefix_hashes(_t(b), m),
             [pow(m, 1 << k, 1 << 32) for k in range(24)]) for m in E._HA]


@pytest.mark.parametrize("mult", E._HA)
def test_prefix_hashes_and_prev_occurrence_match_jax(mult):
    bs = 4096
    _, _, b, w32 = _helper_inputs(bs, 3)
    want = _u32(j_prefix_hashes(jnp.asarray(b), mult))
    got = E._prefix_hashes(_t(b), mult).numpy()
    assert want.shape == got.shape == (NB, bs + 1)
    assert np.array_equal(got, want)
    want = np.asarray(j_prev_occurrence(jnp.asarray(w32)))
    got = E._prev_occurrence(_t(_u32(w32))).numpy()
    assert np.array_equal(got, want)
    assert (got < np.arange(bs)).all()


def test_mul32_and_powers_wrap_at_32_bits():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, 4096, np.uint64)
    y = rng.integers(0, 1 << 32, 4096, np.uint64)
    want = (x * y) & np.uint64(0xFFFFFFFF)   # uint64 wraps mod 2^64
    got = E.mul32(_t(x.astype(np.int64)), _t(y.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for mult in E._HA:
        p = E._powers(mult, 1000, "cpu").numpy()
        assert [int(v) for v in p] == [pow(mult, k, 1 << 32)
                                       for k in range(1000)]


@pytest.mark.parametrize("seed", [4, 5])
def test_match_lengths_and_backward_runs_match_jax(seed):
    bs = 4096
    raw, rlen, b, w32 = _helper_inputs(bs, seed)
    prev = np.asarray(j_prev_occurrence(jnp.asarray(w32)))
    pj = np.maximum(prev, 0)
    rl2 = rlen[:, None]
    want = np.asarray(j_match_lengths(
        jnp.asarray(b), jnp.asarray(pj), jnp.asarray(rl2), bs,
        _hashes_j(b)))
    got = E._match_lengths(_t(b), _t(pj), _t(rl2), bs, _hashes_t(b))
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(j_backward_runs(jnp.asarray(b), jnp.asarray(pj)))
    got = E._backward_runs(_t(b), _t(pj))
    assert np.array_equal(got.numpy(), want)
    assert want.max() == E._CATCHUP_MAX   # the bound is reached


@pytest.mark.parametrize("bs,depths", [(4096, (1, 3, 5)), (131072, (3,))])
def test_best_candidates_match_jax(bs, depths):
    """Depths 1, 3 and 5 at 4 KiB, and 3 on the 128 KiB block whose runs
    lie at distances 65535 and 65536 (depth 1 there: the engine's test);
    on that block, the candidates the window and the chain allow."""
    if bs == 131072:
        blk = _far_block()
        raw, rlen = _pack([blk], bs)
    else:
        raw, rlen = _pack(_blocks(bs, 6), bs)
    b = raw.astype(np.int32)
    w32 = np.asarray(j_le_word(jnp.asarray(b), 4))
    rl2 = rlen[:, None]
    for depth in depths:
        want = [np.asarray(x) for x in j_best_candidates(
            jnp.asarray(b), jnp.asarray(w32), jnp.asarray(rl2), bs, depth)]
        got = [x.numpy() for x in E._best_candidates(
            _t(b), _t(_u32(w32)), _t(rl2), bs, depth)]
        for g, w in zip(got, want):
            assert np.array_equal(g, w), depth
    if bs == 131072:
        for depth in (1, 3):
            bp, ml, _ = (x[0].numpy() for x in E._best_candidates(
                _t(b), _t(_u32(w32)), _t(rl2), bs, depth))
            assert bp[FAR] == (FAR - 500 if depth == 1 else 1000)
            assert ml[FAR] == (10 if depth == 1 else 200)
            assert bp[PAST] == -1 and ml[PAST] == 0   # past the window


def _engine_case(bs: int, depth: int, blocks=None):
    raw, rlen = _pack(blocks or _blocks(bs, bs + depth), bs)
    jc, jl = map(np.asarray, JE._compress_blocks_impl(raw, rlen, bs, depth))
    comp, clen = compress_blocks_device(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs,
        match_depth=depth, impl="xla")
    return raw, rlen, jc, jl, comp.numpy(), clen.numpy()


@pytest.mark.parametrize("bs,depth", [(4096, 1), (4096, 3), (4096, 5),
                                      (65536, 1), (65536, 3),
                                      (131072, 1)])
def test_engine_matches_jax(bs, depth):
    """The whole engine: comp_len and the first compress_bound(bs)
    columns equal JAX's; the port's slot is 8 bytes wider, all zero past
    comp_len. At 64 and 128 KiB the four blocks of bs bytes or near it
    (the lengths under 14 cost the same at every size), at 128 KiB with
    the random block's runs at distances 65535 and 65536."""
    blocks = _blocks(bs, bs + depth)
    if bs > 4096:
        blocks = blocks[:4]
    if bs == 131072:
        blocks[1] = _far_block()
    _, _, jc, jl, comp, clen = _engine_case(bs, depth, blocks)
    cb = F.compress_bound(bs)
    assert comp.shape == (len(blocks), cb + 8) and clen.dtype == np.int32
    assert np.array_equal(clen, jl)
    assert np.array_equal(comp[:, :cb], jc)
    assert (comp[np.arange(cb + 8)[None, :] >= clen[:, None]] == 0).all()
    if bs == 4096:    # raw_len 0, 1 and 12: the token and the literals
        assert list(clen[4:7]) == [1, 2, 13]


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.integers(0, 4096), st.binary(min_size=1, max_size=64),
       st.integers(0, 2 ** 32 - 1))
def test_engine_matches_jax_fuzz(n, alphabet, seed):
    """raw_len and contents drawn by hypothesis, at 4 KiB and depth 3
    (one JAX compile): a block of ``n`` bytes drawn from a small
    alphabet of words in row 0 of the test's usual batch."""
    rng = np.random.default_rng(seed)
    blk = bytes(rng.choice(np.frombuffer(alphabet, np.uint8), n))
    blocks = _blocks(4096, 7)
    blocks[0] = blk
    _, _, jc, jl, comp, clen = _engine_case(4096, 3, blocks)
    assert np.array_equal(clen, jl)
    assert np.array_equal(comp[:, :F.compress_bound(4096)], jc)
    assert golden.decompress(comp[0, :clen[0]].tobytes(), 4096) == blk


@pytest.mark.parametrize("bs,depth", [(4096, 5), (65536, 3)])
def test_engine_round_trips(fixtures, bs, depth):
    """The engine's bytes decode under golden, the port's routed decode,
    its xla decode and liblz4 (where it is present); the two decodes of
    the port are equal."""
    data = fixtures["mixed"]
    blocks = [data[i:i + bs] for i in range(0, len(data), bs)][:NB]
    raw, rlen = _pack(blocks, bs)
    comp, clen = compress_blocks_device(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs,
        match_depth=depth, impl="xla")
    routed = decompress_blocks_device(comp, clen, bs)
    xla = decompress_blocks_device(comp, clen, bs, impl="xla")
    for a, b in zip(routed, xla):
        assert torch.equal(a, b)
    out, out_len, err = (t.numpy() for t in xla)
    cn, ln = comp.numpy(), clen.numpy()
    for j, blk in enumerate(blocks):
        c = cn[j, :ln[j]].tobytes()
        assert golden.decompress(c, bs) == blk
        assert not err[j] and out[j, :out_len[j]].tobytes() == blk
        if oracle.available():
            assert oracle.decompress(c, bs) == blk


def test_wrapper_defaults_warnings_and_types():
    """match_depth=None runs depth 3 and equals JAX compress_blocks_device
    (impl="xla"); acceleration > 1 warns; no depth-cap warning at any
    depth; the cost is comp_len; raw that is not uint8 raises."""
    raw, rlen = _pack(_blocks(4096, 4096 + 3), 4096)
    rt, lt = torch.from_numpy(raw), torch.from_numpy(rlen)
    jc, jl = map(np.asarray, JE.compress_blocks_device(raw, rlen, 4096,
                                                       impl="xla"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        comp, clen, cost = compress_blocks_device(rt, lt, 4096, impl="xla",
                                                  return_cost=True)
        c9, l9 = compress_blocks_device(rt[:1], lt[:1], 4096,
                                        match_depth=9, impl="xla")
    assert np.array_equal(clen.numpy(), jl)
    assert np.array_equal(comp.numpy()[:, :F.compress_bound(4096)], jc)
    assert torch.equal(cost, clen)
    c3, l3 = compress_blocks_device(rt, lt, 4096, match_depth=3, impl="xla")
    assert torch.equal(c3, comp) and torch.equal(l3, clen)
    assert golden.decompress(c9[0, :l9[0]].numpy().tobytes(), 4096) == \
        raw[0].tobytes()
    with pytest.warns(UserWarning, match="acceleration=4"):
        c4, l4 = compress_blocks_device(rt, lt, 4096, acceleration=4,
                                        impl="xla")
    assert torch.equal(c4, comp) and torch.equal(l4, clen)
    with pytest.raises(TypeError, match="uint8"):
        compress_blocks_device(rt.to(torch.int32), lt, 4096, impl="xla")


def test_batches_do_not_change_the_bytes(monkeypatch):
    """Runs of a few blocks (the card's memory bound) give the bytes of
    one whole batch, for the encode and the xla decode alike."""
    from lz4_sgori_torch.ops import primitives as P
    raw, rlen = _pack(_blocks(4096, 11), 4096)
    rt, lt = torch.from_numpy(raw), torch.from_numpy(rlen)
    whole = compress_blocks_device(rt, lt, 4096, impl="xla")
    dec = decompress_blocks_device(*whole, 4096, impl="xla")
    monkeypatch.setattr(P, "BATCH_POSITIONS", 3 * 4096)   # 3 rows, or 2
    for a, b in zip(compress_blocks_device(rt, lt, 4096, impl="xla"), whole):
        assert torch.equal(a, b)
    for a, b in zip(decompress_blocks_device(*whole, 4096, impl="xla"), dec):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_sequences", [None, 1, 2, 40])
def test_xla_decode_matches_jax(max_sequences):
    """decompress_blocks_device(impl="xla") equals JAX
    _decompress_blocks_impl with max_sequences passed through (1 and 2
    cut the chain short of most blocks' terminal: err): err and out_len
    everywhere, the bytes of every block without an error. An erroneous
    row is all zero in the port (every decoder's contract there), where
    JAX leaves what it wrote. The routed decode ignores max_sequences, as
    in JAX."""
    bs = 4096
    blocks = _blocks(bs, 9)
    slot = F.compress_bound(bs) + 8
    comp = np.zeros((NB, slot), np.uint8)
    clen = np.zeros(NB, np.int32)
    for j, b in enumerate(blocks):
        c = golden.compress(b)
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    comp[3, 7] ^= 0x5A      # one malformed block
    want = [np.asarray(x) for x in JD._decompress_blocks_impl(
        comp, clen, bs, max_sequences)]
    ct, lt = torch.from_numpy(comp), torch.from_numpy(clen)
    out, out_len, err = (x.numpy() for x in decompress_blocks_device(
        ct, lt, bs, max_sequences=max_sequences, impl="xla"))
    assert np.array_equal(err, want[2])
    assert np.array_equal(out_len, want[1])
    assert np.array_equal(out[~err], want[0][~err])
    assert not out[err].any()
    if max_sequences == 1:
        assert err.sum() >= 3
    routed = decompress_blocks_device(ct, lt, bs, max_sequences=1)
    full = decompress_blocks_device(ct, lt, bs, impl="xla")
    for a, b in zip(routed, full):
        assert torch.equal(a, b)


def test_codec_config_matches_jax():
    tf = [(f.name, f.default) for f in dataclasses.fields(TC.CodecConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JC.CodecConfig)]
    assert tf == jf
    assert dataclasses.asdict(TC.DEFAULT) == dataclasses.asdict(JC.DEFAULT)
    assert TC.CodecConfig.__doc__ == JC.CodecConfig.__doc__
    for bad in (0, F.MAX_INPUT_SIZE + 1):
        with pytest.raises(ValueError, match="out of range"):
            TC.CodecConfig(block_size=bad)
        with pytest.raises(ValueError, match="out of range"):
            JC.CodecConfig(block_size=bad)
    cfg = TC.CodecConfig(block_size=4096, match_depth=5)
    assert cfg.block_size == 4096 and cfg.match_depth == 5
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.block_size = 8192


def test_logging_levels_and_format():
    """The logger ``lz4_sgori_torch`` takes its level from LZ4J_LOG (in a
    fresh interpreter) and the JAX module's format; its three printers
    are the logger's own methods."""
    code = ("import importlib.util as u, sys; "
            "s = u.spec_from_file_location('L', sys.argv[1]); "
            "L = u.module_from_spec(s); s.loader.exec_module(L); "
            "print(L.log.name, L.log.level); L.pr_debug('dbg'); "
            "L.pr_info('inf'); L.pr_err('bad')")
    env = dict(os.environ, LZ4J_LOG="debug")
    res = subprocess.run([sys.executable, "-c", code, TL.__file__], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["lz4_sgori_torch", "10"]
    assert res.stderr.splitlines() == ["lz4j D dbg", "lz4j I inf",
                                       "lz4j E bad"]
    assert TL.log.name == "lz4_sgori_torch"
    assert TL.pr_err == TL.log.error and TL.pr_debug == TL.log.debug
    assert TL.pr_info == TL.log.info


def test_profile_trace(tmp_path):
    """profile_trace(None) and ("") do nothing; profile_trace(dir) writes
    a Chrome trace of the scope under dir."""
    for off in (None, ""):
        with TL.profile_trace(off):
            x = torch.arange(10).sum()
    assert int(x) == 45
    d = tmp_path / "prof"
    with TL.profile_trace(str(d)):
        x = torch.arange(1000).cumsum(0)
    files = list(d.iterdir())
    assert [f.name for f in files] == ["trace.json"]
    assert files[0].stat().st_size > 0

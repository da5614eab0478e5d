"""K1's plain version (the port's decoder on CPU tensors, also K5's and
K6's) against golden.decompress, the JAX portable decoder and the JAX
v6, v7 and v8 kernels in interpret mode. Outputs are bytes, so every
comparison is exact."""

import numpy as np
import pytest
import torch

from chip_smoke import make_mutants
from lz4_sgori_torch.ops.decode import decompress_blocks_device
from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from lz4_sgori_tpu.utils import oracle


def _pack(payloads, width=None):
    width = width or -(-(max(len(c) for c in payloads) + 8) // 32) * 32
    comp = np.zeros((len(payloads), width), np.uint8)
    clen = np.zeros(len(payloads), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    return comp, clen


def _decode(comp, clen, out_size):
    out, out_len, err = K1.decompress_blocks_v7(
        torch.from_numpy(comp), torch.from_numpy(clen), out_size)
    return out.numpy(), out_len.numpy(), err.numpy()


def _golden_verdicts(payloads, out_size):
    res = []
    for c in payloads:
        try:
            res.append(golden.decompress(bytes(c), out_size))
        except golden.DecodeError:
            res.append(None)
    return res


def _check_against_golden(payloads, out_size):
    comp, clen = _pack(payloads)
    out, out_len, err = _decode(comp, clen, out_size)
    for j, want in enumerate(_golden_verdicts(payloads, out_size)):
        assert bool(err[j]) == (want is None), j
        if want is None:
            assert out_len[j] == 0 and not out[j].any(), j
        else:
            assert out_len[j] == len(want), j
            assert out[j, :len(want)].tobytes() == want, j
            assert not out[j, len(want):].any(), j
    return comp, clen, out, out_len, err


@pytest.mark.parametrize("block_size", [4096, 65536])
def test_plain_roundtrip_fixtures(fixtures, block_size):
    payloads = []
    for data in fixtures.values():
        for i in range(0, max(len(data), 1), block_size):
            rb = data[i:i + block_size]
            payloads.append(golden.compress(rb))
            if oracle.available() and rb:
                payloads.append(oracle.compress(rb))
    _check_against_golden(payloads, block_size)


MALFORMED = [
    b"\xf0" + b"A" * 10,
    golden.compress(b"x" * 1640),
    b"\x10A\x00\x00",                 # offset zero
    b"\x10A\x50\x00",                 # offset beyond output
    b"\x1f",
    b"\x12AB\x01\x00" + b"\xff" * 6,
    golden.compress(bytes(range(256)) * 8),   # past capacity
    b"\x0fABCDEFGHIJKLMNO",           # literal-only terminal
    b"\xff",                          # truncated LSIC literal length
    b"\x10",                          # literal run exceeds input
    b"\x04abcd\x00\x00\x00",          # zero offset
    b"\x04abcd\xff\xff\x00",          # offset outside output
    b"\x14a\x00",                     # match but offset truncated
    b"\x00",                          # empty terminal block
]


def test_plain_malformed_cases():
    _check_against_golden(MALFORMED, 2048)


def test_plain_overlap_periods():
    datas = [(bytes(range(97, 97 + p)) * (3000 // p + 1))[:3000]
             for p in range(1, 10)]
    _check_against_golden([golden.compress(d) for d in datas], 4096)


def test_plain_empty_and_bad_lengths():
    comp = np.zeros((3, 64), np.uint8)
    clen = np.array([0, 1, 65], np.int32)         # empty, b"\x00", > slot
    out, out_len, err = _decode(comp, clen, 4096)
    assert err.tolist() == [True, False, True]
    assert out_len.tolist() == [0, 0, 0]


def test_plain_mutant_pool_matches_golden_and_jax(fixtures):
    """A seeded pool of corrupted streams: err must equal golden's verdict
    and the JAX portable decoder's, and bytes must agree on accepts."""
    from lz4_sgori_tpu.ops.decode import _decompress_blocks_impl

    bs = 4096
    bases = [golden.compress(fixtures[k][:bs]) for k in
             ("text_small", "zeros_4k", "random_4k", "rle_period3",
              "structured")]
    rng = np.random.default_rng(2024)
    slot = F.compress_bound(bs) + 8
    muts = make_mutants(bases, rng, 160, slot - 8)
    comp, clen, out, out_len, err = _check_against_golden(muts, bs)
    jout, jlen, jerr = map(np.asarray, _decompress_blocks_impl(
        comp, clen, bs))
    assert np.array_equal(err, jerr)
    ok = ~err
    assert np.array_equal(out_len[ok], jlen[ok])
    assert np.array_equal(out[ok], jout[ok])
    assert 0 < int(err.sum()) < len(muts)


def test_plain_matches_jax_portable_decoder(fixtures):
    from lz4_sgori_tpu.ops.decode import _decompress_blocks_impl

    bs = 16384
    data = fixtures["mixed"]
    payloads = [golden.compress(data[i:i + bs])
                for i in range(0, len(data), bs)] + MALFORMED
    comp, clen = _pack(payloads, F.compress_bound(bs) + 8)
    out, out_len, err = _decode(comp, clen, bs)
    jout, jlen, jerr = map(np.asarray, _decompress_blocks_impl(
        comp, clen, bs))
    assert np.array_equal(err, jerr)
    ok = ~err
    assert np.array_equal(out_len[ok], jlen[ok])
    assert np.array_equal(out[ok], jout[ok])


def test_plain_matches_jax_v7_interpret():
    """The test_v7_parity shape through the JAX v7 kernel (interpret mode)
    and the port's decoder."""
    from lz4_sgori_tpu.ops.pallas.lockstep_v7 import (
        decompress_blocks_lockstep_v7)
    rng = np.random.RandomState(3)
    out_size = 4096
    period = bytes(rng.randint(0, 256, 1500, np.int64).astype(np.uint8))
    blocks = [
        bytes(out_size),
        (b"the quick brown fox " * 300)[:out_size],
        bytes(rng.randint(0, 256, out_size, np.int64).astype(np.uint8)),
        (period * 4)[:out_size],
        b"ab" * (out_size // 2),
        (b"A" * 300 + b"\xff" * 300) * 6,
        b"z" * 2037,
        b"",
    ]
    comp, clen = _pack([golden.compress(b) for b in blocks])
    jout, jlen, jerr = map(np.asarray, decompress_blocks_lockstep_v7(
        comp, clen, out_size, sr=512, unroll=3, transfers=1,
        interpret=True, sort=True))
    out, out_len, err = _decode(comp, clen, out_size)
    assert not err.any() and not jerr.any()
    assert np.array_equal(out_len, jlen)
    for j, b in enumerate(blocks):
        assert out[j, :len(b)].tobytes() == b == jout[j, :len(b)].tobytes()


def test_device_wrapper_routes_v7_and_counts_nothing_on_cpu():
    before = K1.launches
    comp, clen = _pack([golden.compress(b"hello hello hello hello")])
    out, out_len, err = decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), 16384,
        cost_key=torch.zeros(1, dtype=torch.int32))
    assert not bool(err[0]) and int(out_len[0]) == 23
    assert K1.launches == before          # CPU tensors run the plain version


def test_wrapper_rejects_bad_inputs():
    comp = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        K1.decompress_blocks_v7(comp.to(torch.int32),
                                torch.ones(2, dtype=torch.int32), 4096)
    with pytest.raises(TypeError):
        K1.decompress_blocks_v7(comp, torch.ones(3, dtype=torch.int32), 4096)
    with pytest.raises(ValueError):
        K1.decompress_blocks_v7(comp, torch.ones(2, dtype=torch.int32), 0)


def _v6_blocks(out_size):
    rng = np.random.RandomState(5)
    period = bytes(rng.randint(0, 256, 700, np.int64).astype(np.uint8))
    return [
        bytes(out_size),
        (b"the quick brown fox " * 200)[:out_size],
        bytes(rng.randint(0, 256, out_size, np.int64).astype(np.uint8)),
        (period * 4)[:out_size],
        b"ab" * (out_size // 2),
        bytes(range(256)) * (out_size // 256),
        b"z" * 37,
        b"",
    ]


def test_v6_route_matches_jax_v6_interpret():
    """test_v6_parity_ring_and_far's blocks through the port's v6 route
    (K5's plain version on CPU tensors) and the JAX v6 kernel in
    interpret mode: out, out_len and err are equal."""
    from lz4_sgori_tpu.ops.pallas.lockstep_v6 import (
        decompress_blocks_lockstep_v6)
    out_size = 2048
    blocks = _v6_blocks(out_size)
    comp, clen = _pack([golden.compress(b) for b in blocks])
    jout, jlen, jerr = map(np.asarray, decompress_blocks_lockstep_v6(
        comp, clen, out_size, sr=64, interpret=True))
    out, out_len, err = (t.numpy() for t in decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), out_size))
    assert not err.any() and np.array_equal(err, jerr)
    assert np.array_equal(out_len, jlen)
    assert np.array_equal(out, jout)
    for j, b in enumerate(blocks):
        assert out[j, :len(b)].tobytes() == b


def test_v6_route_malformed_matches_jax_v6_interpret():
    """test_v6_malformed's streams and the port's malformed table at
    out_size 64: err equals the JAX v6 kernel's and golden's verdict."""
    from lz4_sgori_tpu.ops.pallas.lockstep_v6 import (
        decompress_blocks_lockstep_v6)
    cases = [b"\xf0" + b"A" * 10, b"\x10A\x00\x00", b"\x10A\x50\x00",
             b"\x1f", b"\x12AB\x01\x00" + b"\xff" * 6,
             golden.compress(b"x" * 64)] + [m for m in MALFORMED
                                             if len(m) <= 56]
    comp, clen = _pack(cases, 64)
    jout, jlen, jerr = map(np.asarray, decompress_blocks_lockstep_v6(
        comp, clen, 64, sr=64, interpret=True))
    out, out_len, err = (t.numpy() for t in decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), 64))
    assert np.array_equal(err, jerr)
    for j, want in enumerate(_golden_verdicts(cases, 64)):
        assert bool(err[j]) == (want is None), j
        if want is not None:
            assert out_len[j] == jlen[j] == len(want), j
            assert out[j, :len(want)].tobytes() == want, j
    assert 0 < int(err.sum()) < len(cases)


@pytest.mark.parametrize("out_size,engine", [
    (4096, "v6"), (8192, "v6"), (65536, "v7"), (196 * 1024, "v6"),
    (512 * 1024, "v8")])
def test_device_wrapper_routes_by_band(monkeypatch, out_size, engine):
    """Blocks under 16 KiB and in 132-256 KiB go to K5, 16-128 KiB to K1,
    above 256 KiB to K6; CPU tensors launch none of the kernels."""
    from lz4_sgori_torch.ops import decode as D
    from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
    from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
    called = []

    def spy(name, fn):
        def run(*args):
            called.append(name)
            return fn(*args)
        return run

    for name, fn in list(D._ENGINES.items()):
        monkeypatch.setitem(D._ENGINES, name, spy(name, fn))
    data = (b"hello block device " * (out_size // 19 + 1))[:out_size - 3]
    comp, clen = _pack([golden.compress(data)])
    before = (K1.launches, K5.launches, K6.launches)
    out, out_len, err = decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), out_size)
    assert called == [engine]
    assert not bool(err[0]) and out[0, :len(data)].numpy().tobytes() == data
    assert (K1.launches, K5.launches, K6.launches) == before


def test_k5_plain_mutants_match_golden(fixtures):
    """A seeded pool of corrupted 4 KiB streams through K5 (the v6 route's
    kernel wrapper): err equals golden's verdict, bytes agree on
    accepts."""
    from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
    bs = 4096
    bases = [golden.compress(fixtures[k][:bs]) for k in
             ("text_small", "zeros_4k", "random_4k", "structured")]
    muts = make_mutants(bases, np.random.default_rng(606), 96,
                        F.compress_bound(bs))
    comp, clen = _pack(muts, F.compress_bound(bs) + 8)
    out, out_len, err = (t.numpy() for t in K5.decompress_blocks_v6(
        torch.from_numpy(comp), torch.from_numpy(clen), bs))
    for j, want in enumerate(_golden_verdicts(muts, bs)):
        assert bool(err[j]) == (want is None), j
        if want is not None:
            assert out[j, :out_len[j]].tobytes() == want, j
    assert 0 < int(err.sum()) < len(muts)


def _v8_parity_blocks(out_size):
    rng = np.random.RandomState(11)
    period = bytes(rng.randint(0, 256, 1500, np.int64).astype(np.uint8))
    return [
        bytes(out_size),
        (b"the quick brown fox " * 300)[:out_size],
        bytes(rng.randint(0, 256, out_size, np.int64).astype(np.uint8)),
        (period * 4)[:out_size],
        b"ab" * (out_size // 2),
        bytes(range(256)) * (out_size // 256),
        b"z" * 2037,
        b"",
    ]


@pytest.mark.parametrize("sort", [False, True])
def test_v8_route_matches_jax_v8_interpret(sort):
    """test_v8_parity's blocks through the port's forced v8 route (K6's
    plain version on CPU tensors) and the JAX v8 kernel in interpret
    mode: err, out_len and the bytes up to out_len are equal. Past out_len
    the JAX rows keep the kernel's copy slack (11 bytes after the
    2,037-byte block); the port's rows are zero there, as K1's contract
    says."""
    from lz4_sgori_tpu.ops.pallas.lockstep_v8 import (
        decompress_blocks_lockstep_v8)
    out_size = 4096
    blocks = _v8_parity_blocks(out_size)
    comp, clen = _pack([golden.compress(b) for b in blocks])
    jout, jlen, jerr = map(np.asarray, decompress_blocks_lockstep_v8(
        comp, clen, out_size, sr=512, unroll=2, transfers=1,
        interpret=True, sort=sort))
    out, out_len, err = (t.numpy() for t in decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), out_size,
        impl="lockstep_v8"))
    assert not err.any() and np.array_equal(err, jerr)
    assert np.array_equal(out_len, jlen)
    for j, b in enumerate(blocks):
        assert out[j, :len(b)].tobytes() == b == jout[j, :len(b)].tobytes()
        assert not out[j, len(b):].any(), j


def test_v8_route_malformed_matches_jax_v8_interpret():
    """test_v8_malformed's streams through the forced v8 route and the JAX
    v8 kernel: err equals the JAX kernel's and golden's verdict, and the
    bytes agree where a stream decodes."""
    from lz4_sgori_tpu.ops.pallas.lockstep_v8 import (
        decompress_blocks_lockstep_v8)
    out_size = 2048
    cases = [b"\xf0" + b"A" * 10, golden.compress(b"x" * 1640),
             b"\x10A\x00\x00", b"\x10A\x50\x00", b"\x1f",
             b"\x12AB\x01\x00" + b"\xff" * 6,
             golden.compress(bytes(range(256)) * 8),
             golden.compress(b"hello world " * 100)]
    comp, clen = _pack(cases)
    jout, jlen, jerr = map(np.asarray, decompress_blocks_lockstep_v8(
        comp, clen, out_size, sr=512, unroll=2, transfers=1,
        interpret=True, sort=False))
    out, out_len, err = (t.numpy() for t in decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), out_size,
        impl="lockstep_v8"))
    assert np.array_equal(err, jerr) and np.array_equal(out_len, jlen)
    for j, want in enumerate(_golden_verdicts(cases, out_size)):
        assert bool(err[j]) == (want is None), j
        if want is not None:
            assert out[j, :len(want)].tobytes() == want, j
            assert jout[j, :len(want)].tobytes() == want, j
    assert 0 < int(err.sum()) < len(cases)


def test_v8_auto_route_at_512k_matches_golden():
    """One 512 KiB block through the auto route (v8): the decode equals
    golden.decompress, and a truncated copy is an error as in golden."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
    bs = 524288
    data = _synth_corpus(bs, seed=8)
    c = golden.compress(data)
    payloads = [c, c[:-7]]
    comp, clen = _pack(payloads, F.compress_bound(bs) + 8)
    before = K6.launches
    out, out_len, err = (t.numpy() for t in decompress_blocks_device(
        torch.from_numpy(comp), torch.from_numpy(clen), bs))
    assert K6.launches == before          # CPU tensors run the plain version
    verdicts = _golden_verdicts(payloads, bs)
    assert verdicts[0] == data and verdicts[1] is None
    assert not err[0] and out_len[0] == bs and out[0].tobytes() == data
    assert err[1] and out_len[1] == 0 and not out[1].any()

"""The retired round-1 engines of the port (``lz4_sgori_torch.retired``,
T1-T3) on CPU tensors, that is their plain versions, against the JAX
engines of ``tools/retired/`` (Pallas in interpret mode), the JAX
package's golden codec and liblz4. Outputs are bytes, so every comparison
is exact: whole rows, lengths and flags, error rows included.

The JAX v9 engine takes about a minute in interpret mode, so its
comparison is in the ``slow`` lane (``-m slow``)."""

import os

import numpy as np
import pytest
import torch

from __graft_entry__ import _synth_corpus
from chip_smoke import make_mutants
from lz4_sgori_torch import format as TF
from lz4_sgori_torch.ops.kernels import _build
from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
from lz4_sgori_torch.retired import decode_kernel as T2
from lz4_sgori_torch.retired import encode_kernel as T1
from lz4_sgori_torch.retired import lockstep_v9 as T3
from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from lz4_sgori_tpu.utils import oracle
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

RETIRED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "retired")


@pytest.fixture
def jax_retired(monkeypatch):
    """The JAX engines: ``decode_kernel.py`` imports ``encode_kernel`` by
    its bare name, so ``tools/retired`` goes on the path."""
    monkeypatch.syspath_prepend(RETIRED)
    import decode_kernel
    import encode_kernel
    return encode_kernel, decode_kernel


def _rows(bs: int, seed: int):
    """Full rows of a mixed corpus, an all-zero and a random row, then
    short rows (raw_len 0, 1, 12, 13, 100) with random bytes past
    raw_len."""
    rng = np.random.default_rng(seed)
    data = _synth_corpus(6 * bs, seed=seed)
    rows = [data[i * bs:(i + 1) * bs] for i in range(6)]
    rows += [bytes(bs), rng.integers(0, 256, bs, dtype=np.uint8).tobytes()]
    lens = [bs] * len(rows) + [0, 1, 12, 13, 100]
    rows += [rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
             for _ in range(5)]
    return (np.stack([np.frombuffer(r, np.uint8) for r in rows]),
            np.array(lens, np.int32))


def _pack(payloads, slot: int):
    comp = np.zeros((len(payloads), slot), np.uint8)
    clen = np.zeros(len(payloads), np.int32)
    for j, c in enumerate(payloads):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    return comp, clen


def _numpy(res):
    return tuple(t.numpy() for t in res)


# ---- T1: the greedy encoder ----

@pytest.mark.parametrize("bs,acc", [(4096, 1), (4096, 4), (65536, 1),
                                    (65536, 4)])
def test_t1_equals_the_jax_engine(jax_retired, bs, acc):
    """Byte for byte, lengths and zero tails, against
    ``compress_blocks_pallas`` in interpret mode; at 4 KiB the short rows
    carry random bytes past raw_len, which neither engine reads."""
    enc, _ = jax_retired
    if bs == 4096:
        raw, rlen = _rows(bs, seed=3)
    else:
        raw = np.frombuffer(_synth_corpus(bs, seed=4), np.uint8)[None].copy()
        rlen = np.array([bs], np.int32)
    jc, jl = map(np.asarray, enc.compress_blocks_pallas(
        raw, rlen, bs, interpret=True, acceleration=acc))
    pc, pl = _numpy(T1.compress_blocks_retired(
        torch.from_numpy(raw), torch.from_numpy(rlen), bs, acc))
    assert pc.shape == (raw.shape[0], F.compress_bound(bs))
    assert np.array_equal(pl, jl)
    assert np.array_equal(pc, jc)
    for j in range(raw.shape[0]):
        assert pc[j, :pl[j]].tobytes() == golden.compress(
            raw[j, :rlen[j]].tobytes(), acc), j


@pytest.mark.parametrize("acc", [1, 8])
def test_t1_equals_golden_and_liblz4(acc):
    """Over a spread of inputs cut to 4 KiB and 64 KiB blocks, each row
    is the JAX package's golden.compress and, where liblz4 is present,
    LZ4_compress_fast's bytes."""
    rng = np.random.default_rng(11)
    srcs = [_synth_corpus(70000, seed=12), rng.integers(0, 4, 70000,
                                                        dtype=np.uint8)
            .tobytes(), b"motif-11 " * 8000, bytes(70000)]
    for bs in (4096, 65536):
        blocks = [s[i:i + bs] for s in srcs for i in (0, len(s) - 5000)]
        raw, rlen = _pack(blocks, bs)
        pc, pl = _numpy(T1.compress_blocks_retired(
            torch.from_numpy(raw), torch.from_numpy(rlen), bs, acc))
        for j, b in enumerate(blocks):
            got = pc[j, :pl[j]].tobytes()
            assert got == golden.compress(b, acc), (bs, j)
            if oracle.available():
                assert got == oracle.compress_fast(b, acc), (bs, j)
            assert golden.decompress(got, bs) == b
            assert not pc[j, pl[j]:].any()


# ---- T2: the scalar decoder ----

def _t2_payloads(rng):
    """Valid 4 KiB streams, make_mutants' mutants, rows with random
    bytes past comp_len, comp_len 0, and LSIC runs read past comp_len."""
    raw, rlen = _rows(4096, seed=21)
    bases = [golden.compress(raw[j, :rlen[j]].tobytes())
             for j in range(raw.shape[0])]
    slot = F.compress_bound(4096) + 8
    payloads = bases + make_mutants(bases, rng, 200, slot - 8) + [
        b"\xf0", b"\xf0\xff", b"\x1f" + bases[0][1:3] + b"\x05\x00\x0f",
        bases[2][:-1] + b"\xf0"]
    comp, clen = _pack(payloads, slot)
    for j in range(0, len(payloads), 3):
        comp[j, clen[j]:] = rng.integers(0, 256, slot - clen[j],
                                         dtype=np.uint8)
    clen[len(bases) + 1] = 0
    return payloads, comp, clen


def test_t2_equals_the_jax_engine_on_mutants(jax_retired):
    """The whole (out, out_len, err) of ``decompress_blocks_pallas`` in
    interpret mode, error rows (and the bytes they keep) included; err
    and out_len are golden.decompress's."""
    _, dec = jax_retired
    rng = np.random.default_rng(22)
    payloads, comp, clen = _t2_payloads(rng)
    jo, jl, je = map(np.asarray, dec.decompress_blocks_pallas(
        comp, clen, 4096, interpret=True))
    po, pl, pe = _numpy(T2.decompress_blocks_retired(
        torch.from_numpy(comp), torch.from_numpy(clen), 4096))
    assert np.array_equal(pe, je) and np.array_equal(pl, jl)
    assert np.array_equal(po, jo)
    kept = int(po[pe].any(axis=1).sum())
    assert pe.sum() > 100 and kept > 50       # error rows keep bytes
    for j in range(len(payloads)):
        try:
            want = golden.decompress(comp[j, :clen[j]].tobytes(), 4096)
        except golden.DecodeError:
            want = None
        assert bool(pe[j]) == (want is None), j
        if want is not None:
            assert pl[j] == len(want) and po[j, :pl[j]].tobytes() == want


def test_t2_equals_the_jax_engine_at_64k(jax_retired):
    _, dec = jax_retired
    blocks = [_synth_corpus(65536, seed=s) for s in (31, 32)] + [
        bytes(65536)]
    streams = [golden.compress(b) for b in blocks]
    comp, clen = _pack(streams + [streams[0][:-1]],
                       F.compress_bound(65536) + 8)
    jo, jl, je = map(np.asarray, dec.decompress_blocks_pallas(
        comp, clen, 65536, interpret=True))
    po, pl, pe = _numpy(T2.decompress_blocks_retired(
        torch.from_numpy(comp), torch.from_numpy(clen), 65536))
    assert np.array_equal(pe, je) and np.array_equal(pl, jl)
    assert np.array_equal(po, jo)
    for j, b in enumerate(blocks):
        assert not pe[j] and po[j].tobytes() == b
    with pytest.raises(golden.DecodeError):
        golden.decompress(comp[3, :clen[3]].tobytes(), 65536)
    assert pe[3] and po[3].any()


def test_t2_keeps_the_bytes_before_the_fault():
    """The retired contract, pinned without JAX: a literal run that
    overruns its input is copied clipped, an LSIC run read past comp_len
    puts the 4 bytes at ip at op, and K1 zeroes both rows."""
    rows = [b"\x50abc", b"\xf0ABCDEFG", b"\x40abcd\x07\x00"]
    lens = [4, 1, 7]
    comp, _ = _pack(rows, 16)
    clen = np.array(lens, np.int32)
    out, out_len, err = _numpy(T2.decompress_blocks_retired(
        torch.from_numpy(comp), torch.from_numpy(clen), 1024))
    assert err.tolist() == [True, True, True]
    assert out_len.tolist() == [0, 0, 0]
    assert out[0, :4].tobytes() == b"abc\x00"      # clipped literals
    assert out[1, :5].tobytes() == b"BCDE\x00"     # LSIC past comp_len
    assert out[2, :5].tobytes() == b"abcd\x00"     # bad offset: no match
    assert not out[:, 5:].any()
    k1 = _numpy(K1.decompress_blocks_v7(torch.from_numpy(comp),
                                        torch.from_numpy(clen), 1024))
    assert np.array_equal(k1[2], err) and not k1[0].any()


# ---- T3: the chained decoder ----

def _t3_batch(rng, nb: int):
    data = _synth_corpus(nb * 4096, seed=41)
    bases = [golden.compress(data[i * 4096:(i + 1) * 4096 - 97 * (i % 3)])
             for i in range(nb)]
    payloads = bases[:nb - 24] + make_mutants(bases, rng, 24,
                                              F.compress_bound(4096))
    comp, clen = _pack(payloads, F.compress_bound(4096) + 8)
    return payloads, comp, clen


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_t3_equals_golden_and_k1(chain):
    """Every block's (out, out_len, err) is K1's plain version's and
    golden.decompress's, with and without the sort and under a sort key,
    at 77 blocks (not a multiple of chain or of 128 * chain)."""
    rng = np.random.default_rng(40 + chain)
    payloads, comp, clen = _t3_batch(rng, 77)
    ct, lt = torch.from_numpy(comp), torch.from_numpy(clen)
    want = K1.decompress_blocks_plain(ct, lt, 4096)
    keys = torch.from_numpy(rng.integers(0, 1000, 77).astype(np.int32))
    for kw in (dict(), dict(sort=False), dict(sort_key=keys)):
        got = T3.decompress_blocks_lockstep_v9(ct, lt, 4096, chain=chain,
                                               **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), kw
    out, out_len, err = _numpy(want)
    for j, c in enumerate(payloads):
        try:
            g = golden.decompress(c, 4096)
        except golden.DecodeError:
            g = None
        assert bool(err[j]) == (g is None), j
        if g is not None:
            assert out[j, :out_len[j]].tobytes() == g, j


def test_t3_deal_is_the_snake_of_the_jax_engine():
    """The deal: blocks sorted by cost (stable), odd rows reversed,
    columns are chains; ``inv`` undoes it; pads are the largest ids."""
    clen = torch.tensor([5, 9, 9, 1, 7, 3, 8], dtype=torch.int32)
    flat, inv = T3.deal(clen, 3)
    # costs 9, 9, 8, 7, 5, 3, 1, then the two pads (cost 1)
    order = [1, 2, 6, 4, 0, 5, 3, 7, 8]
    mat = np.array(order).reshape(3, 3)
    mat[1] = mat[1, ::-1]
    assert flat.tolist() == mat.T.reshape(-1).tolist()
    assert torch.equal(flat[inv], torch.arange(9))
    flat, _ = T3.deal(clen, 3, sort=False)
    assert sorted(flat.tolist()) == list(range(9))
    flat, _ = T3.deal(clen, 2, sort_key=torch.tensor([0, 0, 0, 0, 0, 0, 9]))
    assert flat[0] == 6


def test_t3_refuses_what_the_jax_engine_refuses(monkeypatch):
    """out_size must be a multiple of max(HSPAN, 4 * FBAND) = 1024."""
    monkeypatch.syspath_prepend(RETIRED)
    import lockstep_v9 as J
    from lz4_sgori_tpu.ops.pallas.lockstep_v6 import FBAND
    from lz4_sgori_tpu.ops.pallas.lockstep_v7 import HSPAN
    assert TF.V9_OUT_ALIGN == max(HSPAN, 4 * FBAND)
    comp, clen = _pack([golden.compress(b"x" * 900)], 64)
    with pytest.raises(AssertionError):
        J.decompress_blocks_lockstep_v9(comp, clen, 1000, chain=2,
                                        interpret=True)
    with pytest.raises(ValueError, match="aligned"):
        T3.decompress_blocks_lockstep_v9(torch.from_numpy(comp),
                                         torch.from_numpy(clen), 1000)
    out, out_len, err = _numpy(T3.decompress_blocks_lockstep_v9(
        torch.from_numpy(comp), torch.from_numpy(clen), 1024, chain=2))
    assert not err[0] and out[0, :out_len[0]].tobytes() == b"x" * 900


@pytest.mark.slow
def test_t3_equals_the_jax_engine(monkeypatch):
    """``decompress_blocks_lockstep_v9`` in interpret mode (about a
    minute) on 8 blocks of 4 KiB at chain 2: the same out_len and err,
    and the same bytes up to each block's out_len (the JAX engine leaves
    the rest unspecified)."""
    monkeypatch.syspath_prepend(RETIRED)
    import lockstep_v9 as J
    rng = np.random.default_rng(50)
    _, comp, clen = _t3_batch(rng, 30)
    comp, clen = comp[2:10], clen[2:10]       # valid blocks and mutants
    jo, jl, je = map(np.asarray, J.decompress_blocks_lockstep_v9(
        comp, clen, 4096, chain=2, interpret=True))
    po, pl, pe = _numpy(T3.decompress_blocks_lockstep_v9(
        torch.from_numpy(comp), torch.from_numpy(clen), 4096, chain=2))
    assert np.array_equal(pe, je) and np.array_equal(pl, jl)
    for j in range(8):
        assert np.array_equal(po[j, :pl[j]], jo[j, :jl[j]]), j


# ---- the wrappers ----

def _calls():
    raw, rlen = _rows(4096, seed=61)
    raw, rlen = torch.from_numpy(raw), torch.from_numpy(rlen)
    comp, clen = _pack([golden.compress(b"abc" * 500)] * 3,
                       F.compress_bound(4096) + 8)
    comp, clen = torch.from_numpy(comp), torch.from_numpy(clen)
    return {
        "T1": (T1, lambda f: T1.compress_blocks_retired(f(raw), f(rlen),
                                                        4096)),
        "T2": (T2, lambda f: T2.decompress_blocks_retired(f(comp), f(clen),
                                                          4096)),
        "T3": (T3, lambda f: T3.decompress_blocks_lockstep_v9(
            f(comp), f(clen), 4096, chain=2)),
    }


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to send a wrapper down
    its kernel branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("name", ["T1", "T2", "T3"])
def test_cpu_tensor_runs_the_plain_version(name):
    mod, call = _calls()[name]
    mod.launches = 0
    res = call(lambda t: t)
    assert all(t.device.type == "cpu" for t in res)
    assert mod.launches == 0


@pytest.mark.parametrize("name", ["T1", "T2", "T3"])
def test_failed_build_raises_and_never_falls_back(monkeypatch, name):
    """On a CUDA tensor the wrapper builds its kernel; when the build
    fails it raises, and no plain result comes back."""
    mod, call = _calls()[name]

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "load", no_nvcc)
    mod.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        call(lambda t: t.as_subclass(_OnCuda))
    assert mod.launches == 0


def test_argument_checks():
    raw = torch.zeros((2, 4096), dtype=torch.uint8)
    rlen = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_size"):
        T1.compress_blocks_retired(torch.zeros((1, 131072), dtype=torch.uint8),
                                   torch.zeros(1, dtype=torch.int32), 131072)
    with pytest.raises(TypeError):
        T1.compress_blocks_retired(raw.to(torch.int32), rlen, 4096)
    with pytest.raises(TypeError):
        T1.compress_blocks_retired(raw, rlen, 8192)            # shape
    with pytest.raises(TypeError):
        T1.compress_blocks_retired(raw, rlen.to(torch.int64), 4096)
    with pytest.raises(ValueError, match="out_size"):
        T2.decompress_blocks_retired(raw, rlen, 131072)
    with pytest.raises(TypeError):
        T2.decompress_blocks_retired(raw[0], rlen, 4096)
    with pytest.raises(ValueError, match="chain"):
        T3.decompress_blocks_lockstep_v9(raw, rlen, 4096, chain=0)
    with pytest.raises(TypeError, match="sort_key"):
        T3.decompress_blocks_lockstep_v9(raw, rlen, 4096,
                                         sort_key=torch.zeros(3))
    # raw_len outside [0, block_size] is clamped, as the kernel clamps it
    c, n = T1.compress_blocks_retired(
        raw, torch.tensor([-5, 9999], dtype=torch.int32), 4096)
    assert n.tolist() == [1, len(golden.compress(bytes(4096)))]

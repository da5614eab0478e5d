"""K5's decode (``csrc/decode_v6.cu``) emulated on the CPU in its
geometries (``csrc/lz4_decode_ring.cuh``): up to 16 KiB the small whole
block (``ring::SmallGeom<L>``: the block in a region of 2^L bytes, the
stream in 4 stages of 2^(L-1) bytes, all issued at the start), K1's 64
KiB whole block up to 64 KiB, K6's 128 KiB history ring above. Held
against ``decompress_blocks_plain`` (out, out_len, err) on
``chip_smoke.crafted_streams`` at 4, 8 and 12 KiB (LSIC runs over the
small geometry's stage bounds) and 256 KiB: the mixed stream, each error
of the safe decoder near the end of a long stream, a stream of exactly
``slot`` bytes, the empty input, a ``clen`` past ``slot`` and a negative
one; rows at every 16-byte alignment; mutants of corpus blocks at 4
KiB; and on a few streams against the JAX package's ``golden.decompress``.
The emulation is ``test_torch_ring_decode``'s (stage and output memory
that holds garbage until written)."""

import numpy as np
import pytest
import torch

from chip_smoke import crafted_streams, k5_stage, make_mutants
from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
from lz4_sgori_torch.ops.kernels.lockstep_v7 import decompress_blocks_plain
from lz4_sgori_tpu import golden
from test_torch_ring_decode import (RING, WHOLE, WHOLE_GEOM, _OnCuda, _rows,
                                    emulate, small)
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

SMALL = (4096, 8192, 12288)
SMALL_MAX = 16384   # ring::kSmallMax


def k5_geom(out_size: int):
    """decode_v6.cu's dispatch: ``SmallGeom<L>`` up to 16 KiB (2^L the
    least power of two at least out_size, L at least 12), K1's whole
    block up to 64 KiB, K6's ring above."""
    if out_size <= SMALL_MAX:
        return small(max(12, (out_size - 1).bit_length()))
    return WHOLE_GEOM if out_size <= WHOLE else RING


def k5_emulate(comp, clen, out_size, **kw):
    return emulate(comp, clen, out_size, geom=k5_geom(out_size), **kw)


def k5_streams(out_size: int):
    return crafted_streams(out_size, stage=k5_stage(out_size))


@pytest.fixture(scope="module")
def streams():
    return {n: k5_streams(n) for n in SMALL + (262144,)}


def _same(got, want):
    for name, a, b in zip(("out", "out_len", "err"), got, want):
        assert torch.equal(a, b), name


def test_small_geometries_hold_a_block():
    """Each small geometry's region holds its blocks at every row
    alignment (no output byte overwrites another), and its stream ring
    holds a whole block's slot and head, so a stream is never refilled;
    ``chip_smoke.k5_stage`` gives its stage."""
    for n in (100, 4097, 5000) + SMALL + (SMALL_MAX, 65536, 262144):
        assert k5_stage(n) == 1 << k5_geom(n).stage_log, n
    for n in SMALL + (SMALL_MAX,):
        g = k5_geom(n)
        size = 1 << g.out_log
        assert n <= size and g.stage_log >= 8       # a window in a stage
        o = np.arange(n)
        for head in range(16):
            assert len(np.unique((head + o) & (size - 1))) == n
        slot = F.compress_bound(n) + 8
        assert (15 + slot + 15) & ~15 <= g.stages << g.stage_log


def test_crafted_streams_cross_the_small_stages(streams):
    """At 4, 8 and 12 KiB the mixed stream decodes, has a run of LSIC
    bytes over a stage bound of its geometry, and every error stream
    fails; one stream is exactly ``slot`` long."""
    for n in SMALL:
        stage = 1 << k5_geom(n).stage_log
        named = streams[n]
        slot = F.compress_bound(n) + 8
        comp, clen = _rows(named, slot)
        _, out_len, err = decompress_blocks_plain(comp, clen, n)
        assert not bool(err[0]) and bool(err[1:].all()), n
        mixed = named[0][1]
        bounds = range(stage, len(mixed), stage)
        assert any(mixed[b - 1] == mixed[b] == 255 for b in bounds), n
        assert len(dict(named)["clen == slot"]) == slot


@pytest.mark.parametrize("out_size", SMALL)
@pytest.mark.parametrize("part", [0, 1])
def test_k5_emulation_matches_plain(streams, out_size, part):
    """Half the crafted streams a case, with the empty input and a clen
    past slot (part 0) or a negative clen (part 1), against the plain
    decoder; no stream is refilled."""
    slot = F.compress_bound(out_size) + 8
    named = streams[out_size][part::2]
    comp, clen = _rows(named, slot, (0, slot + 1) if part == 0 else (-5,))
    refills = []
    _same(k5_emulate(comp, clen, out_size, refills=refills),
          decompress_blocks_plain(comp, clen, out_size))
    assert not any(refills)


@pytest.mark.parametrize("out_size", [4096, 5000])
def test_k5_emulation_at_every_row_alignment(streams, out_size):
    """The mixed 4 KiB stream and a 5,000-byte block's (output rows at
    every alignment too) with the comp and output tensors 0-15 bytes
    past a 16-byte boundary."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import native
    if out_size == 4096:
        named = streams[4096][:1]
    else:
        named = [("corpus", native.compress(_synth_corpus(out_size)))]
    slot = F.compress_bound(out_size) + 8
    comp, clen = _rows(named * 2, slot)
    want = decompress_blocks_plain(comp, clen, out_size)
    assert not bool(want[2].any())
    for shift in range(16):
        _same(k5_emulate(comp, clen, out_size, seed=shift, shift=shift),
              want)


def test_k5_emulation_through_the_ring_at_256k(streams):
    """The 256 KiB band through K6's ring (``decode_v6.cu`` above 64
    KiB): the mixed stream, the slot-long one and one error stream."""
    n = 262144
    slot = F.compress_bound(n) + 8
    named = [s for s in streams[n]
             if s[0] in ("mixed", "clen == slot", "offset 0")]
    comp, clen = _rows(named, slot)
    _same(k5_emulate(comp, clen, n), decompress_blocks_plain(comp, clen, n))


def test_k5_emulation_on_mutants():
    """Blocks of the synthetic corpus at 4 KiB (``native.compress``) and
    24 corruptions of them (``chip_smoke.make_mutants``) against the
    plain decoder."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import native
    data = _synth_corpus(1 << 18)
    bases = [native.compress(data[k:k + 4096])
             for k in range(0, 1 << 18, 1 << 15)]
    slot = F.compress_bound(4096) + 8
    muts = make_mutants(bases, np.random.default_rng(5), 24, slot - 8)
    comp, clen = _rows([("", s) for s in bases + muts], slot)
    want = decompress_blocks_plain(comp, clen, 4096)
    assert not bool(want[2][:len(bases)].any())
    assert 0 < int(want[2].sum()) < len(muts)
    _same(k5_emulate(comp, clen, 4096), want)


@pytest.mark.parametrize("out_size", SMALL)
def test_k5_emulation_matches_jax_golden(streams, out_size):
    """The mixed stream, one error stream and the slot-long one against
    ``lz4_sgori_tpu.golden.decompress``: err exactly when it raises, else
    its bytes, zeros after them."""
    slot = F.compress_bound(out_size) + 8
    named = [s for s in streams[out_size]
             if s[0] in ("mixed", "literals past capacity", "clen == slot")]
    comp, clen = _rows(named, slot)
    out, out_len, err = k5_emulate(comp, clen, out_size)
    for j, (name, s) in enumerate(named):
        try:
            want = golden.decompress(s, out_size)
        except golden.DecodeError:
            want = None
        assert bool(err[j]) == (want is None), name
        if want is not None:
            assert int(out_len[j]) == len(want), name
            assert out[j, :len(want)].numpy().tobytes() == want, name
        assert not out[j, int(out_len[j]):].any(), name


def test_k5_wrapper_runs_the_plain_version_on_the_cpu(streams):
    """K5's wrapper on CPU tensors is the plain decoder, and counts no
    launch."""
    slot = F.compress_bound(4096) + 8
    comp, clen = _rows(streams[4096][:3], slot)
    K5.launches = 0
    _same(K5.decompress_blocks_v6(comp, clen, 4096),
          decompress_blocks_plain(comp, clen, 4096))
    assert K5.launches == 0


def test_k5_failed_build_raises_and_never_falls_back(monkeypatch, streams):
    """A CUDA tensor whose kernel cannot be built raises; the wrapper
    neither runs the plain decoder nor counts a launch."""
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def plain(*_a, **_k):
        raise AssertionError("the plain decoder ran for a CUDA tensor")

    slot = F.compress_bound(4096) + 8
    comp, clen = _rows(streams[4096][:1], slot)
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(K5, "decompress_blocks_plain", plain)
    K5.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        K5.decompress_blocks_v6(comp.as_subclass(_OnCuda),
                                clen.as_subclass(_OnCuda), 4096)
    assert K5.launches == 0

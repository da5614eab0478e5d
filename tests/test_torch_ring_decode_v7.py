"""K1's decode (``csrc/decode_v7.cu``) emulated on the CPU in both of its
geometries (``csrc/lz4_decode_ring.cuh``): at out_size 64 KiB and below
the whole block held in a 64 KiB region of shared memory, never flushed
during the walk, the row written from it at the end; above, K6's 128 KiB
history ring as it stands. Held against ``decompress_blocks_plain``
(out, out_len, err) on ``chip_smoke.crafted_streams`` at out_size 16,
64 and 128 KiB: the mixed stream (offsets 1-4, LSIC runs over the 8 KiB
stage boundaries, a match from the block's first byte; at 128 KiB an
offset of 65,535 and matches across the ring's wrap), each error of the
safe decoder near the end of a long stream, a stream of exactly ``slot``
bytes (every slot here is not a multiple of 16), the empty input, a
``clen`` past ``slot`` and a negative one; and on a few of the streams
against the JAX package's own ``golden.decompress``. The emulation is
``test_torch_ring_decode``'s (rows at every 16-byte alignment, stage and
output memory that holds garbage until written)."""

import numpy as np
import pytest
import torch

from chip_smoke import crafted_streams, make_mutants
from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
from lz4_sgori_torch.ops.kernels.lockstep_v7 import decompress_blocks_plain
from lz4_sgori_tpu import golden
from test_torch_ring_decode import WHOLE, _rows, emulate
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

SIZES = (16384, 65536, 131072)


def k1_emulate(comp, clen, out_size):
    """decode_v7.cu's dispatch: the whole block up to 64 KiB, else K6's
    ring."""
    return emulate(comp, clen, out_size, whole=out_size <= WHOLE)


@pytest.fixture(scope="module")
def streams():
    return {n: crafted_streams(n) for n in SIZES}


def test_crafted_streams_fit_the_v7_band(streams):
    """At each size the mixed stream decodes and fills most of the block,
    every error stream fails, and one stream is exactly ``slot`` long."""
    for n, named in streams.items():
        slot = F.compress_bound(n) + 8
        assert slot % 16 != 0
        comp, clen = _rows(named, slot)
        _, out_len, err = decompress_blocks_plain(comp, clen, n)
        names = [name for name, _ in named]
        assert names[0] == "mixed" and not bool(err[0])
        assert int(out_len[0]) > n * 7 // 8, n
        assert bool(err[1:].all()), n
        assert len(dict(named)["clen == slot"]) == slot


@pytest.mark.parametrize("out_size", SIZES)
@pytest.mark.parametrize("part", [0, 1])
def test_k1_emulation_matches_plain(streams, out_size, part):
    """Half the crafted streams a case, with the empty input and a clen
    past slot (part 0) or a negative clen (part 1)."""
    slot = F.compress_bound(out_size) + 8
    named = streams[out_size][part::2]
    comp, clen = _rows(named, slot, (0, slot + 1) if part == 0 else (-5,))
    got = k1_emulate(comp, clen, out_size)
    want = decompress_blocks_plain(comp, clen, out_size)
    for name, a, b in zip(("out", "out_len", "err"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("out_size", SIZES)
def test_k1_emulation_matches_jax_golden(streams, out_size):
    """The mixed stream, one error stream and the slot-long one against
    ``lz4_sgori_tpu.golden.decompress``: err exactly when it raises, else
    its bytes, zeros after them."""
    slot = F.compress_bound(out_size) + 8
    named = [s for s in streams[out_size]
             if s[0] in ("mixed", "offset 0", "clen == slot")]
    comp, clen = _rows(named, slot)
    out, out_len, err = k1_emulate(comp, clen, out_size)
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


def test_k1_whole_region_holds_every_byte():
    """The whole-block region's index map is one to one over a 64 KiB
    block at every row alignment: no output byte overwrites another."""
    o = np.arange(WHOLE)
    for head in range(16):
        assert len(np.unique((head + o) & (WHOLE - 1))) == WHOLE


def test_k1_wrapper_runs_the_plain_version_on_the_cpu(streams):
    """K1's wrapper on CPU tensors is the plain decoder, and counts no
    launch."""
    slot = F.compress_bound(16384) + 8
    comp, clen = _rows(streams[16384][:2], slot)
    K1.launches = 0
    got = K1.decompress_blocks_v7(comp, clen, 16384)
    want = decompress_blocks_plain(comp, clen, 16384)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K1.launches == 0


def test_k1_emulation_on_mutants():
    """Blocks of the synthetic corpus at 64 KiB (``native.compress``) and
    16 corruptions of them (``chip_smoke.make_mutants``), the whole-block
    geometry against the plain decoder."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import native
    data = _synth_corpus(1 << 20)
    bases = [native.compress(data[k:k + 65536])
             for k in range(0, 1 << 20, 1 << 19)]
    slot = F.compress_bound(65536) + 8
    muts = make_mutants(bases, np.random.default_rng(7), 16, slot - 8)
    comp, clen = _rows([("", s) for s in bases + muts], slot)
    got = k1_emulate(comp, clen, 65536)
    want = decompress_blocks_plain(comp, clen, 65536)
    assert not bool(want[2][:len(bases)].any())
    assert 0 < int(want[2].sum()) < len(muts)
    for name, a, b in zip(("out", "out_len", "err"), got, want):
        assert torch.equal(a, b), name


def test_decode_pace_edits_and_variants_apply():
    """``probes.decode_pace``'s instrumented copies and every variant's
    edits still apply to the sources."""
    import os

    from lz4_sgori_torch.ops.kernels import _build
    from lz4_sgori_torch.probes import decode_pace as D

    for f in D.PROFILE:
        with open(os.path.join(_build.CSRC, f)) as fh:
            text = fh.read()
        assert D.instrumented(f, text, D.PROFILE) != text, f
    for name, (_, edits) in D.VARIANTS.items():
        texts = D.variant_sources(name)
        for f, _, _ in edits:
            with open(os.path.join(_build.CSRC, f)) as fh:
                assert texts[f] != fh.read(), name

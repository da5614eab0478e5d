"""K4, the segment assembly (``csrc/asm_seg.cu``), emulated on the CPU
CTA for CTA and word for word, and held against
``assemble_segments_plain`` (out and out_len) and the JAX package's
``golden.assemble_seg_parts``.

The emulation keeps the kernel's memory and decisions: the output as one
flat buffer of garbage (the wrapper's ``torch.empty``) whose rows start
0-15 bytes past a 16-byte boundary; a CTA a (block, chunk), the chunk's
x range in the row's aligned run from its first word; the plan's scan
into piece offsets; the row's unaligned first and last bytes a byte at a
time; each 16-byte word zeros at or past the length, from one piece
(found by the binary search, read as the two aligned 16-byte words that
hold it) or byte by byte across pieces; bytes past ``ocap`` dropped.
The card runs the kernel itself on such plans
(``test_torch_kernels_cuda.py``: ``-k k4``)."""

import numpy as np
import pytest
import torch

from lz4_sgori_torch.ops.kernels import asm_seg as K4
from lz4_sgori_torch.ops.kernels.asm_seg import assemble_segments_plain
from test_torch_ring_decode import _OnCuda
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

CHUNK = 8192        # asm_seg::kChunk


def plan_offsets(plan_row):
    """``load_plan``: the 3 * nseg + 1 piece offsets of one block, its
    segments' totals scanned (the warps' shuffles give the same sums)."""
    lens = plan_row[:, [0, 1, 3]].reshape(-1).astype(np.int64)
    return np.concatenate([[0], np.cumsum(lens)])


def find(offs, o, np_):
    """The binary search: the last piece p with offs[p] <= o."""
    lo, hi = 0, np_
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if offs[mid] <= o:
            lo = mid
        else:
            hi = mid
    return lo


def emulate(streams, hdr, raw, plan, ocap, shift=0, chunk=CHUNK,
            stats=None):
    """The kernel's (out, out_len); rows start ``shift`` bytes past a
    16-byte boundary; ``stats`` (a dict) counts the words by path and the
    most pieces a word read."""
    streams, hdr, raw, plan = (t.numpy() for t in (streams, hdr, raw, plan))
    nb, bs = raw.shape
    nseg = plan.shape[1]
    scap, hmax = streams.shape[1], hdr.shape[1]
    rng = np.random.default_rng(shift)
    flat = rng.integers(0, 256, shift + nb * ocap + 16, dtype=np.uint8)
    out_len = np.zeros(nb, np.int32)
    st = stats if stats is not None else {}
    for k in ("zero", "one piece", "across"):
        st.setdefault(k, 0)
    st.setdefault("most pieces", 0)
    nchunks = (15 + ocap + chunk - 1) // chunk
    np_ = 3 * nseg
    for b in range(nb):
        offs = plan_offsets(plan[b])
        total = int(offs[-1])
        tails = plan[b, :, 2]

        def src(p, i):
            k, j = divmod(p, 3)
            if j == 0:
                assert 0 <= i < scap
                return int(streams[b * nseg + k, i])
            if j == 1:
                assert 0 <= i < hmax
                return int(hdr[b * nseg + k, i])
            assert 0 <= tails[k] + i < bs
            return int(raw[b, tails[k] + i])

        def byte(o, p):
            if o >= total:
                return 0, p
            while o >= offs[p + 1]:
                p += 1
            return src(p, o - int(offs[p])), p

        r0 = shift + b * ocap
        head = r0 & 15
        g = r0 - head                          # x is flat[g + x]
        for c in range(nchunks):               # the CTAs of row b
            x0, x1 = max(c * chunk, head), min((c + 1) * chunk, head + ocap)
            if x0 >= x1:
                continue
            if c == 0:
                out_len[b] = total
            v0 = min((x0 + 15) & ~15, x1)
            v1 = max(x1 & ~15, v0)
            for x in list(range(x0, v0)) + list(range(v1, x1)):
                o = x - head
                p = find(offs, o, np_) if o < total else 0
                flat[g + x], _ = byte(o, p)
            for x in range(v0, v1, 16):
                assert (g + x) % 16 == 0
                o = x - head
                if o >= total:
                    st["zero"] += 1
                    w = [0] * 16
                else:
                    p = find(offs, o, np_)
                    if o + 16 <= offs[p + 1]:
                        st["one piece"] += 1
                        w = [src(p, o - int(offs[p]) + i) for i in range(16)]
                    else:
                        st["across"] += 1
                        w, p0 = [], p
                        for i in range(16):
                            v, p = byte(o + i, p)
                            w.append(v)
                        st["most pieces"] = max(st["most pieces"],
                                                p - p0 + 1)
                flat[g + x:g + x + 16] = w
    out = flat[shift:shift + nb * ocap].reshape(nb, ocap).copy()
    return torch.from_numpy(out), torch.from_numpy(out_len)


def random_case(seed, nb, nseg, scap, hmax, bs, zero=0.2):
    """Random sources and a plan: lengths up to each source's size, a
    share of them 0 (empty pieces), tails inside the raw row."""
    rng = np.random.default_rng(seed)

    def lens(cap):
        v = rng.integers(0, cap + 1, (nb, nseg))
        return np.where(rng.random((nb, nseg)) < zero, 0, v)
    tl = lens(bs // 2)
    plan = np.stack([lens(scap), lens(hmax), rng.integers(0, bs - tl + 1),
                     tl], axis=2).astype(np.int32)
    return [torch.from_numpy(a) for a in (
        rng.integers(0, 256, (nb * nseg, scap), dtype=np.uint8),
        rng.integers(0, 256, (nb * nseg, hmax), dtype=np.uint8),
        rng.integers(0, 256, (nb, bs), dtype=np.uint8), plan)]


def _same(got, want):
    assert torch.equal(got[1], want[1]), "out_len"
    assert torch.equal(got[0], want[0]), "out"


@pytest.mark.parametrize("nb,nseg,scap,hmax,bs,ocap,chunk", [
    (3, 1, 300, 20, 600, 401, CHUNK),        # nseg 1
    (2, 128, 40, 6, 4096, 6001, CHUNK),      # nseg 128: words over pieces
    (2, 16, 600, 60, 4096, 40001, 1024),     # pieces across chunks
    (4, 16, 200, 30, 4096, 777, CHUNK),      # totals past ocap
    (1, 3, 9000, 40, 40000, 33001, CHUNK),   # a piece over 8 KiB chunks
])
def test_asm_emulation_matches_plain(nb, nseg, scap, hmax, bs, ocap, chunk):
    """Random plans against the plain assembly: empty pieces, words fed
    by three pieces and more, pieces across chunks (8 KiB, and 1 KiB
    chunks on small rows), totals past ``ocap``."""
    args = random_case(nb * 100 + nseg, nb, nseg, scap, hmax, bs)
    st = {}
    got = emulate(*args, ocap, shift=nb, chunk=chunk, stats=st)
    want = assemble_segments_plain(*args, ocap)
    _same(got, want)
    if ocap == 777:
        assert bool((want[1] > ocap).any())
    if nseg == 128:
        assert st["most pieces"] >= 3 and st["one piece"] > 0
    if chunk == 1024 or ocap == 33001:
        assert st["one piece"] > 0 and st["zero"] > 0


@pytest.mark.parametrize("shift", range(16))
def test_asm_emulation_at_every_row_alignment(shift):
    """Rows 0-15 bytes past a 16-byte boundary (an odd ``ocap`` moves
    each later row's head too), with pieces of length 0 among them."""
    args = random_case(shift, 3, 8, 50, 10, 512, zero=0.4)
    _same(emulate(*args, 601, shift=shift),
          assemble_segments_plain(*args, 601))


def _golden_case(blocks, seg):
    """K4's arguments from ``golden.compress_dense_seg_parts`` of each
    block (its streams, the owner headers of ``golden._lit_header``, the
    raw tails) and ``golden.assemble_seg_parts``'s bytes."""
    from lz4_sgori_tpu import format as JF
    from lz4_sgori_tpu import golden
    bs = max(len(b) for b in blocks)
    nseg = -(-bs // seg)
    parts = [golden.compress_dense_seg_parts(b, seg) for b in blocks]
    scap = max(len(p["stream"]) for ps in parts for p in ps) + 1
    hdrs, plan = [], []
    for b, ps in zip(blocks, parts):
        n = len(b)
        for k, p in enumerate(ps):
            h = b""
            if p["has_match"] or k == 0:
                nxt = next((q for q in ps[k + 1:] if q["has_match"]), None)
                run_end = nxt["p1"] if nxt is not None else n
                mcn = min(nxt["m1"], JF.ML_MASK) if nxt is not None else 0
                h = golden._lit_header(run_end - p["last_end"], mcn)
            s1 = min((k + 1) * seg, n)
            hdrs.append(h)
            plan.append((len(p["stream"]), len(h), p["last_end"],
                         s1 - p["last_end"]))
        for _ in range(nseg - len(ps)):       # segments past a short block
            hdrs.append(b"")
            plan.append((0, 0, 0, 0))
    hmax = max(len(h) for h in hdrs) + 1
    streams = np.zeros((len(blocks) * nseg, scap), np.uint8)
    hdr = np.zeros((len(blocks) * nseg, hmax), np.uint8)
    raw = np.zeros((len(blocks), bs), np.uint8)
    r = 0
    for j, (b, ps) in enumerate(zip(blocks, parts)):
        raw[j, :len(b)] = np.frombuffer(b, np.uint8)
        for k in range(nseg):
            if k < len(ps):
                s = ps[k]["stream"]
                streams[r, :len(s)] = np.frombuffer(s, np.uint8)
            hdr[r, :len(hdrs[r])] = np.frombuffer(hdrs[r], np.uint8)
            r += 1
    want = [golden.assemble_seg_parts(b, ps, seg)
            for b, ps in zip(blocks, parts)]
    args = [torch.from_numpy(a) for a in (
        streams, hdr, raw, np.array(plan, np.int32).reshape(
            len(blocks), nseg, 4))]
    return args, want


def test_asm_emulation_matches_jax_golden():
    """Corpus text, a zero block, a random block and a short one at 16
    KiB in segments of 4096, assembled from golden's own parts, against
    ``lz4_sgori_tpu.golden.assemble_seg_parts``: its bytes, zeros after
    them."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_tpu import format as JF
    bs = 16384
    data = _synth_corpus(bs)
    blocks = [data, bytes(bs), np.random.default_rng(1).integers(
        0, 256, bs, dtype=np.uint8).tobytes(), data[:5000]]
    args, want = _golden_case(blocks, 4096)
    ocap = JF.compress_bound(bs) + 8
    for shift in (0, 7):
        out, out_len = emulate(*args, ocap, shift=shift)
        for j, w in enumerate(want):
            assert int(out_len[j]) == len(w), j
            assert out[j, :len(w)].numpy().tobytes() == w, j
            assert not out[j, len(w):].any(), j
    _same(emulate(*args, ocap), assemble_segments_plain(*args, ocap))


def test_asm_wrapper_runs_the_plain_version_on_the_cpu():
    """K4's wrapper on CPU tensors is the plain assembly, and counts no
    launch."""
    args = random_case(3, 2, 4, 30, 8, 256)
    K4.launches = 0
    _same(K4.assemble_segments(*args, 300),
          assemble_segments_plain(*args, 300))
    assert K4.launches == 0


def test_asm_failed_build_raises_and_never_falls_back(monkeypatch):
    """CUDA tensors whose kernel cannot be built raise; the wrapper
    neither runs the plain assembly nor counts a launch."""
    from lz4_sgori_torch.ops.kernels import _build

    def no_nvcc(*_a, **_k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def plain(*_a, **_k):
        raise AssertionError("the plain assembly ran for a CUDA tensor")

    args = [t.as_subclass(_OnCuda) for t in random_case(4, 2, 4, 30, 8, 256)]
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(K4, "assemble_segments_plain", plain)
    K4.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        K4.assemble_segments(*args, 300)
    assert K4.launches == 0

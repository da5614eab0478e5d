"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

Builds the twenty-seven CUDA sources of the port from
``lz4_sgori_torch/csrc`` (one nvcc each, all started together; 48
kernels, T6 and T7, T9 and T10, T11 and T12 sharing a source each,
T14a's 15 harness bodies and T14b's 5 tensor-core readings two: 14
bodies on one SM in ``probe_harness``, ``ohbuild`` and the five
tensor-core readings on every SM in ``probe_harness_wg``) and
drives nine paths: two on a
32 MiB synthetic corpus (``__graft_entry__._synth_corpus``, seed 42,
held on the card), the big-block path on bench.py's config 6 (128 MiB,
seed 55, 1 MiB blocks), the deep modes on its config 5 (128 MiB, seed
1234, 64 KiB blocks), the mlen mode and the retired engines on the 32
MiB corpus again, the design probes of ``tools/`` at their own shapes
and seeds, the xla engine on the 32 MiB corpus, and the block-sharded
write path on it, over NCCL at world size 1.

The 64 KiB compress -> verify -> decompress path (512 blocks; engines
seg and v7, kernels K1-K4):

1. compares each kernel with its plain PyTorch version on the same
   inputs (a 32-block subset, exactly: the outputs are bytes; K2 and K3
   also on a random, an all-zero and a 5,000-byte block);
2. compares the port's bytes with the golden seg contract and its
   decode with golden.decompress on 16 blocks;
3. drives ``lz4_sgori_torch.compress`` / ``decompress`` over the corpus
   with every launch counter reset just before, and requires the round
   trip, zero host fallbacks, a launch of every kernel, and every block
   decoding under the native C++ decoder (and liblz4 where present);
4. decodes about 1024 corrupted blocks through the decode kernel and
   requires golden.decompress's verdict for each, and holds K1 to its
   plain version on the crafted streams (``crafted_streams``) at out_size
   16, 64 and 128 KiB (its whole-block geometry, and K6's ring above 64
   KiB);
5. times the kernel path and each kernel against its plain version with
   CUDA events; K2, K3 and K1 over the corpus and on one block, and K4
   over the corpus, each in turns with the parent tree's when
   ``--parent`` names one (its outputs equal first).

The 4 KiB block-device path (8192 blocks; engines enc3 and v6, kernels
K2, K7 and K5), in ``_smoke_4k``:

6. K2, K7 and K5 against their plain versions exactly (K2 on every 4 KiB
   block of the corpus, a CTA taking some 62 in turn, and on 64 blocks of
   8 KiB; K7 on all five outputs of a 64-block subset, at acceleration 8
   on it, at 5,000 bytes (corpus, short, zero and random blocks) and at 64
   KiB (a corpus and a random block), and against K3 then K4 at seg =
   block size; K5 at 4 KiB, 8 KiB, and 256 KiB on blocks of
   ``native.compress``, and on the crafted streams at 4, 8 and 12 KiB);
7. the golden contract: 64 blocks at 4 KiB and their tails, acceleration 8,
   the non-aligned enc3 sizes 5,000 and 60,000 with edge blocks, and
   seg_splice at 96 and 196 KiB, each decoded through its routed engine;
8. ``lz4_sgori_torch.compress`` / ``decompress`` at 4 KiB with the
   counters reset just before: round trip, zero host fallbacks, K2, K7
   and K5 launched and K1, K3 and K4 not, every block decoding under the
   native decoder (and liblz4 where present);
9. the ratio of bench.py's config-3 mix (4096 zero-or-random 4 KiB
   chunks) against the TPU record of the same bytes;
10. a ProxyStore over a 32 MiB backing file, written with 8192
    sequential 4 KiB requests and read back under sha256, 1024 chunks
    through a CompressedStore, and the CLI's ``verify`` sweep at 4, 8, 64
    and 96 KiB, which launches all six kernels;
11. 1024 corrupted 4 KiB streams through the v6 route against
    golden.decompress's verdict;
12. times with CUDA events: the 4 KiB kernel path, K2, K7 and K5 beside
    their plain versions (K2, K7 and K5 over the corpus and on one block
    in turns with the parent tree's, and with it the median of 1024 4 KiB
    ProxyStore writes with the parent's K2, and with its K7), and the
    ProxyStore's write latency.

The big-block path (128 KiB-4 MiB; engines seg_big and v8, kernels K9,
K3, K4 and K6), in ``_smoke_big``; the pure-Python golden oracles of its
blocks run in a pool of worker processes:

13. K9, K3 and K6 against their plain versions exactly (K9 on 4 blocks
    of 1 MiB, one of 4 MiB, an all-zero and a short block of 1 MiB, and
    at piece 4096 on a block of 1 MiB, and against
    golden.dense_candidates_piecewise on 2; K3 on 2 blocks of 1 MiB at
    seg 8192, acceleration 1 and 8; K6 at 512 KiB, 1 MiB and 4 MiB on
    blocks of ``native.compress``
    and on the eleven ``crafted_streams`` of each size: the rings' wraps
    and stage bounds, each error of the safe decoder late in a long
    stream, a stream of exactly ``slot`` bytes);
14. the golden contract: ``compress_blocks_device`` at 128 KiB, 256 KiB,
    512 KiB, 1 MiB and 4 MiB (a full and a short block each) and at
    acceleration 8 at 1 MiB equals golden.compress_dense_seg_big, and
    each decodes through its routed engine;
15. config 6 through ``lz4_sgori_torch.compress`` / ``decompress`` with the
    counters reset just before: round trip, zero host fallbacks, K9, K3,
    K4 and K6 launched and K1, K2, K5 and K7 not, every block decoding
    under the native decoder (and liblz4 where present), 8 blocks equal
    to golden, and the ratio and size against the TPU record of the same
    bytes;
16. two ProxyStores over 32 MiB backing files, shaped as fio's
    ``test_1m.fio`` and ``test_4m.fio`` (32 sequential 1 MiB writes, 8 of
    4 MiB), read back under sha256, their write latency's median, p99
    and max;
17. the CLI's default ``verify`` sweep (4 KiB-4 MiB, eleven sizes) over
    8 MiB, which launches all eight depth-1 kernels and none of K8's,
    K10's or the retired engines';
18. 512 corrupted 1 MiB streams through the v8 route against
    golden.decompress's verdict;
19. times with CUDA events: config 6's encode and decode kernel paths, K9,
    K3, K4 and K6 over the corpus, K9 and K6 beside their plain versions,
    and K6 at 4 MiB; K9, K3 and K4 over config 6, K9 on one block of 1 MiB
    and one of 4 MiB, and K6 on one block of 1 MiB, one of 4 MiB and over
    config 6, each in turns with the parent tree's when ``--parent`` names
    one (its outputs equal first), and with it the 1 MiB and 4 MiB
    stores' write medians with this tree's K9 and the parent's in turns.

The deep match modes (K8) on bench.py's config 5 (128 MiB, seed 1234,
64 KiB blocks; depth 3 on seg, depth 5 on enc3 over the first 8 MiB;
kernels K2, gaps, K8-seg, K8-enc3, K4 and K1), in ``_smoke_deep``:

20. the gaps kernel (K2's tape at links 2 and 4, K9's tape with its
    floor), K8-seg and K8-enc3 (64 blocks of 4 KiB, and 4 of the 10
    blocks of 64 KiB the kernel parses: the first, the short last one, a
    random and an all-zero block, K8-enc3 at depth 3 and 5, K8-seg at
    seg 4096; K8-seg also on 2 blocks of 1 MiB at seg 8192 over K9's
    tape, acceleration 1 and 8) against their plain versions exactly, and
    the tapes against golden; the gaps kernel also on hand-made tapes
    (``hand_gaps_tape``: 3 blocks of 64 KiB at links 4, 1 MiB with and
    without half, 70,000 blocks of 16 bytes); the plain K8 parses are
    timed here, once;
21. the golden contract of each deep row of the routing table: seg at
    depth 2-3, seg_big at depth 3, enc3 at depth 3 (acceleration 1 and 8)
    and 5, and seg_splice capped at depth 1 with its warning;
22. config 5 through ``lz4_sgori_torch.compress`` / ``decompress`` at
    depth 3, then its first 8 MiB at depth 5, with the counters reset
    just before each: round trip, zero host fallbacks, the deep kernels
    launched and K3, K7 and K9 not, every block decoding under the native
    decoder (and liblz4 where present), blocks equal to golden, and the
    ratio and sizes against the TPU record of the same bytes;
23. a ProxyStore at depth 3, a CompressedStore at depth 5 and
    ``lz4j compress --match-depth 3`` and ``5`` round trips;
24. times with CUDA events: the deep encode paths, K2, K8-seg and the
    gaps kernel (links 2, and links 4 over the depth-5 slice, and on the
    subset) over the corpus (in turns with the parent tree's), K3 beside
    them, K8-enc3 over the depth-5 slice, and each deep kernel beside its
    plain version (the K8 parses' from phase 20); K8-seg on one block of
    1 MiB at seg 8192, K8-enc3 at depth 5 on the first 1, 32 and 128
    blocks and at depth 3 on the 64 blocks of 4 KiB, each in turns with
    the parent tree's when ``--parent`` names one.

The mlen mode (K10: ``LZ4J_ENC_MLEN=1`` at depth 1 and 64 KiB and below;
kernels K2, mcode, K10b and K4 on ``seg``, K2, mcode and K10c through the
enc3 function's ``mlen`` argument) on config 1's corpus, in
``_smoke_mlen``:

25. mcode and K10b on the 32-block 64 KiB subset, K10c on the 64-block
    4 KiB subset, against their plain versions exactly and against K3 and
    K7 on the unverified tape; mcode also on hand-made tapes
    (``hand_mcode_case``: 5 blocks of 64 KiB and of 4097 bytes, 9 of 5,
    70,000 of 16) and against golden.dense_mcode on 4 blocks; K10b and
    K10c on these subsets in turns with the parent tree's when
    ``--parent`` names one;
26. all 512 blocks of 64 KiB through the seg engine with and without the
    mode: the same bytes, and 16 blocks equal golden.compress_dense_seg;
27. ``lz4_sgori_torch.compress`` / ``decompress`` with the variable set
    (and restored after), the counters reset just before: round trip,
    zero host fallbacks, K2, mcode, K10b, K4 and K1 launched and K3 and
    K7 not, the container of phase 3 byte for byte, and the TPU record's
    ratio; then the enc3 function with ``mlen`` over the 8192 blocks of
    4 KiB, the counters reset just before: K2, mcode and K10c launched,
    K7 not, the default bytes;
28. times, each pair in turns: the compress walls with and without the
    mode (host clock), and with CUDA events and as device time (CUDA
    graphs) the mlen encode kernel path against the default one on the
    same blocks, K10b against K3 and K10c
    against K7 over the corpus, and each beside its plain version;
    mcode over configs 1 and 3 and the subset, and both mlen encode
    paths, K10b and K10c over the corpus and on one block, each in turns
    with the parent tree's (its mcode, K10b or K10c) when ``--parent``
    names one.

The retired round-1 engines (``lz4_sgori_torch.retired``: T1 the greedy
encoder, T2 the scalar decoder, T3 the chained decoder; kernels
retired_encode, retired_decode and decode_v9) on config 1's corpus cut to
512 blocks of 64 KiB and 8192 of 4 KiB, in ``_smoke_retired``:

29. T1 on 8 blocks of 64 KiB and 64 of 4 KiB at acceleration 1 and 8, T2
    and T3 (chain 2 and 4) on their streams and on mutants (random bytes
    past comp_len in a third of them) against their plain versions
    exactly, whole rows included; T2's out_len and err and all of T3's
    output equal K1's;
30. the retired path with the counters reset just before: T1 over both
    cuts, then T2 and T3 at chain 2 and 4 back to the corpus, the three
    kernels launched and no other;
31. every block of T1 equals native LZ4_compress_default (and liblz4's
    where present), 16 of each cut equal golden.compress at acceleration
    1 and 8 (and LZ4_compress_fast), and the size is 1.0000x;
32. times with CUDA events: T1 over each cut, T2 and T3 in turns with K1
    (64 KiB) and K5 (4 KiB), and each on K1's 32-block subset; with
    ``--parent``, T1 over each cut and the subset and T3 at chain 2 and
    4 over each cut in turns with the parent tree's kernel, whose
    outputs must equal this tree's; T3's kernel alone on the dealt
    batch beside its call.

The design probes (``lz4_sgori_torch.probes``: T4 the bitonic column
sort, T5 per-lane async row copies, T6 pass-1 get / put rounds, T7
K-batched gets and puts, T8 the 26-word byte extract, T9 and T10 the
per-lane word gather and scatter, T11 the FIFO bitroll, T12 the 30-op
state step, T13 the scratch capacity probe, T14a the primitive-rate
harness around 15 vector-unit bodies, T14b its 5 tensor-core readings,
T15 the dependent scalar walk; kernels probe_sort, probe_dma,
probe_table, probe_banded, probe_lane, probe_step, probe_smem,
probe_harness, probe_harness_wg and probe_walk) at the
tools' shapes and seeds, in ``_smoke_probes``:

33. each probe against its plain version exactly: T4 at logN 1, 4, 10,
    12, 13, 16 and 17 on the tool's keys and on random int32 with
    negatives (and against ``torch.sort``), one launch a call, and the
    kernel's count of its passes (``sort_probe.passes``) equal to
    ``sort_probe.plan``'s at logN 0-24 (9 at 16), T5 at 1, 32 and 128
    lanes of 128 and 512 words for 16 and 48 rounds (and its refusal of
    64 rounds, which read past the tape), T6's three bodies at R 8192 and
    K 8, T7's seven cases, T8's five spans at the tool's mask and at
    unaligned positions, T9 and T10 at each R of the tool (T10's whole
    output), T11 and T12 at 3000 rounds, T13's refusal of every size of the
    tool with no launch and its fit at the card's limit (one row more
    refused), T15 on the tool's table and on one whose walk wraps within a
    few steps; each of T14a's 15 bodies on the tool's inputs at R 0, 1, 3
    and 300 and on inputs drawn over all of int32 at R 3 (every sum wraps),
    ``out`` bit for bit and ``sink`` exactly; each of T14b's 5 readings at R
    0, 1, 3 and 300, ``gather``'s out and sink and ``cumsum_mxu``'s out bit
    for bit, every other out (kernel and plain version) within E of the
    float64 reference (``harness_reference``) and every float sink within
    the summed bound; the nine whole-card readings (``probe_harness_wg``:
    ``ohbuild``, the five tensor-core readings, ``transpose``, ``shiftsel``
    and ``red1``; the grid printed) at R 0, 1, 3, 33 (whole waves of items),
    300 and 301 (a partial last wave), T14a's four also on int32-wide inputs
    at each, twice at each R with the same bits, held as above;
34. the probe path with the counters reset just before: each probe's
    ``main()`` at the tool's defaults (T5 at 16 and 48 rounds; T14's 20
    readings at the card's counts), which prints ns per iteration by
    differencing two repeat counts; the 31 wrappers and bodies launched
    and no codec kernel;
35. times with CUDA events at each row's shape: the kernel and its plain
    version per call (the Python-stepped plain versions of T11, T12,
    T14 and T15 at fewer rounds), and the bound: the bytes over 3.35
    TB/s, for T14 the larger of that and its operations (``Body.ops``:
    T14a's fewest lane operations, T14b's tensor FLOPs) over the card's
    SMs x ``Body.rate`` (128 lanes; 4096 dense bf16 or 2048 TF32 FLOP) x
    its maximum SM clock; each T14 body no faster than that figure on
    the SMs it uses (one; every SM for ``probe_harness_wg``'s); each
    row that one PyTorch call computes in turns with that call on its
    operands, precomputed, on the whole card (T14b: ``torch.mm`` of one
    iteration's product, float32 result; T14a's twelve:
    ``microbench2.library_call``, ``torch.eq`` for ``ohbuild``,
    ``torch.gather``, ``torch.sum``, ``torch.cumsum``, a transposed copy,
    ``torch.index_select``, ``torch.add``, ``torch.clone``, a float32
    conversion; T5, T9 and T10, whose rounds do not depend on one
    another: round 0's ``torch.gather`` or ``index_put_``,
    ``dma_probe.library_call`` and ``microbench3.library_call``, against
    the kernel's time a round by differencing two round counts), each
    call timed two ways: its device time, ``LIBRARY_CALLS`` calls
    captured into a CUDA graph and replayed (``graph_ms``, a measuring
    instrument here only; a call that cannot be captured fails the
    run), and its eager time, the same calls from Python (``time_ms``,
    what a Python caller pays, which a call shorter than its dispatch
    reads as the host's time); its ``library_ms`` the device time times
    the kernel's iterations or rounds, its ``library_eager_ms`` the
    eager one, and both factors (the kernel's time an iteration over the
    call's);
36. T4 at logN 16 in turns with ``torch.sort`` (both ways), with its
    launches a sort, then the ranking of every priced row by its device
    factor, the eager one beside it. No
    single PyTorch call computes the looped functions of T6 (``getk``:
    its K gets XORed), T7 (K gets, a sum and a mask), T8 (a 26-word
    extract and a sum), T11 (three selects and an add), T12 (30 ops) or
    T15 (a dependent load and two adds), each round carrying state to
    the next, nor T13 (a capacity probe), nor three of T14a's bodies:
    ``vpu``, ``sroll`` and ``lroll`` are chains of operations.

The xla engine, the portable and exhaustive max-ratio mode (PyTorch
tensor ops on the card, no kernel of its own), in ``_smoke_xla``:

37. with every counter reset just before, the 32 MiB corpus through
    ``compress_blocks_device(impl="xla")`` on the card at its default
    depth 3, then through the routed decode (K1, its one launch) and the
    ``impl="xla"`` decode, equal to each other, every block its input,
    and no other kernel launched; its ratio and its size against liblz4
    (and the native LZ4_compress_default); the card's bytes equal the
    engine's CPU bytes on 8 blocks of 64 KiB at depths 1 and 3, 16 of 4
    KiB at depth 5 and one of 128 KiB at depth 1; phase 4's mutants
    through the ``impl="xla"`` decode on the card, equal to K1's (so to
    golden's verdict); bench.py's config 5b, the first 16 blocks of
    config 5's corpus, at depth 3 against liblz4
    (``deep_xla_size_vs_lz4``); encode and decode GB/s from CUDA events
    after a warm-up, and the peak memory a call takes.

The block-sharded write path (``lz4_sgori_torch.parallel``) on
``torch.distributed``, in ``_smoke_parallel``:

38. a process group of one rank on NCCL (the card's host has one card,
    and NCCL takes one rank a device) and ``make_mesh()`` on the card;
    with every counter reset just before, config 1 through
    ``write_pipeline_sharded`` (compress, decode-verify, the stats'
    all_reduce), ``decompress_blocks_sharded`` and
    ``assemble_container_sharded`` (the all_gathers and the ordered
    pack): K1-K4 launched and no other kernel, comp and comp_len equal to
    the unsharded ``compress_blocks_device`` byte for byte, every block
    ok, the stats equal to the host's sums, the blocks decoded back, and
    the payload equal to the host's concatenation of the rows; then, with
    CUDA events in turns, the sharded write pipeline, the same on a mesh
    with no process group (no all_reduce), the unsharded compress and
    decode-verify, and the assembly, and one call of each under
    ``torch.profiler`` (device and host time).

``--parent DIR`` names a tree of an earlier commit (``git archive``);
without it phases 5, 12, 19, 24, 25, 28 and 32 time this tree's kernels
alone (with it K1-K7, K9, K8-seg, K8-enc3, gaps, mcode, K10b, K10c, T1
and T3 in turns with the parent's).

Any failure exits non-zero with no result line. It needs a CUDA card
and the repository beside it; it imports nothing of JAX or of the JAX
package, whose backend-neutral modules the port copies. It prints its
whole time, then the card; the last two lines are the per-kernel JSON
record (with each kernel's bytes bound) and the device JSON line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DEVICE = "cuda"
# ``--parent DIR``: a tree of the commit before (``git archive``), whose
# kernel sources phases 5, 12, 19, 24, 25, 28 and 32 build and time in turns
# with this tree's; None times this tree's kernels alone
PARENT = None
_PARENT_LIBS = {}       # the parent tree's builds, by source name
BLOCK = 65536
CORPUS_BYTES = 32 << 20
SUBSET = 32
GOLDEN_BLOCKS = 16
MUTANTS = 1024
# TPU record of the same bytes (BENCH_r05.json, engine seg): the bytes
# are device-independent, so the port should reproduce them
TPU_RECORD = {"ratio": 2.661, "size_vs_lz4": 0.9906}

BLOCK4 = 4096
SUBSET4 = 64
GOLDEN4 = 64
MIX_CHUNKS = 4096
# TPU record of bench.py's config-3 mix (BENCH_r05.json
# bdev_4k_mix_ratio, engine enc3): the same bytes, so the same ratio
TPU_MIX_RATIO = 1.9376
STORE_CHUNKS_COMPRESSED = 1024
STORE_TURNS = 1024      # 4 KiB writes a turn, this tree's K2 or the parent's

BIG_BLOCK = 1 << 20
BIG_CORPUS_BYTES = 128 << 20
BIG_SEED = 55
BIG_SUBSET = 4
BIG_SIZES = (131072, 262144, 524288, 1 << 20, 4 << 20)
BIG_GOLDEN = 8
BIG_MUTANTS = 512
# fio test_1m.fio and test_4m.fio: (chunk and request size, requests)
BIG_STORE_RUNS = ((1 << 20, 32), (4 << 20, 8))
SWEEP_BYTES = 8 << 20
# TPU record of bench.py's config 6 (BENCH_r05.json big_1m_ratio and
# big_1m_size_vs_lz4, engine seg_big): the same bytes, so the same numbers
TPU_BIG_RECORD = {"ratio": 3.3538, "size_vs_lz4": 0.9711}

DEEP_BLOCK = 65536
DEEP_CORPUS_BYTES = 128 << 20
DEEP_SEED = 1234
DEEP5_BYTES = 8 << 20
DEEP_SUBSET = 32
DEEP_GOLDEN = 8
DEEP_STORE_REQUESTS = 64
DEEP_STORE_CHUNKS = 256
# TPU record of bench.py's config 5 (BENCH_r05.json deep_ratio,
# deep_size_vs_lz4 at depth 3 on engine seg, deep5_size_vs_lz4 at depth 5
# on engine enc3 over the first 8 MiB; sizes against liblz4's
# LZ4_compress_default): the same bytes, so the same numbers
TPU_DEEP_RECORD = {"ratio": 2.8231, "size_vs_lz4": 0.9304,
                   "deep5_size_vs_lz4": 0.9171}
# TPU record of bench.py's config 5b (BENCH_r05.json deep_xla_size_vs_lz4:
# the xla engine at depth 3 on the first 16 blocks of config 5's corpus,
# against liblz4's LZ4_compress_default): the same bytes, the same number
TPU_XLA_SIZE_VS_LZ4 = 0.9141

# the xla engine (phase 37): blocks of the corpus it encodes on the CPU
# too at 64 KiB (depths 1 and 3) and at 4 KiB (depth 5), the 128 KiB
# blocks it encodes there at depth 1, config 5b's blocks (bench.py:508-
# 520), and the timed reps
XLA_CPU_64K = 8
XLA_CPU_4K = 16
XLA_CPU_128K = 1
XLA_5B_BLOCKS = 16
XLA_REPS = 2
# runs of each timing of the sharded write path (phase 38)
PARALLEL_REPS = 20
RETIRED_SUBSET = 8          # 64 KiB blocks of check 29 (and SUBSET4 at 4 KiB)
RETIRED_ACC = 8
RETIRED_MUTANTS = (248, 1024)   # at 64 KiB and at 4 KiB

# T4's checks (the tool's keys and random int32 with negatives, against
# its plain version and torch.sort) and the logN of its timings
PROBE_SORT_LOGN = (1, 4, 10, 12, 13, 16, 17)
PROBE_SORT_TIMED = 16
PROBE_DMA_LANES = (1, 32, 128)
PROBE_DMA_WORDS = (128, 512)
# rounds of T5's checks: its tape reads past the end after 63 at w = 512
PROBE_DMA_REPS = (16, 48)
# rounds of T11's and T12's checks, and of their Python-stepped plain
# versions in phase 35 (the kernels' times are at the tool's 10^6)
PROBE_STEP_REPS = 3000
PROBE_STEP_PLAIN = 1000
# steps of T15's checks and of its plain version in phase 35 (the
# kernel's time is at the tool's 2^25)
PROBE_WALK_STEPS = 3000
# T14: the kernel key of a body of probes.microbench2.BODIES is this
# prefix and its name; the largest R of the bodies' checks, and the R of
# their Python-stepped plain versions in phase 35 (the kernels' times are
# at the card's higher count)
HARNESS = "probe_harness_"
PROBE_HARNESS_R = 300
PROBE_HARNESS_PLAIN = 64
# the bytes of a512 that dynrow (rows 0-262: row (37 i) & 255 and the 7
# below it) and statrow (rows 8-15) read; every other body reads all of
# its inputs within a call of the card's counts
HARNESS_READS = {"dynrow": 263 * 128 * 4, "statrow": 8 * 128 * 4}
# calls in each timing of a row's library call, eager and in a CUDA graph
LIBRARY_CALLS = 200

KERNELS = [
    ("K1 decode_v7", "decode_v7",
     "lz4_sgori_tpu/ops/pallas/lockstep_v7.py:209"),
    ("K2 cand", "cand", "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:398"),
    ("K3 parse_seg", "parse_seg",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("K4 asm_seg", "asm_seg", "lz4_sgori_tpu/ops/pallas/asm_seg.py:56"),
    ("K5 decode_v6", "decode_v6",
     "lz4_sgori_tpu/ops/pallas/lockstep_v6.py:283"),
    ("K6 decode_v8", "decode_v8",
     "lz4_sgori_tpu/ops/pallas/lockstep_v8.py:84"),
    ("K7 parse_enc3", "parse_enc3",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("K9 cand_piecewise", "cand_piecewise",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1790"),
    ("K8 gaps", "gaps", "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:398"),
    ("K8 parse_seg_deep", "parse_seg_deep",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("K8 parse_enc3_deep", "parse_enc3_deep",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("K10a mcode", "mcode", "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:398"),
    ("K10b parse_seg_mlen", "parse_seg_mlen",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("K10c parse_enc3_mlen", "parse_enc3_mlen",
     "lz4_sgori_tpu/ops/pallas/lockstep_enc3.py:1279"),
    ("T1 retired_encode", "retired_encode",
     "tools/retired/encode_kernel.py:179"),
    ("T2 retired_decode", "retired_decode",
     "tools/retired/decode_kernel.py:97"),
    ("T3 decode_v9", "decode_v9", "tools/retired/lockstep_v9.py:184"),
    ("T4 probe_sort", "probe_sort", "tools/sort_probe.py:61"),
    ("T5 probe_dma", "probe_dma", "tools/dma_probe.py:35"),
    ("T6 probe_table rounds", "probe_rounds", "tools/microbench6.py:33"),
    ("T7 probe_table kget", "probe_kget", "tools/microbench4.py:80"),
    ("T8 probe_banded", "probe_banded", "tools/microbench4.py:127"),
    ("T9 probe_lane gather", "probe_gather", "tools/microbench3.py:67"),
    ("T10 probe_lane scatter", "probe_scatter", "tools/microbench3.py:108"),
    ("T11 probe_step fifo", "probe_fifo", "tools/microbench3.py:143"),
    ("T12 probe_step state", "probe_state", "tools/microbench3.py:184"),
    ("T13 probe_smem", "probe_smem", "tools/microbench3.py:235"),
    ("T15 probe_walk", "probe_walk", "tools/microbench2.py:230"),
]
# the kernels whose source is not csrc/<key>.cu
SOURCES = {"probe_rounds": "probe_table", "probe_kget": "probe_table",
           "probe_gather": "probe_lane", "probe_scatter": "probe_lane",
           "probe_fifo": "probe_step", "probe_state": "probe_step"}
# H100 SXM device memory rate (NVIDIA data sheet, 3.35 TB/s at 700 W) in
# bytes per millisecond: the bound of every kernel here but T14's. The
# codec kernels do a few integer operations a byte they move; T14's
# bodies do many on a few inputs, so theirs is the larger of the bytes'
# time and their operations' at Body.rate a clock an SM.
HBM_BYTES_PER_MS = 3.35e9
PATH64 = ("decode_v7", "cand", "parse_seg", "asm_seg")
PATH4 = ("cand", "parse_enc3", "decode_v6")
PATHBIG = ("cand_piecewise", "parse_seg", "asm_seg", "decode_v8")
PATHDEEP3 = ("cand", "gaps", "parse_seg_deep", "asm_seg", "decode_v7")
PATHDEEP5 = ("cand", "gaps", "parse_enc3_deep", "decode_v7")
DEEP_ONLY = ("gaps", "parse_seg_deep", "parse_enc3_deep")
PATHMLEN = ("cand", "mcode", "parse_seg_mlen", "asm_seg", "decode_v7")
PATHMLEN_ENC3 = ("cand", "mcode", "parse_enc3_mlen")
MLEN_ONLY = ("mcode", "parse_seg_mlen", "parse_enc3_mlen")
PATHRETIRED = ("retired_encode", "retired_decode", "decode_v9")
PATHPROBES = ("probe_sort", "probe_dma", "probe_rounds", "probe_kget",
              "probe_banded", "probe_gather", "probe_scatter", "probe_fifo",
              "probe_state", "probe_smem", "probe_walk")
# the kernels of the 4, 8, 64 and 96 KiB sizes of phase 10's sweep
SWEEP4 = ("decode_v7", "cand", "parse_seg", "asm_seg", "decode_v6",
          "parse_enc3")


def _mutate(b: bytearray, rng) -> bytes:
    mode = rng.integers(0, 6)
    if mode == 0 and len(b) > 2:              # flip a random byte
        i = int(rng.integers(0, len(b)))
        b[i] ^= int(rng.integers(1, 256))
    elif mode == 1 and len(b) > 1:             # truncate
        b = b[:int(rng.integers(1, len(b)))]
    elif mode == 2:                            # huge literal length chain
        b = bytearray([0xF0]) + b"\xff" * int(rng.integers(4, 64)) + b
    elif mode == 3 and len(b) > 4:             # zero an offset
        b[3] = b[4] = 0
    elif mode == 4 and len(b) > 4:             # offset beyond the output
        b[3] = b[4] = 0xFF
    else:                                      # garbage tail
        b = b + bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    return bytes(b)


def hand_gaps_tape(nb, bs, half=0, seed=0):
    """A hand-made candidate tape: live links 1-254, and 0, 254, 255,
    negatives, values past bs and far links; on K9's geometry (half > 0)
    q1 exactly at h*half and one below it (the tie), chains ending
    exactly at the floor."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 10, (nb, bs))
    c = rng.integers(1, 255, (nb, bs))
    p = np.arange(bs)[None, :]
    c = np.where(kind == 5, 0, c)
    c = np.where(kind == 6, rng.choice([254, 255], (nb, bs)), c)
    c = np.where(kind == 7, -rng.integers(1, 1000, (nb, bs)), c)
    c = np.where(kind == 8, bs + rng.integers(0, 1000, (nb, bs)), c)
    far = rng.integers(0, 1 << 20, (nb, bs)) % np.maximum(p, 1) + 1
    c = np.where(kind == 9, far, c)
    c = c.astype(np.int64)
    if half > 0:
        for h in range(2, -(-bs // half)):
            for x in (0, 1, 2, 7):
                for b in range(nb):
                    j = h * half + x
                    if j + 1 < bs:
                        c[b, j] = x               # q1 == h*half
                        c[b, j + 1] = x + 2       # q1 == h*half - 1
            f = (h - 1) * half
            q1 = f + 3
            j = min(bs - 1, h * half + 40)
            if q1 < j:
                c[:, q1] = 3                      # a chain ending at F
                c[:, j] = j - q1
    return np.clip(c, -(1 << 31), (1 << 31) - 1).astype(np.int32)


def hand_mcode_case(nb, bs, seed=0):
    """Bytes from a small alphabet (matches verify, lcp and cu vary),
    nonzero bytes past n, raw_len negative, zero, short and past bs, and
    candidates d <= 0, d = 1, d = p, d > p, d >= bs and random."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 3, (nb, bs)).astype(np.uint8)
    raw[::3] = rng.integers(0, 256, raw[::3].shape, dtype=np.uint8)
    rlen = rng.integers(-5, bs + 6, nb).astype(np.int32)
    fixed = min(nb, 4)
    rlen[:fixed] = [-3, 0, bs, bs + 9][:fixed]
    p = np.arange(bs)[None, :]
    kind = rng.integers(0, 8, (nb, bs))
    c = rng.integers(1, 17, (nb, bs))
    c = np.where(kind == 1, rng.integers(-3, 1, (nb, bs)), c)
    c = np.where(kind == 2, 1, c)
    c = np.where(kind == 3, p, c)
    c = np.where(kind == 4, p + 1, c)
    c = np.where(kind == 5, bs + rng.integers(0, 50, (nb, bs)), c)
    c = np.where(kind == 6, rng.integers(0, 1 << 20, (nb, bs))
                 % np.maximum(p, 1) + 1, c)
    return raw, rlen, c.astype(np.int32)


def make_mutants(bases, rng, count: int, slot: int) -> list[bytes]:
    """``count`` corrupted streams made from ``bases`` (single-point
    mutations, bit flips, LSIC injection, splices, pure noise, offset
    surgery), each clipped to ``slot`` bytes and non-empty."""
    muts = []
    while len(muts) < count:
        base = bytearray(bases[int(rng.integers(0, len(bases)))])
        mode = int(rng.integers(0, 10))
        if mode < 5:
            m = _mutate(base, rng)
        elif mode == 5 and len(base) > 1:      # single bit flip
            i = int(rng.integers(0, len(base)))
            base[i] ^= 1 << int(rng.integers(0, 8))
            m = bytes(base)
        elif mode == 6 and len(base) > 8:      # mid-stream LSIC injection
            i = int(rng.integers(1, len(base) - 1))
            m = bytes(base[:i]) + b"\xff" * int(rng.integers(1, 32)) \
                + bytes(base[i:])
        elif mode == 7:                        # splice two streams
            other = bases[int(rng.integers(0, len(bases)))]
            i = int(rng.integers(0, len(base)))
            j = int(rng.integers(0, len(other)))
            m = bytes(base[:i]) + bytes(other[j:])
        elif mode == 8:                        # pure noise
            m = bytes(rng.integers(0, 256, size=int(rng.integers(1, 512)),
                                   dtype=np.uint8))
        else:                                  # offset surgery mid-stream
            i = int(rng.integers(0, max(1, len(base) - 2)))
            base[i:i + 2] = int(rng.integers(0, 65536)).to_bytes(2, "little")
            m = bytes(base)
        muts.append((m or b"\x00")[:slot])
    return muts


class _Seqs:
    """An LZ4 block written sequence by sequence, with the bytes it
    decodes to."""

    def __init__(self):
        self.stream, self.out = bytearray(), bytearray()

    def _lsic(self, rem: int) -> None:
        self.stream += b"\xff" * (rem // 255) + bytes([rem % 255])

    def seq(self, lit: bytes, off: int = 1, ml: int = 4,
            last: bool = False) -> None:
        self.stream.append(min(len(lit), 15) << 4
                           | (0 if last else min(ml - 4, 15)))
        if len(lit) >= 15:
            self._lsic(len(lit) - 15)
        self.stream += lit
        self.out += lit
        if last:
            return
        self.stream += off.to_bytes(2, "little")
        if ml - 4 >= 15:
            self._lsic(ml - 4 - 15)
        if 0 < off <= len(self.out):
            period = self.out[len(self.out) - off:]
            self.out += (period * (ml // off + 1))[:ml]

    def pad_to(self, size: int, rng) -> None:
        """Short sequences (literals, then a 4-byte match at offset 1)
        until the stream is exactly ``size`` bytes long."""
        while len(self.stream) < size:
            k = min(size - len(self.stream) - 3, 14)
            if 0 < size - len(self.stream) - 3 - k < 3:
                k -= 3
            self.seq(rng.integers(0, 256, max(k, 0),
                                  dtype=np.uint8).tobytes())


def crafted_streams(out_size: int, seed: int = 17,
                    stage: int = 8192) -> list[tuple[str, bytes]]:
    """Named LZ4 streams for a decoder of ``out_size``-byte blocks, each
    fitting the slot ``compress_bound(out_size) + 8``: valid ones with
    an offset of exactly 65,535 (where the output reaches it), offsets
    1-4, matches across every 128 KiB of output (the history ring's
    wrap) and from sources across it, LSIC runs over ``stage``-byte
    boundaries of the stream (the decoder's stage boundaries, whatever
    the row's alignment; two runs of 40 LSIC bytes from 128 KiB on, below
    it as many runs of 16 as the output holds, below 16 KiB runs of
    out_size / 2048 bytes, and a match whose source is the block's first
    byte); and one of each error of the safe decoder (missing token,
    truncated literal and match LSIC, literals past the input, literals
    and a match past capacity, truncated offset, offset 0, offset past
    the output) placed near the end of a long stream, and a stream of
    exactly ``slot`` bytes."""
    from lz4_sgori_torch import format as F
    rng = np.random.default_rng(seed)
    slot = F.compress_bound(out_size) + 8
    ring = 1 << 17
    # the longest literal run and match of a body's sequence: below 16 KiB
    # short enough that the last body stays inside the block
    long_lit, long_ml = (700, 600) if out_size >= 16384 else (200, 200)

    def rand(k):
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()

    def body(w: _Seqs, target: int) -> None:
        """Mixed sequences until the output reaches ``target``."""
        w.seq(rand(64), 1, 40)
        while len(w.out) < target:
            op = len(w.out)
            nxt = (op // ring + 1) * ring
            if nxt - 40 <= op < nxt:                # across the ring's wrap
                w.seq(b"", int(rng.choice([3, 31, 32, 65535 if op > 65535
                                           else 33])), 120)
                continue
            r = rng.integers(0, 10)
            lit = rand(int(rng.integers(0, 20)))
            if r == 0 and op + len(lit) >= 65535:
                w.seq(lit, 65535, int(rng.integers(4, 80)))
            elif r == 1:
                w.seq(lit, int(rng.integers(1, 5)),
                      int(rng.integers(4, 300)))
            elif r == 2 and op > ring and (op + len(lit)) % ring < 65000:
                # a source that starts 17 bytes before the last wrap
                w.seq(lit, (op + len(lit)) % ring + 17, 50)
            elif r == 3:
                w.seq(rand(int(rng.integers(15, long_lit))),
                      int(rng.integers(1, min(op, 65535) + 1)),
                      int(rng.integers(19, long_ml)))
            else:
                w.seq(lit, int(rng.integers(1, min(op + len(lit), 65535)
                                             + 1)),
                      int(rng.integers(4, 40)))

    streams = []
    w = _Seqs()
    small = out_size < ring
    body(w, out_size // (8 if small else 2))
    nff = 16 if small else 40                    # LSIC bytes of 255 a run
    back = 10 if small else 20                   # the token before a bound
    reserve = 2000                               # output for the last body
    if out_size < 16384:
        nff = max(1, min(16, out_size // 2048))
        back = min(back, nff)
        reserve = 512
    for k in range(2):                           # LSIC over stage bounds
        bound = (len(w.stream) // stage + (1 if small else 2)) * stage
        pad = bound - back
        run = 15 + 255 * nff + 7
        if small and (len(w.out) + (pad - len(w.stream)) * 18 // 17 + run
                      + 64 > out_size - reserve - 100):
            break                                # the output cannot hold it
        w.pad_to(pad, rng)
        if k == 0:
            w.seq(rand(run), 2, 4)
        else:
            w.seq(b"", 3, 4 + run)
    if small:                                    # the source at byte 0
        w.seq(rand(5), len(w.out) + 5, 60)
    body(w, out_size - reserve)
    w.seq(rand(50), last=True)
    streams.append(("mixed", bytes(w.stream)))

    pre = _Seqs()
    body(pre, out_size * 3 // 4)

    def faulty(tail) -> bytes:
        v = _Seqs()
        v.stream, v.out = bytearray(pre.stream), bytearray(pre.out)
        tail(v, out_size - len(v.out))
        return bytes(v.stream)

    def lit_lsic(v, room):
        v.stream += b"\xf0" + b"\xff" * 5

    def lit_past_input(v, room):
        v.stream += b"\xa0" + rand(5)

    def lit_past_cap(v, room):
        v.seq(rand(room + 1), last=True)

    def cut_offset(v, room):
        v.stream += b"\x35" + rand(3) + b"\x01"

    def offset0(v, room):
        v.seq(rand(3), 0, 4)
        v.seq(rand(9), last=True)

    def match_lsic(v, room):
        v.stream += b"\x3f" + rand(3) + b"\x05\x00" + b"\xff" * 3

    def match_past_cap(v, room):
        v.seq(rand(3), 7, room - 3 + 1)
        v.seq(rand(9), last=True)

    for name, tail in (("missing token", lambda v, room: v.seq(rand(4))),
                       ("truncated literal LSIC", lit_lsic),
                       ("literals past input", lit_past_input),
                       ("literals past capacity", lit_past_cap),
                       ("truncated offset", cut_offset),
                       ("offset 0", offset0),
                       ("truncated match LSIC", match_lsic),
                       ("match past capacity", match_past_cap)):
        streams.append((name, faulty(tail)))
    v = _Seqs()                                  # offsets reach 65,535 back
    body(v, min(60000, out_size - 100))
    v.seq(rand(3), len(v.out) + 4, 4)
    v.seq(rand(9), last=True)
    streams.append(("offset past output", bytes(v.stream)))
    for pre in (1, 2):                           # a literal run to the end
        v = _Seqs()
        v.seq(rand(pre))
        room = slot - len(v.stream)
        lit = next((k for k in range(room - 2, 15, -1)
                    if k + 2 + (k - 15) // 255 <= room), None)
        if lit + 2 + (lit - 15) // 255 != room:
            lit = None
        if lit is not None:
            v.seq(rand(lit), last=True)
            streams.append(("clen == slot", bytes(v.stream)))
            break
    for name, s in streams:
        assert 0 < len(s) <= slot, (name, len(s), slot)
    return streams


def k5_stage(out_size: int) -> int:
    """The stream stage of K5's geometry at ``out_size`` (decode_v6.cu):
    ``ring::SmallGeom<L>``'s 2^(L-1) bytes up to 16 KiB (2^L the least
    power of two at least out_size, L at least 12), else 8 KiB."""
    if out_size > 16384:
        return 8192
    return 1 << (max(12, (out_size - 1).bit_length()) - 1)


def load_parent(mod, name: str):
    """The parent tree's build of ``csrc/<name>.cu`` (``--parent``), with
    the port's nvcc flags and its own headers, its C entries those of
    ``mod.ENTRIES``, built once; None without a parent tree."""
    if PARENT is None:
        return None
    if name in _PARENT_LIBS:
        return _PARENT_LIBS[name]
    import ctypes

    from lz4_sgori_torch.ops.kernels import _build
    src = os.path.join(PARENT, "lz4_sgori_torch", "csrc", f"{name}.cu")
    so = os.path.join(_build.BUILD_DIR, f"lib{name}_parent.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           src], capture_output=True, text=True,
                          timeout=600)
    need(proc.returncode == 0, f"nvcc failed for the parent's {src}:\n"
                               f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    for fn, sig in mod.ENTRIES.items():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_int if c == "i" else ctypes.c_void_p
                      for c in sig]
        f.restype = ctypes.c_int
    _PARENT_LIBS[name] = lib
    return lib


def with_kernel(mod, lib, fn):
    """``fn`` run with ``mod``'s kernel taken from ``lib`` (the parent's
    build): its wrapper, checks and launch count stay this tree's."""
    def call():
        own = mod.load_kernel
        mod.load_kernel = lambda: lib
        try:
            return fn()
        finally:
            mod.load_kernel = own
    return call


def against_parent(time_ms, mod, lib, fn, reps: int, what: str,
                   card: str, same=None) -> float:
    """The time of ``fn`` (ms a call), and with a parent tree the
    parent's kernel in turns with it (this, parent, parent, this), both
    printed; the parent's outputs must equal this tree's (``same(got,
    want)`` where only part of them is defined, as a segment parse's
    stream rows past their lengths)."""
    if lib is None:
        ms = time_ms(fn, reps)
        print(f"[{card}] {what}: {ms:.4f} ms (no parent tree given)")
        return ms
    old = with_kernel(mod, lib, fn)
    got, want = fn(), old()
    if same is not None:
        need(same(got, want), f"{what}: the parent's kernel gives other "
                              "outputs")
    else:
        for a, b in zip(got, want):
            need(a is None and b is None or bool((a == b).all()),
                 f"{what}: the parent's kernel gives other outputs")
    ms, ms_old = in_turns(time_ms, fn, old, reps)
    print(f"[{card}] {what}: {ms:.4f} ms, the parent's kernel "
          f"{ms_old:.4f} ms in turns ({ms_old / ms:.2f}x)")
    return ms


def _run(cmd) -> str:
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (p.stdout.strip() or p.stderr.strip()) or f"rc {p.returncode}"


def _golden_call(args):
    """``golden.<name>(block, **kwargs)`` in a worker process."""
    name, block, kwargs = args
    from lz4_sgori_torch import golden
    return getattr(golden, name)(block, **kwargs)


def _golden_verdict(args):
    """(length, sha256) of golden.decompress(stream, out_size), or None
    where it raises."""
    import hashlib

    from lz4_sgori_torch import golden
    stream, out_size = args
    try:
        out = golden.decompress(stream, out_size)
    except golden.DecodeError:
        return None
    return len(out), hashlib.sha256(out).digest()


@contextlib.contextmanager
def golden_pool():
    """Worker processes for the pure-Python golden oracles of the big
    blocks (about 2.5 s per 1 MiB block each), started fresh: they never
    touch the card. On leaving, the workers are joined and the resource
    tracker that the spawn context starts beside them is stopped too: left
    alone, it would outlive this script."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import resource_tracker
    try:
        with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                                 mp_context=multiprocessing.get_context(
                                     "spawn")) as pool:
            yield pool
    finally:
        resource_tracker._resource_tracker._stop()


def child_processes() -> list[int]:
    """The pids of this process's live children (Linux ``/proc``)."""
    me = str(os.getpid())
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the parent pid is the second field after the command's ")"
        if stat[stat.rfind(")") + 2:].split()[1] == me:
            pids.append(int(d))
    return pids


def stop_children() -> list[int]:
    """Terminate and reap any child process still alive; returns their
    pids. Every phase waits for what it starts, so this should find
    none."""
    import signal
    left = child_processes()
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
    for pid in left:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
    return left


class Failed(Exception):
    pass


class Counter:
    """A wrapper's launch count kept in a module attribute other than
    ``launches`` (``probes.microbench4`` holds two wrappers,
    ``probes.microbench3`` five), or in an entry of one that is a dict
    (``probes.microbench2.harness_launches``, one a body), read and reset
    as ``.launches`` like the other modules' counts."""

    def __init__(self, mod, attr: str, load, entry: str | None = None):
        self.mod, self.attr, self.load_kernel = mod, attr, load
        self.entry = entry

    @property
    def launches(self) -> int:
        n = getattr(self.mod, self.attr)
        return n if self.entry is None else n[self.entry]

    @launches.setter
    def launches(self, n: int) -> None:
        if self.entry is None:
            setattr(self.mod, self.attr, n)
        else:
            getattr(self.mod, self.attr)[self.entry] = n


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def parse_bytes(inputs, outs) -> int:
    """Bytes a parse (K3, K7, K8) must move: each input once, the stream
    bytes it writes (the sum of its lengths, ``outs[1]``) and its other
    per-lane outputs."""
    return tensor_bytes(*inputs, *outs[1:]) + int(outs[1].sum())


def decode_bytes(comp_len, res) -> int:
    """Bytes a decode (K1, K5, K6) must move: the compressed payload and
    its lengths in, the decoded bytes, lengths and flags out."""
    out, out_len, err = res
    return int(comp_len.sum()) + int(out_len.sum()) + tensor_bytes(
        comp_len, out_len, err)


def same_parse(torch, maxdiff, what: str = "K3"):
    """``against_parent``'s comparison of two segment parses (K3's or
    K8-seg's): ``segment_diff``, which raises where they differ."""
    return lambda got, want: segment_diff(
        torch, maxdiff, got, want,
        f"{what} (the parent's kernel standing for the plain version)") == 0


def segment_diff(torch, maxdiff, got, want, what: str) -> int:
    """The largest difference between two segment parses' outputs (K3,
    K8-seg): the stream bytes within each length and every per-segment
    output, over the segments without an error; the error flags must be
    equal. Raises when they differ."""
    need(torch.equal(got[2], want[2]),
         f"{what} err differs from its plain version")
    ok = got[2] == 0
    err = max(maxdiff(a[ok], b[ok]) for a, b in zip(got[1:], want[1:]))
    scap = got[0].shape[1]
    smask = (torch.arange(scap, device=ok.device)[None, :]
             < got[1][:, None]) & ok[:, None]
    err = max(err, maxdiff(got[0][smask], want[0][smask]))
    need(err == 0, f"{what} differs from its plain version by {err}")
    return err


def check_launches(counts: dict, path: str, used, idle) -> None:
    """Every kernel of ``used`` launched on the path, none of ``idle``."""
    for k in used:
        need(counts[k] > 0, f"kernel {k} was not launched on the {path} "
                            "path")
    for k in idle:
        need(counts[k] == 0, f"kernel {k} was launched on the {path} path")


def main() -> int:
    global PARENT
    start = time.perf_counter()
    args = sys.argv[1:]
    if args[:1] == ["--parent"] and len(args) == 2:
        PARENT = os.path.abspath(args[1])
    elif args:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "lz4_sgori_torch")):
        print("chip_smoke: the lz4_sgori_torch package is missing beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    try:
        return _smoke(torch, start)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        left = stop_children()
        if left:
            print(f"chip_smoke: stopped child processes {left} left "
                  "running", file=sys.stderr)


def _smoke(torch, start: float) -> int:
    import lz4_sgori_torch
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch import format as F
    from lz4_sgori_torch import golden, native
    from lz4_sgori_torch.ops import seg as S
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    from lz4_sgori_torch.ops.kernels import _build
    from lz4_sgori_torch.ops.kernels import asm_seg as K4
    from lz4_sgori_torch.ops.kernels import cand as K2
    from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
    from lz4_sgori_torch.ops.kernels import gaps as G
    from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
    from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
    from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
    from lz4_sgori_torch.ops.kernels import mcode as M
    from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
    from lz4_sgori_torch.ops.kernels import parse_enc3_deep as K8E
    from lz4_sgori_torch.ops.kernels import parse_enc3_mlen as K10C
    from lz4_sgori_torch.ops.kernels import parse_seg as K3
    from lz4_sgori_torch.ops.kernels import parse_seg_deep as K8S
    from lz4_sgori_torch.ops.kernels import parse_seg_mlen as K10B
    from lz4_sgori_torch.probes import dma_probe as P5
    from lz4_sgori_torch.probes import microbench2 as P15
    from lz4_sgori_torch.probes import microbench3 as P3
    from lz4_sgori_torch.probes import microbench4 as P78
    from lz4_sgori_torch.probes import microbench6 as P6
    from lz4_sgori_torch.probes import sort_probe as P4
    from lz4_sgori_torch.retired import decode_kernel as T2
    from lz4_sgori_torch.retired import encode_kernel as T1
    from lz4_sgori_torch.retired import lockstep_v9 as T3
    from lz4_sgori_torch.utils import oracle
    from lz4_sgori_torch.utils.stats import Stats

    mods = {"decode_v7": K1, "cand": K2, "parse_seg": K3, "asm_seg": K4,
            "decode_v6": K5, "decode_v8": K6, "parse_enc3": K7,
            "cand_piecewise": K9, "gaps": G, "parse_seg_deep": K8S,
            "parse_enc3_deep": K8E, "mcode": M, "parse_seg_mlen": K10B,
            "parse_enc3_mlen": K10C, "retired_encode": T1,
            "retired_decode": T2, "decode_v9": T3, "probe_sort": P4,
            "probe_dma": P5, "probe_rounds": P6,
            "probe_kget": Counter(P78, "kget_launches", P78.load_table_kernel),
            "probe_banded": Counter(P78, "banded_launches", P78.load_kernel),
            "probe_gather": Counter(P3, "gather_launches",
                                    P3.load_lane_kernel),
            "probe_scatter": Counter(P3, "scatter_launches",
                                     P3.load_lane_kernel),
            "probe_fifo": Counter(P3, "fifo_launches", P3.load_step_kernel),
            "probe_state": Counter(P3, "state_launches",
                                   P3.load_step_kernel),
            "probe_smem": Counter(P3, "vmem_launches", P3.load_smem_kernel),
            "probe_walk": P15,
            **{HARNESS + b: Counter(P15, "harness_launches",
                                    lambda b=b: P15.load_harness_kernel(
                                        P15.BODIES[b].source), b)
               for b in P15.BODIES}}
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton_v}")
    print(f"nvcc: {_run([_build.nvcc_path(), '--version']).splitlines()[-1]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.load_kernel(), mods.values()))
    print(f"build: {time.perf_counter() - t0:.1f} s in parallel for "
          + ", ".join(f"{k} {v:.1f} s" for k, v in
                      _build.build_seconds.items()))
    for k, log in _build.build_log.items():
        entry, spills = "", ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] + " "   # the mangled name
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                print(f"ptxas {k} {entry}: {line.strip()}; {spills}")

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps):
        fn()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        sync()
        return a.elapsed_time(b) / reps

    def graph_ms(fn, calls, replays=5):
        """The card's own time of one call of ``fn``: ``calls`` calls
        captured into one CUDA graph (after a warm-up on a side stream),
        replayed once, then CUDA events around ``replays`` replays, over
        ``replays`` x ``calls``. No Python runs between the launches, so
        a call shorter than its dispatch no longer reads as the host's
        time. A call that cannot be captured raises."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        sync()
        return a.elapsed_time(b) / (replays * calls)

    def maxdiff(x, y):
        if x.numel() == 0:
            return 0
        return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())

    # ---- corpus, held on the card ----
    t0 = time.perf_counter()
    data = _synth_corpus(CORPUS_BYTES)
    raw_np, rlen_np = B.split_blocks(data, BLOCK)
    raw = torch.from_numpy(raw_np).to(dev)
    rlen = torch.from_numpy(rlen_np).to(dev)
    nb = raw.shape[0]
    print(f"corpus: {len(data)} bytes, {nb} blocks of {BLOCK} "
          f"({time.perf_counter() - t0:.1f} s to make)")

    # ---- phase 1: each kernel against its plain version (subset) ----
    t0 = time.perf_counter()
    sub = torch.arange(0, nb, nb // SUBSET, device=dev)[:SUBSET]
    rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
    c_k = K2.dense_candidates(rs, ls)
    c_p = K2.dense_candidates_plain(rs, ls)
    err2 = maxdiff(c_k, c_p)
    need(err2 == 0, f"K2 differs from its plain version by {err2}")

    pk = K3.parse_segments(rs, c_k, ls)
    pp = K3.parse_segments_plain(rs, c_k, ls)
    err3 = segment_diff(torch, maxdiff, pk, pp, "K3")
    # K2 and K3 also on a random, an all-zero and a short block (n 5,000)
    noise = np.random.default_rng(41).integers(0, 256, BLOCK, np.uint8)
    xr, xl = (torch.from_numpy(a).to(dev) for a in _batch(
        [noise.tobytes(), bytes(BLOCK), data[:5000]], BLOCK))
    xc = K2.dense_candidates(xr, xl)
    err2 = max(err2, maxdiff(xc, K2.dense_candidates_plain(xr, xl)))
    need(err2 == 0, f"K2 differs from its plain version by {err2} on the "
                    "random, zero or short block")
    err3 = max(err3, segment_diff(
        torch, maxdiff, K3.parse_segments(xr, xc, xl),
        K3.parse_segments_plain(xr, xc, xl),
        "K3 on the random, zero and short blocks"))

    nseg = BLOCK // 4096
    shp = (SUBSET, nseg)
    le = pk[3].reshape(shp).to(torch.int64)
    hdr, hlen = S.run_headers(pk[5].reshape(shp), pk[6].reshape(shp), le,
                              ls, BLOCK)
    plan = S.assembly_plan(pk[1].reshape(shp), hlen, le, ls, 4096)
    ocap = F.compress_bound(BLOCK) + 8
    a_k = K4.assemble_segments(pk[0], hdr, rs, plan, ocap)
    a_p = K4.assemble_segments_plain(pk[0], hdr, rs, plan, ocap)
    err4 = max(maxdiff(a_k[0], a_p[0]), maxdiff(a_k[1], a_p[1]))
    need(err4 == 0, f"K4 differs from its plain version by {err4}")

    comp_s, clen_s = a_k[0], a_k[1]
    d_k = K1.decompress_blocks_v7(comp_s, clen_s, BLOCK)
    d_p = K1.decompress_blocks_plain(comp_s, clen_s, BLOCK)
    err1 = max(maxdiff(x, y) for x, y in zip(d_k, d_p))
    need(err1 == 0, f"K1 differs from its plain version by {err1}")
    need(not bool(d_k[2].any()), "K1 rejected a subset block")
    print(f"phase kernels == plain: ok on {SUBSET} blocks (K2 and K3 also "
          "on a random, a zero and a 5,000-byte block), plain versions on "
          f"the card ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 2: golden contract on 16 blocks ----
    t0 = time.perf_counter()
    gsel = np.linspace(0, nb - 1, GOLDEN_BLOCKS).astype(np.int64)
    gi = torch.from_numpy(gsel).to(dev)
    gcomp, gclen = compress_blocks_device(raw[gi], rlen[gi], BLOCK)
    gout, glen, gerr = decompress_blocks_device(gcomp, gclen, BLOCK)
    gcomp, gclen = gcomp.cpu().numpy(), gclen.cpu().numpy()
    gout, glen, gerr = gout.cpu().numpy(), glen.cpu().numpy(), \
        gerr.cpu().numpy()
    for j, b in enumerate(gsel):
        blk = raw_np[b, :rlen_np[b]].tobytes()
        got = gcomp[j, :gclen[j]].tobytes()
        need(got == golden.compress_dense_seg(blk, 4096, 65536, 16),
             f"block {b}: bytes differ from golden.compress_dense_seg")
        want = golden.decompress(got, BLOCK)
        need(not gerr[j] and glen[j] == len(want)
             and gout[j, :glen[j]].tobytes() == want,
             f"block {b}: decode differs from golden.decompress")
    print(f"phase golden: ok on {GOLDEN_BLOCKS} blocks "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3: the main path, counters reset just before ----
    for m in mods.values():
        m.launches = 0
    stats = Stats()
    sync()
    t0 = time.perf_counter()
    container = lz4_sgori_torch.compress(data, BLOCK, stats=stats,
                                         device=DEVICE)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = lz4_sgori_torch.decompress(container, stats=stats, device=DEVICE)
    t_dec = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    need(back == data, "main path round trip differs")
    need(stats.encode_fallbacks == 0,
         f"{stats.encode_fallbacks} host fallbacks on the main path")
    check_launches(counts, "64 KiB", PATH64,
                   [k for k in mods if k not in PATH64])
    cb = B.CompressedBlocks.from_container(container)
    need(native.available(), "the native codec did not build (g++?)")
    lz_native = 0
    for j in range(nb):
        blk = raw_np[j, :rlen_np[j]].tobytes()
        c = cb.comp[j, :cb.comp_len[j]].tobytes()
        need(native.decompress(c, BLOCK) == blk,
             f"block {j} fails the native decoder")
        if oracle.available():
            need(oracle.decompress(c, BLOCK) == blk,
                 f"block {j} fails liblz4")
        lz_native += len(native.compress(blk))
    ratio = len(data) / cb.compressed_size
    vs_lz4 = cb.compressed_size / lz_native
    print(f"main path: round trip ok, host fallbacks 0, launches {counts}")
    print(f"main path: native decode ok, liblz4 decode "
          f"{'ok' if oracle.available() else 'not run (liblz4 absent)'}")
    print(f"main path: ratio {ratio:.4f}, size {vs_lz4:.4f}x native "
          f"LZ4_compress_default (TPU record of the same bytes: ratio "
          f"{TPU_RECORD['ratio']}, {TPU_RECORD['size_vs_lz4']}x)")
    print(f"main path wall: compress {t_enc:.3f} s "
          f"({len(data) / t_enc / 1e9:.4f} GB/s), decompress {t_dec:.3f} s "
          f"({len(data) / t_dec / 1e9:.4f} GB/s), host framing included")

    # ---- phase 4: malformed decode, K1 against golden's verdict ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(1234)
    bases = [cb.comp[j, :cb.comp_len[j]].tobytes()
             for j in range(0, nb, nb // 32)]
    muts = make_mutants(bases, rng, MUTANTS, ocap - 8)
    mc = np.zeros((len(muts), ocap), np.uint8)
    ml = np.zeros(len(muts), np.int32)
    for j, m in enumerate(muts):
        mc[j, :len(m)] = np.frombuffer(m, np.uint8)
        ml[j] = len(m)
    mo, mlen, merr = K1.decompress_blocks_v7(
        torch.from_numpy(mc).to(dev), torch.from_numpy(ml).to(dev), BLOCK)
    mo, mlen, merr = mo.cpu().numpy(), mlen.cpu().numpy(), merr.cpu().numpy()
    n_err = 0
    for j, m in enumerate(muts):
        try:
            want = golden.decompress(m, BLOCK)
        except golden.DecodeError:
            want = None
        need(bool(merr[j]) == (want is None),
             f"mutant {j}: err {bool(merr[j])} vs golden {want is None}")
        if want is None:
            n_err += 1
        else:
            need(mlen[j] == len(want) and mo[j, :len(want)].tobytes() == want,
                 f"mutant {j}: bytes differ from golden")
    # K1 on the crafted streams: its whole-block geometry at 16 and 64
    # KiB, K6's ring at 128 KiB (stage bounds, far and overlapping
    # offsets, each error late in a long stream, clen == slot)
    for osz in (16384, 65536, 131072):
        cc, cl = _pack_streams([s for _, s in crafted_streams(osz)],
                               F.compress_bound(osz) + 8)
        cc, cl = torch.from_numpy(cc).to(dev), torch.from_numpy(cl).to(dev)
        e = max(maxdiff(x, y) for x, y in zip(
            K1.decompress_blocks_v7(cc, cl, osz),
            K1.decompress_blocks_plain(cc, cl, osz)))
        need(e == 0, f"K1 differs from its plain version on the crafted "
                     f"streams at {osz} by {e}")
        err1 = max(err1, e)
    print(f"phase malformed: {len(muts)} mutants, {n_err} rejected, err == "
          f"golden for all; K1 == plain on the crafted streams at 16, 64 "
          f"and 128 KiB ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 5: times ----
    ms_enc = time_ms(lambda: compress_blocks_device(raw, rlen, BLOCK), 5)
    fcomp, fclen = compress_blocks_device(raw, rlen, BLOCK)
    ms_dec = time_ms(lambda: decompress_blocks_device(fcomp, fclen, BLOCK),
                     5)
    print(f"[{card}] kernel path over the corpus: encode {ms_enc:.3f} ms "
          f"({len(data) / ms_enc / 1e6:.4f} GB/s), decode {ms_dec:.3f} ms "
          f"({len(data) / ms_dec / 1e6:.4f} GB/s)")
    fc = K2.dense_candidates(raw, rlen)
    # K2, K3 and K1 over the corpus and on one block, in turns with the
    # parent's kernels
    old2, old3 = load_parent(K2, "cand"), load_parent(K3, "parse_seg")
    old1 = load_parent(K1, "decode_v7")
    old4 = load_parent(K4, "asm_seg")
    a4 = S.assembly_inputs(raw, rlen, BLOCK)[:5]
    full = {
        "cand": against_parent(time_ms, K2, old2,
                               lambda: K2.dense_candidates(raw, rlen), 5,
                               f"K2 over config 1 ({nb} blocks of {BLOCK})",
                               card),
        "parse_seg": against_parent(
            time_ms, K3, old3, lambda: K3.parse_segments(raw, fc, rlen), 5,
            f"K3 over config 1 ({nb} blocks of {BLOCK}, seg 4096)", card,
            same_parse(torch, maxdiff)),
        "decode_v7": against_parent(
            time_ms, K1, old1,
            lambda: K1.decompress_blocks_v7(fcomp, fclen, BLOCK), 5,
            f"K1 over config 1 ({nb} blocks of {BLOCK})", card),
        "asm_seg": against_parent(
            time_ms, K4, old4, lambda: K4.assemble_segments(*a4), 5,
            f"K4 over config 1 ({nb} blocks of {BLOCK}, seg 4096)", card),
    }
    del a4
    print(f"[{card}] kernels over the corpus (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in full.items()))
    r1, l1, c1 = raw[:1].contiguous(), rlen[:1].contiguous(), \
        fc[:1].contiguous()
    against_parent(time_ms, K2, old2, lambda: K2.dense_candidates(r1, l1),
                   20, f"K2 on one block of {BLOCK}", card)
    against_parent(time_ms, K3, old3,
                   lambda: K3.parse_segments(r1, c1, l1), 20,
                   f"K3 on one block of {BLOCK}", card,
                   same_parse(torch, maxdiff))
    f1, fl1 = fcomp[:1].contiguous(), fclen[:1].contiguous()
    against_parent(time_ms, K1, old1,
                   lambda: K1.decompress_blocks_v7(f1, fl1, BLOCK), 20,
                   f"K1 on one block of {BLOCK}", card)
    # (kernel ms, plain ms, bytes the call must move) on the subset
    sub_times = {
        "cand": (time_ms(lambda: K2.dense_candidates(rs, ls), 10),
                 time_ms(lambda: K2.dense_candidates_plain(rs, ls), 3),
                 tensor_bytes(rs, ls, c_k)),
        "parse_seg": (time_ms(lambda: K3.parse_segments(rs, c_k, ls), 10),
                      time_ms(lambda: K3.parse_segments_plain(rs, c_k, ls),
                              1), parse_bytes((rs, c_k, ls), pk)),
        "asm_seg": (time_ms(lambda: K4.assemble_segments(
            pk[0], hdr, rs, plan, ocap), 10),
            time_ms(lambda: K4.assemble_segments_plain(
                pk[0], hdr, rs, plan, ocap), 3),
            int(pk[1].sum()) + int(hlen.sum()) + int(plan[..., 3].sum())
            + tensor_bytes(plan, *a_k)),
        "decode_v7": (time_ms(lambda: K1.decompress_blocks_v7(
            comp_s, clen_s, BLOCK), 10),
            time_ms(lambda: K1.decompress_blocks_plain(
                comp_s, clen_s, BLOCK), 1), decode_bytes(clen_s, d_k)),
    }
    for k, (a, b, _) in sub_times.items():
        print(f"[{card}] {k} on {SUBSET} blocks: kernel {a:.4f} ms, "
              f"plain {b:.4f} ms")

    r4 = _smoke_4k(torch, data, card, time_ms, maxdiff, mods)
    rb = _smoke_big(torch, card, time_ms, maxdiff, mods)
    rd = _smoke_deep(torch, card, time_ms, maxdiff, mods)
    rm = _smoke_mlen(torch, data, raw, rlen, container, card, time_ms,
                     graph_ms, maxdiff, mods)
    rr = _smoke_retired(torch, data, card, time_ms, maxdiff, mods)
    rp = _smoke_probes(torch, card, time_ms, graph_ms, maxdiff, mods)
    _smoke_xla(torch, data, raw, rlen, (mc, ml, mo, mlen, merr), card,
               time_ms, mods)
    rs = _smoke_parallel(torch, raw, rlen, card, time_ms, mods)
    parts = (r4, rb, rd, rm, rr, rp, rs)
    errs = {"decode_v7": err1, "cand": max(err2, r4["errs"]["cand"]),
            "parse_seg": err3, "asm_seg": err4}
    for r in parts:
        errs.update({k: max(v, errs.get(k, 0)) for k, v in r["errs"].items()})
        sub_times.update(r["sub_times"])
    kernels = KERNELS + [
        (f"T14{'b' if b in P15.T14B else 'a'} harness {b}",
         HARNESS + b, f"tools/microbench2.py:{body.line}")
        for b, body in P15.BODIES.items()]
    record = {"kernels": []}
    for label, key, where in kernels:
        bound, by = bound_ms(sub_times[key][2], rp["op_bound"].get(key, 0.0))
        source = P15.BODIES[key[len(HARNESS):]].source \
            if key.startswith(HARNESS) else SOURCES.get(key, key)
        record["kernels"].append({
            "name": label, "route": "cuda",
            "source": f"lz4_sgori_torch/csrc/{source}.cu",
            "replaces": where,
            "launches": counts[key] + sum(r["counts"][key] for r in parts),
            "max_abs_err": errs[key],
            "ms": sub_times[key][0], "plain_ms": sub_times[key][1],
            "bound_ms": bound, "bound_by": by,
            "library_ms": rp["library"].get(key),
            "library_eager_ms": rp["library_eager"].get(key),
            **({"library_of": rp["library_of"][key]}
               if key in rp["library_of"] else {})})
    for k in record["kernels"]:
        print(f"[{card}] {k['name']}: kernel {k['ms']:.4f} ms, bound "
              f"{k['bound_ms']:.6f} ms ({k['ms'] / k['bound_ms']:.1f}x)")
    print(f"smoke total: {time.perf_counter() - start:.1f} s, the build "
          "included")
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def _pack_streams(streams, slot: int):
    comp = np.zeros((len(streams), slot), np.uint8)
    clen = np.zeros(len(streams), np.int32)
    for j, c in enumerate(streams):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen[j] = len(c)
    return comp, clen


def decodes_to(res, blocks, what: str) -> None:
    """A decoder's (out, out_len, err) holds exactly ``blocks``."""
    out, out_len, err = (t.cpu().numpy() for t in res)
    for j, b in enumerate(blocks):
        need(not err[j] and out_len[j] == len(b)
             and out[j, :len(b)].tobytes() == b,
             f"{what}: block {j} does not decode to its bytes")


def _batch(blocks, bs: int):
    raw = np.zeros((len(blocks), bs), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for j, b in enumerate(blocks):
        raw[j, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[j] = len(b)
    return raw, rlen


def _smoke_4k(torch, data: bytes, card: str, time_ms, maxdiff, mods) -> dict:
    """Phases 6-12: the 4 KiB block-device path. Returns the per-kernel
    errors, launch counts and subset times of K5 and K7 for the record."""
    import hashlib
    import tempfile

    import lz4_sgori_torch
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch import cli
    from lz4_sgori_torch import format as F
    from lz4_sgori_torch import golden, native
    from lz4_sgori_torch import store as ST
    from lz4_sgori_torch.ops import seg as S
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.ops.enc3 import compress_blocks_enc3
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    from lz4_sgori_torch.ops.kernels import cand as K2
    from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
    from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
    from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
    from lz4_sgori_torch.utils import oracle
    from lz4_sgori_torch.utils.stats import Stats

    dev = torch.device(DEVICE)

    def to_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    raw_np, rlen_np = B.split_blocks(data, BLOCK4)
    raw, rlen = to_dev(raw_np, rlen_np)
    nb = raw.shape[0]
    slot4 = F.compress_bound(BLOCK4) + 8

    # ---- phase 6: K7 and K5 against their plain versions ----
    t0 = time.perf_counter()
    sub = torch.arange(0, nb, max(1, nb // SUBSET4), device=dev)[:SUBSET4]
    rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
    sub_blocks = [raw_np[j, :rlen_np[j]].tobytes() for j in sub.tolist()]
    cs = K2.dense_candidates(rs, ls)
    err2 = maxdiff(cs, K2.dense_candidates_plain(rs, ls))
    # and over every block of the corpus: a CTA takes some 62 blocks in
    # turn, clearing only the buckets of the last one between them
    err2 = max(err2, maxdiff(K2.dense_candidates(raw, rlen),
                             K2.dense_candidates_plain(raw, rlen)))
    need(err2 == 0, f"K2 differs from its plain version at 4 KiB by {err2}")
    k7 = K7.parse_blocks_enc3(rs, cs, ls)
    p7 = K7.parse_blocks_enc3_plain(rs, cs, ls)
    err7 = max(maxdiff(a, b) for a, b in zip(k7, p7))
    need(err7 == 0, f"K7 differs from its plain version by {err7}")
    need(not bool(k7[2].any()), "K7 flagged a subset block")
    # acceleration 8 on the subset; 5,000 bytes (corpus, short, zero and
    # random blocks) and 64 KiB (a corpus and a random block)
    k7x = [(K7.parse_blocks_enc3(rs, cs, ls, 8),
            K7.parse_blocks_enc3_plain(rs, cs, ls, 8))]
    noise = np.random.default_rng(41).integers(0, 256, BLOCK, np.uint8)
    for bs, blocks in ((5000, [data[:5000], data[77777:82777], data[:12],
                               data[:13], bytes(5000),
                               noise[:5000].tobytes()]),
                       (BLOCK, [data[:BLOCK], noise.tobytes()])):
        xr, xl = to_dev(*_batch(blocks, bs))
        xc = K2.dense_candidates(xr, xl)
        k7x.append((K7.parse_blocks_enc3(xr, xc, xl),
                    K7.parse_blocks_enc3_plain(xr, xc, xl)))
    for got, want in k7x:
        err7 = max(err7, max(maxdiff(a, b) for a, b in zip(got, want)))
        need(not bool(got[2].any()), "K7 flagged a block")
    need(err7 == 0, f"K7 differs from its plain version by {err7} at "
                    "acceleration 8, 5,000 bytes or 64 KiB")
    sc, sl, serr, sns = S.compress_blocks_seg(rs, ls, BLOCK4, seg=BLOCK4)
    need(not bool(serr.any()) and torch.equal(sc, k7[0])
         and torch.equal(sl, k7[1]) and torch.equal(sns, k7[4]),
         "K7 differs from K3 then K4 at seg = block size")

    e5 = []
    d5 = K5.decompress_blocks_v6(k7[0], k7[1], BLOCK4)
    e5.append(max(maxdiff(x, y) for x, y in zip(
        d5, K1.decompress_blocks_plain(k7[0], k7[1], BLOCK4))))
    decodes_to(d5, sub_blocks, "K5 at 4 KiB")
    b8 = [data[j * 8192:(j + 1) * 8192] for j in range(SUBSET4)]
    r8, l8 = to_dev(*_batch(b8, 8192))
    err2 = max(err2, maxdiff(K2.dense_candidates(r8, l8),
                             K2.dense_candidates_plain(r8, l8)))
    need(err2 == 0, f"K2 differs from its plain version at 8 KiB by {err2}")
    c8, n8 = compress_blocks_device(r8, l8, 8192)
    d5 = K5.decompress_blocks_v6(c8, n8, 8192)
    e5.append(max(maxdiff(x, y) for x, y in zip(
        d5, K1.decompress_blocks_plain(c8, n8, 8192))))
    decodes_to(d5, b8, "K5 at 8 KiB")
    bs256 = 262144
    b256 = [data[j * bs256:(j + 1) * bs256] for j in
            np.linspace(0, len(data) // bs256 - 1, 8).astype(int)]
    c256, n256 = to_dev(*_pack_streams([native.compress(b) for b in b256],
                                       F.compress_bound(bs256) + 8))
    d5 = K5.decompress_blocks_v6(c256, n256, bs256)
    e5.append(max(maxdiff(x, y) for x, y in zip(
        d5, K1.decompress_blocks_plain(c256, n256, bs256))))
    decodes_to(d5, b256, "K5 at 256 KiB")
    # the crafted streams in K5's small geometries (LSIC runs over their
    # stage bounds, each error late in the block, clen == slot)
    for osz in (4096, 8192, 12288):
        cc, cl = to_dev(*_pack_streams(
            [s for _, s in crafted_streams(osz, stage=k5_stage(osz))],
            F.compress_bound(osz) + 8))
        e5.append(max(maxdiff(x, y) for x, y in zip(
            K5.decompress_blocks_v6(cc, cl, osz),
            K1.decompress_blocks_plain(cc, cl, osz))))
    err5 = max(e5)
    need(err5 == 0, f"K5 differs from its plain version by {err5}")
    print(f"phase K7/K5 == plain: ok; K2 on all {nb} blocks of 4 KiB and on "
          f"{SUBSET4} of 8 KiB; K7 on {SUBSET4} blocks of 4 KiB (all "
          f"five outputs; also at acceleration 8), on 6 of 5,000 bytes and "
          f"2 of 64 KiB, and == K3 then K4 at seg 4096; K5 at 4 KiB, 8 KiB "
          f"and 256 KiB, and on the crafted streams at 4, 8 and 12 KiB "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 7: the golden contract ----
    t0 = time.perf_counter()
    gsel = np.linspace(0, nb - 1, GOLDEN4).astype(np.int64)
    gi = torch.from_numpy(gsel).to(dev)
    gblocks = [raw_np[j, :rlen_np[j]].tobytes() for j in gsel]
    gc, gl, ge, gt = (t.cpu().numpy() for t in compress_blocks_enc3(
        raw[gi], rlen[gi], BLOCK4, return_tails=True))
    dc, dl = compress_blocks_device(raw[gi], rlen[gi], BLOCK4)
    need(np.array_equal(dc.cpu().numpy(), gc)
         and np.array_equal(dl.cpu().numpy(), gl),
         "compress_blocks_device at 4 KiB differs from the enc3 engine")
    for j, b in enumerate(gblocks):
        want = golden.compress_dense(b, 1, hashlog=16)
        need(not ge[j] and gc[j, :gl[j]].tobytes() == want,
             f"4 KiB block {gsel[j]}: bytes differ from golden.compress_dense")
        need(int(gt[j]) == golden.tail_offset(want),
             f"4 KiB block {gsel[j]}: tail differs from golden.tail_offset")
    decodes_to(decompress_blocks_device(dc, dl, BLOCK4), gblocks,
               "v6 route at 4 KiB")

    cases = [("acceleration 8", BLOCK4, 8, gblocks[:8])]
    for bs in (5000, 60000):
        offs = np.linspace(0, len(data) - bs, 4).astype(int)
        edge = [b"", data[:1], data[:12], data[:13], data[:bs // 3]]
        cases.append((f"block size {bs}", bs, 1,
                      [data[o:o + bs] for o in offs] + edge))
    for what, bs, acc, blocks in cases:
        r, l = to_dev(*_batch(blocks, bs))
        c, n = compress_blocks_device(r, l, bs, acceleration=acc)
        cn, nn = c.cpu().numpy(), n.cpu().numpy()
        for j, b in enumerate(blocks):
            need(cn[j, :nn[j]].tobytes()
                 == golden.compress_dense(b, acc, hashlog=16),
                 f"{what}: block {j} differs from golden.compress_dense")
        decodes_to(decompress_blocks_device(c, n, bs), blocks,
                   f"{what}, routed decode")
        decodes_to(K5.decompress_blocks_v6(c, n, bs), blocks, f"{what}, K5")
    for bs, nblk in ((96 * 1024, 3), (196 * 1024, 2)):
        blocks = [data[j * bs:(j + 1) * bs] for j in range(nblk - 1)]
        blocks.append(data[:bs - 12345])
        r, l = to_dev(*_batch(blocks, bs))
        c, n = compress_blocks_device(r, l, bs)
        cn, nn = c.cpu().numpy(), n.cpu().numpy()
        for j, b in enumerate(blocks):
            need(cn[j, :nn[j]].tobytes() == golden.compress_segmented(b),
                 f"seg_splice at {bs}: block {j} differs from "
                 "golden.compress_segmented")
        decodes_to(decompress_blocks_device(c, n, bs), blocks,
                   f"seg_splice at {bs}, routed decode")
    print(f"phase golden 4 KiB: ok on {GOLDEN4} blocks with tails, "
          "acceleration 8, enc3 at 5000 and 60000 with edge blocks, "
          "seg_splice at 96 and 196 KiB "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 8: the 4 KiB main path, counters reset just before ----
    for m in mods.values():
        m.launches = 0
    stats = Stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    container = lz4_sgori_torch.compress(data, BLOCK4, stats=stats,
                                         device=DEVICE)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = lz4_sgori_torch.decompress(container, stats=stats, device=DEVICE)
    t_dec = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    need(back == data, "4 KiB main path round trip differs")
    need(stats.encode_fallbacks == 0,
         f"{stats.encode_fallbacks} host fallbacks on the 4 KiB path")
    check_launches(counts, "4 KiB", PATH4,
                   [k for k in mods if k not in PATH4])
    cb = B.CompressedBlocks.from_container(container)
    lz_native = 0
    for j in range(nb):
        blk = raw_np[j, :rlen_np[j]].tobytes()
        c = cb.comp[j, :cb.comp_len[j]].tobytes()
        need(native.decompress(c, BLOCK4) == blk,
             f"4 KiB block {j} fails the native decoder")
        if oracle.available():
            need(oracle.decompress(c, BLOCK4) == blk,
                 f"4 KiB block {j} fails liblz4")
        lz_native += len(native.compress(blk))
    print(f"4 KiB path: round trip ok, host fallbacks 0, launches {counts}")
    print(f"4 KiB path: native decode ok, liblz4 decode "
          f"{'ok' if oracle.available() else 'not run (liblz4 absent)'}")
    print(f"4 KiB path: ratio {len(data) / cb.compressed_size:.4f}, size "
          f"{cb.compressed_size / lz_native:.4f}x native "
          "LZ4_compress_default per 4 KiB block")
    print(f"4 KiB path wall: compress {t_enc:.3f} s "
          f"({len(data) / t_enc / 1e9:.4f} GB/s), decompress {t_dec:.3f} s "
          f"({len(data) / t_dec / 1e9:.4f} GB/s), host framing included")

    # ---- phase 9: bench.py's config-3 mix ----
    rng = np.random.RandomState(77)
    chunks = []
    for _ in range(MIX_CHUNKS):
        if rng.rand() < 0.5:
            chunks.append(np.zeros(BLOCK4, np.uint8))
        else:
            chunks.append(rng.randint(0, 256, BLOCK4).astype(np.uint8))
    mraw = np.stack(chunks)
    mr, ml = to_dev(mraw, np.full(MIX_CHUNKS, BLOCK4, np.int32))
    mc, mn = compress_blocks_device(mr, ml, BLOCK4)
    need(bool((mn > 0).all()), "config-3 mix: a block failed to encode")
    mo, mol, me = decompress_blocks_device(mc, mn, BLOCK4)
    need(not bool(me.any()) and torch.equal(mo, mr),
         "config-3 mix: the round trip differs")
    mix_ratio = mraw.size / int(mn.sum())
    need(round(mix_ratio, 4) == TPU_MIX_RATIO,
         f"config-3 mix ratio {mix_ratio:.4f} != {TPU_MIX_RATIO}")
    print(f"phase config-3 mix: ratio {mix_ratio:.4f} (TPU record of the "
          f"same bytes: {TPU_MIX_RATIO})")

    # ---- phase 10: the stores ----
    nreq = len(data) // BLOCK4
    with tempfile.TemporaryDirectory() as tmp:
        st = ST.ProxyStore(os.path.join(tmp, "backing.img"),
                           chunk_size=BLOCK4, capacity=nreq * BLOCK4,
                           device=DEVICE)
        lat = []
        t0 = time.perf_counter()
        for i in range(nreq):
            t1 = time.perf_counter()
            st.write(i * BLOCK4, data[i * BLOCK4:(i + 1) * BLOCK4])
            lat.append(time.perf_counter() - t1)
        t_store = time.perf_counter() - t0
        got = st.read(0, nreq * BLOCK4)
        need(hashlib.sha256(got).digest()
             == hashlib.sha256(data[:nreq * BLOCK4]).digest(),
             "ProxyStore read-back differs under sha256")
        w = st.stats.as_dict()["write"]
        need(w["reqs_total"] == nreq and w["reqs_failed"] == 0
             and st.stats.encode_fallbacks == 0,
             f"ProxyStore stats: {w}, fallbacks {st.stats.encode_fallbacks}")
        st.close()
        cst = ST.CompressedStore(os.path.join(tmp, "cstore"),
                                 chunk_size=BLOCK4, device=DEVICE)
        for i in range(STORE_CHUNKS_COMPRESSED):
            cst.write_chunk(i, data[i * BLOCK4:(i + 1) * BLOCK4])
        for i in range(STORE_CHUNKS_COMPRESSED):
            need(cst.read_chunk(i) == data[i * BLOCK4:(i + 1) * BLOCK4],
                 f"CompressedStore chunk {i} differs")
        need(cst.stats.encode_fallbacks == 0, "CompressedStore fell back")
        # the CLI's fio-style sweep over a 4 MiB file: every ported engine
        path = os.path.join(tmp, "sweep.bin")
        with open(path, "wb") as f:
            f.write(data[:4 << 20])
        for m in mods.values():
            m.launches = 0
        rc = cli.main(["--device", DEVICE, "verify", path, "--block-sizes",
                       "4", "8", "64", "96"])
        need(rc == 0, f"lz4j verify exited {rc}")
        cli_counts = {k: m.launches for k, m in mods.items()}
        check_launches(cli_counts, "CLI verify", SWEEP4, [])
    lat_ms = 1e3 * float(np.median(lat))
    print(f"phase store: ProxyStore {nreq} writes of 4 KiB, sha256 "
          f"read-back ok, 0 failed, 0 fallbacks; CompressedStore "
          f"{STORE_CHUNKS_COMPRESSED} chunks ok; lz4j verify at 4, 8, 64 "
          f"and 96 KiB ok, launches {cli_counts}")
    print(f"[{card}] ProxyStore.write of 4 KiB: median {lat_ms:.4f} ms, "
          f"p99 {1e3 * float(np.percentile(lat, 99)):.4f} ms, "
          f"{nreq * BLOCK4 / t_store / 1e9:.4f} GB/s over {nreq} sequential "
          "requests")

    # ---- phase 11: malformed 4 KiB streams through the v6 route ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(4321)
    bases = [cb.comp[j, :cb.comp_len[j]].tobytes()
             for j in range(0, nb, max(1, nb // 64))]
    muts = make_mutants(bases, rng, MUTANTS, slot4 - 8)
    uc, ul = to_dev(*_pack_streams(muts, slot4))
    uo, ull, ue = (t.cpu().numpy() for t in
                   decompress_blocks_device(uc, ul, BLOCK4))
    n_err = 0
    for j, m in enumerate(muts):
        try:
            want = golden.decompress(m, BLOCK4)
        except golden.DecodeError:
            want = None
        need(bool(ue[j]) == (want is None),
             f"4 KiB mutant {j}: err {bool(ue[j])} vs golden {want is None}")
        if want is None:
            n_err += 1
        else:
            need(ull[j] == len(want) and uo[j, :len(want)].tobytes() == want,
                 f"4 KiB mutant {j}: bytes differ from golden")
    print(f"phase malformed 4 KiB (v6 route): {len(muts)} mutants, {n_err} "
          f"rejected, err == golden for all "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 12: times ----
    ms_enc = time_ms(lambda: compress_blocks_device(raw, rlen, BLOCK4), 5)
    fc, fl = compress_blocks_device(raw, rlen, BLOCK4)
    ms_dec = time_ms(lambda: decompress_blocks_device(fc, fl, BLOCK4), 5)
    print(f"[{card}] 4 KiB kernel path over the corpus: encode "
          f"{ms_enc:.3f} ms ({len(data) / ms_enc / 1e6:.4f} GB/s), decode "
          f"{ms_dec:.3f} ms ({len(data) / ms_dec / 1e6:.4f} GB/s)")
    fcand = K2.dense_candidates(raw, rlen)
    old2, old7 = load_parent(K2, "cand"), load_parent(K7, "parse_enc3")
    old5 = load_parent(K5, "decode_v6")
    full = {"cand": against_parent(
                time_ms, K2, old2, lambda: K2.dense_candidates(raw, rlen), 5,
                f"K2 over config 3 ({nb} blocks of 4 KiB)", card),
            "parse_enc3": against_parent(
                time_ms, K7, old7,
                lambda: K7.parse_blocks_enc3(raw, fcand, rlen), 5,
                f"K7 over config 3 ({nb} blocks of 4 KiB)", card),
            "decode_v6": against_parent(
                time_ms, K5, old5,
                lambda: K5.decompress_blocks_v6(fc, fl, BLOCK4), 5,
                f"K5 over config 3 ({nb} blocks of 4 KiB)", card)}
    r1, l1 = raw[:1].contiguous(), rlen[:1].contiguous()
    against_parent(time_ms, K2, old2, lambda: K2.dense_candidates(r1, l1),
                   20, "K2 on one block of 4 KiB", card)
    c1 = fcand[:1].contiguous()
    against_parent(time_ms, K7, old7,
                   lambda: K7.parse_blocks_enc3(r1, c1, l1), 20,
                   "K7 on one block of 4 KiB", card)
    f1, n1 = fc[:1].contiguous(), fl[:1].contiguous()
    against_parent(time_ms, K5, old5,
                   lambda: K5.decompress_blocks_v6(f1, n1, BLOCK4), 20,
                   "K5 on one block of 4 KiB", card)
    if old2 is not None:
        # a 4 KiB write's latency with this tree's K2 and the parent's
        def store_median():
            with tempfile.TemporaryDirectory() as tmp:
                st = ST.ProxyStore(os.path.join(tmp, "turns.img"),
                                   chunk_size=BLOCK4,
                                   capacity=STORE_TURNS * BLOCK4,
                                   device=DEVICE)
                lat = []
                for i in range(STORE_TURNS):
                    t1 = time.perf_counter()
                    st.write(i * BLOCK4, data[i * BLOCK4:(i + 1) * BLOCK4])
                    lat.append(time.perf_counter() - t1)
                st.close()
            return 1e3 * float(np.median(lat))
        own, parent, parent7 = turns(store_median,
                                     with_kernel(K2, old2, store_median),
                                     with_kernel(K7, old7, store_median))
        print(f"[{card}] ProxyStore.write of 4 KiB, the median of "
              f"{STORE_TURNS} requests in turns (this, parent K2, parent "
              f"K7, parent K7, parent K2, this): {own:.4f} ms, with the "
              f"parent's K2 {parent:.4f} ms, with the parent's K7 "
              f"{parent7:.4f} ms")
    print(f"[{card}] kernels over the 4 KiB corpus (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in full.items()))
    sub_times = {
        "cand": (time_ms(lambda: K2.dense_candidates(rs, ls), 10),
                 time_ms(lambda: K2.dense_candidates_plain(rs, ls), 3)),
        "parse_enc3": (time_ms(lambda: K7.parse_blocks_enc3(rs, cs, ls), 10),
                       time_ms(lambda: K7.parse_blocks_enc3_plain(rs, cs, ls),
                               1)),
        "decode_v6": (time_ms(lambda: K5.decompress_blocks_v6(
            k7[0], k7[1], BLOCK4), 10),
            time_ms(lambda: K1.decompress_blocks_plain(
                k7[0], k7[1], BLOCK4), 3)),
    }
    for k, (a, b) in sub_times.items():
        print(f"[{card}] {k} on {SUBSET4} blocks of 4 KiB: kernel {a:.4f} "
              f"ms, plain {b:.4f} ms")
    del sub_times["cand"]       # the record keeps K2's 64 KiB subset times
    sub_times["parse_enc3"] += (parse_bytes((rs, cs, ls), k7),)
    sub_times["decode_v6"] += (decode_bytes(k7[1], K5.decompress_blocks_v6(
        k7[0], k7[1], BLOCK4)),)
    return {"errs": {"cand": err2, "parse_enc3": err7, "decode_v6": err5},
            "counts": counts, "sub_times": sub_times}


def _smoke_big(torch, card: str, time_ms, maxdiff, mods) -> dict:
    """Phases 13-19: the big-block path (128 KiB-4 MiB; engines seg_big
    and v8, with v7 and v6 at 128 and 256 KiB; kernels K9, K3, K4 and K6).
    Returns the per-kernel errors, launch counts and subset times of K6
    and K9 for the record."""
    import hashlib
    import tempfile

    import lz4_sgori_torch
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch import cli
    from lz4_sgori_torch import format as F
    from lz4_sgori_torch import native
    from lz4_sgori_torch import routing as R
    from lz4_sgori_torch import store as ST
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.ops import seg as S
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    from lz4_sgori_torch.ops.kernels import asm_seg as K4
    from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
    from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
    from lz4_sgori_torch.ops.kernels import lockstep_v8 as K6
    from lz4_sgori_torch.ops.kernels import parse_seg as K3
    from lz4_sgori_torch.utils import oracle
    from lz4_sgori_torch.utils.stats import Stats

    dev = torch.device(DEVICE)
    bs = BIG_BLOCK
    seg = R.seg_for(bs)
    top = BIG_SIZES[-1]
    slot = F.compress_bound(bs) + 8

    def to_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    t0 = time.perf_counter()
    data = _synth_corpus(BIG_CORPUS_BYTES, seed=BIG_SEED)
    raw_np, rlen_np = B.split_blocks(data, bs)
    raw, rlen = to_dev(raw_np, rlen_np)
    nb = raw.shape[0]
    print(f"big corpus: {len(data)} bytes, {nb} blocks of {bs} (seed "
          f"{BIG_SEED}, {time.perf_counter() - t0:.1f} s to make)")

    with golden_pool() as pool:
        # ---- phase 13: K9 and K6 against their plain versions ----
        t0 = time.perf_counter()
        sub = torch.arange(0, nb, max(1, nb // BIG_SUBSET),
                           device=dev)[:BIG_SUBSET]
        rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
        psel = sub.tolist()[:2]
        gpw = [pool.submit(_golden_call, ("dense_candidates_piecewise",
                                          raw_np[j, :rlen_np[j]].tobytes(),
                                          {})) for j in psel]
        c9 = K9.dense_candidates_piecewise(rs, ls)
        r4m, l4m = to_dev(*_batch([data[:top]], top))
        # an all-zero block (one bucket, one warp's steps) and a short one
        rz, lz = to_dev(*_batch([bytes(bs), data[bs:2 * bs - 12345]], bs))
        err9 = max(maxdiff(c9, K9.dense_candidates_piecewise_plain(rs, ls)),
                   maxdiff(K9.dense_candidates_piecewise(r4m, l4m),
                           K9.dense_candidates_piecewise_plain(r4m, l4m)),
                   maxdiff(K9.dense_candidates_piecewise(rz, lz),
                           K9.dense_candidates_piecewise_plain(rz, lz)),
                   maxdiff(K9.dense_candidates_piecewise(rs[:1], ls[:1], 4096),
                           K9.dense_candidates_piecewise_plain(
                               rs[:1], ls[:1], 4096)))
        need(err9 == 0, f"K9 differs from its plain version by {err9}")
        # K3 on two of the blocks at seg 8192 (a CTA a segment, reading
        # older match sources from the row), acceleration 1 and 8
        r2, l2, c2 = rs[:2].contiguous(), ls[:2].contiguous(), \
            c9[:2].contiguous()
        err3 = max(segment_diff(
            torch, maxdiff, K3.parse_segments(r2, c2, l2, seg=seg, accel=a),
            K3.parse_segments_plain(r2, c2, l2, seg=seg, accel=a),
            f"K3 at {bs}, seg {seg}, acceleration {a}") for a in (1, 8))
        c9n = c9.cpu().numpy()
        for i, f in enumerate(gpw):
            w = np.asarray(f.result(), np.int64)
            need(np.array_equal(c9n[i, :len(w)], w)
                 and not c9n[i, len(w):].any(),
                 f"K9 block {psel[i]} differs from "
                 "golden.dense_candidates_piecewise")
        e6 = []
        k6_in = {}
        for dbs, nblk in ((524288, 4), (bs, BIG_SUBSET), (top, 2)):
            offs = np.linspace(0, len(data) - dbs, nblk).astype(int)
            blocks = [data[o:o + dbs] for o in offs]
            blocks[-1] = blocks[-1][:dbs - 12345]      # a short block
            c, n = to_dev(*_pack_streams([native.compress(b) for b in blocks],
                                         F.compress_bound(dbs) + 8))
            d6 = K6.decompress_blocks_v8(c, n, dbs)
            e6.append(max(maxdiff(x, y) for x, y in zip(
                d6, K1.decompress_blocks_plain(c, n, dbs))))
            decodes_to(d6, blocks, f"K6 at {dbs}")
            k6_in[dbs] = (c, n)
            # the crafted streams: the rings' wraps and stage bounds, each
            # error of the safe decoder late in a long stream
            named = crafted_streams(dbs)
            c, n = to_dev(*_pack_streams([b for _, b in named],
                                         F.compress_bound(dbs) + 8))
            d6 = K6.decompress_blocks_v8(c, n, dbs)
            for j, (x, y) in enumerate(zip(
                    d6, K1.decompress_blocks_plain(c, n, dbs))):
                e6.append(maxdiff(x, y))
            need(not bool(d6[2][0]) and bool(d6[2][1:].all()),
                 f"K6 at {dbs}: the crafted streams' verdicts are wrong")
        err6 = max(e6)
        need(err6 == 0, f"K6 differs from its plain version by {err6}")
        print(f"phase K9/K6 == plain: ok; K9 on {BIG_SUBSET} blocks of {bs} "
              f"and one of {top}, an all-zero and a short ({bs - 12345} "
              f"bytes) block, piece 4096 on a block of {bs} (runs of "
              f"{K9.run_length(BIG_SUBSET, bs)}, "
              f"{K9.run_length(1, top)} and "
              f"{K9.run_length(1, bs, 4096)} half-pieces a CTA), == golden "
              f"on {len(psel)}; K3 on 2 blocks "
              f"of {bs} at seg {seg}, acceleration 1 and 8; K6 at 524288, "
              f"{bs} and {top} on native.compress streams and on "
              f"{len(named)} crafted streams each "
              f"({time.perf_counter() - t0:.1f} s)")

        # ---- phase 14: the golden contract of seg_big ----
        t0 = time.perf_counter()
        jobs = []
        for gbs, acc in [(g, 1) for g in BIG_SIZES] + [(bs, 8)]:
            o = 2 * gbs if acc > 1 else 0
            blocks = [data[o:o + gbs], data[o + gbs:o + 2 * gbs - 12345]]
            futs = [pool.submit(_golden_call, (
                "compress_dense_seg_big", b,
                {"seg": R.seg_for(gbs), "acceleration": acc}))
                for b in blocks]
            r, l = to_dev(*_batch(blocks, gbs))
            need(R.select_encode_engine(gbs, 1) == "seg_big",
                 f"{gbs} does not route to seg_big")
            c, n = compress_blocks_device(r, l, gbs, acceleration=acc)
            decodes_to(decompress_blocks_device(c, n, gbs), blocks,
                       f"seg_big at {gbs}, acceleration {acc}, routed "
                       f"decode ({R.select_decode_engine(gbs)})")
            jobs.append((gbs, acc, c.cpu().numpy(), n.cpu().numpy(), futs))
        for gbs, acc, cn, nn, futs in jobs:
            for j, f in enumerate(futs):
                need(cn[j, :nn[j]].tobytes() == f.result(),
                     f"seg_big at {gbs}, acceleration {acc}: block {j} "
                     "differs from golden.compress_dense_seg_big")
        print(f"phase golden big: seg_big == golden.compress_dense_seg_big "
              f"at {', '.join(str(g) for g in BIG_SIZES)} (a full and a "
              f"short block each) and acceleration 8 at {bs}; routed "
              f"decodes ok ({time.perf_counter() - t0:.1f} s)")

        # ---- phase 15: config 6, counters reset just before ----
        for m in mods.values():
            m.launches = 0
        stats = Stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        container = lz4_sgori_torch.compress(data, bs, stats=stats,
                                             device=DEVICE)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = lz4_sgori_torch.decompress(container, stats=stats,
                                          device=DEVICE)
        t_dec = time.perf_counter() - t0
        counts = {k: m.launches for k, m in mods.items()}
        need(back == data, "config 6 round trip differs")
        need(stats.encode_fallbacks == 0,
             f"{stats.encode_fallbacks} host fallbacks on config 6")
        check_launches(counts, "big-block", PATHBIG,
                       [k for k in mods if k not in PATHBIG])
        t0 = time.perf_counter()
        cb = B.CompressedBlocks.from_container(container)
        gsel = np.linspace(0, nb - 1, BIG_GOLDEN).astype(np.int64)
        gfut = [pool.submit(_golden_call, (
            "compress_dense_seg_big", raw_np[j, :rlen_np[j]].tobytes(),
            {"seg": seg})) for j in gsel]
        lz_native = lz_lib = 0
        for j in range(nb):
            blk = raw_np[j, :rlen_np[j]].tobytes()
            c = cb.comp[j, :cb.comp_len[j]].tobytes()
            need(native.decompress(c, bs) == blk,
                 f"config 6 block {j} fails the native decoder")
            if oracle.available():
                need(oracle.decompress(c, bs) == blk,
                     f"config 6 block {j} fails liblz4")
                lz_lib += len(oracle.compress(blk))
            lz_native += len(native.compress(blk))
        for j, f in zip(gsel, gfut):
            need(cb.comp[j, :cb.comp_len[j]].tobytes() == f.result(),
                 f"config 6 block {j} differs from "
                 "golden.compress_dense_seg_big")
        ratio = len(data) / cb.compressed_size
        vs_lz4 = cb.compressed_size / lz_native
        print(f"config 6: round trip ok, host fallbacks 0, launches {counts}")
        print(f"config 6: native decode ok, liblz4 decode "
              f"{'ok' if oracle.available() else 'not run (liblz4 absent)'}"
              f", {BIG_GOLDEN} blocks == golden.compress_dense_seg_big "
              f"({time.perf_counter() - t0:.1f} s)")
        print(f"config 6: ratio {ratio:.4f}, size {vs_lz4:.4f}x native "
              "LZ4_compress_default"
              + (f" ({cb.compressed_size / lz_lib:.4f}x liblz4)" if lz_lib
                 else "")
              + f" (TPU record of the same bytes: ratio "
              f"{TPU_BIG_RECORD['ratio']}, {TPU_BIG_RECORD['size_vs_lz4']}x)")
        need(round(ratio, 4) == TPU_BIG_RECORD["ratio"]
             and round(vs_lz4, 4) == TPU_BIG_RECORD["size_vs_lz4"],
             f"config 6 ratio {ratio:.4f} / size {vs_lz4:.4f} differ from "
             "the TPU record of the same bytes")
        print(f"[{card}] config 6 wall: compress {t_enc:.3f} s "
              f"({len(data) / t_enc / 1e9:.4f} GB/s), decompress "
              f"{t_dec:.3f} s ({len(data) / t_dec / 1e9:.4f} GB/s), host "
              "framing included")

        # ---- phases 16-17: fio-shaped stores and the CLI's sweep ----
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            for chunk, nreq in BIG_STORE_RUNS:
                st = ST.ProxyStore(os.path.join(tmp, f"backing{chunk}.img"),
                                   chunk_size=chunk, capacity=chunk * nreq,
                                   device=DEVICE)
                lat = []
                for i in range(nreq):
                    t1 = time.perf_counter()
                    st.write(i * chunk, data[i * chunk:(i + 1) * chunk])
                    lat.append(time.perf_counter() - t1)
                got = st.read(0, nreq * chunk)
                need(hashlib.sha256(got).digest()
                     == hashlib.sha256(data[:nreq * chunk]).digest(),
                     f"ProxyStore({chunk}) read-back differs under sha256")
                w = st.stats.as_dict()["write"]
                need(w["reqs_total"] == nreq and w["reqs_failed"] == 0
                     and st.stats.encode_fallbacks == 0,
                     f"ProxyStore({chunk}) stats: {w}, fallbacks "
                     f"{st.stats.encode_fallbacks}")
                st.close()
                print(f"[{card}] ProxyStore.write of {chunk} bytes: median "
                      f"{1e3 * float(np.median(lat)):.4f} ms, p99 "
                      f"{1e3 * float(np.percentile(lat, 99)):.4f} ms, max "
                      f"{1e3 * max(lat):.4f} ms over {nreq} sequential "
                      "requests; sha256 read-back ok, 0 failed, 0 fallbacks")
            path = os.path.join(tmp, "sweep.bin")
            with open(path, "wb") as f:
                f.write(data[:SWEEP_BYTES])
            for m in mods.values():
                m.launches = 0
            rc = cli.main(["--device", DEVICE, "verify", path])
            need(rc == 0, f"lz4j verify (default sweep) exited {rc}")
            cli_counts = {k: m.launches for k, m in mods.items()}
            unrouted = DEEP_ONLY + MLEN_ONLY + PATHRETIRED \
                + path_probes(mods)
            check_launches(cli_counts, "CLI default verify",
                           [k for k in mods if k not in unrouted], unrouted)
        print(f"phase big stores and sweep: lz4j verify's default sweep "
              f"(4 KiB-4 MiB) over {SWEEP_BYTES} bytes ok, launches "
              f"{cli_counts} ({time.perf_counter() - t0:.1f} s)")

        # ---- phase 18: malformed 1 MiB streams through the v8 route ----
        t0 = time.perf_counter()
        need(R.select_decode_engine(bs) == "v8", f"{bs} does not route to v8")
        rng = np.random.default_rng(8765)
        bases = [cb.comp[j, :cb.comp_len[j]].tobytes()
                 for j in range(0, nb, max(1, nb // 16))]
        muts = make_mutants(bases, rng, BIG_MUTANTS, slot - 8)
        verdicts = pool.map(_golden_verdict, [(m, bs) for m in muts],
                            chunksize=8)
        uc, ul = to_dev(*_pack_streams(muts, slot))
        uo, ull, ue = (t.cpu().numpy() for t in
                       decompress_blocks_device(uc, ul, bs))
        n_err = 0
        for j, want in enumerate(verdicts):
            need(bool(ue[j]) == (want is None),
                 f"1 MiB mutant {j}: err {bool(ue[j])} vs golden "
                 f"{want is None}")
            if want is None:
                n_err += 1
            else:
                need((int(ull[j]), hashlib.sha256(
                    uo[j, :ull[j]].tobytes()).digest()) == want,
                     f"1 MiB mutant {j}: bytes differ from golden")
        print(f"phase malformed 1 MiB (v8 route): {len(muts)} mutants, "
              f"{n_err} rejected, err == golden for all "
              f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 19: times ----
    ms_enc = time_ms(lambda: compress_blocks_device(raw, rlen, bs), 3)
    fc, fl = compress_blocks_device(raw, rlen, bs)
    ms_dec = time_ms(lambda: decompress_blocks_device(fc, fl, bs), 3)
    print(f"[{card}] config 6 kernel path over {len(data)} bytes: encode "
          f"{ms_enc:.3f} ms ({len(data) / ms_enc / 1e6:.4f} GB/s), decode "
          f"{ms_dec:.3f} ms ({len(data) / ms_dec / 1e6:.4f} GB/s)")
    fcand = K9.dense_candidates_piecewise(raw, rlen)
    old9 = load_parent(K9, "cand_piecewise")
    full = {"cand_piecewise": against_parent(
                time_ms, K9, old9,
                lambda: K9.dense_candidates_piecewise(raw, rlen), 3,
                f"K9 over config 6 ({nb} blocks of {bs}, runs of "
                f"{K9.run_length(nb, bs)} half-pieces)", card),
            "parse_seg": against_parent(
                time_ms, K3, load_parent(K3, "parse_seg"),
                lambda: K3.parse_segments(raw, fcand, rlen, seg=seg), 3,
                f"K3 over config 6 ({nb} blocks of {bs}, seg {seg})", card,
                same_parse(torch, maxdiff)),
            "decode_v8": ms_dec}
    a4 = S.assembly_inputs(raw, rlen, bs, seg=seg)[:5]
    full["asm_seg"] = against_parent(
        time_ms, K4, load_parent(K4, "asm_seg"),
        lambda: K4.assemble_segments(*a4), 3,
        f"K4 over config 6 ({nb} blocks of {bs}, seg {seg})", card)
    del a4
    print(f"[{card}] kernels over config 6 (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in full.items()))
    c1, n1 = k6_in[bs]
    c4, n4 = k6_in[top]
    sub_times = {
        "cand_piecewise": (
            time_ms(lambda: K9.dense_candidates_piecewise(rs, ls), 10),
            time_ms(lambda: K9.dense_candidates_piecewise_plain(rs, ls), 3)),
        "decode_v8": (time_ms(lambda: K6.decompress_blocks_v8(c1, n1, bs), 5),
                      time_ms(lambda: K1.decompress_blocks_plain(c1, n1, bs),
                              1)),
    }
    for k, (a, b) in sub_times.items():
        print(f"[{card}] {k} on {BIG_SUBSET} blocks of {bs}: kernel {a:.4f} "
              f"ms, plain {b:.4f} ms")
    sub_times["cand_piecewise"] += (tensor_bytes(rs, ls, c9),)
    sub_times["decode_v8"] += (decode_bytes(n1, K6.decompress_blocks_v8(
        c1, n1, bs)),)
    print(f"[{card}] at {top}: K6 on two blocks "
          f"{time_ms(lambda: K6.decompress_blocks_v8(c4, n4, top), 3):.4f}"
          " ms")
    # K9 on one block of 1 MiB and one of 4 MiB (a single request), and
    # the fio-shaped stores' write medians, in turns with the parent's K9
    r1, l1 = rs[:1].contiguous(), ls[:1].contiguous()
    for what, (r, l) in ((f"one block of {bs}", (r1, l1)),
                         (f"one block of {top}", (r4m, l4m))):
        against_parent(time_ms, K9, old9,
                       lambda r=r, l=l: K9.dense_candidates_piecewise(r, l),
                       10, f"K9 on {what} (runs of "
                       f"{K9.run_length(1, r.shape[1])} half-pieces)", card)
    if old9 is not None:
        for chunk, nreq in BIG_STORE_RUNS:
            def own(chunk=chunk, nreq=nreq):
                return store_median(data, chunk, nreq)
            readings = [f() for f in (own, with_kernel(K9, old9, own),
                                      with_kernel(K9, old9, own), own)]
            print(f"[{card}] ProxyStore.write of {chunk} bytes, the median "
                  f"of {nreq} requests in turns (this, parent, parent, "
                  f"this): this {readings[0]:.4f} {readings[3]:.4f} ms, "
                  f"with the parent's K9 {readings[1]:.4f} "
                  f"{readings[2]:.4f} ms")
    # K6 on one block and over config 6, in turns with the parent's
    old6 = load_parent(K6, "decode_v8")
    for what, (c, n), size, reps in (
            (f"one block of {bs}", k6_in[bs], bs, 5),
            (f"one block of {top}", k6_in[top], top, 3),
            (f"config 6 ({fc.shape[0]} blocks of {bs})", (fc, fl), bs, 3)):
        c, n = c[:1 if "one" in what else None].contiguous(), \
            n[:1 if "one" in what else None].contiguous()
        against_parent(time_ms, K6, old6,
                       lambda c=c, n=n, size=size:
                       K6.decompress_blocks_v8(c, n, size), reps,
                       f"K6 on {what}", card)
    return {"errs": {"cand_piecewise": err9, "decode_v8": err6,
                     "parse_seg": err3},
            "counts": counts, "sub_times": sub_times}


def _smoke_deep(torch, card: str, time_ms, maxdiff, mods) -> dict:
    """Phases 20-24: the deep match modes (K8) on bench.py's config 5
    (128 MiB, seed 1234, 64 KiB blocks: depth 3 on seg, then depth 5 on
    enc3 over the first 8 MiB; kernels K2, gaps, K8-seg, K8-enc3, K4 and
    K1). Returns the per-kernel errors, launch counts (both runs) and
    subset times of the gaps kernel and both K8 parses for the record."""
    import hashlib
    import tempfile
    import warnings

    import lz4_sgori_torch
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch import cli
    from lz4_sgori_torch import native
    from lz4_sgori_torch import routing as R
    from lz4_sgori_torch import store as ST
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    from lz4_sgori_torch.ops.kernels import cand as K2
    from lz4_sgori_torch.ops.kernels import cand_piecewise as K9
    from lz4_sgori_torch.ops.kernels import gaps as G
    from lz4_sgori_torch.ops.kernels import parse_enc3_deep as K8E
    from lz4_sgori_torch.ops.kernels import parse_seg as K3
    from lz4_sgori_torch.ops.kernels import parse_seg_deep as K8S
    from lz4_sgori_torch.utils import oracle
    from lz4_sgori_torch.utils.stats import Stats

    dev = torch.device(DEVICE)
    bs = DEEP_BLOCK

    def to_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def spread(n, size, short=777):
        """``n`` blocks of ``size`` spread over the corpus, the last one
        short."""
        offs = np.linspace(0, len(data) - size, n).astype(int)
        blocks = [data[o:o + size] for o in offs]
        blocks[-1] = blocks[-1][:size - short]
        return blocks

    t0 = time.perf_counter()
    data = _synth_corpus(DEEP_CORPUS_BYTES, seed=DEEP_SEED)
    raw_np, rlen_np = B.split_blocks(data, bs)
    raw, rlen = to_dev(raw_np, rlen_np)
    nb = raw.shape[0]
    print(f"deep corpus: {len(data)} bytes, {nb} blocks of {bs} (seed "
          f"{DEEP_SEED}, {time.perf_counter() - t0:.1f} s to make)")

    with golden_pool() as pool:
        # ---- phase 20: gaps, K8-seg and K8-enc3 against their plain
        # versions ----
        t0 = time.perf_counter()
        sub = torch.arange(0, nb, nb // DEEP_SUBSET, device=dev)[:DEEP_SUBSET]
        rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
        gsub = [raw_np[j, :rlen_np[j]].tobytes() for j in sub.tolist()[:2]]
        tape_jobs = [(name, i, pool.submit(_golden_call,
                                           (name, b, {"hashlog": 16})))
                     for name in ("dense_gaps", "dense_gaps2")
                     for i, b in enumerate(gsub)]
        piece_job = pool.submit(_golden_call, (
            "dense_candidates_piecewise", data[:1 << 20],
            {"with_gaps": True}))
        cs = K2.dense_candidates(rs, ls)
        gk, g2k = G.chain_gaps(cs, 4)
        g3k, none = G.chain_gaps(cs, 2)
        gp, g2p = G.chain_gaps_plain(cs, 4)
        need(none is None, "the gaps wrapper returned gaps2 at links 2")
        errg = max(maxdiff(gk, gp), maxdiff(g2k, g2p), maxdiff(g3k, gp))
        rm, lm = to_dev(*B.split_blocks(data[:4 << 20], 1 << 20))
        c9 = K9.dense_candidates_piecewise(rm, lm)
        pwk, _ = G.chain_gaps(c9, 2, K9.PIECE // 2)
        errg = max(errg, maxdiff(pwk, G.chain_gaps_plain(
            c9, 2, K9.PIECE // 2)[0]))
        # hand-made tapes (links of 0, 254, 255, negative, past bs, far;
        # K9's ties and chains ending at the floor): 64 KiB blocks at 4
        # links, 1 MiB with half (K9's floor, one division a quad) and
        # without, 70,000 blocks of 16 (the grid's block index)
        for hn, hbs, half, links in ((3, bs, 0, 4), (2, 1 << 20,
                                                     K9.PIECE // 2, 2),
                                     (1, 1 << 20, 0, 4), (70000, 16, 0, 4)):
            ht = torch.from_numpy(hand_gaps_tape(hn, hbs, half,
                                                 seed=hbs)).to(dev)
            got = G.chain_gaps(ht, links, half)
            for a, b in zip(got, G.chain_gaps_plain(ht, links, half)):
                errg = max(errg, maxdiff(a, b) if a is not None else 0)
        need(errg == 0, f"gaps differs from its plain version by {errg}")
        tapes = {"dense_gaps": gk.cpu().numpy(),
                 "dense_gaps2": g2k.cpu().numpy()}
        for name, i, f in tape_jobs:
            w = np.asarray(f.result(), np.int64)
            need(np.array_equal(tapes[name][i, :len(w)], w)
                 and not tapes[name][i, len(w):].any(),
                 f"gaps: subset block {i} differs from golden.{name}")
        need(np.array_equal(pwk[0].cpu().numpy(),
                            np.asarray(piece_job.result()[1], np.int64)),
             "gaps over K9's tape differs from golden."
             "dense_candidates_piecewise(with_gaps=True)")

        # K8-enc3 on 64 blocks of 4 KiB and on 8 of 64 KiB with a random
        # and an all-zero block; its plain version on all 64 and on 4 of
        # the 10 (the first, the short last one, the random and the zero
        # block): at 64 KiB it steps for tens of seconds a call, so it
        # runs once (acceleration 8: the card tests)
        err8e = 0
        enc3_in = {}
        enc3_plain_ms = {}
        noise = np.random.default_rng(20).integers(0, 256, bs, np.uint8)
        for ebs, nblk, rows in ((4096, 64, range(64)),
                                (bs, 8, (0, 7, 8, 9))):
            blocks = spread(nblk, ebs)
            if ebs == bs:
                blocks += [noise.tobytes(), bytes(bs)]
            r, l = to_dev(*_batch(blocks, ebs))
            c = K2.dense_candidates(r, l)
            sel = torch.tensor(list(rows), device=dev)
            for depth in (3, 5):
                g, g2 = G.chain_gaps(c, 4 if depth == 5 else 2)
                k = K8E.parse_blocks_enc3_deep(r, c, g, g2, l, depth=depth)
                need(not bool(k[2].any()),
                     f"K8-enc3 flagged a block at {ebs}, depth {depth}")
                sub = [t[sel].contiguous() if t is not None else None
                       for t in (r, c, g, g2, l)]
                ks = K8E.parse_blocks_enc3_deep(*sub, depth=depth)
                p, enc3_plain_ms[ebs, depth] = timed_once(
                    torch, lambda: K8E.parse_blocks_enc3_deep_plain(
                        *sub, depth=depth))
                err8e = max(err8e, max(maxdiff(a, b) for a, b in zip(ks, p)),
                            max(maxdiff(a[sel], b) for a, b in zip(k, ks)))
                enc3_in[ebs, depth] = (*sub, ks)
        need(err8e == 0, f"K8-enc3 differs from its plain version by "
                         f"{err8e}")
        # K8-seg at seg 4096 on those 64 blocks of 4 KiB and 4 of 64 KiB
        # (the first, the short last one, a random and a zero block), and
        # at seg 8192 on 2 blocks of 1 MiB over K9's tape and its floored
        # gaps, acceleration 1 and 8; each plain parse runs once
        seg_cases = {}
        for ebs in (4096, bs):
            r, c, g, _, l, _ = enc3_in[ebs, 3]
            seg_cases[f"{r.shape[0]} blocks of {ebs}"] = (r, c, g, l, 4096, 1)
        big2 = [t[:2].contiguous() for t in (rm, c9, pwk, lm)]
        for a in (1, 8):
            seg_cases[f"2 blocks of {1 << 20} at seg 8192, acceleration "
                      f"{a}"] = (*big2, 8192, a)
        err8s, seg_plain_ms, seg_out = 0, {}, {}
        for what, (r, c, g, l, sg, a) in seg_cases.items():
            seg_out[what] = K8S.parse_segments_deep(r, c, g, l, seg=sg,
                                                    accel=a)
            p, seg_plain_ms[what] = timed_once(
                torch, lambda: K8S.parse_segments_deep_plain(
                    r, c, g, l, seg=sg, accel=a))
            err8s = max(err8s, segment_diff(torch, maxdiff, seg_out[what], p,
                                            f"K8-seg on {what}"))
        print(f"phase gaps/K8 == plain: ok; gaps (links 2 and 4) on "
              f"{DEEP_SUBSET} blocks of {bs} and == golden on 2, over K9's "
              f"tape on 4 blocks of 1 MiB and == golden on 1, on hand-made "
              f"tapes (3 of {bs}, 1 MiB with and without half, 70,000 of "
              f"16); K8-seg on "
              + ", ".join(seg_cases) + "; K8-enc3 at 4096 (64 blocks) and "
              f"{bs} (8 blocks, a random and a zero block, 4 against the "
              f"plain version), depth 3 and 5; the plain parses once each, "
              "ms: K8-seg "
              + ", ".join(f"{k} {v:.1f}" for k, v in seg_plain_ms.items())
              + ", K8-enc3 "
              + ", ".join(f"{b} depth {d} {v:.1f}"
                          for (b, d), v in enc3_plain_ms.items())
              + f" ({time.perf_counter() - t0:.1f} s)")

        # ---- phase 21: the golden contract of each deep row ----
        t0 = time.perf_counter()
        seg_kw = {"seg": 4096, "window": 65536, "hashlog": 16, "depth": 3}
        cases = [
            ("seg", bs, 3, 1, spread(4, bs), "compress_dense_seg", seg_kw),
            ("seg", 16384, 2, 8, spread(4, 16384), "compress_dense_seg",
             {**seg_kw, "acceleration": 8}),
            ("seg_big", 1 << 20, 3, 1, spread(2, 1 << 20),
             "compress_dense_seg_big", {"seg": R.seg_for(1 << 20),
                                        "depth": 3}),
            ("enc3", 4096, 3, 1, spread(8, 4096), "compress_deep",
             {"hashlog": 16, "depth": 3}),
            ("enc3", 5000, 3, 8, spread(4, 5000) + [b"", data[:13]],
             "compress_deep", {"acceleration": 8, "hashlog": 16,
                               "depth": 3}),
            ("enc3", bs, 5, 1, spread(2, bs), "compress_deep",
             {"hashlog": 16, "depth": 5}),
            ("seg_splice", 96 * 1024, 3, 1, spread(2, 96 * 1024),
             "compress_segmented", {}),
        ]
        jobs = []
        for engine, cbs, md, acc, blocks, fn, kw in cases:
            need(R.select_encode_engine(cbs, md) == engine,
                 f"{cbs} at depth {md} does not route to {engine}")
            futs = [pool.submit(_golden_call, (fn, b, kw)) for b in blocks]
            r, l = to_dev(*_batch(blocks, cbs))
            with warnings.catch_warnings(record=True) as warned:
                warnings.simplefilter("always")
                c, n = compress_blocks_device(r, l, cbs, match_depth=md,
                                              acceleration=acc)
            capped = R.encode_depth_cap(engine, md) < md
            need(capped == any("depth cap" in str(w.message)
                               for w in warned),
                 f"{engine} at depth {md}: the depth-cap warning is wrong")
            decodes_to(decompress_blocks_device(c, n, cbs), blocks,
                       f"{engine} at {cbs}, depth {md}, routed decode")
            jobs.append((engine, cbs, md, c.cpu().numpy(), n.cpu().numpy(),
                         fn, futs))
        for engine, cbs, md, cn, nn, fn, futs in jobs:
            for j, f in enumerate(futs):
                need(cn[j, :nn[j]].tobytes() == f.result(),
                     f"{engine} at {cbs}, depth {md}: block {j} differs "
                     f"from golden.{fn}")
        print(f"phase golden deep: seg at 64 KiB (depth 3) and 16 KiB "
              f"(depth 2, acceleration 8), seg_big at 1 MiB, enc3 at 4096 "
              f"and 5000 (acceleration 8) at depth 3 and at 64 KiB at depth "
              f"5, and seg_splice capped at depth 1 with its warning, equal "
              f"golden; routed decodes ok ({time.perf_counter() - t0:.1f} s)")

        # ---- phase 22: config 5, counters reset just before each run ----
        def main_run(payload, depth, path, label):
            for m in mods.values():
                m.launches = 0
            stats = Stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            container = lz4_sgori_torch.compress(payload, bs, stats=stats,
                                                 match_depth=depth,
                                                 device=DEVICE)
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = lz4_sgori_torch.decompress(container, stats=stats,
                                              device=DEVICE)
            t_dec = time.perf_counter() - t0
            counts = {k: m.launches for k, m in mods.items()}
            need(back == payload, f"{label} round trip differs")
            need(stats.encode_fallbacks == 0,
                 f"{stats.encode_fallbacks} host fallbacks on {label}")
            check_launches(counts, label, path,
                           [k for k in mods if k not in path])
            cb = B.CompressedBlocks.from_container(container)
            lz_native = lz_lib = 0
            for j in range(cb.num_blocks):
                blk = payload[j * bs:(j + 1) * bs]
                c = cb.comp[j, :cb.comp_len[j]].tobytes()
                need(native.decompress(c, bs) == blk,
                     f"{label} block {j} fails the native decoder")
                if oracle.available():
                    need(oracle.decompress(c, bs) == blk,
                         f"{label} block {j} fails liblz4")
                    lz_lib += len(oracle.compress(blk))
                lz_native += len(native.compress(blk))
            ratio = len(payload) / cb.compressed_size
            vs_native = cb.compressed_size / lz_native
            vs_lib = cb.compressed_size / lz_lib if lz_lib else None
            print(f"{label}: round trip ok, host fallbacks 0, launches "
                  f"{counts}")
            print(f"{label}: native decode ok, liblz4 decode "
                  f"{'ok' if oracle.available() else 'not run (absent)'}; "
                  f"ratio {ratio:.4f}, size {vs_native:.4f}x native "
                  "LZ4_compress_default"
                  + (f", {vs_lib:.4f}x liblz4" if vs_lib else ""))
            print(f"[{card}] {label} wall: compress {t_enc:.3f} s "
                  f"({len(payload) / t_enc / 1e9:.4f} GB/s), decompress "
                  f"{t_dec:.3f} s ({len(payload) / t_dec / 1e9:.4f} GB/s), "
                  "host framing included")
            # the TPU record compares with liblz4; native is the same
            # function where liblz4 is absent
            return cb, counts, ratio, vs_lib or vs_native

        t0 = time.perf_counter()
        gsel = np.linspace(0, nb - 1, DEEP_GOLDEN).astype(np.int64)
        gfut = [pool.submit(_golden_call, (
            "compress_dense_seg", raw_np[j, :rlen_np[j]].tobytes(), seg_kw))
            for j in gsel]
        cb, counts3, ratio, vs_lz4 = main_run(data, 3, PATHDEEP3,
                                              "config 5 (depth 3)")
        for j, f in zip(gsel, gfut):
            need(cb.comp[j, :cb.comp_len[j]].tobytes() == f.result(),
                 f"config 5 block {j} differs from golden.compress_dense_seg"
                 "(depth=3)")
        print(f"config 5: {DEEP_GOLDEN} blocks == golden.compress_dense_seg"
              f"(depth=3); TPU record of the same bytes: ratio "
              f"{TPU_DEEP_RECORD['ratio']}, {TPU_DEEP_RECORD['size_vs_lz4']}x"
              f" ({time.perf_counter() - t0:.1f} s)")
        need(round(ratio, 4) == TPU_DEEP_RECORD["ratio"]
             and round(vs_lz4, 4) == TPU_DEEP_RECORD["size_vs_lz4"],
             f"config 5 ratio {ratio:.4f} / size {vs_lz4:.4f} differ from "
             "the TPU record of the same bytes")
        d5 = data[:DEEP5_BYTES]
        g5 = [pool.submit(_golden_call, (
            "compress_deep", d5[j * bs:(j + 1) * bs],
            {"hashlog": 16, "depth": 5})) for j in (0, DEEP5_BYTES // bs - 1)]
        cb5, counts5, _, vs5 = main_run(d5, 5, PATHDEEP5,
                                        "config 5c (depth 5, 8 MiB)")
        for j, f in zip((0, cb5.num_blocks - 1), g5):
            need(cb5.comp[j, :cb5.comp_len[j]].tobytes() == f.result(),
                 f"config 5c block {j} differs from golden.compress_deep"
                 "(depth=5)")
        print(f"config 5c: 2 blocks == golden.compress_deep(depth=5); TPU "
              f"record: {TPU_DEEP_RECORD['deep5_size_vs_lz4']}x")
        need(round(vs5, 4) == TPU_DEEP_RECORD["deep5_size_vs_lz4"],
             f"config 5c size {vs5:.4f} differs from the TPU record")

    # ---- phase 23: the stores and the CLI at match depth ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for m in mods.values():
            m.launches = 0
        nreq = DEEP_STORE_REQUESTS
        st = ST.ProxyStore(os.path.join(tmp, "deep.img"), chunk_size=bs,
                           capacity=nreq * bs, device=DEVICE, match_depth=3)
        lat = []
        for i in range(nreq):
            t1 = time.perf_counter()
            st.write(i * bs, data[i * bs:(i + 1) * bs])
            lat.append(time.perf_counter() - t1)
        need(hashlib.sha256(st.read(0, nreq * bs)).digest()
             == hashlib.sha256(data[:nreq * bs]).digest(),
             "ProxyStore at depth 3: read-back differs under sha256")
        w = st.stats.as_dict()["write"]
        need(w["reqs_total"] == nreq and w["reqs_failed"] == 0
             and st.stats.encode_fallbacks == 0,
             f"ProxyStore at depth 3: {w}, fallbacks "
             f"{st.stats.encode_fallbacks}")
        st.close()
        cst = ST.CompressedStore(os.path.join(tmp, "c5"), chunk_size=4096,
                                 device=DEVICE, match_depth=5)
        for i in range(DEEP_STORE_CHUNKS):
            cst.write_chunk(i, data[i * 4096:(i + 1) * 4096])
        for i in range(DEEP_STORE_CHUNKS):
            need(cst.read_chunk(i) == data[i * 4096:(i + 1) * 4096],
                 f"CompressedStore at depth 5: chunk {i} differs")
        need(cst.stats.encode_fallbacks == 0,
             "CompressedStore at depth 5 fell back")
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(data[:4 << 20])
        for cbs, md in ((bs, 3), (4096, 5)):
            out = os.path.join(tmp, f"out{md}.lz4j")
            back = os.path.join(tmp, f"back{md}.bin")
            need(cli.main(["--device", DEVICE, "compress", src, out,
                           "--block-size", str(cbs), "--match-depth",
                           str(md)]) == 0, f"lz4j compress --match-depth "
                                           f"{md} failed")
            need(cli.main(["--device", DEVICE, "decompress", out, back]) == 0,
                 f"lz4j decompress of the depth-{md} container failed")
            with open(back, "rb") as f:
                need(f.read() == data[:4 << 20],
                     f"lz4j round trip at depth {md} differs")
        store_counts = {k: m.launches for k, m in mods.items()}
        check_launches(store_counts, "deep stores and CLI",
                       ("gaps", "parse_seg_deep", "parse_enc3_deep"), [])
    print(f"phase deep stores and CLI: ProxyStore at depth 3 ({nreq} writes "
          f"of {bs}, median {1e3 * float(np.median(lat)):.4f} ms), "
          f"CompressedStore at depth 5 ({DEEP_STORE_CHUNKS} chunks of 4 KiB), "
          "lz4j compress "
          f"--match-depth 3 and 5: ok, launches {store_counts} "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 24: times ----
    n5 = DEEP5_BYTES // bs
    ms_d3 = time_ms(lambda: compress_blocks_device(raw, rlen, bs,
                                                   match_depth=3), 3)
    ms_d1 = time_ms(lambda: compress_blocks_device(raw, rlen, bs), 3)
    ms_d5 = time_ms(lambda: compress_blocks_device(
        raw[:n5], rlen[:n5], bs, match_depth=5), 3)
    print(f"[{card}] config 5 kernel path over {len(data)} bytes: depth-3 "
          f"encode {ms_d3:.3f} ms ({len(data) / ms_d3 / 1e6:.4f} GB/s), "
          f"depth-1 encode of the same blocks {ms_d1:.3f} ms "
          f"({len(data) / ms_d1 / 1e6:.4f} GB/s); depth-5 encode of "
          f"{DEEP5_BYTES} bytes {ms_d5:.3f} ms "
          f"({DEEP5_BYTES / ms_d5 / 1e6:.4f} GB/s)")
    fc = K2.dense_candidates(raw, rlen)
    fg, _ = G.chain_gaps(fc)
    old8s = load_parent(K8S, "parse_seg_deep")
    oldg = load_parent(G, "gaps")
    full = {"cand": against_parent(
                time_ms, K2, load_parent(K2, "cand"),
                lambda: K2.dense_candidates(raw, rlen), 3,
                f"K2 over config 5 ({nb} blocks of {bs})", card),
            "gaps": against_parent(
                time_ms, G, oldg, lambda: G.chain_gaps(fc), 5,
                f"gaps over config 5 ({nb} blocks of {bs}, links 2)", card),
            "parse_seg_deep": against_parent(
                time_ms, K8S, old8s,
                lambda: K8S.parse_segments_deep(raw, fc, fg, rlen), 3,
                f"K8-seg over config 5 ({nb} blocks of {bs}, seg 4096, "
                "depth 3)", card, same_parse(torch, maxdiff, "K8-seg")),
            "parse_seg (depth 1)": time_ms(
                lambda: K3.parse_segments(raw, fc, rlen), 3)}
    f5c = fc[:n5].contiguous()
    f5g, f5g2 = G.chain_gaps(f5c, 4)
    full["gaps (links 4, 8 MiB)"] = against_parent(
        time_ms, G, oldg, lambda: G.chain_gaps(f5c, 4), 5,
        f"gaps over config 5's first {n5} blocks (links 4)", card)
    full["parse_enc3_deep (depth 5, 8 MiB)"] = time_ms(
        lambda: K8E.parse_blocks_enc3_deep(raw[:n5], f5c, f5g, f5g2,
                                           rlen[:n5], depth=5), 3)
    print(f"[{card}] kernels over config 5 (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in full.items()))
    r1, c1, g1, l1 = (t[:1].contiguous() for t in big2)
    against_parent(time_ms, K8S, old8s,
                   lambda: K8S.parse_segments_deep(r1, c1, g1, l1, seg=8192),
                   10, f"K8-seg on one block of {1 << 20} at seg 8192 (depth "
                   "3)", card, same_parse(torch, maxdiff, "K8-seg"))
    # K8-enc3 runs a CTA of one warp a 64 KiB block: k blocks take k SMs,
    # so t(k) stays one walk up to the card's SMs; the parent's kernel
    # (one thread a block, 32-thread CTAs) in turns with it
    old8 = load_parent(K8E, "parse_enc3_deep")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in (1, 32, n5):
        against_parent(time_ms, K8E, old8,
                       lambda k=k: K8E.parse_blocks_enc3_deep(
                           raw[:k], f5c[:k], f5g[:k], f5g2[:k], rlen[:k],
                           depth=5), 3,
                       f"K8-enc3 at depth 5 on the first {k} blocks of {bs} "
                       f"({sms} SMs)", card)
    r, c, g, g2, l, k = enc3_in[bs, 5]
    sub8 = f"4 blocks of {bs}"
    r8, c8, g8, l8, _, _ = seg_cases[sub8]
    sub_times = {
        "gaps": (against_parent(time_ms, G, oldg,
                                lambda: G.chain_gaps(cs), 10,
                                f"gaps on {DEEP_SUBSET} blocks of {bs} "
                                "(links 2)", card),
                 time_ms(lambda: G.chain_gaps_plain(cs), 3),
                 tensor_bytes(cs, g3k)),
        "parse_seg_deep": (
            time_ms(lambda: K8S.parse_segments_deep(r8, c8, g8, l8), 10),
            seg_plain_ms[sub8], parse_bytes((r8, c8, g8, l8), seg_out[sub8])),
        "parse_enc3_deep": (
            time_ms(lambda: K8E.parse_blocks_enc3_deep(
                r, c, g, g2, l, depth=5), 5),
            enc3_plain_ms[bs, 5], parse_bytes((r, c, g, g2, l), k)),
    }
    for key, (a, b, _) in sub_times.items():
        print(f"[{card}] {key} on its subset: kernel {a:.4f} ms, plain "
              f"{b:.4f} ms")
    print(f"(both K8 parses' subset: 4 blocks of {bs}, two of the corpus, "
          "a random and a zero block, K8-enc3 at depth 5, K8-seg at depth "
          "3; their plain times are phase 20's calls)")
    r4, c4, g4, _, l4, _ = enc3_in[4096, 3]
    against_parent(time_ms, K8E, old8,
                   lambda: K8E.parse_blocks_enc3_deep(r4, c4, g4, None, l4),
                   10, "K8-enc3 at depth 3 on 64 blocks of 4 KiB", card)
    counts = {k: counts3[k] + counts5[k] for k in mods}
    return {"errs": {"gaps": errg, "parse_seg_deep": err8s,
                     "parse_enc3_deep": err8e},
            "counts": counts, "sub_times": sub_times}


def store_median(data: bytes, chunk: int, nreq: int) -> float:
    """Milliseconds, the median of ``nreq`` sequential ``ProxyStore``
    writes of ``chunk`` bytes of ``data`` (each ending in a host sync)."""
    import tempfile

    from lz4_sgori_torch import store as ST
    lat = []
    with tempfile.TemporaryDirectory() as tmp:
        st = ST.ProxyStore(os.path.join(tmp, "backing.img"),
                           chunk_size=chunk, capacity=chunk * nreq,
                           device=DEVICE)
        for i in range(nreq):
            t1 = time.perf_counter()
            st.write(i * chunk, data[i * chunk:(i + 1) * chunk])
            lat.append(time.perf_counter() - t1)
        st.close()
    return 1e3 * float(np.median(lat))


def timed_once(torch, fn):
    """``(fn(), its milliseconds)``: one call between two CUDA events, for
    a plain version too slow to run again for its time."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


@contextlib.contextmanager
def env_var(name: str, value: str | None):
    """Set (or, with None, unset) an environment variable for the block,
    and restore it after, whatever the block raises."""
    prev = os.environ.get(name)
    try:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def turns(*timers):
    """The mean of two readings of each timer, taken in turns (a, b, c,
    c, b, a), so that a drift of the card's clock falls on all."""
    got = [[t()] for t in timers]
    for g, t in zip(reversed(got), reversed(timers)):
        g.append(t())
    return [sum(g) / 2 for g in got]


def in_turns(time_ms, fa, fb, reps: int):
    """Mean times of ``fa`` and ``fb`` taken in turns (a, b, b, a)."""
    return tuple(turns(lambda: time_ms(fa, reps), lambda: time_ms(fb, reps)))


def _smoke_mlen(torch, data: bytes, raw, rlen, container: bytes, card: str,
                time_ms, graph_ms, maxdiff, mods) -> dict:
    """Phases 25-28: the mlen mode (K10) on config 1's corpus: its 64 KiB
    blocks (``raw``, ``rlen``, on the card) through ``seg`` (K2, mcode,
    K10b, K4), and its 4 KiB blocks through the enc3 function's ``mlen``
    argument (K2, mcode, K10c). ``container`` is phase 3's default
    container of the corpus. Returns the per-kernel errors, launch counts
    (both runs) and subset times of mcode, K10b and K10c for the
    record."""
    import lz4_sgori_torch
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch import native
    from lz4_sgori_torch.ops.enc3 import compress_blocks_enc3
    from lz4_sgori_torch.ops.kernels import cand as K2
    from lz4_sgori_torch.ops.kernels import mcode as M
    from lz4_sgori_torch.ops.kernels import parse_enc3 as K7
    from lz4_sgori_torch.ops.kernels import parse_enc3_mlen as K10C
    from lz4_sgori_torch.ops.kernels import parse_seg as K3
    from lz4_sgori_torch.ops.kernels import parse_seg_mlen as K10B
    from lz4_sgori_torch.ops.seg import compress_blocks_seg
    from lz4_sgori_torch.utils.stats import Stats

    dev = torch.device(DEVICE)
    nb = raw.shape[0]
    raw_np, rlen_np = raw.cpu().numpy(), rlen.cpu().numpy()
    r4_np, l4_np = B.split_blocks(data, BLOCK4)
    raw4, rlen4 = (torch.from_numpy(a).to(dev) for a in (r4_np, l4_np))
    nb4 = raw4.shape[0]

    with golden_pool() as pool:
        # ---- phase 25: mcode, K10b and K10c against their plain
        # versions ----
        t0 = time.perf_counter()
        sub = torch.arange(0, nb, nb // SUBSET, device=dev)[:SUBSET]
        rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
        msel = sub.tolist()[:4]
        mfut = [pool.submit(_golden_call, (
            "dense_mcode", raw_np[j, :rlen_np[j]].tobytes(), {}))
            for j in msel]
        cs = K2.dense_candidates(rs, ls)
        cv, mc = M.dense_mcode(cs, rs, ls)
        errm = max(maxdiff(a, b) for a, b in
                   zip((cv, mc), M.dense_mcode_plain(cs, rs, ls)))
        # hand-made tapes (d <= 0, d = 1, d = p, d > p, d >= bs; nonzero
        # bytes past n, raw_len negative and past bs) at odd block sizes,
        # rows off the 16-byte grid, and 70,000 blocks of 16
        for hn, hbs in ((5, BLOCK), (5, 4097), (9, 5), (70000, 16)):
            hr, hl, hc = (torch.from_numpy(a).to(dev)
                          for a in hand_mcode_case(hn, hbs, seed=hbs))
            errm = max(errm, max(maxdiff(a, b) for a, b in zip(
                M.dense_mcode(hc, hr, hl), M.dense_mcode_plain(hc, hr, hl))))
        need(errm == 0, f"mcode differs from its plain version by {errm}")
        pk = K10B.parse_segments_mlen(rs, cv, mc, ls)
        err10b = segment_diff(torch, maxdiff, pk,
                              K10B.parse_segments_mlen_plain(rs, cv, mc, ls),
                              "K10b")
        segment_diff(torch, maxdiff, pk, K3.parse_segments(rs, cs, ls),
                     "K10b against K3")
        sub4 = torch.arange(0, nb4, max(1, nb4 // SUBSET4),
                            device=dev)[:SUBSET4]
        r4s, l4s = raw4[sub4].contiguous(), rlen4[sub4].contiguous()
        c4 = K2.dense_candidates(r4s, l4s)
        cv4, mc4 = M.dense_mcode(c4, r4s, l4s)
        k10c = K10C.parse_blocks_enc3_mlen(r4s, cv4, mc4, l4s)
        err10c = max(maxdiff(a, b) for a, b in zip(
            k10c, K10C.parse_blocks_enc3_mlen_plain(r4s, cv4, mc4, l4s)))
        need(err10c == 0, f"K10c differs from its plain version by "
                          f"{err10c}")
        need(not bool(k10c[2].any()), "K10c flagged a subset block")
        need(all(torch.equal(a, b) for a, b in
                 zip(k10c, K7.parse_blocks_enc3(r4s, c4, l4s))),
             "K10c differs from K7 on the unverified tape")
        cvn, mcn = cv.cpu().numpy(), mc.cpu().numpy()
        for i, f in enumerate(mfut):
            wd, wm = f.result()
            n = len(wd)
            need(np.array_equal(cvn[i, :n], wd)
                 and np.array_equal(mcn[i, :n], wm)
                 and not cvn[i, n:].any() and not mcn[i, n:].any(),
                 f"mcode: block {msel[i]} differs from golden.dense_mcode")
        print(f"phase mcode/K10b/K10c == plain: ok; mcode and K10b on "
              f"{SUBSET} blocks of {BLOCK} (K10b == K3 on the unverified "
              f"tape), K10c on {SUBSET4} blocks of {BLOCK4} (== K7); mcode "
              f"on hand-made tapes (5 of {BLOCK} and of 4097, 9 of 5, 70,000 "
              f"of 16) and == golden.dense_mcode on {len(msel)} "
              f"({time.perf_counter() - t0:.1f} s)")
        # K10b and K10c on the subsets, in turns with the parent's
        old10b = load_parent(K10B, "parse_seg_mlen")
        old10c = load_parent(K10C, "parse_enc3_mlen")
        against_parent(time_ms, K10B, old10b,
                       lambda: K10B.parse_segments_mlen(rs, cv, mc, ls), 10,
                       f"K10b on {SUBSET} blocks of {BLOCK}", card,
                       same_parse(torch, maxdiff, "K10b"))
        against_parent(time_ms, K10C, old10c,
                       lambda: K10C.parse_blocks_enc3_mlen(r4s, cv4, mc4,
                                                           l4s), 10,
                       f"K10c on {SUBSET4} blocks of {BLOCK4}", card)

        # ---- phase 26: every block with and without the mode ----
        t0 = time.perf_counter()
        gsel = np.linspace(0, nb - 1, GOLDEN_BLOCKS).astype(np.int64)
        gfut = [pool.submit(_golden_call, (
            "compress_dense_seg", raw_np[j, :rlen_np[j]].tobytes(),
            {"seg": 4096, "window": 65536, "hashlog": 16})) for j in gsel]
        base = compress_blocks_seg(raw, rlen, BLOCK)
        fast = compress_blocks_seg(raw, rlen, BLOCK, mlen=True)
        need(not bool(fast[2].any()), "the mlen mode flagged a block")
        need(all(torch.equal(a, b) for a, b in zip(base, fast)),
             "the mlen bytes differ from the default bytes")
        fcn, fln = fast[0].cpu().numpy(), fast[1].cpu().numpy()
        for j, f in zip(gsel, gfut):
            need(fcn[j, :fln[j]].tobytes() == f.result(),
                 f"mlen block {j} differs from golden.compress_dense_seg")
        print(f"phase mlen == default: all {nb} blocks of {BLOCK} give the "
              f"default bytes, {GOLDEN_BLOCKS} == golden.compress_dense_seg "
              f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 27: the mlen paths, counters reset just before each ----
    with env_var("LZ4J_ENC_MLEN", "1"):
        for m in mods.values():
            m.launches = 0
        stats = Stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcont = lz4_sgori_torch.compress(data, BLOCK, stats=stats,
                                         device=DEVICE)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = lz4_sgori_torch.decompress(mcont, stats=stats, device=DEVICE)
        t_dec = time.perf_counter() - t0
        counts = {k: m.launches for k, m in mods.items()}
    need(back == data, "mlen path round trip differs")
    need(stats.encode_fallbacks == 0,
         f"{stats.encode_fallbacks} host fallbacks on the mlen path")
    check_launches(counts, "mlen", PATHMLEN,
                   [k for k in mods if k not in PATHMLEN])
    need(mcont == container, "the mlen container differs from the default "
                             "container")
    cb = B.CompressedBlocks.from_container(mcont)
    lz_native = sum(len(native.compress(raw_np[j, :rlen_np[j]].tobytes()))
                    for j in range(nb))
    ratio = len(data) / cb.compressed_size
    vs_lz4 = cb.compressed_size / lz_native
    need(round(ratio, 4) == TPU_RECORD["ratio"]
         and round(vs_lz4, 4) == TPU_RECORD["size_vs_lz4"],
         f"mlen ratio {ratio:.4f} / size {vs_lz4:.4f} differ from the TPU "
         "record of the same bytes")
    print(f"mlen path: round trip ok, host fallbacks 0, launches {counts}; "
          f"the container of phase 3 byte for byte; ratio {ratio:.4f}, size "
          f"{vs_lz4:.4f}x native LZ4_compress_default (TPU record of the "
          f"same bytes: {TPU_RECORD['ratio']}, {TPU_RECORD['size_vs_lz4']}x)")
    print(f"[{card}] mlen path wall: compress {t_enc:.3f} s "
          f"({len(data) / t_enc / 1e9:.4f} GB/s), decompress {t_dec:.3f} s "
          f"({len(data) / t_dec / 1e9:.4f} GB/s), host framing included")

    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    e_fast = compress_blocks_enc3(raw4, rlen4, BLOCK4, return_tails=True,
                                  return_nseq=True, mlen=True)
    counts_e = {k: m.launches for k, m in mods.items()}
    check_launches(counts_e, "enc3 mlen", PATHMLEN_ENC3,
                   [k for k in mods if k not in PATHMLEN_ENC3])
    e_base = compress_blocks_enc3(raw4, rlen4, BLOCK4, return_tails=True,
                                  return_nseq=True)
    need(not bool(e_fast[2].any())
         and all(torch.equal(a, b) for a, b in zip(e_base, e_fast)),
         "the enc3 mlen bytes, tails or nseq differ from the default ones")
    print(f"enc3 mlen path: {nb4} blocks of {BLOCK4}, the default bytes, "
          f"tails and nseq; launches {counts_e}")

    # ---- phase 28: times ----
    def seg_path(flag):
        return lambda: compress_blocks_seg(raw, rlen, BLOCK, mlen=flag)

    def enc3_path(flag):
        return lambda: compress_blocks_enc3(raw4, rlen4, BLOCK4, mlen=flag)

    def compress_wall(flag):
        with env_var("LZ4J_ENC_MLEN", "1" if flag else None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lz4_sgori_torch.compress(data, BLOCK, device=DEVICE)
            return time.perf_counter() - t0

    walls = [compress_wall(f) for f in (False, True, True, False)]
    w_d, w_m = (walls[0] + walls[3]) / 2, (walls[1] + walls[2]) / 2
    print(f"[{card}] lz4_sgori_torch.compress wall of the corpus, in turns "
          f"(default, mlen, mlen, default): default {w_d:.4f} s "
          f"({len(data) / w_d / 1e9:.4f} GB/s), mlen {w_m:.4f} s "
          f"({len(data) / w_m / 1e9:.4f} GB/s), host framing included")
    ms_d, ms_m = in_turns(time_ms, seg_path(False), seg_path(True), 5)
    ms4_d, ms4_m = in_turns(time_ms, enc3_path(False), enc3_path(True), 5)
    print(f"[{card}] encode kernel path over the corpus, in turns (default, "
          f"mlen, mlen, default): 64 KiB seg default {ms_d:.3f} ms "
          f"({len(data) / ms_d / 1e6:.4f} GB/s), mlen {ms_m:.3f} ms "
          f"({len(data) / ms_m / 1e6:.4f} GB/s), mlen/default "
          f"{ms_m / ms_d:.4f}; 4 KiB enc3 default {ms4_d:.3f} ms, mlen "
          f"{ms4_m:.3f} ms, mlen/default {ms4_m / ms4_d:.4f}")
    # the same on the card alone: three calls a CUDA graph, so the host's
    # launches between the kernels do not set the pace
    dv_d, dv_m = in_turns(graph_ms, seg_path(False), seg_path(True), 3)
    dv4_d, dv4_m = in_turns(graph_ms, enc3_path(False), enc3_path(True), 3)
    print(f"[{card}] the same paths' device time (CUDA graphs), in turns: "
          f"64 KiB seg default {dv_d:.4f} ms, mlen {dv_m:.4f} ms, "
          f"mlen/default {dv_m / dv_d:.4f}; 4 KiB enc3 default "
          f"{dv4_d:.4f} ms, mlen {dv4_m:.4f} ms, mlen/default "
          f"{dv4_m / dv4_d:.4f}")
    fc = K2.dense_candidates(raw, rlen)
    fcv, fmc = M.dense_mcode(fc, raw, rlen)
    f4 = K2.dense_candidates(raw4, rlen4)
    f4v, f4m = M.dense_mcode(f4, raw4, rlen4)
    # mcode and the mlen paths with the parent's mcode, in turns
    oldm = load_parent(M, "mcode")
    mcode_ms = {
        "mcode (64 KiB)": against_parent(
            time_ms, M, oldm, lambda: M.dense_mcode(fc, raw, rlen), 5,
            f"mcode over config 1 ({nb} blocks of {BLOCK})", card),
        "mcode (4 KiB)": against_parent(
            time_ms, M, oldm, lambda: M.dense_mcode(f4, raw4, rlen4), 5,
            f"mcode over config 3 ({nb4} blocks of {BLOCK4})", card)}
    against_parent(time_ms, M, oldm, seg_path(True), 5,
                   "the mlen encode kernel path over config 1", card)
    against_parent(time_ms, M, oldm, enc3_path(True), 5,
                   "the 4 KiB enc3 mlen encode kernel path over config 3",
                   card)
    k3_ms, k10b_ms = in_turns(
        time_ms, lambda: K3.parse_segments(raw, fc, rlen),
        lambda: K10B.parse_segments_mlen(raw, fcv, fmc, rlen), 5)
    k7_ms, k10c_ms = in_turns(
        time_ms, lambda: K7.parse_blocks_enc3(raw4, f4, rlen4),
        lambda: K10C.parse_blocks_enc3_mlen(raw4, f4v, f4m, rlen4), 5)
    # K10b and K10c over the corpus and on one block, in turns with the
    # parent's kernels
    against_parent(time_ms, K10B, old10b,
                   lambda: K10B.parse_segments_mlen(raw, fcv, fmc, rlen), 5,
                   f"K10b over config 1 ({nb} blocks of {BLOCK}, seg 4096)",
                   card, same_parse(torch, maxdiff, "K10b"))
    against_parent(time_ms, K10C, old10c,
                   lambda: K10C.parse_blocks_enc3_mlen(raw4, f4v, f4m,
                                                       rlen4), 5,
                   f"K10c over config 3 ({nb4} blocks of {BLOCK4})", card)
    one = [t[:1].contiguous() for t in (raw, fcv, fmc, rlen)]
    against_parent(time_ms, K10B, old10b,
                   lambda: K10B.parse_segments_mlen(*one), 20,
                   f"K10b on one block of {BLOCK}", card,
                   same_parse(torch, maxdiff, "K10b"))
    one4 = [t[:1].contiguous() for t in (raw4, f4v, f4m, rlen4)]
    against_parent(time_ms, K10C, old10c,
                   lambda: K10C.parse_blocks_enc3_mlen(*one4), 20,
                   f"K10c on one block of {BLOCK4}", card)
    full = {**mcode_ms,
            "parse_seg_mlen": k10b_ms, "parse_seg (in turns)": k3_ms,
            "parse_enc3_mlen (4 KiB)": k10c_ms,
            "parse_enc3 (4 KiB, in turns)": k7_ms}
    print(f"[{card}] kernels over the corpus (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in full.items()))
    k3s, k10bs = in_turns(time_ms, lambda: K3.parse_segments(rs, cs, ls),
                          lambda: K10B.parse_segments_mlen(rs, cv, mc, ls),
                          10)
    sub_times = {
        "mcode": (against_parent(time_ms, M, oldm,
                                 lambda: M.dense_mcode(cs, rs, ls), 10,
                                 f"mcode on {SUBSET} blocks of {BLOCK}",
                                 card),
                  time_ms(lambda: M.dense_mcode_plain(cs, rs, ls), 3),
                  tensor_bytes(cs, rs, ls, cv, mc)),
        "parse_seg_mlen": (
            k10bs, time_ms(lambda: K10B.parse_segments_mlen_plain(
                rs, cv, mc, ls), 1), parse_bytes((rs, cv, mc, ls), pk)),
        "parse_enc3_mlen": (
            time_ms(lambda: K10C.parse_blocks_enc3_mlen(r4s, cv4, mc4, l4s),
                    10),
            time_ms(lambda: K10C.parse_blocks_enc3_mlen_plain(
                r4s, cv4, mc4, l4s), 1),
            parse_bytes((r4s, cv4, mc4, l4s), k10c)),
    }
    for k, (a, b, _) in sub_times.items():
        print(f"[{card}] {k} on its subset: kernel {a:.4f} ms, plain "
              f"{b:.4f} ms")
    print(f"[{card}] K3 on the 32-block subset in turns with K10b: "
          f"{k3s:.4f} ms")
    return {"errs": {"mcode": errm, "parse_seg_mlen": err10b,
                     "parse_enc3_mlen": err10c},
            "counts": {k: counts[k] + counts_e[k] for k in mods},
            "sub_times": sub_times}


def _smoke_retired(torch, data: bytes, card: str, time_ms, maxdiff,
                   mods) -> dict:
    """Phases 29-32: the retired round-1 engines (T1 the greedy encoder,
    T2 the scalar decoder, T3 the chained decoder) on config 1's corpus,
    cut to 512 blocks of 64 KiB and to 8192 of 4 KiB. Returns their
    errors, launch counts and subset times for the record."""
    from lz4_sgori_torch import blocks as B
    from lz4_sgori_torch import format as F
    from lz4_sgori_torch import native
    from lz4_sgori_torch.ops.kernels import lockstep_v6 as K5
    from lz4_sgori_torch.ops.kernels import lockstep_v7 as K1
    from lz4_sgori_torch.retired import decode_kernel as T2
    from lz4_sgori_torch.retired import encode_kernel as T1
    from lz4_sgori_torch.retired import lockstep_v9 as T3
    from lz4_sgori_torch.utils import oracle

    dev = torch.device(DEVICE)
    cuts = {}
    for bs in (BLOCK, BLOCK4):
        r_np, l_np = B.split_blocks(data, bs)
        cuts[bs] = (r_np, l_np, torch.from_numpy(r_np).to(dev),
                    torch.from_numpy(l_np).to(dev))
    errs = dict.fromkeys(PATHRETIRED, 0)

    def worst(key, got, want, what):
        e = max(maxdiff(a, b) for a, b in zip(got, want))
        need(e == 0, f"{what} differs from its plain version by {e}")
        errs[key] = max(errs[key], e)

    # ---- phase 29: T1, T2 and T3 against their plain versions ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(2929)
    for (bs, nsub), nmut in zip(((BLOCK, RETIRED_SUBSET), (BLOCK4, SUBSET4)),
                                RETIRED_MUTANTS):
        _, _, raw, rlen = cuts[bs]
        nb = raw.shape[0]
        sub = torch.arange(0, nb, max(1, nb // nsub), device=dev)[:nsub]
        rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
        for acc in (RETIRED_ACC, 1):
            got = T1.compress_blocks_retired(rs, ls, bs, acc)
            worst("retired_encode", got,
                  T1.compress_blocks_retired_plain(rs, ls, bs, acc),
                  f"T1 at {bs} acceleration {acc}")
        cn, ln = (t.cpu().numpy() for t in got)
        bases = [cn[j, :ln[j]].tobytes() for j in range(nsub)]
        slot = F.compress_bound(bs) + 8
        mc, ml = _pack_streams(bases + make_mutants(bases, rng, nmut,
                                                    slot - 8), slot)
        for j in range(nsub, mc.shape[0], 3):      # bytes past comp_len
            mc[j, ml[j]:] = rng.integers(0, 256, slot - ml[j], dtype=np.uint8)
        ct, lt = torch.from_numpy(mc).to(dev), torch.from_numpy(ml).to(dev)
        k1 = K1.decompress_blocks_v7(ct, lt, bs)
        d2 = T2.decompress_blocks_retired(ct, lt, bs)
        worst("retired_decode", d2,
              T2.decompress_blocks_retired_plain(ct, lt, bs), f"T2 at {bs}")
        need(torch.equal(d2[1], k1[1]) and torch.equal(d2[2], k1[2]),
             f"T2's out_len or err differs from K1's at {bs}")
        kept = int(d2[0][d2[2]].any(dim=1).sum())
        for chain in (2, 4):
            d3 = T3.decompress_blocks_lockstep_v9(ct, lt, bs, chain=chain)
            worst("decode_v9", d3, T3.decompress_blocks_lockstep_v9_plain(
                ct, lt, bs, chain=chain), f"T3 at {bs} chain {chain}")
            need(all(torch.equal(a, b) for a, b in zip(d3, k1)),
                 f"T3 differs from K1 at {bs} chain {chain}")
        print(f"phase T1/T2/T3 == plain at {bs}: T1 on {nsub} blocks at "
              f"acceleration 1 and {RETIRED_ACC}; T2 and T3 (chain 2, 4) on "
              f"their streams and {nmut} mutants, {int(d2[2].sum())} "
              f"rejected ({kept} keep bytes in T2's rows), out_len and err "
              "== K1's, T3 == K1 whole rows")
    print(f"phase T1/T2/T3 == plain: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 30: the retired path, counters reset just before ----
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc, dec = {}, {}
    for bs, (_, _, raw, rlen) in cuts.items():
        enc[bs] = T1.compress_blocks_retired(raw, rlen, bs)
        dec[bs, "T2"] = T2.decompress_blocks_retired(*enc[bs], bs)
        for chain in (2, 4):
            dec[bs, f"T3 chain {chain}"] = T3.decompress_blocks_lockstep_v9(
                *enc[bs], bs, chain=chain)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    check_launches(counts, "retired", PATHRETIRED,
                   [k for k in mods if k not in PATHRETIRED])
    for (bs, what), (out, out_len, err) in dec.items():
        _, _, raw, rlen = cuts[bs]
        need(not bool(err.any()) and torch.equal(out_len, rlen)
             and torch.equal(out, raw),
             f"{what} does not decode T1's {bs}-byte blocks to the corpus")
    print(f"retired path: T1 over {len(data)} bytes cut to {BLOCK} and "
          f"{BLOCK4}, then T2 and T3 (chain 2, 4) back to the corpus "
          f"({t_path:.3f} s), launches {counts}")

    # ---- phase 31: T1 is LZ4_compress_default (and _fast) ----
    t0 = time.perf_counter()
    with golden_pool() as pool:
        for bs, (r_np, l_np, raw, rlen) in cuts.items():
            nb = raw.shape[0]
            cn, ln = (t.cpu().numpy() for t in enc[bs])
            gsel = np.linspace(0, nb - 1, GOLDEN_BLOCKS).astype(np.int64)
            blk = [r_np[j, :l_np[j]].tobytes() for j in gsel]
            gfut = [pool.submit(_golden_call, ("compress", b, {}))
                    for b in blk]
            f8 = [pool.submit(_golden_call, (
                "compress", b, {"acceleration": RETIRED_ACC})) for b in blk]
            c8, l8 = (t.cpu().numpy() for t in T1.compress_blocks_retired(
                raw[torch.from_numpy(gsel).to(dev)],
                rlen[torch.from_numpy(gsel).to(dev)], bs, RETIRED_ACC))
            n_ref = 0
            for j in range(nb):
                b = r_np[j, :l_np[j]].tobytes()
                got = cn[j, :ln[j]].tobytes()
                want = native.compress(b)
                need(got == want, f"T1 block {j} of {bs} differs from "
                                  "native LZ4_compress_default")
                n_ref += len(want)
                if oracle.available():
                    need(got == oracle.compress(b),
                         f"T1 block {j} of {bs} differs from liblz4")
            for i, j in enumerate(gsel):
                need(cn[j, :ln[j]].tobytes() == gfut[i].result(),
                     f"T1 block {j} of {bs} differs from golden.compress")
                got8 = c8[i, :l8[i]].tobytes()
                need(got8 == f8[i].result(),
                     f"T1 block {j} of {bs} at acceleration {RETIRED_ACC} "
                     "differs from golden.compress")
                if oracle.available():
                    need(got8 == oracle.compress_fast(blk[i], RETIRED_ACC),
                         f"T1 block {j} of {bs} at acceleration "
                         f"{RETIRED_ACC} differs from LZ4_compress_fast")
            total = int(ln.sum())
            print(f"T1 at {bs}: all {nb} blocks == native "
                  f"LZ4_compress_default, liblz4 "
                  f"{'too' if oracle.available() else 'not run (absent)'}; "
                  f"{GOLDEN_BLOCKS} == golden.compress at acceleration 1 and "
                  f"{RETIRED_ACC} (and LZ4_compress_fast); size {total} "
                  f"bytes, ratio {len(data) / total:.4f}, "
                  f"{total / n_ref:.4f}x LZ4_compress_default")
    print(f"phase T1 contract: ok ({time.perf_counter() - t0:.1f} s)")

    # ---- phase 32: times ----
    old1 = load_parent(T1, "retired_encode")
    old3 = load_parent(T3, "decode_v9")
    for bs, (_, _, raw, rlen) in cuts.items():
        ref = ("K1", K1.decompress_blocks_v7) if bs == BLOCK else \
            ("K5", K5.decompress_blocks_v6)
        ms1 = against_parent(
            time_ms, T1, old1,
            lambda: T1.compress_blocks_retired(raw, rlen, bs), 5,
            f"T1 over the {bs}-byte cut", card)
        comp, clen = enc[bs]
        for chain in (2, 4):
            ms3 = against_parent(
                time_ms, T3, old3,
                lambda c=chain: T3.decompress_blocks_lockstep_v9(
                    comp, clen, bs, chain=c), 5,
                f"T3 chain {chain} over the {bs}-byte cut", card)
            dc, dl, _ = T3.dealt(comp, clen, chain)
            msk = time_ms(lambda c=chain: T3.decode_dealt(dc, dl, bs, c), 5)
            print(f"[{card}] T3 chain {chain} over the {bs}-byte cut: the "
                  f"kernel alone on the dealt batch {msk:.4f} ms, the deal's "
                  f"torch ops {ms3 - msk:.4f} ms of the call")
        pairs = {"T2": lambda: T2.decompress_blocks_retired(comp, clen, bs)}
        for chain in (2, 4):
            pairs[f"T3 chain {chain}"] = (
                lambda c=chain: T3.decompress_blocks_lockstep_v9(
                    comp, clen, bs, chain=c))
        line = []
        for what, fn in pairs.items():
            mr, mt = in_turns(time_ms, lambda: ref[1](comp, clen, bs), fn, 5)
            line.append(f"{what} {mt:.4f} ms ({len(data) / mt / 1e6:.4f} "
                        f"GB/s) against {ref[0]} {mr:.4f} ms, "
                        f"{mt / mr:.4f}x")
        print(f"[{card}] retired engines over the {bs}-byte cut: T1 encode "
              f"{ms1:.3f} ms ({len(data) / ms1 / 1e6:.4f} GB/s); in turns "
              "(ref, new, new, ref): " + "; ".join(line))
    _, _, raw, rlen = cuts[BLOCK]
    nb = raw.shape[0]
    sub = torch.arange(0, nb, nb // SUBSET, device=dev)[:SUBSET]
    rs, ls = raw[sub].contiguous(), rlen[sub].contiguous()
    cs, lc = T1.compress_blocks_retired(rs, ls, BLOCK)
    d2 = T2.decompress_blocks_retired(cs, lc, BLOCK)
    against_parent(time_ms, T1, old1,
                   lambda: T1.compress_blocks_retired(rs, ls, BLOCK), 10,
                   f"T1 on {SUBSET} blocks of {BLOCK}", card)
    sub_times = {
        "retired_encode": (
            time_ms(lambda: T1.compress_blocks_retired(rs, ls, BLOCK), 10),
            time_ms(lambda: T1.compress_blocks_retired_plain(rs, ls, BLOCK),
                    1),
            int(ls.sum()) + int(lc.sum()) + tensor_bytes(ls, lc)),
        "retired_decode": (
            time_ms(lambda: T2.decompress_blocks_retired(cs, lc, BLOCK), 10),
            time_ms(lambda: T2.decompress_blocks_retired_plain(cs, lc, BLOCK),
                    1), decode_bytes(lc, d2)),
        "decode_v9": (
            time_ms(lambda: T3.decompress_blocks_lockstep_v9(
                cs, lc, BLOCK, chain=2), 10),
            time_ms(lambda: T3.decompress_blocks_lockstep_v9_plain(
                cs, lc, BLOCK, chain=2), 1), decode_bytes(lc, d2)),
    }
    for k, (a, b, _) in sub_times.items():
        print(f"[{card}] {k} on {SUBSET} blocks of {BLOCK} (T3 at chain 2): "
              f"kernel {a:.4f} ms, plain {b:.4f} ms")
    return {"errs": errs, "counts": counts, "sub_times": sub_times}


def path_probes(mods) -> tuple[str, ...]:
    """The probe path's kernels: PATHPROBES and T14a's bodies."""
    return PATHPROBES + tuple(k for k in mods if k.startswith(HARNESS))


def bound_ms(nbytes: int, op_ms: float = 0.0) -> tuple[float, str]:
    """The least time of a call that moves ``nbytes`` and whose operations
    take ``op_ms`` at the card's peak, and which of the two bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_MS
    return (op_ms, "operations") if op_ms > by_bytes else (by_bytes, "bytes")


def sm_clock_mhz() -> int:
    """The card's maximum SM clock in MHz, as nvidia-smi reports it."""
    got = _run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                "--format=csv,noheader,nounits"]).splitlines()[0].strip()
    need(got.isdigit(), f"nvidia-smi gave no SM clock: {got!r}")
    return int(got)


def dma_bytes(nl: int, w: int, reps: int) -> int:
    """Bytes T5 must move: each lane's words that its rounds copy, read
    once (the windows of consecutive rounds overlap where w > 128), its
    index, and the result."""
    words = (reps - 1) * 128 + w if w >= 128 else reps * w
    return 4 * (nl * words + nl + 1) if reps else 4 * (nl + 1)


def banded_cells(torch, tape, pos0, reps: int) -> int:
    """How many cells of the tape T8's rounds read at the tool's mask: its
    plain loop replayed, marking the 26 rows at each round's position
    (27 where the position is not word-aligned)."""
    from lz4_sgori_torch.probes import microbench4 as P78
    from lz4_sgori_torch.probes import wrap32
    rows = tape.shape[0]
    mask = P78.default_mask(rows)
    hit = torch.zeros(tape.shape, dtype=torch.bool, device=tape.device)
    lanes = torch.arange(P78.L, device=tape.device).expand(P78.WORDS + 1, -1)
    p0 = pos0[0].to(torch.int64)
    acc = torch.zeros_like(p0)
    for _ in range(reps):
        pos = wrap32(p0 + (acc & 63)).to(torch.int64) & mask
        i = torch.arange(P78.WORDS + 1, device=tape.device)[:, None]
        r = (pos >> 2)[None, :] + i
        ok = (r >= 0) & (r < rows) & ((i < P78.WORDS) | (pos & 3 != 0))
        hit[r[ok], lanes[ok]] = True
        w = P78.extract_bytes(tape, pos, P78.WORDS).to(torch.int64)
        acc = (acc + w.sum(0)) & 0xFFFF
    need(torch.equal(acc.to(torch.int32)[None],
                     P78.banded_plain(tape, pos0, reps)),
         "the replay of T8's rounds differs from its plain version")
    return int(hit.sum())


def _smoke_probes(torch, card: str, time_ms, graph_ms, maxdiff, mods
                  ) -> dict:
    """Phases 33-36: the design probes of ``tools/`` (T4-T15) at the
    tools' shapes and seeds. Returns their errors, launch counts, per-call
    times and the library times of the rows that one PyTorch call prices
    (on the card, from a CUDA graph, and eager) for the record."""
    from lz4_sgori_torch.probes import dma_probe as P5
    from lz4_sgori_torch.probes import microbench2 as P15
    from lz4_sgori_torch.probes import microbench3 as P3
    from lz4_sgori_torch.probes import microbench4 as P78
    from lz4_sgori_torch.probes import microbench6 as P6
    from lz4_sgori_torch.probes import per_iter
    from lz4_sgori_torch.probes import sort_probe as P4

    dev = torch.device(DEVICE)
    probes = path_probes(mods)
    errs = dict.fromkeys(probes, 0)

    def same(key, got, want, what):
        e = maxdiff(got, want)
        need(e == 0 and torch.equal(got, want),
             f"{what} differs from its plain version by {e}")
        errs[key] = max(errs[key], e)

    # ---- phase 33: each probe against its plain version ----
    t0 = time.perf_counter()
    sorts = {}
    sort_rng = np.random.default_rng(4)
    for logn in PROBE_SORT_LOGN:
        x = torch.from_numpy(P4.keys(logn)).to(dev)
        sorts[logn] = x
        wide = torch.from_numpy(sort_rng.integers(
            -(1 << 31), 1 << 31, (1 << logn, P4.LANES)).astype(np.int32)
        ).to(dev)
        for t, what in ((x, "the tool's keys"), (wide, "random int32")):
            before = P4.launches
            got = P4.device_sort(t)
            need(P4.launches == before + 1, f"T4 at logN {logn}: "
                 f"{P4.launches - before} calls counted for one")
            same("probe_sort", got, P4.device_sort_plain(t),
                 f"T4 at logN {logn} on {what}")
            need(torch.equal(got, torch.sort(t, dim=0).values),
                 f"T4 at logN {logn} on {what} differs from torch.sort")
    # the kernel's own count of its passes against the Python plan
    plans = {logn: (P4.passes(1 << logn), len(P4.plan(logn)))
             for logn in range(P4.MAX_LOGN + 1)}
    need(all(a == b for a, b in plans.values()),
         f"T4's passes (kernel, plan) differ: {plans}")
    idx, hbm = (torch.from_numpy(a).to(dev) for a in P5.inputs())
    for nl in PROBE_DMA_LANES:
        for w in PROBE_DMA_WORDS:
            for reps in PROBE_DMA_REPS:
                same("probe_dma", P5.run(idx, hbm, w, nl, reps),
                     P5.run_plain(idx, hbm, w, nl, reps),
                     f"T5 at {nl} lanes, {w} words, {reps} rounds")
    before, refused = P5.launches, False
    try:
        P5.run(idx, hbm, 512, 128, 64)
    except ValueError:
        refused = True
    need(refused and P5.launches == before,
         "T5 did not refuse 64 rounds of 512 words, which read past the tape")
    carry = torch.from_numpy(P6.carry(8192)).to(dev)
    for body in P6.BODIES:
        same("probe_rounds", P6.rounds(body, carry, P6.ITERS[0]),
             P6.rounds_plain(body, carry, P6.ITERS[0]),
             f"T6 {body} at R 8192, K 8, {P6.ITERS[0]} rounds")
    seed = torch.arange(P78.L, dtype=torch.int32, device=dev).reshape(1, -1)
    for K, puts in P78.KGET_CASES:
        reps = P78.KGET_REPS[0]
        same("probe_kget", P78.kget(seed, reps, K, puts),
             P78.kget_plain(seed, reps, K, puts),
             f"T7 at K {K}, puts {puts}, {reps} rounds")
    tapes = {}
    for span in P78.BANDED_SPANS:
        tape, pos = (torch.from_numpy(a).to(dev) for a in P78.banded_inputs(
            P78.BANDED_ROWS, span * 64))
        tapes[span] = tape, pos
        reps = P78.BANDED_REPS[0]
        edge = pos - 40
        edge[0, :4] = torch.tensor([4 * P78.BANDED_ROWS - 3, -1, -6, 1])
        for p, mask in ((pos, None), (pos + 1, -1), (edge, -1)):
            same("probe_banded", P78.banded(tape, p, reps, mask),
                 P78.banded_plain(tape, p, reps, mask),
                 f"T8 at span {span}, mask {mask}")
    lane_tapes = {}
    for R in P3.GATHER_R:
        t = torch.from_numpy(P3.tape(R)).to(dev)
        lane_tapes[R] = t
        n = P3.lane_reps(R)
        same("probe_gather", P3.gather(t, n), P3.gather_plain(t, n),
             f"T9 at R {R}, {n} rounds")
    for R in P3.SCATTER_R:
        n = P3.lane_reps(R)
        same("probe_scatter", P3.scatter(R, n, DEVICE, whole=True),
             P3.scatter_plain(R, n, dev, whole=True),
             f"T10 at R {R}, {n} rounds")
    for key, fn, plain in (("probe_fifo", P3.fifo, P3.fifo_plain),
                           ("probe_state", P3.state, P3.state_plain)):
        same(key, fn(PROBE_STEP_REPS, DEVICE), plain(PROBE_STEP_REPS, dev),
             f"{key} at {PROBE_STEP_REPS} rounds")
    # from the tool's start T12 reaches no negative value before round
    # 55,578: random int32 states reach the signed shifts and compares
    wide = torch.from_numpy(np.random.default_rng(12).integers(
        -(1 << 31), 1 << 31, (4, P3.L)).astype(np.int32)).to(dev)
    same("probe_state", P3.state(PROBE_STEP_PLAIN, start=wide),
         P3.state_plain(PROBE_STEP_PLAIN, start=wide),
         f"T12 from random states, {PROBE_STEP_PLAIN} rounds")
    before = P3.vmem_launches
    refused = [rows for rows in P3.VMEM_ROWS
               if P3.vmem(rows, P3.RING, DEVICE) is None]
    need(refused == list(P3.VMEM_ROWS) and P3.vmem_launches == before,
         f"T13 launched or fitted a size of the tool: refused {refused}")
    limit = P3.smem_limit(dev)
    fit = P3.fit_rows(limit, P3.FIT_RING)
    out = P3.vmem(fit, P3.FIT_RING, DEVICE)
    need(out is not None, f"T13 refused rows {fit}, which fit {limit} bytes")
    same("probe_smem", out, P3.vmem_plain(fit, P3.FIT_RING, dev),
         f"T13 at rows {fit}")
    need(P3.vmem(fit + 1, P3.FIT_RING, DEVICE) is None
         and P3.vmem_launches == before + 1,
         f"T13 did not refuse rows {fit + 1} above the {limit} bytes")
    walk_tbl = torch.from_numpy(P15.walk_table()).to(dev)
    wide = torch.from_numpy(np.random.default_rng(15).integers(
        (1 << 30) - 4096, 1 << 30, P15.TBL).astype(np.int32)).to(dev)
    for t, what in ((walk_tbl, "the tool's table"), (wide, "entries near "
                                                      "2^30")):
        same("probe_walk", P15.walk(t, PROBE_WALK_STEPS),
             P15.walk_plain(t, PROBE_WALK_STEPS),
             f"T15 on {what}, {PROBE_WALK_STEPS} steps")
    harness_ins = {b: P15.body_inputs(b, dev) for b in P15.BODIES}
    t14a, t14b = P15.T14A, P15.T14B
    whole_card = [b for b, body in P15.BODIES.items()
                  if body.source == P15.WG]
    rng = np.random.default_rng(14)
    for b in t14a:
        ins, key = harness_ins[b], HARNESS + b
        wide = [torch.from_numpy(
            rng.normal(size=t.shape).astype(np.float32)
            if t.is_floating_point() else
            rng.integers(-(1 << 31), 1 << 31, t.shape).astype(np.int32)
        ).to(dev) for t in ins]
        for args, r, what in ((ins, 0, "the tool's"), (ins, 1, "the tool's"),
                              (ins, 3, "the tool's"),
                              (ins, PROBE_HARNESS_R, "the tool's"),
                              (wide, 3, "int32-wide")):
            out, sink = P15.harness(b, r, *args)
            want_out, want_sink = P15.harness_plain(b, r, *args)
            same(key, out.view(torch.int32), want_out.view(torch.int32),
                 f"T14a {b} out on {what} inputs at R {r}")
            same(key, sink, want_sink,
                 f"T14a {b} sink on {what} inputs at R {r}")
    # T14b: the float readings within E of the float64 reference (kernel
    # and plain version alike), the exact ones bit for bit; max_abs_err is
    # the kernel's largest difference from the plain version's out
    worst_e = dict.fromkeys(t14b, 0.0)
    for b in t14b:
        ins, key = harness_ins[b], HARNESS + b
        for r in (0, 1, 3, PROBE_HARNESS_R):
            out, sink = P15.harness(b, r, *ins)
            want_out, want_sink = P15.harness_plain(b, r, *ins)
            what, body = f"T14b {b} at R {r}", P15.BODIES[b]
            if body.exact:
                same(key, out.view(torch.int32), want_out.view(torch.int32),
                     f"{what}: out")
            if body.sink == torch.int32:
                same(key, sink, want_sink, f"{what}: sink")
                continue
            ref, e_out, ref_sink, e_sink = P15.harness_reference(b, r, *ins)
            for got, who in ((out, "the kernel"), (want_out, "the plain "
                                                   "version")):
                units = float(((got.double() - ref).abs()
                               / e_out.clamp_min(1e-300)).max()) if r else 0.
                need(units <= 1.0, f"{what}: {who}'s out is {units:.4f} E "
                                   "from the float64 reference")
                if got is out:
                    worst_e[b] = max(worst_e[b], units)
            for got, who in ((sink, "the kernel"), (want_sink, "the plain "
                                                    "version")):
                need(abs(float(got) - ref_sink) <= e_sink,
                     f"{what}: {who}'s sink {float(got)!r} is more than "
                     f"{e_sink!r} from {ref_sink!r}")
            errs[key] = max(errs[key], float((out - want_out).abs().max()))
    # the whole-card readings: whole and partial waves of the grid's
    # items, and the same bits from two calls (a static item list); T14a's
    # also on int32-wide inputs
    grid = P15.wg_grid(dev)
    waves = (0, 1, 3, 33, PROBE_HARNESS_R, PROBE_HARNESS_R + 1)
    for b in whole_card:
        ins, key, body = harness_ins[b], HARNESS + b, P15.BODIES[b]
        cases = [(ins, r, "") for r in waves]
        if body.rate == P15.LANES:
            wide = [torch.from_numpy(rng.integers(
                -(1 << 31), 1 << 31, t.shape).astype(np.int32)).to(dev)
                for t in ins]
            cases += [(wide, r, " on int32-wide inputs") for r in waves]
        for args, r, how in cases:
            what = f"T14 {b} on {grid} blocks at R {r}{how}"
            out, sink = P15.harness(b, r, *args)
            out2, sink2 = P15.harness(b, r, *args)
            same(key, out2.view(torch.int32), out.view(torch.int32),
                 f"{what}: a second call's out")
            same(key, sink2.reshape(1).view(torch.uint8),
                 sink.reshape(1).view(torch.uint8),
                 f"{what}: a second call's sink")
            want_out, want_sink = P15.harness_plain(b, r, *args)
            if body.exact:
                same(key, out.view(torch.int32), want_out.view(torch.int32),
                     f"{what}: out")
            if body.sink == torch.int32:
                same(key, sink, want_sink, f"{what}: sink")
                continue
            ref, e_out, ref_sink, e_sink = P15.harness_reference(b, r, *args)
            units = float(((out.double() - ref).abs()
                           / e_out.clamp_min(1e-300)).max()) if r else 0.
            need(units <= 1.0, f"{what}: out is {units:.4f} E from the "
                               "float64 reference")
            need(abs(float(sink) - ref_sink) <= e_sink,
                 f"{what}: sink {float(sink)!r} is more than {e_sink!r} "
                 f"from {ref_sink!r}")
    print(f"T14 whole-card readings on a grid of {grid} blocks (one an "
          f"SM): {', '.join(whole_card)} at R 0, 1, 3, 33, "
          f"{PROBE_HARNESS_R} and {PROBE_HARNESS_R + 1} (33: whole waves; "
          "301: a partial last wave), T14a's also on int32-wide inputs, "
          "against the plain version (out bit for bit where exact, else "
          "within E of the float64 reference), two calls each with the "
          "same bits: ok")
    print("T14b against the float64 reference (worst cell of the kernel's "
          "out in units of E, up to R "
          f"{PROBE_HARNESS_R}): " + ", ".join(
              f"{b} {worst_e[b]:.6f}" for b in t14b
              if not P15.BODIES[b].exact) + "; exact: " + ", ".join(
              f"{b} {errs[HARNESS + b]}" for b in t14b
              if P15.BODIES[b].exact))
    print(f"phase probes == plain: T4 at logN {PROBE_SORT_LOGN} on the "
          f"tool's keys and random int32 (and torch.sort; its passes as the "
          f"plan's at logN 0-{P4.MAX_LOGN}, "
          f"{plans[PROBE_SORT_TIMED][0]} at {PROBE_SORT_TIMED}), T5 at "
          f"{PROBE_DMA_LANES} lanes x {PROBE_DMA_WORDS} "
          f"words x {PROBE_DMA_REPS} rounds (64 rounds of 512 words refused), "
          f"T6 {P6.BODIES}, T7 {len(P78.KGET_CASES)} cases, T8 "
          f"{len(P78.BANDED_SPANS)} spans aligned and not, T9 at R "
          f"{P3.GATHER_R} and T10 at R {P3.SCATTER_R} (whole outputs), "
          f"T11 and T12 at {PROBE_STEP_REPS} rounds "
          f"(T12 also {PROBE_STEP_PLAIN} from random states), "
          f"T13 refused {refused} with no launch and fit rows {fit} + "
          f"{P3.FIT_RING} ({P3.scratch_bytes(fit, P3.FIT_RING)} of {limit} "
          f"bytes; one row more refused), T15 on the tool's table and one "
          f"that wraps, T14a's {len(t14a)} bodies at R 0, 1, 3 and "
          f"{PROBE_HARNESS_R} and on int32-wide inputs (out bit for bit, "
          f"sink exactly), T14b's {len(t14b)} readings at R 0, 1, 3 and "
          f"{PROBE_HARNESS_R} (within E or bit for bit): ok "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 34: the probe path, counters reset just before ----
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rcs = {m.__name__: m.main([]) for m in (P4, P5, P6, P78, P3, P15)}
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    need(not any(rcs.values()), f"a probe's main() failed: {rcs}")
    check_launches(counts, "probe", probes,
                   [k for k in mods if k not in probes])
    print(f"probe path: the six main()s at the tools' defaults (T14's "
          f"{len(P15.BODIES)} readings at the card's counts) "
          f"({t_path:.1f} s), launches "
          + str({k: counts[k] for k in probes}))

    # ---- phase 35: times per call at each row's shape ----
    logn, span = PROBE_SORT_TIMED, P78.BANDED_SPANS[-1]
    x = sorts[logn]
    nl, w, reps5 = 128, 512, PROBE_DMA_REPS[1]
    n6 = P6.ITERS[1]
    K7, reps7 = 8, P78.KGET_REPS[1]
    tape, pos = tapes[span]
    reps8 = P78.BANDED_REPS[1]
    R9, R10 = P3.GATHER_R[-1], P3.SCATTER_R[-1]
    n9, n10 = 5 * P3.lane_reps(R9), 5 * P3.lane_reps(R10)
    t9 = lane_tapes[R9]
    n11 = P3.STEP_REPS[1]
    n15 = P15.STEPS[1]
    out_bytes = 8 * P3.L * 4
    calls = {
        "probe_sort": (lambda: P4.device_sort(x),
                       lambda: P4.device_sort_plain(x),
                       2 * tensor_bytes(x), f"logN {logn}"),
        "probe_dma": (lambda: P5.launch(idx, hbm, w, nl, reps5),
                      lambda: P5.run_plain(idx, hbm, w, nl, reps5),
                      dma_bytes(nl, w, reps5),
                      f"{nl} lanes, {w} words, {reps5} rounds (the launch; "
                      f"run adds its range check's read of idx: "
                      f"{time_ms(lambda: P5.run(idx, hbm, w, nl, reps5), 10):.4f}"
                      " ms a call)"),
        "probe_rounds": (lambda: P6.rounds("getk", carry, n6),
                         lambda: P6.rounds_plain("getk", carry, n6),
                         tensor_bytes(carry) + 8 * P6.L * 4,
                         f"getk, R 8192, K 8, {n6} rounds"),
        "probe_kget": (lambda: P78.kget(seed, reps7, K7, True),
                       lambda: P78.kget_plain(seed, reps7, K7, True),
                       2 * tensor_bytes(seed),
                       f"K {K7} with puts, {reps7} rounds"),
        "probe_banded": (lambda: P78.banded(tape, pos, reps8),
                         lambda: P78.banded_plain(tape, pos, reps8),
                         4 * banded_cells(torch, tape, pos, reps8)
                         + 2 * tensor_bytes(pos),
                         f"span {span}, {reps8} rounds"),
        "probe_gather": (lambda: P3.gather(t9, n9),
                         lambda: P3.gather_plain(t9, n9),
                         4 * int((P3.last_visit(R9, n9, P3.GATHER_STRIDE, dev)
                                  >= 0).sum()) + out_bytes,
                         f"R {R9}, {n9} rounds (the cells visited read "
                         "once)"),
        "probe_scatter": (lambda: P3.scatter(R10, n10, DEVICE),
                          lambda: P3.scatter_plain(R10, n10, dev),
                          4 * int((P3.last_visit(R10, n10, P3.SCATTER_STRIDE,
                                                 dev) >= 0).sum()),
                          f"R {R10}, {n10} rounds (the cells written)"),
        "probe_fifo": (lambda: P3.fifo(n11, DEVICE),
                       lambda: P3.fifo_plain(PROBE_STEP_PLAIN, dev),
                       out_bytes, f"{n11} rounds, the plain version "
                                  f"{PROBE_STEP_PLAIN}"),
        "probe_state": (lambda: P3.state(n11, DEVICE),
                        lambda: P3.state_plain(PROBE_STEP_PLAIN, dev),
                        out_bytes, f"{n11} rounds, the plain version "
                                   f"{PROBE_STEP_PLAIN}"),
        "probe_smem": (lambda: P3.vmem(fit, P3.FIT_RING, DEVICE),
                       lambda: P3.vmem_plain(fit, P3.FIT_RING, dev),
                       out_bytes, f"rows {fit} + ring {P3.FIT_RING}, "
                                  f"the card's limit {limit} bytes"),
        "probe_walk": (lambda: P15.walk(walk_tbl, n15),
                       lambda: P15.walk_plain(walk_tbl, PROBE_WALK_STEPS),
                       tensor_bytes(walk_tbl) + out_bytes,
                       f"{n15} steps, the plain version "
                       f"{PROBE_WALK_STEPS}"),
    }
    # T14: a call at the card's higher count; the bound counts each input
    # read once, out and sink written once, and the body's operations (the
    # fewest lane operations, or the tensor FLOPs) at Body.rate an SM
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the SMs a body's kernel runs on: probe_harness_wg's grid, else one
    used = {HARNESS + b: grid if body.source == P15.WG else 1
            for b, body in P15.BODIES.items()}
    op_bound = {}
    for b, body in P15.BODIES.items():
        key, ins, n = HARNESS + b, harness_ins[b], body.card[1]
        op_bound[key] = n * body.ops / (sms * body.rate * clock * 1e3)
        calls[key] = (
            lambda b=b, n=n, ins=ins: P15.harness(b, n, *ins),
            lambda b=b, ins=ins: P15.harness_plain(b, PROBE_HARNESS_PLAIN,
                                                   *ins),
            HARNESS_READS.get(b, tensor_bytes(*ins)) + out_bytes
            + body.sink.itemsize,
            f"R {n}, the plain version {PROBE_HARNESS_PLAIN}; {body.ops} "
            f"ops and {body.nbytes} input bytes an iteration: "
            f"{op_bound[key]:.6f} ms at {sms} SMs x "
            f"{body.rate} ops x {clock} MHz, "
            f"{op_bound[key] * sms / used[key]:.6f} ms on the {used[key]} "
            "SMs the kernel uses")
    # a call of T15's 2^25 steps takes most of a second, one of T14's on
    # one SM 50-200 ms: fewer of them
    kernel_calls = {"probe_walk": 2, **{k: 2 if n == 1 else 10
                                        for k, n in used.items()}}
    sub_times = {}
    for key, (fk, fp, nbytes, shape) in calls.items():
        sub_times[key] = (time_ms(fk, kernel_calls.get(key, 10)),
                          time_ms(fp, 1), nbytes)
        bound, by = bound_ms(nbytes, op_bound.get(key, 0.0))
        print(f"[{card}] {key} at {shape}: kernel {sub_times[key][0]:.4f} ms,"
              f" plain {sub_times[key][1]:.4f} ms, bound {bound:.6f} ms by "
              f"{by} ({nbytes} bytes)")
    # a body faster than its operations on the SMs it uses would disprove
    # the count
    fast = {k: (sub_times[k][0], v * sms / used[k], used[k])
            for k, v in op_bound.items()
            if sub_times[k][0] < v * sms / used[k]}
    need(not fast, f"T14 bodies faster than their operations on the SMs "
         f"they use (kernel ms, figure ms, SMs): {fast}")
    # each row that one PyTorch call computes, in turns with that call on
    # its operands, precomputed, on the whole card (the port never calls
    # it): the call's device time from a CUDA graph of LIBRARY_CALLS calls
    # (graph_ms) and its eager time, LIBRARY_CALLS calls from Python
    # (time_ms), which a call shorter than its dispatch reads as the
    # host's; library_ms is the device time times the iterations (or
    # rounds) of the kernel's call, the factor the kernel's time an
    # iteration over the call's device time
    library, library_eager, library_of = {}, {}, {}
    factor, eager_factor = {}, {}

    def price(key, kernel_ms, fn, how, what, n, calls=LIBRARY_CALLS):
        """Time the kernel (``kernel_ms()``: ms an iteration) and ``fn``
        both ways in turns; record the row's library times and factors."""
        def on_card():
            try:
                return graph_ms(fn, calls)
            except Exception as e:   # the capture's own error, named
                raise Failed(f"{key}: {how} cannot be captured into a CUDA "
                             f"graph ({type(e).__name__}: {e})") from e
        ker, dev_ms, eager = turns(kernel_ms, on_card,
                                   lambda: time_ms(fn, calls))
        library[key], library_eager[key] = dev_ms * n, eager * n
        library_of[key] = (f"{how}, computing {what}, in turns with the "
                           f"kernel: its device time from a CUDA graph of "
                           f"{calls} calls, x {n}")
        factor[key], eager_factor[key] = ker / dev_ms, ker / eager
        return ker, dev_ms, eager

    for b, body in P15.BODIES.items():
        key, n, ins = HARNESS + b, body.card[1], harness_ins[b]
        if b in P15.T14B:
            fn, how = library_product(torch, *P15.tool_operands(b, 0, *ins))
            what = "one iteration's product"
        elif b in P15.WHOLE:
            fn, how = P15.library_call(b, *ins)
            what = "iteration 0's whole result"
        else:
            continue
        # a call on one SM takes 50-200 ms, one on every SM under 2 ms
        ker, dev_ms, eager = price(
            key, lambda key=key, n=n: time_ms(
                calls[key][0], kernel_calls[key] // 2) / n,
            fn, how, what, n)
        print(f"[{card}] {key} in turns (kernel, graph, eager, eager, "
              f"graph, kernel): kernel {ker * 1e3:.4f} us an iteration on "
              f"{used[key]} SM{'s' if used[key] > 1 else ''} "
              f"({op_bound[key] * sms / used[key] / n * 1e3:.4f} us its "
              f"figure there), {how} {dev_ms * 1e3:.4f} us a call on the "
              f"card ({factor[key]:.4f}x), {eager * 1e3:.4f} us eager "
              f"({eager_factor[key]:.4f}x"
              + (f"; allow_tf32 {torch.backends.cuda.matmul.allow_tf32})"
                 if b in P15.T14B else ")"))
    # T5, T9 and T10: their rounds do not depend on one another, and one
    # call computes a round (round 0's, dma_probe and microbench3's
    # library_call); the kernel's time a round by differencing two round
    # counts (per_iter, as their main()s)
    lo9, lo10 = P3.lane_reps(R9), P3.lane_reps(R10)
    out10 = torch.zeros((R10, P3.L), dtype=torch.int32, device=dev)
    rounds = {
        "probe_dma": (lambda k: P5.launch(idx, hbm, w, nl, k),
                      PROBE_DMA_REPS, P5.library_call(idx, hbm, w, nl),
                      "round 0's copies", reps5),
        "probe_gather": (lambda k: P3.gather(t9, k), (lo9, n9),
                         P3.library_call("gather", t9),
                         "round 0's 128 reads", n9),
        "probe_scatter": (lambda k: P3.scatter(R10, k, DEVICE), (lo10, n10),
                          P3.library_call("scatter", out10),
                          "round 0's 128 writes", n10),
    }
    for key, (run, (lo, hi), (fn, how), what, n) in rounds.items():
        ker, dev_ms, eager = price(
            key, lambda run=run, lo=lo, hi=hi: 1e3 * per_iter(run, lo, hi,
                                                            dev),
            fn, how, what, n)
        print(f"[{card}] {key} at {calls[key][3].split(' (')[0]} in turns "
              f"(kernel, graph, eager, eager, graph, kernel): kernel "
              f"{ker * 1e6:.3f} ns a round (rounds {lo} and {hi} "
              f"differenced), {how} {dev_ms * 1e3:.4f} us a call on the "
              f"card ({factor[key]:.4f}x), {eager * 1e3:.4f} us eager "
              f"({eager_factor[key]:.4f}x)")

    # ---- phase 36: T4 in turns with torch.sort; the ranking ----
    ker, dev_ms, eager = price(
        "probe_sort", lambda: time_ms(lambda: P4.device_sort(x), 10),
        lambda: torch.sort(x, dim=0), "torch.sort(dim=0)",
        "the same column sort", 1, calls=10)
    print(f"[{card}] T4 at logN {logn} in turns (T4, graph, eager, eager, "
          f"graph, T4): T4 {ker:.4f} ms ({plans[logn][0]} launches), "
          f"torch.sort {dev_ms:.4f} ms on the "
          f"card ({factor['probe_sort']:.4f}x), {eager:.4f} ms eager "
          f"({eager_factor['probe_sort']:.4f}x); no single PyTorch call "
          "computes the looped function of T6 (getk: its K gets XORed), "
          "T7 (K gets, a sum and a mask a round), T8 (a 26-word extract "
          "and a sum), T11 (three selects and an add), T12 (30 ops), T13 "
          "(a capacity probe) or T15 (a dependent load and two adds), each "
          "round carrying state to the next, nor three of T14a's bodies "
          "(vpu, sroll, lroll: chains of operations)")
    print(f"[{card}] ranking, kernel over its library call's device time "
          "(T4 a call; T5, T9, T10 a round; T14 an iteration; the eager "
          "factor in brackets): " + ", ".join(
              f"{k} {v:.4f}x ({eager_factor[k]:.4f}x)" for k, v in sorted(
                  factor.items(), key=lambda kv: -kv[1])))
    return {"errs": errs, "counts": counts, "sub_times": sub_times,
            "library": library, "library_eager": library_eager,
            "library_of": library_of, "op_bound": op_bound}


def _smoke_xla(torch, data: bytes, raw, rlen, mutants, card: str, time_ms,
               mods) -> None:
    """Phase 37: the xla engine (PyTorch tensor ops, no kernel of its
    own) on the card. ``raw``, ``rlen``: config 1's corpus on the card;
    ``mutants``: phase 4's streams and lengths and K1's (out, out_len,
    err) on them, numpy arrays."""
    from __graft_entry__ import _synth_corpus
    from lz4_sgori_torch import native
    from lz4_sgori_torch.ops import encode as E
    from lz4_sgori_torch.ops import primitives as P
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.utils import oracle

    dev = raw.device
    nb = raw.shape[0]

    def enc(r, n, bs, depth=None):
        return E.compress_blocks_device(r, n, bs, match_depth=depth,
                                        impl="xla")

    def lz4_size(blocks) -> int:
        """Bytes of liblz4's LZ4_compress_default, or of the native
        codec's (the same function) where liblz4 is absent."""
        lib = oracle.compress if oracle.available() else native.compress
        return sum(len(lib(b)) for b in blocks)

    def same_bytes(r, n, bs, depth, got=None) -> None:
        """The engine's card bytes (``got``, or a call on the card) equal
        its CPU bytes on the same blocks."""
        got = enc(r, n, bs, depth) if got is None else got
        want = enc(r.cpu(), n.cpu(), bs, depth)
        need(torch.equal(got[1].cpu(), want[1])
             and torch.equal(got[0].cpu(), want[0]),
             f"the xla engine's card bytes differ from its CPU bytes at "
             f"{bs} bytes, depth {depth}")

    # ---- phase 37: the xla engine, the counters reset just before ----
    t0 = time.perf_counter()
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    comp, clen = enc(raw, rlen, BLOCK)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t1
    peak_enc = torch.cuda.max_memory_allocated() - held
    routed = decompress_blocks_device(comp, clen, BLOCK)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xla = decompress_blocks_device(comp, clen, BLOCK, impl="xla")
    torch.cuda.synchronize()
    peak_dec = torch.cuda.max_memory_allocated() - held
    counts = {k: m.launches for k, m in mods.items()}
    check_launches(counts, "xla", ("decode_v7",),
                   [k for k in mods if k != "decode_v7"])
    need(counts["decode_v7"] == 1, f"K1 launched {counts['decode_v7']} "
                                   "times on the xla path, not once")
    need(comp.device == dev and xla[0].device == dev,
         "the xla engine left the card")
    for a, b in zip(xla, routed):
        need(torch.equal(a, b), "the xla decode differs from K1's on the "
                                "xla engine's bytes")
    out, out_len, err = xla
    pos = torch.arange(BLOCK, device=dev)[None, :]
    same = ((pos >= rlen[:, None]) | (out == raw)).all(dim=1)
    need(bool((~err & (out_len == rlen) & same).all()),
         "a block of the xla engine does not decode to its input")
    total = int(clen.sum())
    blocks = [data[j * BLOCK:(j + 1) * BLOCK] for j in range(nb)]
    vs_lz4 = total / lz4_size(blocks)
    vs_native = total / sum(len(native.compress(b)) for b in blocks)
    print(f"[{card}] xla engine, config 1 ({nb} blocks of {BLOCK}, depth "
          f"3): round trip ok through K1 (launched once, no other kernel) "
          f"and through the xla decode, equal; ratio "
          f"{len(data) / total:.4f}, size {vs_lz4:.4f}x "
          f"{'liblz4' if oracle.available() else 'native (liblz4 absent)'}"
          f", {vs_native:.4f}x native LZ4_compress_default; first call "
          f"{t_enc:.3f} s (host clock)")
    print(f"[{card}] xla engine peak memory over the {held / 2**20:.1f} "
          f"MiB held: encode {peak_enc / 2**20:.1f} MiB, decode "
          f"{peak_dec / 2**20:.1f} MiB (batches of "
          f"{max(1, P.BATCH_POSITIONS // BLOCK)} blocks)")

    # the card's bytes against the CPU's: 64 KiB at depths 1 and 3, 4 KiB
    # at depth 5, 128 KiB at depth 1
    t1 = time.perf_counter()
    si = torch.from_numpy(
        np.linspace(0, nb - 1, XLA_CPU_64K).astype(np.int64)).to(dev)
    rs, ls = raw[si].contiguous(), rlen[si].contiguous()
    same_bytes(rs, ls, BLOCK, 3, (comp[si], clen[si]))
    same_bytes(rs, ls, BLOCK, 1)
    offs = np.linspace(0, len(data) - 4096, XLA_CPU_4K).astype(int)
    b4 = [data[o:o + 4096] for o in offs]
    b4[-1] = b4[-1][:1234]
    r4, l4 = (torch.from_numpy(a).to(dev) for a in _batch(b4, 4096))
    same_bytes(r4, l4, 4096, 5)
    b128 = [data[o:o + 131072] for o in
            np.linspace(0, len(data) - 131072, XLA_CPU_128K).astype(int)]
    r128, l128 = (torch.from_numpy(a).to(dev) for a in _batch(b128, 131072))
    same_bytes(r128, l128, 131072, 1)
    print(f"phase xla: card bytes == CPU bytes on {XLA_CPU_64K} blocks of "
          f"{BLOCK} at depths 1 and 3, {XLA_CPU_4K} of 4096 at depth 5, "
          f"{XLA_CPU_128K} of 131072 at depth 1 "
          f"({time.perf_counter() - t1:.1f} s)")

    # phase 4's mutants through the xla decode on the card
    mc, ml, mo, mlen, merr = mutants
    mx = [t.cpu().numpy() for t in decompress_blocks_device(
        torch.from_numpy(mc).to(dev), torch.from_numpy(ml).to(dev), BLOCK,
        impl="xla")]
    need(np.array_equal(mx[2], merr), "the xla decode's err differs from "
                                      "K1's (golden's verdict) on a mutant")
    need(np.array_equal(mx[1], mlen) and np.array_equal(mx[0], mo),
         "the xla decode's bytes differ from K1's on a mutant")

    # bench.py's config 5b: the first 16 blocks of config 5's corpus
    d5 = _synth_corpus(XLA_5B_BLOCKS * BLOCK, seed=DEEP_SEED)
    b5 = [d5[j * BLOCK:(j + 1) * BLOCK] for j in range(XLA_5B_BLOCKS)]
    r5, l5 = (torch.from_numpy(a).to(dev) for a in _batch(b5, BLOCK))
    c5, cl5 = enc(r5, l5, BLOCK, 3)
    decodes_to(decompress_blocks_device(c5, cl5, BLOCK), b5, "config 5b")
    vs5 = int(cl5.sum()) / lz4_size(b5)
    print(f"[{card}] xla engine: deep_xla_size_vs_lz4 {vs5:.4f} (config "
          f"5b, {XLA_5B_BLOCKS} blocks of {BLOCK} at depth 3; TPU record of "
          f"the same bytes {TPU_XLA_SIZE_VS_LZ4}), config 1 {vs_lz4:.4f}; "
          f"{len(mc)} mutants: err, out_len and bytes == K1's")
    need(round(vs5, 4) == TPU_XLA_SIZE_VS_LZ4,
         f"config 5b size {vs5:.4f} differs from the TPU record")

    ms_enc = time_ms(lambda: enc(raw, rlen, BLOCK), XLA_REPS)
    ms_dec = time_ms(lambda: decompress_blocks_device(comp, clen, BLOCK,
                                                      impl="xla"), XLA_REPS)
    print(f"[{card}] xla engine over config 1 ({len(data)} bytes, CUDA "
          f"events, {XLA_REPS} runs after a warm-up): encode {ms_enc:.3f} "
          f"ms ({len(data) / ms_enc / 1e6:.4f} GB/s), decode {ms_dec:.3f} "
          f"ms ({len(data) / ms_dec / 1e6:.4f} GB/s)")
    # where one batch's time goes: torch.profiler over its encode
    nbat = max(1, P.BATCH_POSITIONS // BLOCK)
    rb, lb = raw[:nbat].contiguous(), rlen[:nbat].contiguous()
    ops = profile_ops(torch, lambda: enc(rb, lb, BLOCK))
    print(f"[{card}] xla engine, one batch of {nbat} blocks under "
          f"torch.profiler: device {ops['device_ms']:.3f} ms, host "
          f"{ops['host_ms']:.3f} ms, {ops['launches']} launches; by device "
          "time: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ops["top"]))
    print(f"phase xla: ok ({time.perf_counter() - t0:.1f} s)")


def _smoke_parallel(torch, raw, rlen, card: str, time_ms, mods) -> dict:
    """Phase 38: the block-sharded write path on NCCL at world size 1.
    ``raw``, ``rlen``: config 1's corpus on the card. Returns the phase's
    launch counts (``counts``), as the other paths do."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from lz4_sgori_torch import format as F
    from lz4_sgori_torch.ops.decode import decompress_blocks_device
    from lz4_sgori_torch.ops.encode import compress_blocks_device
    from lz4_sgori_torch.parallel import (decompress_blocks_sharded,
                                          make_mesh, stats_totals,
                                          write_pipeline_sharded)
    from lz4_sgori_torch.parallel.dist import (assemble_container_sharded,
                                               shard_rows)

    nb = raw.shape[0]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        # ---- phase 38: the sharded path, the counters reset just before
        t0 = time.perf_counter()
        mesh = make_mesh()
        need((mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cuda")
             and dist.get_backend(mesh.group) == "nccl",
             f"the mesh is not one rank on the card over NCCL: {mesh}")
        # the rank's rows (at world 1, the whole batch as a view), each
        # call's shard passed straight to the next
        r, rl = shard_rows(raw, mesh), shard_rows(rlen, mesh)
        for m in mods.values():
            m.launches = 0
        torch.cuda.synchronize()
        comp, clen, ok, stats = write_pipeline_sharded(r, rl, BLOCK, mesh)
        out, olen, err = decompress_blocks_sharded(comp, clen, BLOCK, mesh)
        payload, sizes, total = assemble_container_sharded(comp, clen, mesh)
        torch.cuda.synchronize()
        counts = {k: m.launches for k, m in mods.items()}
        check_launches(counts, "sharded", PATH64,
                       [k for k in mods if k not in PATH64])
        ucomp, uclen = compress_blocks_device(raw, rlen, BLOCK)
        need(torch.equal(clen, uclen) and torch.equal(comp, ucomp),
             "the sharded write pipeline's bytes differ from the unsharded "
             "compress_blocks_device's")
        need(bool(ok.all()), f"{int((~ok).sum())} blocks not ok in the "
                             "sharded write pipeline")
        want = (nb, 0, int(rlen.sum()), int(uclen.sum()))
        need(stats_totals(stats) == want,
             f"sharded stats {stats_totals(stats)} != host sums {want}")
        pos = torch.arange(BLOCK, device=raw.device)[None, :]
        same = ((pos >= rlen[:, None]) | (out == raw[:, :BLOCK])).all(dim=1)
        need(bool((~err & (olen == rlen) & same).all()),
             "a block of decompress_blocks_sharded differs from its input")
        ch, lh = ucomp.cpu().numpy(), uclen.cpu().numpy()
        body = b"".join(ch[j, :lh[j]].tobytes() for j in range(nb))
        t = int(total)
        p = payload.cpu().numpy()
        need(torch.equal(sizes, uclen) and t == len(body)
             and p[:t].tobytes() == body and not p[t:].any(),
             "the sharded assembly differs from the host concatenation")
        print(f"phase sharded: NCCL world 1, config 1 ({nb} blocks of "
              f"{BLOCK}): write pipeline == unsharded compress byte for "
              f"byte, {nb} blocks ok, stats == host sums {want}, decode "
              f"round trip ok, assembly == host concatenation ({t} bytes); "
              f"launches {counts} ({time.perf_counter() - t0:.1f} s)")

        def unsharded():
            c, n = compress_blocks_device(raw, rlen, BLOCK)
            o, on, e = decompress_blocks_device(c, n, BLOCK)
            s = ((pos >= rlen[:, None]) | (o == raw[:, :BLOCK])).all(dim=1)
            return ~e & (on == rlen) & s

        # the same rank with no process group: the pipeline without its
        # all_reduce, which prices the collective
        solo = dataclasses.replace(mesh, group=None)
        calls = {
            "sharded": lambda: write_pipeline_sharded(r, rl, BLOCK, mesh),
            "no group": lambda: write_pipeline_sharded(r, rl, BLOCK, solo),
            "unsharded": unsharded,
            "assembly": lambda: assemble_container_sharded(comp, clen, mesh)}
        ms = dict(zip(calls, turns(*(lambda f=f: time_ms(f, PARALLEL_REPS)
                                     for f in calls.values()))))
        mb = nb * BLOCK / 1e6
        print(f"[{card}] sharded write pipeline (NCCL, world 1) over config "
              f"1 ({nb} blocks of {BLOCK}, CUDA events, {PARALLEL_REPS} "
              f"runs, twice in turns): {ms['sharded']:.3f} ms "
              f"({mb / ms['sharded']:.4f} GB/s); with no process group (no "
              f"all_reduce) {ms['no group']:.3f} ms; unsharded compress + "
              f"decode-verify {ms['unsharded']:.3f} ms "
              f"({mb / ms['unsharded']:.4f} GB/s), sharded/unsharded "
              f"{ms['sharded'] / ms['unsharded']:.4f}; "
              f"assemble_container_sharded {ms['assembly']:.3f} ms "
              f"({nb * (F.compress_bound(BLOCK) + 8)} bytes of payload "
              f"capacity)")
        for k, fn in calls.items():
            ops = profile_ops(torch, fn, top=4)
            print(f"[{card}] {k}, one call under torch.profiler: device "
                  f"{ops['device_ms']:.3f} ms, host {ops['host_ms']:.3f} "
                  f"ms, {ops['launches']} launches; by device time: "
                  + ", ".join(f"{n} {v:.3f} ms" for n, v in ops["top"]))
    finally:
        dist.destroy_process_group()
    return {"counts": counts, "errs": {}, "sub_times": {}}


def profile_ops(torch, fn, top: int = 6) -> dict:
    """One call of ``fn`` (after a warm-up) under ``torch.profiler``:
    its device milliseconds (the aten ops' self device times, which hold
    the kernels each op launched), its host milliseconds (every event's
    self host time), its kernel launches, and the ``top`` aten ops by
    self device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    aten = sorted((e for e in ev if e.key.startswith("aten::")),
                  key=dev_us, reverse=True)
    return {"device_ms": sum(dev_us(e) for e in aten) / 1e3,
            "host_ms": sum(e.self_cpu_time_total for e in ev) / 1e3,
            "launches": sum(e.count for e in ev
                            if e.key == "cudaLaunchKernel"),
            "top": [(e.key[6:], dev_us(e) / 1e3) for e in aten[:top]]}


def library_product(torch, a, b):
    """One PyTorch product ``a @ b`` with a float32 result, and its name:
    ``torch.mm`` with ``out_dtype`` for bf16 operands where the card's
    build has it (a bf16 @ bf16 ``matmul`` returns bf16), else on float32
    copies."""
    if a.dtype == torch.float32:
        return (lambda: torch.mm(a, b)), "torch.mm"
    try:
        torch.mm(a, b, out_dtype=torch.float32)
        return (lambda: torch.mm(a, b, out_dtype=torch.float32)), \
            "torch.mm(out_dtype=float32)"
    except (RuntimeError, TypeError):
        a, b = a.float(), b.float()
        return (lambda: torch.mm(a, b)), "torch.mm on float32 copies"


if __name__ == "__main__":
    sys.exit(main())

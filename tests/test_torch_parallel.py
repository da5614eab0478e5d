"""The port's ``parallel`` (block-sharded encode, verify, stats and ordered
assembly on ``torch.distributed``) on the CPU with gloo, against itself
unsharded and against the JAX package's ``parallel`` on its 4-device CPU
mesh.

One world of 4 rank processes serves the module: a module-scoped fixture
writes the batch of ``test_parallel._batch`` (16 blocks of 1 KiB) as
``.npy`` files and starts the ranks (``_WORKER``: torch and the port only,
jax blocked, one torch thread, a free port). Each rank takes its rows
with ``shard_rows`` once and passes each call's shard straight to the
next, as the JAX package's callers pass its arrays. While they run, the
fixture runs the JAX functions on ``make_mesh(4)``, writes JAX's
``comp`` and ``comp_len``, and closes the ranks' stdin, on which each
rank waits before it decodes and assembles JAX's streams. Each rank
saves its shard and its replicated outputs as ``.npy``.

On the CPU JAX's sharded functions run the ``xla`` engine at depth 3
(``lz4_sgori_tpu/ops/routing.py``), so for the parity cases the workers
put ``compress_blocks_device(..., match_depth=3, impl="xla")`` in place
of the compress that ``dist`` calls; the port's rows are
``compress_bound(bs) + 8`` wide, JAX's ``compress_bound(bs)``, and the
port's 8 extra columns are zero.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lz4_sgori_torch import format as F
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.parallel import make_mesh, stats_totals
from lz4_sgori_torch.parallel import dist as D
from lz4_sgori_torch.parallel import mesh as M
from lz4_sgori_tpu.parallel import dist as JD
from lz4_sgori_tpu.parallel import make_mesh as j_make_mesh
from test_parallel import BS, _batch
from test_torch_threads import one_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 120      # seconds a rank may take; a hung rank fails the test
BAD_ROW = 5        # the row of JAX's streams cut short for the decode

_WORKER = r"""
import functools
import os
import sys
sys.modules["jax"] = None              # the port imports nothing of JAX
sys.modules["lz4_sgori_tpu"] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
from lz4_sgori_torch import format as F
from lz4_sgori_torch.parallel import (compress_blocks_sharded,
                                      decompress_blocks_sharded,
                                      initialize_multihost, make_mesh,
                                      write_pipeline_sharded)
from lz4_sgori_torch.ops.encode import compress_blocks_device
from lz4_sgori_torch.parallel import dist as D
from lz4_sgori_torch.parallel.dist import (assemble_container_sharded,
                                           shard_rows)
initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
mesh = make_mesh(device="cpu")
BS = int(sys.argv[5])


def load(name):
    return torch.from_numpy(np.load(f"{d}/{name}.npy"))


def save(name, t):
    np.save(f"{d}/{name}.{rank}.npy", t.cpu().numpy())


raw, rlen = load("raw"), load("rlen")
r, rl = shard_rows(raw, mesh), shard_rows(rlen, mesh)
save("mesh", torch.tensor([mesh.size, mesh.rank]))
# each call's shard goes straight into the next, as JAX's callers chain
comp, clen = compress_blocks_sharded(r, rl, BS, mesh)
save("comp", comp)
save("clen", clen)
for name, t in zip(("out", "olen", "err"),
                   decompress_blocks_sharded(comp, clen, BS, mesh)):
    save(name, t)
for name, t in zip(("wcomp", "wclen", "ok", "stats"),
                   write_pipeline_sharded(r, rl, BS, mesh)):
    save(name, t)
for name, t in zip(("payload", "sizes", "total"),
                   assemble_container_sharded(comp, clen, mesh)):
    save(name, t)
# the engine JAX's sharded functions run on the CPU (the xla engine at
# depth 3), put in place of the port's default for the parity cases
D.compress_blocks_device = functools.partial(compress_blocks_device,
                                             match_depth=3, impl="xla")
for name, t in zip(("xcomp", "xclen", "xok", "xstats"),
                   write_pipeline_sharded(r, rl, BS, mesh)):
    save(name, t)
ccomp, cclen = compress_blocks_sharded(r, rl, BS, mesh)
save("ccomp", ccomp)
save("cclen", cclen)
for name, t in zip(("cout", "colen", "cerr"),
                   decompress_blocks_sharded(ccomp, cclen, BS, mesh)):
    save(name, t)
for name, t in zip(("cpayload", "csizes", "ctotal"),
                   assemble_container_sharded(ccomp, cclen, mesh)):
    save(name, t)
D.compress_blocks_device = compress_blocks_device
try:
    shard_rows(raw[:-1], mesh)
    save("ragged_raises", torch.tensor(0))
except ValueError:
    save("ragged_raises", torch.tensor(1))
try:
    make_mesh(world + 1, device="cpu")
    save("too_many_raises", torch.tensor(0))
except ValueError:
    save("too_many_raises", torch.tensor(1))
# a mesh of the first two ranks (every rank calls new_group, once: the
# second mesh of two reuses the group)
half = make_mesh(2, device="cpu")
save("half", torch.tensor([half.size, half.rank,
                           int(make_mesh(2, device="cpu").group
                               is half.group)]))
if half.rank >= 0:
    save("half_stats", write_pipeline_sharded(
        shard_rows(raw[:4], half), shard_rows(rlen[:4], half), BS, half)[3])
sys.stdin.read()     # the parent writes JAX's streams, then closes stdin
jc, jl = load("jax_comp").numpy(), load("jax_clen")
slot = F.compress_bound(BS) + 8
jpad = torch.zeros((jc.shape[0], slot), dtype=torch.uint8)
jpad[:, :jc.shape[1]] = torch.from_numpy(jc)
jcut = jl.clone()
jcut[int(sys.argv[6])] -= 1
for name, t in zip(("jout", "jolen", "jerr"),
                   decompress_blocks_sharded(shard_rows(jpad, mesh),
                                             shard_rows(jcut, mesh), BS,
                                             mesh)):
    save(name, t)
for name, t in zip(("jpayload", "jsizes", "jtotal"),
                   assemble_container_sharded(
                       shard_rows(torch.from_numpy(jc), mesh),
                       shard_rows(jl, mesh), mesh)):
    save(name, t)
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank}: done", flush=True)
os._exit(0)   # past torch's teardown at interpreter exit (see _finish)
"""

_MULTIHOST = r"""
import os
import sys
sys.modules["jax"] = None
import torch
import torch.distributed as dist
torch.set_num_threads(1)
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from lz4_sgori_torch.parallel import initialize_multihost
initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid, device="cpu")
assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
x = torch.full((1,), pid + 1, dtype=torch.int32)
dist.all_reduce(x)
assert int(x[0]) == sum(range(1, nproc + 1)), x
print(f"proc {pid}: all_reduce ok = {int(x[0])}", flush=True)
dist.barrier()
dist.destroy_process_group()
os._exit(0)
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _start(script, args_of_rank, n: int):
    """Start ``n`` ranks of ``script``, each writing its output to a file
    beside it and reading its stdin from a pipe."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for r in range(n):
        with open(f"{script}.{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *args_of_rank(r)], env=env,
                stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _finish(script, procs) -> list[str]:
    """Close every rank's stdin, then wait for each; every rank is stopped,
    whatever happens, and a rank that failed or hung fails the test.
    The workers leave by ``os._exit(0)`` once their group is destroyed: a
    rank that had finished once aborted in torch's teardown at
    interpreter exit ("terminate called without an active exception")
    under the load of a full parallel test run."""
    try:
        for p in procs:
            p.stdin.close()
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(f"{script}.{r}.log").read() for r in range(len(procs))]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def _jax_reference(raw, rlen) -> dict:
    """JAX's write pipeline on its 4-device mesh, its decode of its own
    streams (``BAD_ROW`` cut one byte short), its assembly, and its
    compress chained into its assembly and its decode (``c*``)."""
    mesh = j_make_mesh(WORLD)
    comp, clen, ok, stats = (np.asarray(a) for a in
                             JD.write_pipeline_sharded(raw, rlen, BS, mesh))
    slot = F.compress_bound(BS) + 8
    pad = np.zeros((comp.shape[0], slot), np.uint8)
    pad[:, :comp.shape[1]] = comp
    cut = clen.copy()
    cut[BAD_ROW] -= 1
    out, olen, err = (np.asarray(a) for a in
                      JD.decompress_blocks_sharded(pad, cut, BS, mesh))
    payload, sizes, total = (np.asarray(a) for a in
                             JD.assemble_container_sharded(comp, clen, mesh))
    ccomp, cclen = JD.compress_blocks_sharded(raw, rlen, BS, mesh)
    cpayload, csizes, ctotal = (np.asarray(a) for a in
                                JD.assemble_container_sharded(ccomp, cclen,
                                                              mesh))
    ccomp, cclen = np.asarray(ccomp), np.asarray(cclen)
    cpad = np.zeros((ccomp.shape[0], slot), np.uint8)
    cpad[:, :ccomp.shape[1]] = ccomp
    cout, colen, cerr = (np.asarray(a) for a in
                         JD.decompress_blocks_sharded(cpad, cclen, BS, mesh))
    return dict(comp=comp, clen=clen, ok=ok, stats=stats, out=out,
                olen=olen, err=err, payload=payload, sizes=sizes,
                total=total, ccomp=ccomp, cclen=cclen, cpayload=cpayload,
                csizes=csizes, ctotal=ctotal, cout=cout, colen=colen,
                cerr=cerr)


@pytest.fixture(scope="module")
def world(tmp_path_factory, fixtures):
    """Run the 4-rank world (and, meanwhile, the JAX package's functions);
    returns (raw, rlen, ranks, jax): ``ranks`` a dict of name -> list of
    the ranks' arrays."""
    d = tmp_path_factory.mktemp("world")
    raw, rlen = _batch(fixtures)
    np.save(d / "raw.npy", raw)
    np.save(d / "rlen.npy", rlen)
    script = d / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    procs = _start(script, lambda r: [str(r), str(WORLD), port, str(d),
                                      str(BS), str(BAD_ROW)], WORLD)
    try:
        ref = _jax_reference(raw, rlen)
        np.save(d / "jax_comp.npy", ref["comp"])
        np.save(d / "jax_clen.npy", ref["clen"])
    finally:
        _finish(script, procs)
    ranks = {}
    for f in sorted(os.listdir(d)):
        name, _, rest = f.partition(".")
        if rest[:-4].isdigit():
            ranks.setdefault(name, []).append(np.load(d / f))
    for name, v in ranks.items():
        assert len(v) == (2 if name == "half_stats" else WORLD), name
    return raw, rlen, ranks, ref


def _cat(ranks, name):
    return np.concatenate(ranks[name])


def test_mesh_without_process_group(monkeypatch):
    """A single process is a mesh of one, with no process group; asking for
    more ranks than the world has raises JAX's ValueError; ``cuda`` without
    a card raises and does not fall back to the CPU."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.axis == M.BLOCK_AXIS and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.initialize_multihost("127.0.0.1:1", 2, 0)


def test_world_meshes(world):
    """Each rank of the world is its own place on a mesh of 4; a mesh of 5
    raises; the mesh of the first two ranks holds ranks 0 and 1 (the
    others -1), a second one has the same group, and its stats over 4
    blocks are the sums of those blocks."""
    raw, rlen, ranks, _ = world
    assert [list(m) for m in ranks["mesh"]] == [[WORLD, r]
                                                 for r in range(WORLD)]
    assert all(int(x) == 1 for x in ranks["too_many_raises"])
    assert [list(m) for m in ranks["half"]] == [[2, 0, 1], [2, 1, 1],
                                                 [2, -1, 1], [2, -1, 1]]
    clen = _cat(ranks, "wclen")[:4]
    s0, s1 = ranks["half_stats"]
    assert np.array_equal(s0, s1)
    assert stats_totals(s0) == (4, 0, int(rlen[:4].sum()), int(clen.sum()))


def test_sharded_roundtrip(world):
    raw, rlen, ranks, _ = world
    assert not _cat(ranks, "err").any()
    assert np.array_equal(_cat(ranks, "olen"), rlen)
    assert np.array_equal(_cat(ranks, "out"), raw)


def test_write_pipeline_stats(world):
    raw, rlen, ranks, _ = world
    assert _cat(ranks, "ok").all()
    total, failed, raw_bytes, comp_bytes = stats_totals(ranks["stats"][0])
    assert total == raw.shape[0]
    assert failed == 0
    assert raw_bytes == int(rlen.sum())
    assert comp_bytes == int(_cat(ranks, "wclen").sum())


def test_sharded_matches_unsharded(world):
    """The shards, in rank order, are the unsharded port's bytes on the
    default route (the compress and the write pipeline alike)."""
    raw, rlen, ranks, _ = world
    c2, l2 = compress_blocks_device(torch.from_numpy(raw),
                                    torch.from_numpy(rlen), BS)
    for comp, clen in (("comp", "clen"), ("wcomp", "wclen")):
        assert np.array_equal(_cat(ranks, clen), l2.numpy())
        assert np.array_equal(_cat(ranks, comp), c2.numpy())


def test_assembly_matches_host_concatenation(world):
    _, _, ranks, _ = world
    comp, clen = _cat(ranks, "comp"), _cat(ranks, "clen")
    want = b"".join(comp[j, :clen[j]].tobytes() for j in range(len(clen)))
    payload, sizes = ranks["payload"][0], ranks["sizes"][0]
    total = int(ranks["total"][0])
    assert payload.dtype == np.uint8 and sizes.dtype == np.int32
    assert payload.shape == (comp.size,)
    assert np.array_equal(sizes, clen)
    assert total == len(want)
    assert payload[:total].tobytes() == want
    assert not payload[total:].any()


def test_replicated_outputs_equal_on_every_rank(world):
    _, _, ranks, _ = world
    for name in ("stats", "xstats", "payload", "sizes", "total", "jpayload",
                 "jsizes", "jtotal"):
        for r in range(1, WORLD):
            assert np.array_equal(ranks[name][r], ranks[name][0]), (name, r)


def test_batch_not_dividing_the_world_raises(world):
    """JAX's contract: num_blocks must divide the mesh size, and
    ``pad_to_multiple`` gives the padded count."""
    assert all(int(x) == 1 for x in world[2]["ragged_raises"])
    assert [D.pad_to_multiple(n, WORLD) for n in (0, 1, 15, 16, 17)] == \
        [0, 4, 16, 16, 20]
    mesh = M.Mesh(M.BLOCK_AXIS, WORLD, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        D.shard_rows(np.zeros((6, BS), np.uint8), mesh)
    assert D.shard_rows(np.arange(8), mesh).tolist() == [0, 1]


def test_write_pipeline_matches_jax(world):
    """The port's xla route at depth 3 against JAX's pipeline on its CPU
    mesh: comp's first compress_bound(bs) columns, comp_len, ok and the
    6-word stats exactly, and the port's 8 extra columns zero."""
    _, _, ranks, ref = world
    comp = _cat(ranks, "xcomp")
    width = F.compress_bound(BS)
    assert ref["comp"].shape[1] == width and comp.shape[1] == width + 8
    assert np.array_equal(comp[:, :width], ref["comp"])
    assert not comp[:, width:].any()
    assert np.array_equal(_cat(ranks, "xclen"), ref["clen"])
    assert np.array_equal(_cat(ranks, "xok"), ref["ok"])
    assert ref["stats"].dtype == ranks["xstats"][0].dtype == np.int32
    assert np.array_equal(ranks["xstats"][0], ref["stats"])


def test_chain_matches_jax(world):
    """``compress_blocks_sharded``'s shards passed straight to
    ``decompress_blocks_sharded`` and ``assemble_container_sharded``, with
    no gather between, give JAX's chain: its streams, its decode, and its
    payload's bytes, sizes and total (the payload's capacity is each
    package's own row width times the blocks, zero past ``total``)."""
    raw, rlen, ranks, ref = world
    width = F.compress_bound(BS)
    comp = _cat(ranks, "ccomp")
    assert np.array_equal(comp[:, :width], ref["ccomp"])
    assert not comp[:, width:].any()
    assert np.array_equal(_cat(ranks, "cclen"), ref["cclen"])
    assert not _cat(ranks, "cerr").any() and not ref["cerr"].any()
    assert np.array_equal(_cat(ranks, "colen"), ref["colen"])
    assert np.array_equal(_cat(ranks, "cout"), ref["cout"])
    assert np.array_equal(ref["cout"], raw)
    payload, total = ranks["cpayload"][0], int(ranks["ctotal"][0])
    assert total == int(ref["ctotal"])
    assert np.array_equal(ranks["csizes"][0], ref["csizes"])
    assert payload.shape == (comp.size,)
    assert np.array_equal(payload[:total], ref["cpayload"][:total])
    assert not payload[total:].any() and not ref["cpayload"][total:].any()
    for name in ("cpayload", "csizes", "ctotal"):
        for r in range(1, WORLD):
            assert np.array_equal(ranks[name][r], ranks[name][0]), (name, r)


def test_decompress_matches_jax(world):
    """Both decode JAX's streams (``BAD_ROW`` one byte short): the same
    err, and the same bytes and lengths on the rows without err."""
    _, _, ranks, ref = world
    err = _cat(ranks, "jerr")
    assert np.array_equal(err, ref["err"])
    assert err[BAD_ROW] and err.sum() == 1
    good = ~err
    assert np.array_equal(_cat(ranks, "jolen")[good], ref["olen"][good])
    assert np.array_equal(_cat(ranks, "jout")[good], ref["out"][good])


def test_assembly_matches_jax(world):
    """The port's assembly fed JAX's own comp and comp_len gives JAX's
    payload, sizes and total."""
    _, _, ranks, ref = world
    for name in ("payload", "sizes", "total"):
        got = ranks["j" + name][0]
        assert got.dtype == ref[name].dtype, name
        assert np.array_equal(got, ref[name]), name


def test_initialize_multihost_two_processes(tmp_path):
    """Two gloo processes join through initialize_multihost(device="cpu")
    and an all_reduce crosses them."""
    script = tmp_path / "multihost.py"
    script.write_text(_MULTIHOST)
    port = _free_port()
    outs = _finish(script, _start(script, lambda r: [str(r), "2", port], 2))
    for out in outs:
        assert "all_reduce ok = 3" in out, out


def test_initialize_multihost_one_process_is_a_no_op():
    for n in (None, 1):
        D.initialize_multihost("127.0.0.1:1", n, 0)
        assert not torch.distributed.is_initialized()

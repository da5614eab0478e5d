"""Sharded codec entry points and the distributed write pipeline.

Port of ``lz4_sgori_tpu/parallel/dist.py`` onto ``torch.distributed``:
the write pipeline compresses, decode-verifies and accumulates stats,
block-parallel over the ranks of a ``Mesh``. JAX's ``shard_map`` becomes
each rank working on its own rows; ``psum`` becomes
``dist.all_reduce`` (SUM) and the ordered ``all_gather`` the list form of
``dist.all_gather``, in rank order.

Every call takes the rank's own rows, as a ``shard_map`` body sees its
shard, and returns the rank's rows where the JAX function's output is
sharded over the block axis and a tensor equal on every rank where it is
replicated. So the calls chain as the JAX package's do: the shard one
call returns is the shard the next takes. ``shard_rows`` splits a global
batch once, into rows ``[rank * n / size, (rank + 1) * n / size)`` on
``mesh.device``; ``num_blocks`` must divide the mesh size (the host
framing layer pads with empty blocks, ``pad_to_multiple``), so every
rank holds as many rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..blocks import resolve_device
from ..ops.decode import decompress_blocks_device
from ..ops.encode import compress_blocks_device
from ..ops.primitives import exclusive_cumsum
from .mesh import BLOCK_AXIS, Mesh


def pad_to_multiple(num_blocks: int, n_shards: int) -> int:
    return -(-num_blocks // n_shards) * n_shards


def _on_mesh(mesh: Mesh, axis: str, *arrays):
    """Each of this rank's arrays on ``mesh.device``."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")
    return [torch.as_tensor(a).to(mesh.device) for a in arrays]


def shard_rows(x, mesh: Mesh, axis: str = BLOCK_AXIS) -> torch.Tensor:
    """This rank's rows of the global batch ``x``, on ``mesh.device``:
    what the sharded calls take. Raises ``ValueError`` unless the rows
    divide the mesh size (JAX's contract; pad with ``pad_to_multiple``)."""
    (x,) = _on_mesh(mesh, axis, x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"num_blocks {n} does not divide the mesh size "
                         f"{mesh.size}; pad with pad_to_multiple")
    return x[mesh.rank * n // mesh.size:(mesh.rank + 1) * n // mesh.size]


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated in rank order."""
    if mesh.group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def compress_blocks_sharded(raw, raw_len, block_size: int, mesh: Mesh,
                            axis: str = BLOCK_AXIS):
    """Shard-parallel batched encode of this rank's rows: its
    (comp, comp_len)."""
    r, rl = _on_mesh(mesh, axis, raw, raw_len)
    return compress_blocks_device(r, rl, block_size)


def decompress_blocks_sharded(comp, comp_len, out_size: int, mesh: Mesh,
                              axis: str = BLOCK_AXIS):
    """Shard-parallel batched decode of this rank's rows: its
    (out, out_len, err)."""
    c, cl = _on_mesh(mesh, axis, comp, comp_len)
    return decompress_blocks_device(c, cl, out_size)


def write_pipeline_sharded(raw, raw_len, block_size: int, mesh: Mesh,
                           axis: str = BLOCK_AXIS):
    """The full write-request pipeline, sharded: compress -> decode-verify
    -> global stats all_reduce (lz4e_req.c:144-213: SG-compress,
    verify-decompress, stats update).

    Takes this rank's rows; returns (comp, comp_len, ok, stats): its comp,
    comp_len and ok, and stats, the same on every rank:
    stats = [blocks_total, blocks_failed, raw_hi, raw_lo, comp_hi, comp_lo]
    int32. The byte counters are split at bit 8 (bytes = hi * 256 + lo) so
    the int32 sum cannot wrap for any step up to the format's 2 GB-per-
    block envelope. A block the engine could not encode (comp_len 0)
    counts as failed; there is no host re-encode here. Reassemble with
    ``stats_totals``.
    """
    r, rl = _on_mesh(mesh, axis, raw, raw_len)
    r = r[:, :block_size]
    rl = rl.to(torch.int32)
    # the port's comp is compress_bound(bs) + 8 wide, the decoder's pad
    # bytes included: none of the padding JAX's pipeline adds is needed
    comp, clen = compress_blocks_device(r, rl, block_size)
    out, olen, err = decompress_blocks_device(comp, clen, block_size)
    pos = torch.arange(block_size, device=r.device)[None, :]
    same = ((pos >= rl[:, None]) | (out == r)).all(dim=1)
    ok = ~err & (olen == rl) & same
    rb = torch.where(ok, rl, 0)
    cb = torch.where(ok, clen, 0)
    stats = torch.stack([
        torch.ones_like(rl).sum(), (~ok).sum(),
        (rb >> 8).sum(), (rb & 255).sum(),
        (cb >> 8).sum(), (cb & 255).sum()]).to(torch.int32)
    if mesh.group is not None:
        dist.all_reduce(stats, group=mesh.group)
    return comp, clen, ok, stats


def stats_totals(stats):
    """Reassemble write_pipeline_sharded's split counters into Python ints:
    (blocks_total, blocks_failed, raw_bytes, comp_bytes)."""
    s = torch.as_tensor(stats).cpu().numpy().astype(np.int64)
    return int(s[0]), int(s[1]), int(s[2] * 256 + s[3]), int(s[4] * 256 + s[5])


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         device="cuda") -> None:
    """Bring up the process group across processes or hosts: NCCL for
    ``device="cuda"`` (which raises without CUDA), gloo for
    ``device="cpu"``. ``coordinator_address`` is ``host:port`` of rank 0.
    No-op when running single-process."""
    if num_processes in (None, 1):
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def assemble_container_sharded(comp, comp_len, mesh: Mesh,
                               axis: str = BLOCK_AXIS):
    """Explicit cross-shard ordered assembly: all_gather the per-shard
    compressed sizes and slot-padded rows, derive global byte offsets, and
    build the dense payload with every block's bytes packed back-to-back in
    original block order (lz4e_compress.c:533, lz4e_req.c:191-198).

    comp: uint8 [n, slot], comp_len int32 [n], this rank's rows (every
    rank holds n of the num_blocks = n * mesh.size).
    Returns (payload uint8 [num_blocks * slot], sizes int32 [num_blocks],
    total int32), the same on every rank; payload[:total] is the packed
    container body and zero past it.
    """
    c, cl = _on_mesh(mesh, axis, comp, comp_len)
    nblocks, slot = c.shape[0] * mesh.size, c.shape[1]
    sizes = _gather(mesh, cl.to(torch.int32))
    full = _gather(mesh, c.to(torch.uint8)).reshape(-1)
    offs = exclusive_cumsum(sizes.to(torch.int64))
    total = offs[-1] + sizes[-1]
    # dense pack: for every output byte t, its block by searchsorted over
    # the offsets, then its byte within the block
    t = torch.arange(nblocks * slot, device=mesh.device)
    blk = (torch.searchsorted(offs, t, right=True) - 1).clamp(0, nblocks - 1)
    within = (t - offs[blk]).clamp(0, slot - 1)
    payload = torch.where(t < total, full[blk * slot + within], 0)
    return payload.to(torch.uint8), sizes, total.to(torch.int32)

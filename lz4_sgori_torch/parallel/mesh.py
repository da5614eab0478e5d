"""The block mesh: the ranks of a ``torch.distributed`` process group over
which independent blocks shard.

Port of ``lz4_sgori_tpu/parallel/mesh.py``. JAX's ``Mesh`` of devices
becomes the process group: one rank a device, blocks split over the
ranks in rank order. A single process needs no process group, just as
the JAX package needs no ``jax.distributed``: it is a mesh of one.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..blocks import resolve_device

BLOCK_AXIS = "blocks"

# the groups of the first ranks, made once in each world: every
# dist.new_group makes a communicator that nothing frees, and a mesh, as
# in the JAX package, is cheap to ask for again
_first = (None, {})     # (the world they were made in, {size: group})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ``size`` ranks. ``rank`` is this process's place on
    it (-1 for a process outside a mesh of the first ranks), ``group`` the
    process group its collectives run over (None for a mesh of one
    process with no process group), ``device`` the rank's device."""

    axis: str
    size: int
    rank: int
    group: object
    device: torch.device


def _first_ranks(size: int):
    """The process group of ranks ``0..size-1`` of the current world."""
    global _first
    world = dist.group.WORLD
    if _first[0] is not world:
        _first = (world, {})
    groups = _first[1]
    if size not in groups:
        groups[size] = dist.new_group(list(range(size)))
    return groups[size]


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS, *,
              device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (every rank when None).

    With a process group up, the world is ``dist.get_world_size()`` ranks;
    without one, a single rank 0. A smaller ``n_devices`` takes ranks
    ``0..n-1`` through ``dist.new_group``, which every rank must call
    (once in a world: the group is kept for the next call).
    ``device="cuda"`` gives rank r the card ``LOCAL_RANK`` (else r modulo
    the cards present) and raises without CUDA; ``device="cpu"`` runs the
    kernels' plain versions, with gloo as the group's backend.
    """
    dev = resolve_device(device)
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    size = world if n_devices is None else n_devices
    group = None
    if up:
        group = dist.group.WORLD if size == world else _first_ranks(size)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    return Mesh(axis, size, rank if rank < size else -1, group, dev)

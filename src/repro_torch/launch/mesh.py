"""The flat mesh of the sharded analyze: one ``torch.distributed`` rank per
shard.

The reference is single-controller (one JAX process drives a mesh through
``shard_map``); PyTorch's idiom for several devices is one process per rank,
so the port's mesh is SPMD: every rank calls ``repro_torch.analyze(a, opts,
mesh=mesh)``, relaxes its own row of the interleaved source matrix, and
after the collectives holds the whole, identical plan.  GSoFa shards
*sources* over the flattened device space, so one axis (``FLAT_AXIS``) is
the whole story at any scale.

``make_flat_mesh()`` takes the initialized default process group's world,
or — with no process group — a one-shard mesh with no group, on which every
collective is the identity (the reference's "1-device mesh on a laptop").
Functions, not module-level state: importing this module touches neither
the card nor the process group.  The mesh is never stored in a plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device

FLAT_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class FlatMesh:
    """One-axis ``(shards,)`` mesh over a process group: ``size`` ranks,
    this process is ``rank`` and runs its shard on ``device``.  ``group``
    is None for the one-shard mesh of a process with no process group."""

    group: Optional[object]
    size: int
    rank: int
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str]:
        return (FLAT_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return {FLAT_AXIS: self.size}


def _world() -> Tuple[Optional[object], int, int]:
    """(group, size, rank) of the default process group, or (None, 1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def visible_device_count() -> int:
    """Devices this process can place work on right now — what
    ``LUPlan.place()`` and the dynamic runtime default to: the world size
    under a process group, else the CUDA device count on a card, else 1."""
    group, size, _ = _world()
    if group is not None:
        return size
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def rank_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: ``cuda:(rank % device_count)`` by default
    (several ranks share a card when there are fewer cards than ranks),
    ``device`` when the caller names one (``"cpu"`` for a CPU world)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)                 # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_flat_mesh(n_devices: Optional[int] = None, *,
                   device=None) -> FlatMesh:
    """One-axis mesh over the default process group (every rank calls it).

    ``n_devices=None`` takes the whole world; an explicit ``n_devices``
    must equal it (a flat mesh spans its process group: start a world of
    that many ranks).  Without a process group the mesh is one shard.
    ``device`` as in ``rank_device``."""
    group, size, rank = _world()
    if n_devices is not None:
        if not 1 <= n_devices <= size:
            raise ValueError(f"n_devices={n_devices} out of range for "
                             f"{size} visible device(s)")
        if n_devices != size:
            raise ValueError(
                f"n_devices={n_devices}: a flat mesh spans its whole "
                f"process group ({size} ranks); start a world of "
                f"{n_devices} ranks instead")
    return FlatMesh(group=group, size=size, rank=rank,
                    device=rank_device(rank, device))

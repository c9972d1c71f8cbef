"""Start a gloo world of ranks on this machine (a helper of the port's
tests and of ``chip_smoke.py``, not part of the package).

``run_world(n, fn, *args, workdir=...)`` spawns ``n`` processes with
``torch.multiprocessing`` (the ``spawn`` method); each joins the default
process group on the ``gloo`` backend through a ``FileStore`` under
``workdir`` — no TCP port, so worlds started side by side never clash —
runs ``fn(rank, n, *args)``, leaves the group and hands its result back
(pickled under ``workdir``).  ``fn`` must be importable by name (a
module-level function).  A rank that raises fails the whole world:
``torch.multiprocessing`` stops the other ranks and ``run_world`` raises
with the rank's traceback.

Every rank sees the same cards; ``repro_torch.launch.mesh.make_flat_mesh``
puts rank r on ``cuda:(r % device_count)``, so a world larger than the
card count shares cards.  A user's own job starts its world with
``torchrun --nproc_per_node N script.py`` instead
(``init_process_group("gloo")`` reads its environment).
"""
from __future__ import annotations

import datetime
import os
import pickle
from pathlib import Path
from typing import Callable, List


def _rank_main(rank: int, world_size: int, store: str, workdir: str,
               fn: Callable, args: tuple, timeout_s: float) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world_size), rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    path = Path(workdir) / f"rank{rank}.pkl"
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, path)


def run_world(world_size: int, fn: Callable, *args, workdir,
              timeout_s: float = 600.0) -> List[object]:
    """Run ``fn(rank, world_size, *args)`` on every rank of a fresh gloo
    world of ``world_size`` processes; returns the ranks' results in rank
    order.  ``workdir`` is an empty directory this call may write to;
    ``timeout_s`` bounds each collective."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        raise ValueError(f"{store} exists: give each world a fresh workdir")
    mp.spawn(_rank_main, args=(world_size, str(store), str(workdir), fn,
                               args, timeout_s),
             nprocs=world_size, join=True)
    out = []
    for rank in range(world_size):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out

"""Checkpoint I/O (no external deps: an npz of arrays and a JSON manifest).

The port of the JAX package's ``checkpoint/io.py``, with its layout::

    step_000123/
      manifest.json       # step, leaf paths with shapes and dtypes, extra
      arrays.npz          # one entry per leaf (path -> ndarray)
      done                # commit marker, written last

A tree is nested dicts, lists and tuples of tensors (``(params, opt)`` in
the train driver); a leaf's path joins its keys and indices with ``/``
(``0/groups/3/l0/mixer/wq``), as the reference names its leaves.  The
manifest stores no JAX treedef: a load takes the structure from a
``template`` tree and reads each of its leaves by path.  bfloat16 leaves,
which numpy has no type for, are stored as their 16 bits (int16) and the
manifest keeps their dtype.

Fault tolerance: a crash mid-write leaves no ``done`` marker, so
``latest_step`` never picks a torn checkpoint and a restart falls back to
the previous complete one.  ``CheckpointManager`` adds retention, async
writes (the save runs on a worker thread after the tensors are copied to
the host), and the data pipeline's state in ``extra``.  The reference's
``reshard_checkpoint`` (a device_put under another mesh) becomes
``load_checkpoint(..., device=)``: a checkpoint holds whole arrays, so it
restores onto any device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: leaf} in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten(template, leaves, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return leaves[prefix]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """(array, dtype name) of every leaf, copied off the device and off
    the live tensors (the train step updates them in place)."""
    return {k: (np.array(_to_numpy(v), copy=True), str(v.dtype)[6:])
            for k, v in _flatten(tree).items()}


def _write(directory: str, step: int, flat, extra: Optional[Dict]) -> str:
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    # commit marker last: readers only trust directories containing it
    with open(os.path.join(path, "done"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    return path


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: Optional[Dict] = None) -> str:
    """Write one complete checkpoint; returns its path."""
    return _write(directory, step, _snapshot(tree), extra)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete (``done``-marked) step under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "done")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(directory: str, template, *, step: Optional[int] = None,
                    device=None) -> Tuple[Any, int, Dict]:
    """Load into the structure of ``template`` (its leaves name the paths
    to read) on ``device`` (``None``: the card); returns (tree, step,
    extra).  ``step`` defaults to the latest complete one."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under "
                                    f"{directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key in _flatten(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = torch.from_numpy(np.array(data[key], copy=True))
            dt = _TORCH_DTYPES.get(manifest["leaves"][key]["dtype"])
            if dt is not None:
                t = t.view(dt)
            leaves[key] = t.to(dev)
    return (_unflatten(template, leaves), manifest["step"],
            manifest.get("extra", {}))


class CheckpointManager:
    """Retention + async saves + pipeline-state capture."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Join the write in flight; re-raise its error, if it failed."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save(self, step: int, flat, extra) -> None:
        try:
            _write(self.directory, step, flat, extra)
            self._gc()
        except Exception as e:      # the thread's boundary: wait() raises it
            self._error = e

    def save(self, step: int, tree, *, extra: Optional[Dict] = None) -> None:
        flat = _snapshot(tree)              # off the device first
        self.wait()
        if self.async_save:
            self._worker = threading.Thread(
                target=self._save, args=(step, flat, extra), daemon=True)
            self._worker.start()
        else:
            self._save(step, flat, extra)
            self.wait()

    def restore(self, template, *, step: Optional[int] = None, device=None):
        self.wait()
        return load_checkpoint(self.directory, template, step=step,
                               device=device)

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

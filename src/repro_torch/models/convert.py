"""Carry the reference's parameters into the port.

``params_from_jax`` takes the tree that the JAX package's
``models/transformer.py::init_params`` builds, with every leaf already a
numpy array (``jax.tree.map(np.asarray, params)`` on the caller's side), and
returns the port's parameters: the same nested dict of tensors, except that
``groups`` and ``encoder.layers`` — stacked by the reference along a
leading ``n_groups`` / ``n_enc_layers`` axis for ``lax.scan`` (``jax.vmap``
of the per-group / per-layer init) — become lists of one dict per group /
layer.  ``opt_from_jax`` maps the reference's AdamW state the same way
(``master``, ``m`` and ``v`` are trees of the parameters' structure), and
a gradient tree converts as a parameter tree does.  Nothing here imports
JAX; only the tests hold both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, copy=True), device=device)


def _group(tree, g: int):
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _unstack(tree, device):
    """A stacked tree as a list of its slices along the leading axis."""
    n = len(next(iter(_leaves(tree))))
    return [_tensors(_group(tree, g), device) for g in range(n)]


def params_from_jax(tree: Dict, device=None) -> Dict:
    """The port's parameters, on ``device`` (``None``: the card), from a
    reference parameter tree of numpy arrays."""
    dev = resolve_device(device)
    out = {k: _tensors(v, dev) for k, v in tree.items()
           if k not in ("groups", "encoder")}
    out["groups"] = _unstack(tree["groups"], dev)
    if "encoder" in tree:
        out["encoder"] = {"layers": _unstack(tree["encoder"]["layers"], dev),
                          "norm": _tensors(tree["encoder"]["norm"], dev)}
    return out


def opt_from_jax(opt_tree: Dict, device=None) -> Dict:
    """The port's AdamW state (``train/optimizer.py``), on ``device``
    (``None``: the card), from the reference's ``init_adamw`` /
    ``adamw_update`` state of numpy arrays."""
    dev = resolve_device(device)
    out = {k: params_from_jax(opt_tree[k], dev)
           for k in ("master", "m", "v")}
    out["count"] = _tensors(opt_tree["count"], dev)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

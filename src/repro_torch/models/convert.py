"""Carry the reference's parameters into the port.

``params_from_jax`` takes the tree that the JAX package's
``models/transformer.py::init_params`` builds, with every leaf already a
numpy array (``jax.tree.map(np.asarray, params)`` on the caller's side), and
returns the port's parameters: the same nested dict of tensors, except that
``groups`` — stacked by the reference along a leading ``n_groups`` axis for
``lax.scan`` — becomes a list of one dict per group.  Nothing here imports
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


def params_from_jax(tree: Dict, device=None) -> Dict:
    """The port's parameters, on ``device`` (``None``: the card), from a
    reference parameter tree of numpy arrays."""
    dev = resolve_device(device)
    out = {k: _tensors(v, dev) for k, v in tree.items() if k != "groups"}
    n_groups = len(next(iter(_leaves(tree["groups"]))))
    out["groups"] = [_tensors(_group(tree["groups"], g), dev)
                     for g in range(n_groups)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

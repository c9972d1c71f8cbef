"""AdamW with float32 master weights.

The port of the JAX package's ``train/optimizer.py``.  State layout:
``{"master": float32 params, "m": float32, "v": float32, "count": int32
()}``, each of the first three a tree of the parameters' structure (nested
dicts and lists of tensors).  Model parameters may be bfloat16 (the
compute copy); the update runs in float32 against the master and casts
back.  The schedule and the bias corrections are float32 tensors on the
parameters' device, as the reference computes them (``b1 ** count`` in
float32), not Python floats.  The reference returns new trees; here
``adamw_update`` updates the parameters and the state IN PLACE, under
``torch.no_grad()``, and returns the same trees.  ZeRO-1 sharding of the
state has no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(acfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, a float32 0-d tensor
    of the int32 ``step``."""
    s = step.float()
    warm = s / max(1.0, acfg.warmup_steps)
    prog = torch.clip((s - acfg.warmup_steps)
                      / max(1.0, acfg.decay_steps - acfg.warmup_steps), 0, 1)
    cos = acfg.min_lr_frac + (1 - acfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, s) * prog))
    return acfg.lr * torch.where(s < acfg.warmup_steps, warm, cos)


def tree_leaves(tree):
    """The tensors of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_zip(tree, *others):
    """Tuples of the leaves of ``tree`` and the same-placed leaves of
    ``others`` (matched by key and index, not by order), in ``tree``'s
    order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_zip(v, *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_zip(v, *(o[i] for o in others))
    elif isinstance(tree, torch.Tensor):
        yield (tree,) + others


def tree_map(fn, tree):
    """``fn`` of every tensor of a nested dict / list / tuple, same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def init_adamw(params) -> Dict:
    """Fresh state on the parameters' device: a float32 copy of them and
    zero moments."""
    leaf = next(tree_leaves(params))
    return {"master": tree_map(lambda x: x.detach().float().clone(), params),
            "m": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                device=x.device), params),
            "v": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                device=x.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt: Dict, acfg: AdamWConfig
                 ) -> Tuple[Dict, Dict, Dict]:
    """One step, in place: returns (params, opt, metrics) with metrics
    ``grad_norm`` (before clipping) and ``lr``, float32 0-d tensors."""
    opt["count"] += 1
    count = opt["count"]
    gnorm = global_norm(grads)
    scale = torch.clamp(acfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = schedule(acfg, count)
    b1c = 1 - torch.pow(_f32(acfg.b1, gnorm), count.float())
    b2c = 1 - torch.pow(_f32(acfg.b2, gnorm), count.float())
    for p, g, m, v, master in tree_zip(params, grads, opt["m"], opt["v"],
                                       opt["master"]):
        g = g.float() * scale
        m.mul_(acfg.b1).add_((1 - acfg.b1) * g)
        v.mul_(acfg.b2).add_((1 - acfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + acfg.eps)
        master.sub_(lr * (step + acfg.weight_decay * master))
        p.copy_(master)
    return params, opt, {"grad_norm": gnorm, "lr": lr}

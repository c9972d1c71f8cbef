"""Step factories: the train step, prefill and greedy decode as plain
callables.

The port of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` of the JAX package's ``train/steps.py``.  There is no
``jit``, mesh or sharding on one card (``train/sharding.py`` has no
counterpart; ZeRO-1 waits for ROADMAP item 10b): a step is a function that
runs the model eagerly with float32 matrix products in full float32 (no
TF32, as the reference's float32 default).

The train step, ``train_step(params, opt, batch) -> (params, opt,
metrics)``, takes the loss ``ce_loss + AUX_LOSS_WEIGHT * moe_aux`` of a
train-mode forward, its gradient through ``torch.autograd`` (K5's backward
kernel in every attention layer, K7's in every rwkv6 layer, K6's in every
mamba layer), and one AdamW update in place
(``train/optimizer.py``).  With ``micro_steps`` > 1 it accumulates the
gradient of contiguous row blocks in float32 and divides by their number,
and averages the metrics, as the reference's ``lax.scan`` over
microbatches; ``micro_steps`` is halved until it divides the batch.  The
metrics, ``loss``, ``moe_aux``, ``moe_drop``, ``grad_norm`` and ``lr``,
are float32 0-d tensors left on the device.

The serving steps run under ``torch.inference_mode`` and return
``(tokens int32 (B,), caches, aux)``: the reference's steps drop
``forward``'s MoE auxiliaries ``aux`` (float32 ``[moe_aux_loss,
moe_drop_frac]``), and these pass them on, left on the device, so that a
serving loop can report its drop fraction.  The prefill passes the
batch's ``frames`` (whisper) and ``patches`` (internvl) on to the model,
as the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.plain import fp32_highest
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (
    AdamWConfig, adamw_update, tree_leaves, tree_map, tree_zip,
)

AUX_LOSS_WEIGHT = 0.01

Step = Callable[..., Tuple[torch.Tensor, List[Dict], torch.Tensor]]


def _greedy(params: Dict, cfg: ModelConfig, hidden: torch.Tensor
            ) -> torch.Tensor:
    return tf.logits_last(params, cfg, hidden).argmax(dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, *,
                      cache_len: Optional[int] = None) -> Step:
    """``prefill(params, batch)`` with ``batch["tokens"]`` (B, S), and
    ``batch["frames"]`` / ``batch["patches"]`` where the model takes them:
    the first greedy token of every request, caches of ``cache_len`` slots
    (default: S, patches included) and the MoE auxiliaries."""
    tf.check_supported(cfg)

    def prefill_step(params: Dict, batch: Dict):
        with torch.inference_mode(), fp32_highest():
            hidden, caches, aux = tf.forward(
                params, cfg, batch["tokens"], mode="prefill",
                cache_len=cache_len, frames=batch.get("frames"),
                patches=batch.get("patches"))
            return _greedy(params, cfg, hidden), caches, aux

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Step:
    """``decode(params, caches, tokens)`` with ``tokens`` (B, 1): the next
    greedy token of every request, the caches (updated in place) and the
    MoE auxiliaries."""
    tf.check_supported(cfg)

    def decode_step(params: Dict, caches: List[Dict], tokens: torch.Tensor):
        with torch.inference_mode(), fp32_highest():
            hidden, caches, aux = tf.forward(params, cfg, tokens,
                                             mode="decode", caches=caches)
            return _greedy(params, cfg, hidden), caches, aux

    return decode_step


def _micro_steps(batch_rows: int, micro_steps: int) -> int:
    """The reference's clamp: halve until it divides the batch."""
    while batch_rows % micro_steps:
        micro_steps //= 2
    return max(1, micro_steps)


def loss_and_grads(params: Dict, cfg: ModelConfig, batch: Dict
                   ) -> Tuple[Dict, Dict]:
    """(gradient tree of ``params``' structure, metrics ``loss``,
    ``moe_aux``, ``moe_drop``) of ``ce_loss + AUX_LOSS_WEIGHT * moe_aux``
    over ``batch``: a train-mode forward through ``torch.autograd`` on
    leaves that share ``params``' storage (a leaf the loss does not reach
    gets zeros)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    hidden, _, aux = tf.forward(live, cfg, batch["tokens"], mode="train",
                                frames=batch.get("frames"),
                                patches=batch.get("patches"))
    loss = tf.ce_loss(live, cfg, hidden, batch["labels"])
    total = loss + AUX_LOSS_WEIGHT * aux[0]
    grads = iter(torch.autograd.grad(total, leaves, allow_unused=True))
    tree = tree_map(lambda p: (lambda g: torch.zeros_like(p) if g is None
                               else g)(next(grads)), params)
    return tree, {"loss": loss.detach(), "moe_aux": aux[0].detach(),
                  "moe_drop": aux[1].detach()}


def make_train_step(cfg: ModelConfig, *, acfg: AdamWConfig = AdamWConfig(),
                    micro_steps: Optional[int] = None) -> Callable:
    """``train_step(params, opt, batch)``: ``batch`` holds ``tokens`` (B,
    S_text) and ``labels`` (B, S), and ``frames`` / ``patches`` where the
    model takes them; ``params`` and ``opt`` (``init_adamw``) are updated in
    place and returned with the metrics.  ``micro_steps`` defaults to
    ``cfg.micro_steps``."""
    tf.check_supported(cfg)
    if micro_steps is None:
        micro_steps = cfg.micro_steps

    def train_step(params: Dict, opt: Dict, batch: Dict):
        n = _micro_steps(batch["tokens"].shape[0], micro_steps)
        rows = batch["tokens"].shape[0] // n
        grads = metrics = None
        with fp32_highest():
            for i in range(n):
                micro = {k: v[i * rows:(i + 1) * rows]
                         for k, v in batch.items()}
                g, m = loss_and_grads(params, cfg, micro)
                if grads is None:           # the float32 sums
                    grads = tree_map(lambda x: x.float(), g)
                    metrics = {k: v / n for k, v in m.items()}
                else:
                    for acc, x in tree_zip(grads, g):
                        acc.add_(x.float())
                    metrics = {k: metrics[k] + v / n for k, v in m.items()}
            if n > 1:
                grads = tree_map(lambda g: g / n, grads)
            params, opt, opt_metrics = adamw_update(params, grads, opt, acfg)
        return params, opt, {**metrics, **opt_metrics}

    return train_step

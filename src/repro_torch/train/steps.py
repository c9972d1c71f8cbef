"""Serving step factories: prefill and greedy decode as plain callables.

The port of ``make_prefill_step`` and ``make_decode_step`` of the JAX
package's ``train/steps.py``.  There is no ``jit``, mesh or sharding on one
card: a step is a function that runs the model eagerly under
``torch.inference_mode`` with float32 matrix products in full float32 (no
TF32, as the reference's float32 default), and returns
``(tokens int32 (B,), caches, aux)``: the reference's steps drop
``forward``'s MoE auxiliaries ``aux`` (float32 ``[moe_aux_loss,
moe_drop_frac]``), and these pass them on, left on the device, so that a
serving loop can report its drop fraction.  The prefill passes the
batch's ``frames`` (whisper) and ``patches`` (internvl) on to the model,
as the reference's.  The train step is not ported yet (ROADMAP Queue A
item 12.9).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.plain import fp32_highest
from repro_torch.models import transformer as tf

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

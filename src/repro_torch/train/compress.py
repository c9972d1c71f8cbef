"""Int8 gradient compression with error feedback.

The port of the JAX package's ``train/compress.py``: gradients are
quantized per leaf to int8 with one float32 scale (max-abs / 127), and the
quantization error is carried into the next step ("error feedback").  The
division is float32 and the rounding half to even in both packages, so the
results agree bitwise.  The cross-device ring that would carry the int8
payload has no counterpart on one card; ``compress_decompress`` shows the
numerics.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.train.optimizer import tree_map, tree_zip


def init_error_feedback(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-30) / 127.0
    q = torch.clip(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads, err):
    """Returns (dequantized grads, new error feedback), trees of grads'
    structure."""
    deq, new_err = [], []
    for g, e in tree_zip(grads, err):
        g32 = g.float() + e
        q, scale = quantize(g32)
        d = dequantize(q, scale)
        deq.append(d)
        new_err.append(g32 - d)
    it_d, it_e = iter(deq), iter(new_err)
    return (tree_map(lambda _: next(it_d), grads),
            tree_map(lambda _: next(it_e), grads))

"""Primitive layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

The port of the JAX package's ``models/layers.py``: parameters are nested
dicts of tensors, the apply functions are free of global state, compute
runs in the activation dtype and norms accumulate in float32.  ``init_*``
draw from a ``torch.Generator`` at the reference's scales; the two packages
give different numbers from one seed, so the tests carry the reference's
parameters over with ``models/convert.py``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


class MetaGenerator:
    """Takes a ``torch.Generator``'s place in the ``init_*`` functions when
    the target is ``meta`` (shapes without memory: a dry run), where no
    generator can be made: ``device`` is meta, and ``_normal`` draws
    through a CPU generator, which a draw on meta leaves as it was."""

    def __init__(self, seed: int = 0):
        self.device = torch.device("meta")
        self.cpu = torch.Generator().manual_seed(seed)


def generator(device: torch.device, seed: int):
    """A generator seeded with ``seed`` on ``device`` (a ``MetaGenerator``
    for ``meta``)."""
    if device.type == "meta":
        return MetaGenerator(seed)
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen: torch.Generator, shape, scale: float,
            dtype=torch.float32) -> torch.Tensor:
    """float32 N(0, scale^2) on the generator's device, cast to ``dtype``.
    Scaled in place: an expert stack of deepseek-v3 is 15 GB in float32,
    and a second buffer of its size would be drawn beside it."""
    x = torch.randn(shape, generator=getattr(gen, "cpu", gen),
                    dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, D) with even D; positions: (B, S) int.  Split-half
    rotation (the first and second halves of D are the pair)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (D/2,)
    angles = positions[:, None, :, None].float() * freqs         # (B,1,S,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype=torch.float32) -> Dict:
    s_in, s_out = d ** -0.5, d_ff ** -0.5
    return {
        "w_gate": _normal(gen, (d, d_ff), s_in, dtype),
        "w_up": _normal(gen, (d, d_ff), s_in, dtype),
        "w_down": _normal(gen, (d_ff, d), s_out, dtype),
    }


def mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> Dict:
    return {"table": _normal(gen, (vocab, d), d ** -0.5, dtype)}


def embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32."""
    return x.float() @ params["table"].float().T

"""RWKV6 ("Finch") time-mix: linear attention with a data-dependent decay,
through the rwkv6 scan kernel K7 (``kernels/ops.py::rwkv6_scan``).

The port of the JAX package's ``models/rwkv6.py``.  Per head h with head
size K the state S (K x K, keyed [key, value]) evolves per token as

    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

All projections (r, k, v, g, the decay LoRA and the output) run over the
whole sequence as matrix products; only the recurrence runs in K7, which
takes the state in and gives the final state out, so prefill (from the zero
state) and decode (L = 1, against the cache's state) are one code path.
Training (``train=True``) runs the recurrence through
``rwkv6_scan_train``: K7 forward, and K7's backward kernel for its
gradient.
The channel-mix FFN is the framework's SwiGLU and the per-head output norm
an RMSNorm, as in the reference.

State contract: ``{"s" (B, H, K, K) float32, "x_prev" (B, d), "idx"}``,
``idx`` the number of tokens seen, a host int.  A step returns a new state
dict (K7 writes a new state tensor), the input one is not changed.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _normal, init_rmsnorm, rmsnorm

_DECAY_LORA = 64


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    d = cfg.d_model
    hs = cfg.ssm.head_size
    s = d ** -0.5
    p = {name: _normal(gen, (d, d), s, dtype)
         for name in ("wr", "wk", "wv", "wg", "wo")}
    p.update({
        # data-dependent decay: w_t = exp(-exp(base + lora(x_t)))
        "w_base": torch.full((d,), -0.6, dtype=torch.float32,
                             device=gen.device),
        "w_lora_a": _normal(gen, (d, _DECAY_LORA), s, dtype),
        "w_lora_b": _normal(gen, (_DECAY_LORA, d), _DECAY_LORA ** -0.5,
                            dtype),
        "u": _normal(gen, (d // hs, hs), 0.5, torch.float32),
        # token-shift mixing coefficients for (r, k, v, g, w)
        "mix": _normal(gen, (5, d), 0.1, torch.float32),
        "o_norm": init_rmsnorm(hs, dtype, gen.device),
    })
    return p


def _projections(params: Dict, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ModelConfig):
    """Token-shifted projections of x (B, L, d) after ``x_prev`` (B, d),
    the last hidden of the previous segment.  Returns r, k, v, g and the
    decay w in (0, 1), each (B, L, H, K)."""
    b, l, d = x.shape
    hs = cfg.ssm.head_size
    h = d // hs
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mix = params["mix"].to(x.dtype)[:, None, None, :]           # (5,1,1,d)
    xr, xk, xv, xg, xw = x[None] * (1 - mix) + shifted[None] * mix
    r = (xr @ params["wr"]).reshape(b, l, h, hs)
    k = (xk @ params["wk"]).reshape(b, l, h, hs)
    v = (xv @ params["wv"]).reshape(b, l, h, hs)
    g = (xg @ params["wg"]).reshape(b, l, h, hs)
    w_log = params["w_base"].float() + (
        (xw @ params["w_lora_a"]) @ params["w_lora_b"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, l, h, hs)
    return r, k, v, g, w


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    d = cfg.d_model
    hs = cfg.ssm.head_size
    return {"s": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, d), dtype=dtype, device=device),
            "idx": 0}


def rwkv6_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Dict] = None, *, train: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """Time-mix over x (B, L, d) from ``state`` (default: the zero state).
    Returns (out (B, L, d), the state after the segment).  ``train``:
    differentiable through K7's backward."""
    b, l, d = x.shape
    if state is None:
        state = init_rwkv6_state(cfg, b, x.dtype, x.device)
    r, k, v, g, w = _projections(params, x, state["x_prev"], cfg)
    scan = kops.rwkv6_scan_train if train else kops.rwkv6_scan
    o, s_new = scan(r.float(), k.float(), v.float(), w, params["u"].float(),
                    state["s"])
    o = rmsnorm(params["o_norm"], o.to(x.dtype), cfg.norm_eps)
    o = (o * F.silu(g)).reshape(b, l, d)
    # a copy, so the state does not keep the whole segment alive
    new_state = {"s": s_new, "x_prev": x[:, -1, :].clone(),
                 "idx": state["idx"] + l}
    return o @ params["wo"], new_state


def rwkv6_decode(params: Dict, x: torch.Tensor, state: Dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: the same math at L = 1 against the state."""
    return rwkv6_forward(params, x, cfg, state)

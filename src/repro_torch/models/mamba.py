"""Mamba (S6) selective state-space mixer, as used by Jamba's SSM layers,
through the selective scan kernel K6 (``kernels/ops.py::mamba_scan``).

The port of the JAX package's ``models/mamba.py``:

    h_t = exp(dt_t A) . h_{t-1} + (dt_t x_t) outer B_t
    y_t = h_t . C_t + D x_t

with A (di, N) negative and dt, B, C data-dependent.  The projections and
the depthwise causal conv run over the whole sequence; only the recurrence
runs in K6, which takes the state in and gives the final state out, so
prefill (from the zero state) and decode (L = 1) are one code path.  The
conv is written as ``d_conv`` shifted scaled adds, as the reference does
(``F.conv1d`` would go through cuDNN, in TF32 by default on the card).
Training (``train=True``) runs the scan through ``mamba_scan_train``: K6
forward, and K6's backward kernel for its gradient.

State contract: ``{"h" (B, di, N) float32, "conv" (B, d_conv - 1, di),
"idx"}``, ``idx`` the number of tokens seen, a host int.  A step returns a
new state dict; the input one is not changed.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _normal

_DT_RANK_DIV = 16   # dt_rank = d_model / 16 (mamba default ~ d/16)


def _dims(cfg: ModelConfig):
    di = cfg.ssm.expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // _DT_RANK_DIV)
    return di, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    d = cfg.d_model
    di, dt_rank, n, d_conv = _dims(cfg)
    s = d ** -0.5
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_in": _normal(gen, (d, 2 * di), s, dtype),       # x, z
        "conv_w": _normal(gen, (d_conv, di), 0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=gen.device),
        "w_xproj": _normal(gen, (di, dt_rank + 2 * n), di ** -0.5, dtype),
        "w_dt": _normal(gen, (dt_rank, di), dt_rank ** -0.5, dtype),
        "dt_bias": torch.full((di,), -4.6, **f32),        # softplus ~ 0.01
        "a_log": torch.log(torch.arange(1, n + 1, **f32)).expand(
            di, n).contiguous(),
        "d_skip": torch.ones((di,), **f32),
        "w_out": _normal(gen, (di, d), di ** -0.5, dtype),
    }


def _conv_causal(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time as shifted adds.  x (B, L, di);
    ``conv_state`` (B, d_conv - 1, di), the trailing inputs of the previous
    segment.  Returns (y, the new conv state)."""
    d_conv = w.shape[0]
    ext = torch.cat([conv_state.to(x.dtype), x], dim=1)     # (B, L+dc-1, di)
    l = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(d_conv):
        # tap i multiplies the input at offset t - (d_conv - 1 - i)
        y = y + ext[:, i:i + l, :] * w[i]
    # a copy, so the state does not keep the whole segment alive
    new_state = (ext[:, -(d_conv - 1):, :].clone() if d_conv > 1
                 else conv_state)
    return y + b, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    di, _, n, d_conv = _dims(cfg)
    return {"h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, d_conv - 1, di), dtype=dtype,
                                device=device),
            "idx": 0}


def mamba_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Dict] = None, *, train: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """x (B, L, d) -> (B, L, d) from ``state`` (default: the zero state),
    for prefill and decode (L = 1).  Returns (out, the state after the
    segment).  ``train``: differentiable through K6's backward."""
    b, l, d = x.shape
    di, dt_rank, n, _ = _dims(cfg)
    if state is None:
        state = init_mamba_state(cfg, b, x.dtype, x.device)

    xi, z = (x @ params["w_in"]).split(di, dim=-1)          # (B, L, di) each
    xc, conv_new = _conv_causal(xi, state["conv"], params["conv_w"],
                                params["conv_b"])
    xc = F.silu(xc)

    proj = xc @ params["w_xproj"]                           # (B, L, r+2N)
    dt_raw, b_t, c_t = proj.split([dt_rank, n, n], dim=-1)
    # F.softplus returns x itself above x = 20, where jax.nn.softplus's
    # log1p(exp(-x)) + x is within one float32 ulp of x
    dt = F.softplus((dt_raw @ params["w_dt"]).float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])                         # (di, N) < 0

    scan = kops.mamba_scan_train if train else kops.mamba_scan
    y, h_new = scan(xc.float(), dt, b_t.float().contiguous(),
                    c_t.float().contiguous(), a, params["d_skip"],
                    state["h"])
    y = (y.to(x.dtype) * F.silu(z)) @ params["w_out"]
    new_state = {"h": h_new, "conv": conv_new, "idx": state["idx"] + l}
    return y, new_state


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    return mamba_forward(params, x, cfg, state)

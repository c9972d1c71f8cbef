"""Mixture-of-Experts FFN: top-k router and capacity-based sort dispatch.

The port of the JAX package's ``models/moe.py``.  Tokens are dispatched
into a dense capacity buffer (C = ``_capacity(S)`` slots per expert and
row), each expert's SwiGLU runs over its slots as one batched product
over the expert axis, and the results are combined with the router's
weights.  A (token, slot) pair whose rank among its expert's pairs is C or
more is dropped (the GShard/Switch convention); the drop fraction is a
metric.  Shared (always-on) experts are one dense SwiGLU of width
``n_shared * d_expert``, as the reference fuses them.

Dispatch is per row (each sequence has its own capacity), as the
reference's ``vmap`` of ``_dispatch_row``: here one batched sort along the
last axis does every row at once.  A pair's rank comes from one STABLE
sort of the row's flattened expert ids and a left ``searchsorted`` of each
expert's first pair, so the lower (token, slot) wins a slot, as in the
reference; dropped pairs are written to a dump row ``E``, never read.

The buffer is held expert-major, ``(E + 1, B, C, d)``: the reference's
``(B, E, C, d)`` with its first two axes swapped, so that each expert's
slots of the whole batch are one contiguous ``(B * C, d)`` matrix and the
expert products are ``torch.bmm`` over the expert axis with no copy.  The
routing, dispatch, expert and combine steps are separate functions so
that a check can hold one of them alone against another device.

The router is float32 whatever the parameters' dtype, and its logits are
taken in float32.  No kernel of the port runs here: the reference computes
its MoE with plain products outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    s_in, s_out = d ** -0.5, m.d_expert ** -0.5
    p = {
        "router": _normal(gen, (d, m.n_experts), s_in, torch.float32),
        "w_gate": _normal(gen, (m.n_experts, d, m.d_expert), s_in, dtype),
        "w_up": _normal(gen, (m.n_experts, d, m.d_expert), s_in, dtype),
        "w_down": _normal(gen, (m.n_experts, m.d_expert, d), s_out, dtype),
    }
    if m.n_shared:
        p["shared"] = init_mlp(gen, d, m.n_shared * m.d_expert, dtype)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a row of ``n_tokens``: the capacity factor's
    share of the row's pairs, rounded up to 8, at least 8 (the
    reference's sublane alignment; it decides which pairs drop)."""
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)


class Route(NamedTuple):
    """The routing of a batch, pairs in (token, slot) order per row."""
    expert: torch.Tensor   # (B, S, k) int64 expert ids, descending logits
    gates: torch.Tensor    # (B, S, k) softmax over the k chosen logits
    pos: torch.Tensor      # (B, S * k) int64 rank among the expert's pairs
    keep: torch.Tensor     # (B, S * k) bool, pos < capacity


def route(logits: torch.Tensor, cap: int, top_k: int,
          dtype=torch.float32) -> Route:
    """Top-k routing of float32 ``logits`` (B, S, E) into ``cap`` slots
    per expert and row; ``gates`` in ``dtype``."""
    b, s, n_experts = logits.shape
    gate_logits, expert = torch.topk(logits, top_k, dim=-1, sorted=True)
    gates = torch.softmax(gate_logits, dim=-1).to(dtype)
    flat_e = expert.reshape(b, s * top_k)
    sorted_e, sort_i = torch.sort(flat_e, dim=-1, stable=True)
    ids = torch.arange(n_experts, device=logits.device).expand(b, n_experts)
    seg_start = torch.searchsorted(sorted_e, ids.contiguous())
    pos_sorted = (torch.arange(s * top_k, device=logits.device)
                  - seg_start.gather(1, sorted_e))
    pos = torch.empty_like(flat_e).scatter_(1, sort_i, pos_sorted)
    return Route(expert, gates, pos, pos < cap)


def _slots(r: Route, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pair's (expert, slot), dropped pairs at the dump row's slot
    (``n_experts``, 0)."""
    b = r.pos.shape[0]
    e_safe = torch.where(r.keep, r.expert.view(b, -1), n_experts)
    return e_safe, torch.where(r.keep, r.pos, 0)


def dispatch(x: torch.Tensor, r: Route, cap: int,
             n_experts: int) -> torch.Tensor:
    """x (B, S, d) into the expert-major buffer: (E, B * C, d), expert e's
    slot c of row b at ``[e, b * C + c]``, empty slots zero."""
    b, s, d = x.shape
    k = r.expert.shape[-1]
    e_safe, p_safe = _slots(r, n_experts)
    rows = torch.arange(b, device=x.device)[:, None].expand_as(e_safe)
    buf = x.new_zeros((n_experts + 1, b, cap, d))
    # kept slots are unique; every dropped pair writes (E, b, 0), a row
    # that is sliced off unread
    buf[e_safe, rows, p_safe] = x.repeat_interleave(k, dim=1)
    return buf[:n_experts].view(n_experts, b * cap, d)


def expert_swiglu(params: Dict, disp: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its slots: (E, N, d) -> (E + 1, N, d),
    row E zero (the dump row's output, as the reference pads it)."""
    n_experts, n, d = disp.shape
    h = F.silu(torch.bmm(disp, params["w_gate"])) * torch.bmm(
        disp, params["w_up"])
    # the dump row appended by a concatenation, not by ``bmm(out=)`` into a
    # slice of a zeroed buffer, which autograd refuses
    return torch.cat([torch.bmm(h, params["w_down"]),
                      disp.new_zeros((1, n, d))])


def combine(h_out: torch.Tensor, r: Route, cap: int) -> torch.Tensor:
    """(E + 1, B * C, d) expert outputs back to (B, S, d): each token's
    pairs weighted by ``gates * keep`` and summed over its k slots."""
    b, s, k = r.expert.shape
    d = h_out.shape[-1]
    e_safe, p_safe = _slots(r, h_out.shape[0] - 1)
    rows = torch.arange(b, device=h_out.device)[:, None] * cap
    per_pair = h_out.view(-1, d)[e_safe * (b * cap) + rows + p_safe]
    w = (r.gates.view(b, -1) * r.keep.to(h_out.dtype))[..., None]
    return (per_pair * w).view(b, s, k, d).sum(dim=2)


def moe_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (B, S, d) and the metrics ``moe_aux_loss`` (the
    Switch load-balance loss) and ``moe_drop_frac``, float32 scalars."""
    m = cfg.moe
    b, s, d = x.shape
    cap = _capacity(s, cfg)
    logits = x.float() @ params["router"]                    # (B, S, E)
    r = route(logits, cap, m.top_k, x.dtype)
    h_out = expert_swiglu(params, dispatch(x, r, cap, m.n_experts))
    y = combine(h_out, r, cap)
    if m.n_shared:
        y = y + mlp(params["shared"], x.reshape(b * s, d)).view(b, s, d)

    probs = torch.softmax(logits, dim=-1)
    # the reference's one_hot(expert).sum(-2): the k experts of a token are
    # distinct, so a scatter of ones gives the same 0/1 table (and no host
    # read of the ids, which one_hot makes on the CPU)
    chosen = torch.zeros((b, s, m.n_experts), dtype=torch.float32,
                         device=x.device).scatter_(-1, r.expert, 1.0)
    frac_tokens = chosen.mean(dim=(0, 1)) / m.top_k
    frac_probs = probs.mean(dim=(0, 1))
    metrics = {
        "moe_aux_loss": m.n_experts * torch.sum(frac_tokens * frac_probs),
        "moe_drop_frac": 1.0 - r.keep.float().mean(),
    }
    return y, metrics

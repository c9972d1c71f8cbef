"""GQA attention, global or sliding-window (local), causal or
bidirectional, with a KV cache for decode, and the whisper decoder's
cross-attention over the encoder output, all through the flash-attention
kernel K5 (``kernels/ops.py::flash_attention``); and DeepSeek's
multi-head latent attention (MLA) with its latent cache.

The port of the JAX package's ``models/attention.py``.
Weights and layouts are the reference's, 1:1: q heads are zero-padded from
``n_heads`` up to ``cfg.hp`` (``wq`` gains zero columns, ``wo`` zero rows).
The reference repeats the K/V heads ``n_heads // n_kv_heads`` times
(``jnp.repeat`` order) and zero-pads them to ``hp``; here K5 does both
itself: it takes the (B, n_kv_heads, ., hd) K/V as they are, maps query
head h to KV head ``h // (n_heads // n_kv_heads)`` and returns exact zeros
for the padded heads (``live_heads=n_heads``), so no repeated or padded
copy of K/V is ever made.  Prefill attends causally over its own S
positions (K/V read in place through their strides), a local layer only
over the last ``window`` of them (K5's ``window``: the reference's
``_causal_mask(s, t, window)``); with ``causal=False`` (whisper's encoder)
every position sees all S, still rotated at positions ``[0, S)`` as the
reference's.  Decode attends with S = 1 over the
cache's valid slots (the reference's ``_sdpa`` under the mask ``pos <=
idx``, and ``pos > idx - window`` on a local layer), passing the cache
tensors themselves with ``kv_len`` the number of valid slots.

Cache contract: ``{"k", "v"}`` of shape (B, n_kv_heads, t, hd) and
``idx``, the number of positions written, one host int for the whole
batch; ``t = max_len`` for a global layer and ``min(max_len, window)``
for a local one, whose cache is a ring (position p in slot ``p % t``, as
the reference's).  Decode writes the new token's K/V into the cache
tensors IN PLACE (the reference returns new arrays) and returns the same
tensors with ``idx + 1``: a serving loop holds one cache, and a copy per
token would move the whole cache.  The valid slots are ``[0, min(idx,
t - 1)]``: a global cache fills in order, and a ring holds exactly the
positions ``(idx - t, idx]`` once it has wrapped, all inside the window
since ``t <= window``.  So the port keeps no per-slot position array (the
reference's ``pos``).  A ring's slots are not in position order, so decode
passes no window to K5: every valid slot is visible, and the softmax, a
sum over slots, does not depend on their order beyond the last bits.

Training (``train=True``, ``cross_train``) runs K5 through
``kernels/ops.py::flash_attention_train``: its forward also writes the
log-sum-exp, and the backward pass runs K5's backward kernel; no cache is
made or written.  ``mla_forward`` runs under autograd as it is (plain
products).

MLA (``init_mla`` .. ``mla_decode``) is the reference's absorbed form:
queries and keys share a ``kv_lora_rank``-wide latent ``c_kv`` and one
rotated key ``k_rope`` of ``rope_head_dim`` for all heads; ``q_nope`` is
folded into the latent through the k part of ``wkv_b``, the logits are
taken against ``c_kv`` plus the shared rope key, scaled by ``(nope_head_dim
+ rope_head_dim) ** -0.5`` with the softmax in float32, and the output is
taken in the latent and then expanded through the v part of ``wkv_b``.
The reference computes it with plain einsums outside any Pallas kernel,
so here it is plain products too (K5 has no head size of 576 / 512).
Per batch the products are ``(H * S, r)`` by ``(r, T)`` matrices: the one
latent is shared by every head, and no per-head copy of it is made.  Its
cache is ``{"ckv": (B, t, kv_lora_rank), "krope": (B, 1, t,
rope_head_dim), "idx"}`` under the same contract as the GQA cache: the
prefill fills slots ``[0, S)`` in place, decode writes slot ``idx`` in
place and attends over the slots ``[0, idx]`` (the reference's mask ``pos
<= idx``, whose masked logits weigh exactly 0).  MLA has no window.  The
reference's ``q_chunk`` (prefill queries in chunks under ``lax.scan``)
bounds a trace's memory at 32k-token shapes and has no counterpart here.

Cross-attention (``init_cross`` .. ``cross_decode``, whisper's decoder):
the decoder's q (B, hp, S, hd) over K/V (B, n_kv_heads, T, hd) projected
from the encoder output, no RoPE, ``q_norm`` / ``k_norm`` under
``cfg.qk_norm``, and no mask (K5 with ``causal=False`` over all T keys).
Its cache is ``{"k", "v"}`` with no ``idx``: the prefill projects the
encoder output once, writes it into the cache in place and attends over
it (the reference projects it twice, once for ``cross_forward`` and once
for ``make_cross_cache``; the values are the same), and decode reads it and
never writes it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import _normal, apply_rope, init_rmsnorm, rmsnorm

NEG = -1e30     # the reference's masked logit: exp(NEG - max) is 0


def init_gqa(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Dict:
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    wq = _normal(gen, (d, cfg.n_heads * hd), s, dtype)
    wk = _normal(gen, (d, cfg.n_kv_heads * hd), s, dtype)
    wv = _normal(gen, (d, cfg.n_kv_heads * hd), s, dtype)
    wo = _normal(gen, (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5,
                 dtype)
    if cfg.hp != cfg.n_heads:
        # zero column / row blocks for the padded heads, as the reference
        pad = (cfg.hp - cfg.n_heads) * hd
        wq = torch.cat([wq, wq.new_zeros((d, pad))], dim=1)
        wo = torch.cat([wo, wo.new_zeros((pad, d))], dim=0)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, gen.device)
        p["k_norm"] = init_rmsnorm(hd, dtype, gen.device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.view(b, s, n_heads, hd).transpose(1, 2)        # (B, H, S, hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """Projected, normed and rotated q (B, hp, S, hd) and k, v
    (B, n_kv_heads, S, hd)."""
    hd = cfg.hd
    q = _split_heads(x @ params["wq"], cfg.hp, hd)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ModelConfig, *, causal: bool, window: Optional[int] = None,
            train: bool = False) -> torch.Tensor:
    """K5 over the live heads: ``flash_attention``, or with ``train`` its
    differentiable form ``flash_attention_train`` (K5's forward with the
    log-sum-exp, and its backward kernel in the backward pass)."""
    attend = kops.flash_attention_train if train else kops.flash_attention
    return attend(q, k, v, causal=causal, scale=cfg.hd ** -0.5,
                  live_heads=cfg.n_heads, window=window)


def gqa_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                window: Optional[int] = None, causal: bool = True,
                return_kv: bool = False, train: bool = False):
    """Full-sequence (prefill or train) GQA over x (B, S, d) at positions
    ``[0, S)``: causal, and with a ``window`` each position sees the last
    ``window`` positions up to itself (a local layer); with ``causal=False``
    every position sees all S (whisper's encoder; no window).  ``train``
    runs the differentiable K5 (``flash_attention_train``).

    ``return_kv`` additionally returns the rotated (B, n_kv_heads, S, hd)
    K and V for the prefill cache.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg, causal=causal, window=window, train=train)
    y = _merge_heads(out) @ params["wo"]
    if return_kv:
        return y, (k, v)
    return y


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   window: Optional[int] = None, dtype=torch.float32,
                   device=None) -> Dict:
    """A zeroed cache of ``max_len`` slots, or of ``min(max_len, window)``
    ring slots for a local layer."""
    t = min(max_len, window) if window else max_len
    shape = (batch, cfg.n_kv_heads, t, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}


def fill_gqa_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int] = None) -> Dict:
    """Write a prefill segment (rotated K/V, (B, n_kv_heads, S, hd)) into
    a fresh cache, in place: slots ``[0, S)``, or for a ring (``window``)
    the last ``t`` positions, position p in slot ``p % t``."""
    s = k.shape[2]
    t = cache["k"].shape[2]
    if s > t and not window:
        raise ValueError(f"a {s}-token prefill does not fit a {t}-slot cache")
    for buf, x in ((cache["k"], k), (cache["v"], v)):
        if s > t:
            # positions [s - t, s) in slots (s - t + j) % t: a rotation by
            # s % t, written as two slices
            r = s % t
            buf[:, :, r:] = x[:, :, s - t:s - r]
            buf[:, :, :r] = x[:, :, s - r:]
        else:
            buf[:, :, :s] = x
    return {"k": cache["k"], "v": cache["v"], "idx": s}


def gqa_decode(params: Dict, x: torch.Tensor, cache: Dict,
               cfg: ModelConfig, *, window: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); the token sits at position
    ``cache["idx"]``, is written to slot ``idx`` (``idx % t`` on a ring,
    ``window`` set) and attends over the valid slots ``[0, min(idx,
    t - 1)]``."""
    b = x.shape[0]
    idx = cache["idx"]
    t = cache["k"].shape[2]
    if not window and idx >= t:
        raise ValueError(f"the {t}-slot KV cache is full")
    slot = idx % t
    pos = torch.full((b, 1), idx, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, pos)
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]
    out = kops.flash_attention(q, cache["k"], cache["v"], causal=True,
                               scale=cfg.hd ** -0.5, kv_len=min(idx + 1, t),
                               live_heads=cfg.n_heads)
    new_cache = {"k": cache["k"], "v": cache["v"], "idx": idx + 1}
    return _merge_heads(out) @ params["wo"], new_cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def init_cross(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    return init_gqa(gen, cfg, dtype)


def init_cross_cache(cfg: ModelConfig, batch: int, *, dtype=torch.float32,
                     device=None) -> Dict:
    """A zeroed cross cache of the encoder's ``enc_len`` positions."""
    shape = (batch, cfg.n_kv_heads, cfg.encdec.enc_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_kv(params: Dict, enc: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V (B, n_kv_heads, T, hd): projected,
    ``k_norm`` under ``cfg.qk_norm``, no RoPE."""
    k = _split_heads(enc @ params["wk"], cfg.n_kv_heads, cfg.hd)
    v = _split_heads(enc @ params["wv"], cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v


def make_cross_cache(params: Dict, enc: torch.Tensor, cfg: ModelConfig,
                     cache: Dict) -> Dict:
    """The encoder output's K and V (B, n_kv_heads, T, hd), projected once
    a request and written into ``cache`` (a fresh ``init_cross_cache`` of
    T slots) in place."""
    k, v = cross_kv(params, enc, cfg)
    if cache["k"].shape != k.shape:
        raise ValueError(f"an encoder output of {k.shape[2]} positions does "
                         f"not fit a {cache['k'].shape[2]}-slot cross cache "
                         f"(cfg.encdec.enc_len)")
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    return {"k": cache["k"], "v": cache["v"]}


def cross_decode(params: Dict, x: torch.Tensor, cross_cache: Dict,
                 cfg: ModelConfig, *, train: bool = False) -> torch.Tensor:
    """x: (B, S, d) decoder states (S = 1 in decode) attending over every
    cached encoder position (``{"k", "v"}``); the cache is not written.
    ``train`` runs the differentiable K5."""
    q = _split_heads(x @ params["wq"], cfg.hp, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    out = _attend(q, cross_cache["k"], cross_cache["v"], cfg, causal=False,
                  train=train)
    return _merge_heads(out) @ params["wo"]


def cross_forward(params: Dict, x: torch.Tensor, enc: torch.Tensor,
                  cfg: ModelConfig, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) decoder states over enc: (B, T, d) encoder output, no
    mask.  Returns the output and the cross cache: the encoder K/V,
    projected once into ``cache`` in place."""
    cross = make_cross_cache(params, enc, cfg, cache)
    return cross_decode(params, x, cross, cfg), cross


def cross_train(params: Dict, x: torch.Tensor, enc: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """``cross_forward`` for training: the encoder K/V projected with no
    cache (the cache's in-place copy would cut the graph), through the
    differentiable K5."""
    k, v = cross_kv(params, enc, cfg)
    return cross_decode(params, x, {"k": k, "v": v}, cfg, train=True)


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    qd = m.nope_head_dim + m.rope_head_dim
    dev = gen.device
    return {
        "wq_a": _normal(gen, (d, m.q_lora_rank), s, dtype),
        "q_norm": init_rmsnorm(m.q_lora_rank, dtype, dev),
        "wq_b": _normal(gen, (m.q_lora_rank, h * qd),
                        m.q_lora_rank ** -0.5, dtype),
        "wkv_a": _normal(gen, (d, m.kv_lora_rank + m.rope_head_dim), s,
                         dtype),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dtype, dev),
        "wkv_b": _normal(gen, (m.kv_lora_rank,
                               h * (m.nope_head_dim + m.v_head_dim)),
                         m.kv_lora_rank ** -0.5, dtype),
        "wo": _normal(gen, (h * m.v_head_dim, d),
                      (h * m.v_head_dim) ** -0.5, dtype),
    }


def _mla_qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    """q_nope (B, H, S, nope), rotated q_rope (B, H, S, rd), the normed
    latent c_kv (B, S, r) and the rotated shared key k_rope (B, 1, S,
    rd)."""
    m = cfg.mla
    b, s, _ = x.shape
    q = rmsnorm(params["q_norm"], x @ params["wq_a"], cfg.norm_eps) \
        @ params["wq_b"]
    q = q.view(b, s, cfg.n_heads, -1).transpose(1, 2)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ params["wkv_a"]).split(
        [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(params: Dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
                c_kv: torch.Tensor, k_rope: torch.Tensor, cfg: ModelConfig,
                causal: bool) -> torch.Tensor:
    """The absorbed attention of queries (B, H, S, .) over the T latent
    positions of ``c_kv`` (B, T, r) and ``k_rope`` (B, 1, T, rd); with
    ``causal`` query i sees positions ``[0, T - S + i]``, else all T."""
    m = cfg.mla
    b, h, s, _ = q_nope.shape
    t = c_kv.shape[1]
    kvb = params["wkv_b"].view(m.kv_lora_rank, h,
                               m.nope_head_dim + m.v_head_dim)
    k_nope_w = kvb[:, :, :m.nope_head_dim]                 # (r, H, nope)
    v_w = kvb[:, :, m.nope_head_dim:]                      # (r, H, vdim)
    # absorb the k projection into q: attend in the latent space
    q_lat = torch.einsum("bhsn,rhn->bhsr", q_nope, k_nope_w)
    logits = torch.bmm(q_lat.reshape(b, h * s, -1).float(),
                       c_kv.float().transpose(1, 2))
    logits += torch.bmm(q_rope.reshape(b, h * s, -1).float(),
                        k_rope[:, 0].float().transpose(1, 2))
    logits = logits.view(b, h, s, t) * (
        (m.nope_head_dim + m.rope_head_dim) ** -0.5)
    if causal:
        q_ids = torch.arange(s, device=c_kv.device)[:, None] + (t - s)
        hidden = torch.arange(t, device=c_kv.device)[None, :] > q_ids
        logits = logits.masked_fill(hidden, NEG)
    probs = torch.softmax(logits, dim=-1).to(c_kv.dtype)
    out_lat = torch.bmm(probs.view(b, h * s, t), c_kv).view(b, h, s, -1)
    out = torch.einsum("bhsr,rhv->bhsv", out_lat, v_w)
    return _merge_heads(out) @ params["wo"]


def mla_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                return_latent: bool = False):
    """Full-sequence (prefill) causal MLA over x (B, S, d) at positions
    ``[0, S)``.  ``return_latent`` additionally returns ``(c_kv, k_rope)``
    for the prefill cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions)
    out = _mla_attend(params, q_nope, q_rope, c_kv, k_rope, cfg,
                      causal=True)
    if return_latent:
        return out, (c_kv, k_rope)
    return out


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype=torch.float32, device=None) -> Dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, 1, max_len, m.rope_head_dim),
                                 dtype=dtype, device=device),
            "idx": 0}


def fill_mla_cache(cache: Dict, c_kv: torch.Tensor,
                   k_rope: torch.Tensor) -> Dict:
    """Write a prefill's latents (c_kv (B, S, r), k_rope (B, 1, S, rd))
    into slots ``[0, S)`` of a fresh cache, in place."""
    s = c_kv.shape[1]
    if s > cache["ckv"].shape[1]:
        raise ValueError(f"a {s}-token prefill does not fit a "
                         f"{cache['ckv'].shape[1]}-slot cache")
    cache["ckv"][:, :s] = c_kv
    cache["krope"][:, :, :s] = k_rope
    return {"ckv": cache["ckv"], "krope": cache["krope"], "idx": s}


def mla_decode(params: Dict, x: torch.Tensor, cache: Dict,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, d); the token sits at position
    ``cache["idx"]``, is written to that slot and attends over ``[0,
    idx]``."""
    b = x.shape[0]
    idx = cache["idx"]
    t = cache["ckv"].shape[1]
    if idx >= t:
        raise ValueError(f"the {t}-slot latent cache is full")
    pos = torch.full((b, 1), idx, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, pos)
    cache["ckv"][:, idx] = c_kv[:, 0]
    cache["krope"][:, :, idx] = k_rope[:, :, 0]
    out = _mla_attend(params, q_nope, q_rope, cache["ckv"][:, :idx + 1],
                      cache["krope"][:, :, :idx + 1], cfg, causal=False)
    return out, {"ckv": cache["ckv"], "krope": cache["krope"],
                 "idx": idx + 1}

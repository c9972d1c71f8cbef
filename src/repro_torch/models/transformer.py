"""Transformer assembly for serving: embed -> ``n_groups`` x pattern ->
final norm, in prefill and decode.

The port of the JAX package's ``models/transformer.py`` for layers of
any mixer among ``"attn"``, ``"local"``, ``"mla"``, ``"rwkv6"`` and
``"mamba"`` with a dense (``"mlp"``) or MoE (``"moe"``) FFN: the dense GQA
family (smollm, qwen3), gemma3's sliding-window (local) and global layers,
rwkv6-7b, moonshot's attention + MoE layers, deepseek-v3's MLA + MoE
layers, and jamba's period with its MoE FFNs; and the two models with a
second input: whisper (``cfg.encdec``: a bidirectional encoder over
precomputed frame embeddings, ``frames``, and a cross-attention block
after each attention layer's mixer) and internvl (``cfg.n_patches``:
precomputed patch embeddings, ``patches``, prepended to the token
embeddings, so the tokens start at position ``n_patches``).  Both
front ends are stubs in the reference too.  A model is a sequence of
layer groups, each one copy of ``cfg.pattern``; ``params["groups"]`` is a
LIST of per-group dicts (the reference stacks them along a leading
``n_groups`` axis for ``lax.scan``; a Python loop over the list takes its
place here, and ``models/convert.py`` unstacks a reference tree), and so
is ``params["encoder"]["layers"]``.  The caches are a list of per-group
dicts in the same way.

What has no counterpart on one card: ``lax.scan`` (a Python loop over the
groups) and the sharding constraints ``constrain`` / ``step_context`` (one
device holds every tensor).

Modes: ``train`` (full sequence, no caches, differentiable: every
attention layer runs K5 with its backward kernel, ``flash_attention_train``,
every rwkv6 layer K7 with its backward kernel, ``rwkv6_scan_train``, every
mamba layer K6 with its backward kernel, ``mamba_scan_train``; remat as
the reference's, below), ``prefill`` (full sequence, returns the
caches: KV caches for attention layers, ring caches of ``min(cache_len,
sliding_window)`` slots for local ones, latent caches for MLA layers,
recurrent states for rwkv6 and mamba layers) and ``decode`` (one token
against them).  All three return the reference's MoE auxiliaries, summed
over the MoE layers.

Remat in ``train``, as the reference's ``jax.checkpoint``: with
``cfg.remat`` and more than one group each group runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, and with
``cfg.layer_remat`` (gemma3, jamba) so does each layer inside it; each
chunk of ``ce_loss`` is checkpointed; the encoder is not.  A checkpointed
function runs its forward again in the backward pass (K5's, K6's or K7's
forward launches twice per layer and step), and the recompute is the same
arithmetic, so gradients are bitwise those without remat.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod

MIXERS = ("attn", "local", "mla", "rwkv6", "mamba")
LAYER_KINDS = tuple((mixer, ffn) for mixer in MIXERS
                    for ffn in ("mlp", "moe"))
ATTN_KINDS = ("attn", "local")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind the port does not know."""
    for mixer, ffn in cfg.pattern:
        if (mixer, ffn) not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {(mixer, ffn)!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, mixer: str,
               ffn: str, dtype) -> Dict:
    init_mixer = {"attn": attn.init_gqa, "local": attn.init_gqa,
                  "mla": attn.init_mla, "rwkv6": rwkv_mod.init_rwkv6,
                  "mamba": mamba_mod.init_mamba}[mixer]
    p = {
        "norm1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mixer": init_mixer(gen, cfg, dtype),
        "ffn": (moe_mod.init_moe(gen, cfg, dtype) if ffn == "moe"
                else L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if cfg.encdec is not None and mixer in ATTN_KINDS:
        p["cross"] = attn.init_cross(gen, cfg, dtype)
        p["norm_cross"] = L.init_rmsnorm(cfg.d_model, dtype, gen.device)
    return p


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    return {
        "norm1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mixer": attn.init_gqa(gen, cfg, dtype),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def init_params(cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
                device=None) -> Dict:
    """Random parameters at the reference's scales, drawn on ``device``
    (``None``: the card) from a ``torch.Generator`` there seeded with
    ``seed``.  The card's generator gives other numbers than the CPU's:
    to run the same parameters on both, draw once and copy with
    ``to_device``.  On ``"meta"`` the tensors have shapes only (a dry
    run, ``launch/dryrun.py``)."""
    check_supported(cfg)
    dev = resolve_device(device, meta=True)
    gen = L.generator(dev, seed)
    params: Dict = {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "groups": [{f"l{i}": init_layer(gen, cfg, mixer, ffn, dtype)
                    for i, (mixer, ffn) in enumerate(cfg.pattern)}
                   for _ in range(cfg.n_groups)],
    }
    if not cfg.tie_embeddings:
        params["head"] = {"table": L._normal(gen, (cfg.vocab, cfg.d_model),
                                             cfg.d_model ** -0.5, dtype)}
    if cfg.encdec is not None:
        params["encoder"] = {
            "layers": [_init_enc_layer(gen, cfg, dtype)
                       for _ in range(cfg.encdec.n_enc_layers)],
            "norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
        }
    return params


def to_device(tree, device):
    """A copy of a nested dict / list of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def n_params(params) -> int:
    return sum(t.numel() for t in _leaves(params))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    """The sliding window of a local layer, None for a global one."""
    return cfg.sliding_window if mixer == "local" else None


def _layer_cache(cfg: ModelConfig, mixer: str, batch: int, cache_len: int,
                 dtype, device) -> Dict:
    if mixer in ATTN_KINDS:
        c = {"self": attn.init_gqa_cache(cfg, batch, cache_len,
                                         window=_window(cfg, mixer),
                                         dtype=dtype, device=device)}
        if cfg.encdec is not None:
            c["cross"] = attn.init_cross_cache(cfg, batch, dtype=dtype,
                                               device=device)
        return c
    if mixer == "mla":
        return {"self": attn.init_mla_cache(cfg, batch, cache_len,
                                            dtype=dtype, device=device)}
    init_state = {"rwkv6": rwkv_mod.init_rwkv6_state,
                  "mamba": mamba_mod.init_mamba_state}[mixer]
    return {"state": init_state(cfg, batch, dtype, device)}


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.float32, device=None) -> List[Dict]:
    """Per-group list of per-layer caches, zeroed, on ``device``: a KV
    cache of ``cache_len`` slots for a global attention layer, a ring of
    ``min(cache_len, sliding_window)`` slots for a local one, a latent
    cache of ``cache_len`` slots for an MLA layer, the recurrent state for
    an rwkv6 or mamba layer; an attention layer of an encoder-decoder model
    also gets a cross cache of the encoder's ``enc_len`` positions."""
    check_supported(cfg)
    dev = resolve_device(device, meta=True)
    return [{f"l{i}": _layer_cache(cfg, mixer, batch, cache_len, dtype, dev)
             for i, (mixer, _) in enumerate(cfg.pattern)}
            for _ in range(cfg.n_groups)]


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------

def _sinusoidal(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32 position table: the sines of every position's
    d / 2 angles, then their cosines (not interleaved).  The powers of
    10000 are taken in float64 and rounded once: float32 ``pow`` may miss by
    an ulp, which moves the angle of position 1500 by ~1e-4."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, (dim / d).double()).float()
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)[:, :d]


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """Whisper's bidirectional pre-norm encoder over precomputed frame
    embeddings (B, T, d) (the conv front end is a stub in the reference
    too): sinusoidal positions, then per layer non-causal GQA and the MLP,
    then the encoder's norm.  ``train``: differentiable K5, no remat."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model,
                             frames.device).to(frames.dtype)
    for lp in params["encoder"]["layers"]:
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        x = x + attn.gqa_forward(lp["mixer"], h, cfg, causal=False,
                                 train=train)
        h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(lp["ffn"], h2)
    return L.rmsnorm(params["encoder"]["norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

_SSM_FORWARD = {"rwkv6": rwkv_mod.rwkv6_forward,
                "mamba": mamba_mod.mamba_forward}


def _layer(lp: Dict, x: torch.Tensor, ce: Dict, cfg: ModelConfig,
           mixer: str, ffn: str, *, mode: str,
           enc: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """One layer: (x, its new cache, its [moe_aux_loss, moe_drop_frac],
    None for a dense FFN: no device call on the dense models' path).
    ``enc``: the encoder output of an encoder-decoder model's prefill or
    train step.  ``train`` makes and reads no cache (its new cache is
    ``{}``)."""
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    window = _window(cfg, mixer)
    if mode == "train":
        if mixer == "mla":
            o = attn.mla_forward(lp["mixer"], h, cfg)
        elif mixer not in ATTN_KINDS:
            o, _ = _SSM_FORWARD[mixer](lp["mixer"], h, cfg, train=True)
        else:
            o = attn.gqa_forward(lp["mixer"], h, cfg, window=window,
                                 train=True)
        new_cache = {}
    elif mixer == "mla":
        if mode == "decode":
            o, self_cache = attn.mla_decode(lp["mixer"], h, ce["self"], cfg)
        else:
            o, (c_kv, k_rope) = attn.mla_forward(lp["mixer"], h, cfg,
                                                 return_latent=True)
            self_cache = attn.fill_mla_cache(ce["self"], c_kv, k_rope)
        new_cache = {"self": self_cache}
    elif mixer not in ATTN_KINDS:
        # prefill runs from the fresh cache's zero state, decode from the
        # state the previous step returned
        o, state = _SSM_FORWARD[mixer](lp["mixer"], h, cfg, ce["state"])
        new_cache = {"state": state}
    elif mode == "decode":
        o, self_cache = attn.gqa_decode(lp["mixer"], h, ce["self"], cfg,
                                        window=window)
        new_cache = {"self": self_cache}
    else:
        o, (k, v) = attn.gqa_forward(lp["mixer"], h, cfg, window=window,
                                     return_kv=True)
        new_cache = {"self": attn.fill_gqa_cache(ce["self"], k, v,
                                                 window=window)}
    x = x + o
    if cfg.encdec is not None and mixer in ATTN_KINDS:
        hc = L.rmsnorm(lp["norm_cross"], x, cfg.norm_eps)
        if mode == "train":
            oc = attn.cross_train(lp["cross"], hc, enc, cfg)
        elif mode == "decode":
            oc = attn.cross_decode(lp["cross"], hc, ce["cross"], cfg)
            new_cache["cross"] = ce["cross"]
        else:
            oc, new_cache["cross"] = attn.cross_forward(lp["cross"], hc, enc,
                                                        cfg, ce["cross"])
        x = x + oc
    h2 = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if ffn == "mlp":
        return x + L.mlp(lp["ffn"], h2), new_cache, None
    f, mm = moe_mod.moe_forward(lp["ffn"], h2, cfg)
    return (x + f, new_cache,
            torch.stack([mm["moe_aux_loss"], mm["moe_drop_frac"]]))


def _group(gp: Dict, x: torch.Tensor, cg: Optional[Dict],
           cfg: ModelConfig, mode: str, enc: Optional[torch.Tensor]):
    """One group's layers: (x, the group's new caches, its summed aux or
    None).  In ``train`` with ``cfg.layer_remat`` each layer runs under a
    checkpoint."""
    nc, aux = {}, None
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        ce = cg[f"l{i}"] if cg is not None else None
        if mode == "train" and cfg.layer_remat:
            x, nc[f"l{i}"], aux_i = checkpoint(
                _layer, gp[f"l{i}"], x, ce, cfg, mixer, ffn, mode=mode,
                enc=enc, use_reentrant=False)
        else:
            x, nc[f"l{i}"], aux_i = _layer(gp[f"l{i}"], x, ce, cfg, mixer,
                                           ffn, mode=mode, enc=enc)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    return x, nc, aux


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: str, caches: Optional[List[Dict]] = None,
            cache_len: Optional[int] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[List[Dict]], torch.Tensor]:
    """Returns (hidden (B, S, d) after the final norm, new caches, aux).

    ``train`` and ``prefill`` run ``tokens`` (B, S), after ``patches`` (B,
    n_patches, d), cast to the embeddings' dtype, when ``cfg.n_patches``,
    and over the encoding of ``frames`` (B, enc_len, d) when ``cfg.encdec``;
    either one missing raises ``ValueError``.  ``train`` returns no caches
    (None) and is differentiable in ``params``; ``prefill`` builds caches
    of ``cache_len`` slots (default: the sequence length, patches
    included).  ``decode`` runs ``tokens`` (B, 1) against ``caches`` (KV
    caches updated in place, see ``models/attention.py``; recurrent states
    replaced; the cross caches read) and takes neither.  ``aux`` is the
    reference's float32 (2,) ``[moe_aux_loss, moe_drop_frac]`` summed over
    the MoE layers, zeros without any.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got "
                         f"{mode!r}")
    check_supported(cfg)
    if mode == "decode" and caches is None:
        raise ValueError("decode needs the caches of a prefill")
    full = mode != "decode"
    enc = None
    if full and cfg.encdec is not None:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its "
                             f"{mode} needs frames (B, enc_len, d)")
        enc = encode(params, cfg, frames, train=mode == "train")
    x = L.embed(params["embed"], tokens)
    if full and cfg.n_patches:
        if patches is None:
            raise ValueError(f"{cfg.name} takes patch embeddings: its "
                             f"{mode} needs patches (B, n_patches, d)")
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    if mode == "prefill":
        caches = init_caches(cfg, x.shape[0], cache_len or x.shape[1],
                             dtype=x.dtype, device=x.device)
    remat = mode == "train" and cfg.remat and cfg.n_groups > 1
    new_caches, aux = [], None
    for g, gp in enumerate(params["groups"]):
        cg = caches[g] if caches is not None else None
        if remat:
            x, nc, aux_g = checkpoint(_group, gp, x, cg, cfg, mode, enc,
                                      use_reentrant=False)
        else:
            x, nc, aux_g = _group(gp, x, cg, cfg, mode, enc)
        if aux_g is not None:
            aux = aux_g if aux is None else aux + aux_g
        new_caches.append(nc)
    if aux is None:
        aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    return (L.rmsnorm(params["final_norm"], x, cfg.norm_eps),
            None if mode == "train" else new_caches, aux)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _unembed_table(params: Dict) -> torch.Tensor:
    return (params["head"]["table"] if "head" in params
            else params["embed"]["table"])


def logits_last(params: Dict, cfg: ModelConfig,
                hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, V) float32 logits of the last position."""
    return hidden[:, -1].float() @ _unembed_table(params).float().T


def _ce_chunk(hidden: torch.Tensor, targets: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """Sum over (B, C) of ``logsumexp(logits) - logits[target]`` for one
    chunk, the (B, C, V) float32 logits formed here and dropped."""
    logits = hidden.float() @ table.T
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def ce_loss(params: Dict, cfg: ModelConfig, hidden: torch.Tensor,
            targets: torch.Tensor, *, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy over (B, S), float32, in sequence
    chunks of ``chunk`` (the whole sequence when S is not a multiple or
    fits one): a (B, C, V) logits block is the only vocab-sized buffer,
    and each chunk is checkpointed, so the backward pass forms each block
    again instead of keeping them all.  The reference's chunked loss."""
    table = _unembed_table(params).float()
    b, s, _ = hidden.shape
    if s % chunk or s <= chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_ce_chunk, hidden[:, sl], targets[:, sl],
                                   table, use_reentrant=False)
    return total / (b * s)

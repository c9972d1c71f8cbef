"""Config schema + registry for the assigned architectures and shapes.

One ``ModelConfig`` describes any of the ten families (dense / MoE / MLA /
SSM / hybrid / enc-dec / VLM backbone) via the ``pattern`` of per-layer
(mixer, ffn) kinds that the scan-over-groups transformer consumes
(models/transformer.py).  ``reduced()`` derives the CPU-smoke-test variant.

The port's own copy of the JAX package's ``configs/base.py``, field for
field, so a configuration means the same model in both packages.  The port
runs the layer kinds its ``models/transformer.py`` lists; the distribution
knobs (``fsdp_axes``, ``remat``, ``act_shard``, ...) have no meaning on one
card and are carried only so the two schemas stay equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# mixer kinds: "attn" (global), "local" (sliding window), "mla", "rwkv6", "mamba"
# ffn kinds:   "mlp" (swiglu), "moe", "none"
LayerKind = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert ffn hidden
    n_shared: int = 0          # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int
    kv_lora_rank: int
    rope_head_dim: int
    nope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # rwkv6: head_size; mamba: d_state/expand/conv
    head_size: int = 64
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    enc_len: int               # precomputed frame embeddings (frontend stub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # layer pattern, repeated to n_layers; default all ("attn", "mlp")
    pattern: Tuple[LayerKind, ...] = (("attn", "mlp"),)
    sliding_window: int = 1024
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: SSMConfig = SSMConfig()
    encdec: Optional[EncDecConfig] = None
    n_patches: int = 0                      # vlm: prepended patch embeddings
    norm_eps: float = 1e-6
    # distribution knobs (baseline; hillclimb may override)
    fsdp_axes: Tuple[str, ...] = ("data",)
    remat: bool = True
    layer_remat: bool = False               # nested per-layer remat (long patterns)
    micro_steps: int = 1                    # gradient-accumulation microbatches
    # activation sharding between layers: "rep" (replicated over model — the
    # Megatron default), "seq" (sequence dim over model — Megatron-SP),
    # "d" (hidden dim over model), "off" (let GSPMD propagate freely)
    act_shard: str = "rep"
    # shard the SDPA q-chunks over 'model' (wins when n_heads % tp != 0 and
    # head-TP is impossible; see EXPERIMENTS.md §Perf)
    seq_shard_attention: bool = False
    # zero-pad the query-head count to a TP-friendly multiple: wq/wo carry
    # zero blocks for the padded heads (their contribution is exactly zero),
    # head tensors become divisible by the model axis, and the backward-pass
    # resharding all-gathers at the head-reshape boundary disappear
    # (EXPERIMENTS.md §Perf, hillclimb #1)
    padded_heads: Optional[int] = None
    sub_quadratic: bool = False             # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def hp(self) -> int:
        """Padded query-head count (== n_heads unless padded_heads set)."""
        return self.padded_heads or self.n_heads

    @property
    def full_pattern(self) -> Tuple[LayerKind, ...]:
        reps = self.n_layers // len(self.pattern)
        assert reps * len(self.pattern) == self.n_layers, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern {len(self.pattern)}")
        return self.pattern

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.n_patches:
            total += self.n_patches * d
        if self.encdec:
            e = self.encdec
            enc_attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            enc_mlp = 3 * d * self.d_ff
            total += e.n_enc_layers * (enc_attn + enc_mlp)
        for mixer, ffn in self.full_pattern:
            count = 0
            if mixer in ("attn", "local"):
                count += d * (self.n_heads * hd)            # q
                count += 2 * d * (self.n_kv_heads * hd)     # k, v
                count += (self.n_heads * hd) * d            # o
                if self.encdec:                             # cross-attn in decoder
                    count += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                        + (self.n_heads * hd) * d
            elif mixer == "mla":
                m = self.mla
                count += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                    m.nope_head_dim + m.rope_head_dim)
                count += d * (m.kv_lora_rank + m.rope_head_dim)
                count += (m.kv_lora_rank * self.n_heads
                          * (m.nope_head_dim + m.v_head_dim))
                count += self.n_heads * m.v_head_dim * d
            elif mixer == "rwkv6":
                count += 5 * d * d + 2 * d * 64  # r,k,v,g,o + decay lora
            elif mixer == "mamba":
                di = self.ssm.expand * d
                count += 2 * d * di + di * d                # in (x,z), out
                count += di * (2 * self.ssm.d_state + 1)    # B, C, dt per channel-ish
                count += di * self.ssm.d_conv + 2 * di      # conv + A, D
            if ffn == "mlp":
                count += 3 * d * self.d_ff
            elif ffn == "moe":
                count += d * self.moe.n_experts             # router
                count += self.moe.n_experts * 3 * d * self.moe.d_expert
                count += self.moe.n_shared * 3 * d * self.moe.d_expert
            total += count * self.n_groups
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        per_expert = 3 * self.d_model * self.moe.d_expert
        n_moe_layers = (sum(1 for _, f in self.full_pattern if f == "moe")
                        * self.n_groups)
        inactive = n_moe_layers * (self.moe.n_experts - self.moe.top_k) * per_expert
        return full - inactive

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/pattern wiring, tiny dims."""
        changes: Dict = dict(
            n_layers=2 * len(self.pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(1, self.n_heads)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            sliding_window=8,
            padded_heads=None,      # TP-16 head padding is meaningless at smoke scale
        )
        if self.moe:
            # capacity_factor high enough to never drop at smoke scale:
            # capacity drops are load-dependent, which would make the
            # decode-vs-teacher-forcing exactness tests flaky by design
            changes["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                                       n_shared=self.moe.n_shared and 1,
                                       capacity_factor=8.0)
        if self.mla:
            changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                       rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
        if self.encdec:
            changes["encdec"] = EncDecConfig(n_enc_layers=2, enc_len=16)
        if self.n_patches:
            changes["n_patches"] = 8
        changes["ssm"] = SSMConfig(head_size=16, d_state=4, expand=2, d_conv=4)
        return dataclasses.replace(self, **changes)


def dense_period(cfg):
    """``cfg`` cut to one period of its pattern with every FFN the dense
    MLP of the model's width (``d_ff``).  For jamba-1.5-large-398b that is
    the 8-layer period the port serves: the whole model, or one period
    with its 16-expert MoE FFNs, does not fit one card.  Not registered.
    Only ``dataclasses.replace`` and ``cfg.pattern`` are used, so the JAX
    package's config takes the same cut."""
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern), pattern=tuple(
        (mixer, "mlp") for mixer, _ in cfg.pattern))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        import repro_torch.configs.archs  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    if not _REGISTRY:
        import repro_torch.configs.archs  # noqa: F401
    return dict(_REGISTRY)


def cell_is_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §6 skip list)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention at 500k context (documented skip)"
    return True, ""

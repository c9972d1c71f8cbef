"""The ten assigned architectures, exact dims from the assignment table.

Each also has a ``reduced()`` smoke variant (tests/test_models_smoke.py) and is
selectable via ``--arch <name>`` in the launch scripts.  Deviations from the
upstream checkpoints are noted inline and in DESIGN.md §6/§8.  The port's
copy of the JAX package's ``configs/archs.py``, as data.
"""
from repro_torch.configs.base import (
    EncDecConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig, register,
)

L, G = ("local", "mlp"), ("attn", "mlp")

internvl2_26b = register(ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, head_dim=128, rope_theta=1e6,
    n_patches=256,      # InternViT frontend STUB: precomputed patch embeddings
    micro_steps=8,
))

whisper_tiny = register(ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, head_dim=64,
    encdec=EncDecConfig(n_enc_layers=4, enc_len=1500),  # conv frontend STUB
))

rwkv6_7b = register(ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, head_dim=64,
    pattern=(("rwkv6", "mlp"),),
    ssm=SSMConfig(head_size=64),
    micro_steps=2,
    sub_quadratic=True,          # O(1) state -> runs long_500k
))

# 34 layers at ~5:1 local:global (pattern period 17 = 14 local + 3 global,
# matching gemma3's interleave as closely as 34 admits); 1024-token window.
gemma3_4b = register(ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256, rope_theta=1e6, tie_embeddings=True,
    padded_heads=16,   # 8 heads -> TP-divisible
    pattern=(L, L, L, L, L, G, L, L, L, L, L, G, L, L, L, L, G),
    sliding_window=1024,
    micro_steps=4, layer_remat=True,
    sub_quadratic=True,          # sliding-window local layers bound the cache
))

qwen3_1_7b = register(ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
    micro_steps=2,
))

smollm_135m = register(ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, head_dim=64, tie_embeddings=True,
    padded_heads=16,   # 9 heads: shard SDPA 16-way instead of replicating
))

qwen3_14b = register(ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    micro_steps=4,
    padded_heads=48,   # 40 heads % 16-way TP != 0 -> zero-pad (EXPERIMENTS §Perf)
))

moonshot_v1_16b = register(ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, head_dim=128,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    micro_steps=4,
))

# MLA + 1 shared + 256 routed top-8.  Deviations: MTP head omitted; the
# first-3-dense-layers nuance folded into uniform MoE (DESIGN.md §8).
deepseek_v3_671b = register(ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280,
    pattern=(("mla", "moe"),),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1),
    micro_steps=8,
    fsdp_axes=("pod", "data"),   # 671B must shard params over all 512 chips
))

# attn:mamba 1:7, MoE every other layer (period-8 block).
jamba_1_5_large = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    pattern=(("attn", "moe"), ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
             ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp")),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
    ssm=SSMConfig(d_state=16, expand=2, d_conv=4),
    micro_steps=8, layer_remat=True,
    fsdp_axes=("pod", "data"),
    sub_quadratic=True,          # 63/72 layers are O(1)-state mamba
))

ALL_ARCHS = [
    "internvl2-26b", "whisper-tiny", "rwkv6-7b", "gemma3-4b", "qwen3-1.7b",
    "smollm-135m", "qwen3-14b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
    "jamba-1.5-large-398b",
]

"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, ~3B active params.

[hf:Qwen/Qwen3-30B-A3B]  48L, d_model=2048, 32 heads, GQA kv=4, head_dim=128,
expert d_ff=768, 128 experts top-8, vocab=151936, SwiGLU experts, qk-norm.
Expert parallelism: experts sharded over the "model" mesh axis (128/16 = 8
experts per shard).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    num_experts=128,
    experts_per_tok=8,
    vocab_size=151_936,
    layer_pattern=("global",),
    mlp="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    sharding_profile="tp_ep",
    optstate_dtype="bfloat16",
    microbatches=4,
    remat="full",
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="EP over model axis; pure full attention -> long_500k skipped",
))

ENSEMBLE_NOTES = "Exercises EP + dense one-hot dispatch (kernels/moe_gmm)."

"""grok-1-314b — MoE, 8 experts top-2, 314B total params.

[hf:xai-org/grok-1; unverified]  64L, d_model=6144, 48 heads, GQA kv=8,
head_dim=128, expert d_ff=32768, 8 experts top-2, vocab=131072, attention and
final logit softcaps (tanh 30), embedding scaling.  With only 8 experts the
"model" axis (16) cannot shard the expert dim, so experts are sharded
*internally* (Megatron-style TP on d_ff over "model", d_model over "data").
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    moe_d_ff=32768,
    num_experts=8,
    experts_per_tok=2,
    vocab_size=131_072,
    layer_pattern=("global",),
    mlp="geglu",
    norm="rmsnorm",
    attn_softcap=30.0,
    final_softcap=30.0,
    emb_scale=True,
    tie_embeddings=False,
    rope_theta=10_000.0,
    sharding_profile="tp",      # experts internally TP-sharded (E=8 < 16)
    optstate_dtype="bfloat16",
    microbatches=8,             # 256/8 = 32 = pod*data batch shards
    remat="full",
    source="hf:xai-org/grok-1; unverified",
    notes="largest assigned arch; FSDP+TP, bf16 optimizer states, 8 "
          "microbatches; pure full attention -> long_500k skipped",
))

ENSEMBLE_NOTES = "Stress config for memory_analysis at 256/512 chips."

"""nemotron-4-15b — dense, GQA, squared-ReLU MLP.

[arXiv:2402.16819; unverified]  32L, d_model=6144, 48 heads, GQA kv=8,
d_ff=24576 (squared-ReLU, non-gated), vocab=256000, untied embeddings,
LayerNorm (no-bias variant).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256_000,
    layer_pattern=("global",),
    mlp="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    tie_embeddings=False,
    sharding_profile="tp",
    optstate_dtype="bfloat16",
    microbatches=4,
    remat="full",
    source="arXiv:2402.16819; unverified",
    notes="pure full attention -> long_500k skipped",
))

ENSEMBLE_NOTES = "Mid-size TP-profile member; squared-ReLU exercises mlp=relu2."

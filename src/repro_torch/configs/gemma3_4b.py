"""gemma3-4b — dense, 5:1 local:global attention, qk-norm, 128k context.

[hf:google/gemma-3-4b-pt; unverified]  34L, d_model=2560, 8 heads, GQA kv=4,
d_ff=10240 (GeGLU), vocab=262144; sliding window 1024 on local layers; global
layers use rope theta 1M (local 10k); qk-norm instead of softcaps.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    mlp="geglu",
    norm="rmsnorm",
    post_norms=True,
    qk_norm=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    emb_scale=True,
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",  # measured best on the bytes roofline (§Perf gemma2)

    source="hf:google/gemma-3-4b-pt; unverified",
    notes="5:1 local:global, designed for 128k+; long_500k runs",
))

ENSEMBLE_NOTES = "SAL-pattern train->eval loop member in examples."

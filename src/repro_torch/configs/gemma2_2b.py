"""gemma2-2b — dense, local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf:google/gemma-2-2b]  26L, d_model=2304, 8 heads, GQA
kv=4, d_ff=9216 (GeGLU), vocab=256000, sliding window 4096 on local layers,
attn softcap 50, final softcap 30, post-sublayer norms, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    mlp="geglu",
    norm="rmsnorm",
    post_norms=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    emb_scale=True,
    tie_embeddings=True,
    attn_scale=1.0 / 16.0,   # gemma2 scales by 1/sqrt(256)=1/16
    sharding_profile="fsdp",
    remat="full",
    source="arXiv:2408.00118; hf",
    notes="1:1 local:global; global layers hold full KV at 500k (sharded)",
))

ENSEMBLE_NOTES = (
    "Primary RE/SAL population member in examples and Fig.6 kernel-swap bench."
)

"""minicpm-2b — llama-like dense; trained with the WSD schedule.

[arXiv:2404.06395; hf:openbmb/MiniCPM-2B]  40L, d_model=2304, 36 heads,
MHA (kv=36), head_dim=64, d_ff=5760 (SwiGLU), vocab=122753.  The paper's WSD
(warmup-stable-decay) LR schedule is implemented in
repro_torch.optim.schedules and selected by this config.  ``notes`` keeps
the JAX package's text, so the two configs compare equal field by field.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    layer_pattern=("global",),
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",  # measured best on the bytes roofline (§Perf gemma2)

    source="arXiv:2404.06395; hf",
    notes="WSD schedule (repro.optim.schedules.wsd); pure full attention -> "
          "long_500k skipped",
))

SCHEDULE = "wsd"
ENSEMBLE_NOTES = "PBT/RE population member exercising the WSD schedule."

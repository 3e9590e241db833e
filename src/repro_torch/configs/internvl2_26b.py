"""internvl2-26b — InternViT-6B frontend (stubbed) + InternLM2-20B backbone.

[arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B]  48L, d_model=6144, 48 heads,
GQA kv=8, d_ff=16384, vocab=92553.  The vision frontend is a STUB per the
assignment: ``input_specs`` supplies precomputed patch embeddings that replace
the first ``vision_tokens`` positions of the sequence.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=("global",),
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    vision_tokens=256,
    sharding_profile="tp",
    optstate_dtype="bfloat16",
    microbatches=4,
    remat="full",
    source="arXiv:2404.16821; hf",
    notes="pure full attention -> long_500k skipped (assignment rule)",
))

ENSEMBLE_NOTES = (
    "Paper technique fully applicable: backbone train/serve steps are kernel "
    "plugins (lm.train_step/lm.prefill/lm.decode); VLM frontend stub adds a "
    "vision_embeds input produced by the data plane."
)

"""whisper-large-v3 — encoder-decoder backbone; conv/mel frontend stubbed.

[arXiv:2212.04356; unverified]  32 encoder + 32 decoder layers, d_model=1280,
20 heads MHA (kv=20), head_dim=64, d_ff=5120 (GELU), vocab=51866, LayerNorm.
Per the assignment the audio frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, 1500, 1280).  Backbone adaptation: absolute
sinusoidal positions are computed on the fly so the decoder backbone can be
exercised at the assigned 32k decode shape (real whisper caps at 448).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    layer_pattern=("global",),
    mlp="gelu",
    norm="layernorm",
    rope_theta=0.0,          # 0 => absolute sinusoidal positions
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",  # measured best on the bytes roofline (§Perf gemma2)

    source="arXiv:2212.04356; unverified",
    notes="enc-dec; decode runs (causal decoder); long_500k skipped "
          "(full attention + enc-dec semantics)",
))

ENSEMBLE_NOTES = (
    "Pipeline-pattern example: frontend-stub -> encode -> decode stages map "
    "onto a 3-stage pipe per utterance batch."
)

"""falcon-mamba-7b — attention-free Mamba-1 SSM.

[arXiv:2410.05355; unverified]  64L, d_model=4096, d_inner=8192 (expand 2),
ssm_state=16, conv 4, dt_rank=256, vocab=65024.  No attention layers at all;
the per-layer mixer is the selective scan (CUDA kernel
``kernels/mamba/csrc/selective_scan.cu``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,        # unused
    head_dim=64,           # unused
    d_ff=0,                # mamba blocks have no separate MLP
    vocab_size=65024,
    layer_pattern=("mamba",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    norm="rmsnorm",
    tie_embeddings=False,
    # channel-parallel TP: mamba channels are independent through the scan,
    # so d_inner shards over "model" collective-free
    sharding_profile="tp",
    microbatches=1,
    source="arXiv:2410.05355; unverified",
    notes="attention-free; O(1) decode state; long_500k runs",
))

ENSEMBLE_NOTES = (
    "Attention-inapplicable arch: the paper's orchestration is agnostic; the "
    "selective scan replaces attention as the kernel hot spot."
)

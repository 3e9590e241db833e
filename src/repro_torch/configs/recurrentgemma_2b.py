"""recurrentgemma-2b — Griffin: RG-LRU recurrent blocks + local attention, 1:2.

[arXiv:2402.19427; hf:google/recurrentgemma-2b]  26L, d_model=2560, 10 heads
(MQA kv=1) on the local-attention blocks, d_ff=7680 (GeGLU), vocab=256000.
Block pattern repeats (rec, rec, local) — two RG-LRU residual blocks per
local-attention block; sliding window 2048.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=("rec", "rec", "local"),
    sliding_window=2048,
    lru_width=2560,
    mlp="geglu",
    norm="rmsnorm",
    emb_scale=True,
    tie_embeddings=True,
    sharding_profile="fsdp",
    remat="full",
    scan_layers=False,   # heterogeneous block params -> unrolled stack
    source="arXiv:2402.19427; hf",
    notes="RG-LRU state + 2048 window => O(1) per-token state; long_500k runs",
))

ENSEMBLE_NOTES = (
    "Representative RE-pattern population member (2B-scale). The RG-LRU scan "
    "is a CUDA kernel (kernels/rglru/csrc/linear_scan.cu)."
)

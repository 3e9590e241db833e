"""Arch registry: importing this package registers the ported architectures
(gemma2-2b, gemma3-4b, minicpm-2b, nemotron-4-15b, recurrentgemma-2b,
falcon-mamba-7b, qwen3-moe-30b-a3b, grok-1-314b, whisper-large-v3,
internvl2-26b and ``serve-tiny``);
``configs.toy`` holds the paper's toy workload (not a model)."""
from repro_torch.configs.base import (  # noqa: F401
    LAYER_KINDS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    cell_applicable,
    get_config,
    input_specs,
    list_configs,
    reduced,
    register,
    resolve_config,
)

from repro_torch.configs import (  # noqa: F401
    falcon_mamba_7b,
    gemma2_2b,
    gemma3_4b,
    grok_1_314b,
    internvl2_26b,
    minicpm_2b,
    nemotron_4_15b,
    qwen3_moe_30b_a3b,
    recurrentgemma_2b,
    toy,
    whisper_large_v3,
)

# The small dense model the serving plugins decode with when no arch is
# given (``plugins/serve.py::_serve_cfg``): all-global attention, so
# ``BatchedServer`` runs its continuous-batching loop on it.
SERVE_TINY = register(ModelConfig(
    name="serve-tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=256,
    layer_pattern=("global",)))

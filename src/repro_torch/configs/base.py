"""Model configs, the input-shape cells and the arch registry (own copy of
``repro.configs.base``).

``SHAPES`` are the JAX package's four pod-scale input-shape cells, kept as
they are; ``launch.dryrun`` takes them (and a one-device ``--batch`` /
``--seq``).  ``input_specs`` returns ``torch.empty(..., device="meta")``
stand-ins with the JAX specs' shapes and dtypes, so nothing is allocated.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

# Layer kinds used in ``layer_pattern`` (cycled over the depth of the stack):
#   "global" - full causal attention
#   "local"  - sliding-window causal attention
#   "rec"    - RG-LRU recurrent block (Griffin / RecurrentGemma)
#   "mamba"  - Mamba-1 selective-SSM block
LAYER_KINDS = ("global", "local", "rec", "mamba")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # -- block structure ----------------------------------------------------
    layer_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 0          # >0 for "local" layers
    mlp: str = "swiglu"              # swiglu | geglu | relu2 | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    post_norms: bool = False         # gemma2-style post-sublayer norms

    # -- attention details ----------------------------------------------------
    attn_softcap: float = 0.0        # tanh softcap on attention logits
    final_softcap: float = 0.0       # tanh softcap on final logits
    qk_norm: bool = False            # rmsnorm on q and k heads (gemma3/qwen3)
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # if >0, separate theta for global layers
    attn_scale: float = 0.0          # 0 => 1/sqrt(head_dim)

    # -- embeddings ----------------------------------------------------------
    tie_embeddings: bool = True
    emb_scale: bool = False          # multiply embeddings by sqrt(d_model)

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0                # expert hidden dim (0 => use d_ff)

    # -- SSM (mamba) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                 # 0 => ceil(d_model / 16)

    # -- RG-LRU (hybrid) -------------------------------------------------------
    lru_width: int = 0               # 0 => d_model

    # -- encoder/decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0          # 0 => decoder-only
    encoder_seq: int = 1500          # frontend-stub sequence length

    # -- VLM (internvl) ---------------------------------------------------------
    vision_tokens: int = 0           # prepended patch-embedding stub tokens

    # -- numerics / parallelism -----------------------------------------------
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"     # master parameter dtype
    optstate_dtype: str = "float32"  # Adam m/v dtype (bf16 for the huge archs)
    sharding_profile: str = "fsdp"   # fsdp | tp | tp_ep
    remat: str = "full"              # none | dots | full
    microbatches: int = 1            # gradient-accumulation steps
    scan_layers: bool = True         # stack homogeneous layer groups
    loss_chunk: int = 1024           # seq chunk for fused lm-head + loss

    # free-form provenance / notes
    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------ utils
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.num_layers))

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rec", "mamba") for k in self.layer_kinds)

    @property
    def is_pure_full_attention(self) -> bool:
        return all(k == "global" for k in self.layer_kinds)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic per-token state: SSM / recurrent / local-dominant."""
        return not self.is_pure_full_attention

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------- params
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d = self.d_model
        n = self.vocab_size * d                      # token embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = {}
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        gated = self.mlp in ("swiglu", "geglu")

        def mlp_params(ff):
            return d * ff * (3 if gated else 2)
        for kind in set(self.layer_kinds):
            if kind in ("global", "local"):
                p = attn + (mlp_params(self.d_ff) if self.num_experts == 0
                            else d * self.num_experts
                            + self.num_experts * (self.expert_ff * d * (3 if gated else 2)))
            elif kind == "rec":
                w = self.lru_width_
                p = 2 * d * w + w * d + 3 * w * w + self.ssm_conv * w + mlp_params(self.d_ff)
            elif kind == "mamba":
                di, st, dr = self.d_inner, self.ssm_state, self.dt_rank_
                p = (d * 2 * di + self.ssm_conv * di + di * (dr + 2 * st)
                     + dr * di + di * st + di + di * d)
            else:
                raise ValueError(kind)
            per_layer[kind] = p
        n += sum(per_layer[k] for k in self.layer_kinds)
        if self.encoder_layers:
            n += self.encoder_layers * (attn + mlp_params(self.d_ff))
            n += self.num_layers * attn              # cross attention
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        dense = self.replace(num_experts=0, experts_per_tok=0,
                             d_ff=self.expert_ff)
        base = dense.param_count()
        gated = self.mlp in ("swiglu", "geglu")
        per_expert = self.expert_ff * self.d_model * (3 if gated else 2)
        n_attn_layers = sum(1 for k in self.layer_kinds
                            if k in ("global", "local"))
        # dense.param_count used one expert-sized ffn per layer; swap in top-k
        base += n_attn_layers * (self.experts_per_tok - 1) * per_expert
        base += n_attn_layers * self.d_model * self.num_experts  # router
        return int(base)


# --------------------------------------------------------------------------
# Input-shape cells
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeSpec("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeSpec("long_500k",   "decode",  524_288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k skipped per assignment"
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins on the meta device (no storage) for every model input of
    the given shape cell, with the JAX package's shapes and dtypes."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = spec((B, S), i32)
            specs["seg_ids"] = spec((B, S), i32)
        if cfg.vision_tokens:
            specs["vision_embeds"] = spec((B, cfg.vision_tokens, cfg.d_model),
                                          bf16)
        if cfg.encoder_layers:
            specs["enc_frames"] = spec((B, cfg.encoder_seq, cfg.d_model),
                                       bf16)
        return specs
    if shape.kind == "decode":
        # one new token against a KV/state cache of length S
        return {"tokens": spec((B, 1), i32), "positions": spec((B,), i32)}
    raise ValueError(shape.kind)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (triggers arch registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_configs()}")
    return _REGISTRY[name]


def resolve_config(name: str) -> ModelConfig:
    """The config ``name``: a registered arch, or ``<base>-L<n>``, the
    full-width ``base`` config cut to its first n layers (not registered)."""
    try:
        return get_config(name)
    except KeyError:
        m = re.fullmatch(r"(.+)-L(\d+)", name)
        if m is None:
            raise
        return get_config(m[1]).replace(name=name, num_layers=int(m[2]))


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# Reduced configs for CPU tests
# --------------------------------------------------------------------------

def reduced(cfg: ModelConfig, *, layers: Optional[int] = None) -> ModelConfig:
    """Tiny same-family config: identical structure, laptop-scale dims."""
    pat = cfg.layer_pattern
    L = layers or max(2, len(pat))
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv, 4)
    kw: Dict[str, Any] = dict(
        name=cfg.name + "-reduced",
        num_layers=L,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=257,
        dtype="float32",
        param_dtype="float32",
        optstate_dtype="float32",
        microbatches=1,
        remat="none",
        loss_chunk=64,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_tok=min(2, cfg.experts_per_tok),
                  moe_d_ff=32)
    if cfg.ssm_state:
        kw.update(ssm_state=4, ssm_conv=4, ssm_expand=2, dt_rank=8)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.vision_tokens:
        kw.update(vision_tokens=8)
    out = cfg.replace(**kw)
    _REGISTRY.pop(out.name, None)
    return out

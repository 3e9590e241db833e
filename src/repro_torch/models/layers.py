"""Model substrate layers for dense attention models: norms, rope, MLP
variants and GQA attention (prefill and single-token decode).

Conventions (as in ``repro.models.layers``):
  * params stored in ``cfg.param_dtype``; compute in ``cfg.dtype``
    (norm/softmax accumulation in float32).
  * activations layout (B, S, D); attention heads (B, S, H, head_dim).
  * params are plain dicts of tensors; randomness comes from an explicit
    ``torch.Generator`` on the device the tensors are made on.

MoE, RG-LRU and Mamba mixers are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pd(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def cast(cfg: ModelConfig, w):
    return w.to(_dt(cfg))


def _normal(gen: torch.Generator, shape, std, dtype):
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


# ---------------------------------------------------------------- norms

def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=_pd(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_pd(cfg), device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        out = xf * p["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rms_head_norm(x, scale, eps: float = 1e-6):
    """qk-norm: rmsnorm over head_dim with a learned (head_dim,) scale."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


# ---------------------------------------------------------------- positions

def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S)."""
    D = x.shape[-1]
    half = D // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d: int):
    """Absolute sinusoidal embeddings: positions (...,) -> (..., d)."""
    half = d // 2
    inv = torch.exp(-torch.arange(half, dtype=torch.float32,
                                  device=positions.device)
                    * (math.log(10_000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- MLP

def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    D = cfg.d_model
    std_in = 0.02
    std_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    p = {"wi": _normal(gen, (D, d_ff), std_in, _pd(cfg)),
         "wo": _normal(gen, (d_ff, D), std_out, _pd(cfg))}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = _normal(gen, (D, d_ff), std_in, _pd(cfg))
    return p


def _mlp_act(cfg: ModelConfig, hi, hg):
    if cfg.mlp == "swiglu":
        return F.silu(hg) * hi
    if cfg.mlp == "geglu":
        return F.gelu(hg, approximate="tanh") * hi
    if cfg.mlp == "relu2":
        return torch.square(F.relu(hi))
    if cfg.mlp == "gelu":
        return F.gelu(hi, approximate="tanh")
    raise ValueError(cfg.mlp)


def apply_mlp(cfg: ModelConfig, p: Params, x):
    hi = x @ cast(cfg, p["wi"])
    hg = x @ cast(cfg, p["wg"]) if "wg" in p else None
    return _mlp_act(cfg, hi, hg) @ cast(cfg, p["wo"])


# ---------------------------------------------------------------- attention

def init_attn(cfg: ModelConfig, gen: torch.Generator,
              cross: bool = False) -> Params:
    D, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    std = 0.02
    std_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    p = {"wq": _normal(gen, (D, qd), std, _pd(cfg)),
         "wk": _normal(gen, (D, kvd), std, _pd(cfg)),
         "wv": _normal(gen, (D, kvd), std, _pd(cfg)),
         "wo": _normal(gen, (qd, D), std_out, _pd(cfg))}
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=_pd(cfg),
                                 device=gen.device)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=_pd(cfg),
                                 device=gen.device)
    return p


def _theta_for(cfg: ModelConfig, kind: str) -> float:
    if kind == "global" and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _qkv(cfg: ModelConfig, p: Params, x, positions, kind: str):
    B, S, _ = x.shape
    q = (x @ cast(cfg, p["wq"])).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ cast(cfg, p["wk"])).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ cast(cfg, p["wv"])).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    theta = _theta_for(cfg, kind)
    if theta:  # theta == 0 -> absolute sinusoidal positions (added upstream)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def apply_attn(cfg: ModelConfig, p: Params, x, *, kind: str, positions,
               seg_ids=None, impl: Optional[str] = None):
    """Self-attention.  kind: global | local | enc."""
    if kind == "cross":
        raise NotImplementedError("cross-attention is not ported yet")
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions, kind)
    window = cfg.sliding_window if kind == "local" else 0
    o = flash_attention(q, k, v, causal=kind != "enc", window=window,
                        softcap=cfg.attn_softcap,
                        scale=cfg.attn_scale or None,
                        seg_q=seg_ids, seg_kv=seg_ids, impl=impl)
    return o.reshape(B, S, cfg.q_dim) @ cast(cfg, p["wo"])


# -- decode (single new token against a cache) ------------------------------

def _decode_attention(cfg: ModelConfig, q, kc, vc, mask):
    """q: (B,1,H,D); kc/vc: (B,Sc,KH,D); mask: broadcastable to (B,Sc)."""
    B, _, H, Dh = q.shape
    KH = kc.shape[2]
    G = H // KH
    scale = cfg.attn_scale or Dh ** -0.5
    qf = q.float().reshape(B, KH, G, Dh) * scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, kc.float())
    if cfg.attn_softcap:
        s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    pden = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", e / pden.clamp_min(1e-30), vc.float())
    return o.reshape(B, 1, H * Dh).to(q.dtype)


def attn_decode(cfg: ModelConfig, p: Params, x, cache: Params, positions,
                *, kind: str) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); positions: (B,) per-row cache positions.  Each row writes
    its k/v at its own offset and attends under its own causal mask.
    Sliding-window local layers stay batch-synchronized (positions[0]):
    their ring cache carries one shared ``pos`` vector.

    Unlike the JAX version, the cache tensors are updated IN PLACE (the
    returned dict holds the same tensors), which saves a copy of the whole
    cache per layer and step.  Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    if kind == "cross":
        raise ValueError("use attn_decode_cross")
    q, k, v = _qkv(cfg, p, x, positions[:, None], kind)
    kc, vc = cache["k"], cache["v"]
    if kind == "local" and cfg.sliding_window:
        pos = positions[:1].long()             # ring cache: batch-synchronized
        W = kc.shape[1]
        slot = pos % W
        kc.index_copy_(1, slot, k)
        vc.index_copy_(1, slot, v)
        pc = cache["pos"]
        pc.index_copy_(0, slot, pos.to(pc.dtype))
        mask = (pc <= pos) & (pc > pos - W) & (pc >= 0)
        mask = mask[None, :].expand(B, W)
        new_cache = {"k": kc, "v": vc, "pos": pc}
    else:
        rows = torch.arange(B, device=x.device)
        pos = positions.long()
        kc.index_put_((rows, pos), k[:, 0])
        vc.index_put_((rows, pos), v[:, 0])
        S = kc.shape[1]
        mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
        new_cache = {"k": kc, "v": vc}
    out = _decode_attention(cfg, q, kc, vc, mask)
    return out @ cast(cfg, p["wo"]), new_cache


def attn_decode_cross(cfg: ModelConfig, p: Params, x, cache: Params):
    """Cross-attention decode (encoder-decoder models): not ported yet."""
    raise NotImplementedError("cross-attention decode is not ported yet")

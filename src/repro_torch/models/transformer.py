"""Decoder: parameter init, forward (prefill) and decode step.

Counterpart of ``repro.models.transformer`` for the layer kinds "global" and
"local" (attention, with a dense MLP or a mixture-of-experts FFN), "rec"
(RG-LRU, recurrentgemma) and "mamba" (Mamba-1, falcon-mamba); encoders and
vision tokens are not ported yet.  Where the JAX package scans stacked
``(G, ...)`` parameter groups with ``lax.scan``, the port keeps one
parameter dict per layer in ``params["layers"]`` (layer ``i`` has kind
``cfg.layer_kind(i)``) and loops over them in Python; ``models.convert``
maps between the two layouts.  The decode cache is likewise a list with one
dict per layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.remat import remat as _remat

Params = Dict[str, Any]
Cache = List[Params]

_ATTN_KINDS = ("global", "local")
_REC_KINDS = ("rec", "mamba")           # recurrent mixers with (h, conv) state
_KINDS = _ATTN_KINDS + _REC_KINDS


def _check_ported(cfg: ModelConfig) -> None:
    bad = sorted({k for k in cfg.layer_kinds if k not in _KINDS})
    if bad or cfg.encoder_layers or cfg.vision_tokens:
        raise NotImplementedError(
            f"{cfg.name}: only decoders of {'/'.join(_KINDS)} layers are "
            f"ported so far (found kinds {bad}, encoder layers "
            f"{cfg.encoder_layers}, vision tokens {cfg.vision_tokens})")


# ---------------------------------------------------------------- init

def _init_block(cfg: ModelConfig, gen: torch.Generator, kind: str) -> Params:
    dev = gen.device
    p: Params = {"ln1": L.init_norm(cfg, dev)}
    if kind == "rec":
        p["rec"] = L.init_rglru(cfg, gen)
        p["ln2"] = L.init_norm(cfg, dev)
        p["mlp"] = L.init_mlp(cfg, gen)
        return p
    if kind == "mamba":
        p["mamba"] = L.init_mamba(cfg, gen)
        return p
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    p["attn"] = L.init_attn(cfg, gen)
    if cfg.post_norms:
        p["ln1_post"] = L.init_norm(cfg, dev)
    p["ln2"] = L.init_norm(cfg, dev)
    if cfg.num_experts:
        p["moe"] = L.init_moe(cfg, gen)
    else:
        p["mlp"] = L.init_mlp(cfg, gen)
    if cfg.post_norms:
        p["ln2_post"] = L.init_norm(cfg, dev)
    return p


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, num_scanned_groups, num_tail_layers) of the JAX layout."""
    period = len(cfg.layer_pattern)
    if not cfg.scan_layers:
        return period, 0, cfg.num_layers
    G = cfg.num_layers // period
    return period, G, cfg.num_layers - G * period


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters with the JAX package's stds and dtypes, made on
    ``gen.device`` from ``gen`` (the numbers differ from JAX's)."""
    _check_ported(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    params: Params = {
        "embed": {"tok": L._normal(gen, (V, D), 0.02, L._pd(cfg))},
        "final_norm": L.init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (D, V), 0.02, L._pd(cfg))
    params["layers"] = [_init_block(cfg, gen, cfg.layer_kind(i))
                        for i in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------- blocks

def forward_block(cfg: ModelConfig, bp: Params, h, kind: str, *, positions,
                  seg_ids, cache_len: Optional[int],
                  impl: Optional[str] = None):
    """Returns (h, aux, cache_or_None); aux is the MoE load-balance loss
    (0 without experts).  ``impl`` goes to the block's kernels."""
    cache = None
    xin = L.apply_norm(cfg, bp["ln1"], h)
    if kind in _REC_KINDS:
        mixer = L.apply_rglru if kind == "rec" else L.apply_mamba
        if cache_len:
            m, cache = mixer(cfg, bp[kind], xin, return_state=True, impl=impl)
        else:
            m = mixer(cfg, bp[kind], xin, impl=impl)
        return _rec_mlp(cfg, bp, h + m), 0.0, cache
    if cache_len:
        a, cache = _attn_with_cache(cfg, bp["attn"], xin, kind=kind,
                                    positions=positions, seg_ids=seg_ids,
                                    cache_len=cache_len, impl=impl)
    else:
        a = L.apply_attn(cfg, bp["attn"], xin, kind=kind, positions=positions,
                         seg_ids=seg_ids, impl=impl)
    if cfg.post_norms:
        a = L.apply_norm(cfg, bp["ln1_post"], a)
    h = h + a
    y, aux = _ffn(cfg, bp, L.apply_norm(cfg, bp["ln2"], h), impl)
    if cfg.post_norms:
        y = L.apply_norm(cfg, bp["ln2_post"], y)
    return h + y, aux, cache


def _ffn(cfg: ModelConfig, bp: Params, x, impl: Optional[str]):
    """The FFN half of an attention block: (y, aux), aux 0 for a dense MLP."""
    if "moe" in bp:
        return L.apply_moe(cfg, bp["moe"], x, impl=impl)
    return L.apply_mlp(cfg, bp["mlp"], x), 0.0


def _rec_mlp(cfg: ModelConfig, bp: Params, h):
    """The MLP half of a Griffin residual block; Mamba blocks have none."""
    if "mlp" not in bp:
        return h
    return h + L.apply_mlp(cfg, bp["mlp"], L.apply_norm(cfg, bp["ln2"], h))


def _attn_with_cache(cfg, p, x, *, kind, positions, seg_ids, cache_len,
                     impl=None):
    """Prefill: compute attention AND return the kv cache (roped keys)."""
    B, S, _ = x.shape
    q, k, v = L._qkv(cfg, p, x, positions, kind)
    window = cfg.sliding_window if kind == "local" else 0
    o = flash_attention(q, k, v, causal=kind != "enc", window=window,
                        softcap=cfg.attn_softcap,
                        scale=cfg.attn_scale or None,
                        seg_q=seg_ids, seg_kv=seg_ids, impl=impl)
    out = o.reshape(B, S, cfg.q_dim) @ L.cast(cfg, p["wo"])
    if kind == "local" and cfg.sliding_window:
        W = cfg.sliding_window
        take = min(W, S)
        pos_tail = torch.arange(S - take, S, dtype=torch.int32,
                                device=x.device)
        slots = (pos_tail % W).long()
        kc = k.new_zeros((B, W) + tuple(k.shape[2:]))
        vc = v.new_zeros((B, W) + tuple(v.shape[2:]))
        kc[:, slots] = k[:, -take:]
        vc[:, slots] = v[:, -take:]
        pc = torch.full((W,), -1, dtype=torch.int32, device=x.device)
        pc[slots] = pos_tail
        return out, {"k": kc, "v": vc, "pos": pc}
    pad = cache_len - S
    kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return out, {"k": kc, "v": vc}


def decode_block(cfg: ModelConfig, bp: Params, h, cache: Params, kind: str,
                 *, positions, impl: Optional[str] = None):
    """Single-token step.  h: (B,1,D).  Returns (h, cache).  ``impl`` goes
    to the block's kernels (the MoE FFN's ``gmm``)."""
    xin = L.apply_norm(cfg, bp["ln1"], h)
    if kind in _REC_KINDS:
        step = L.rglru_decode if kind == "rec" else L.mamba_decode
        m, cache = step(cfg, bp[kind], xin, cache)
        return _rec_mlp(cfg, bp, h + m), cache
    a, cache = L.attn_decode(cfg, bp["attn"], xin, cache, positions,
                             kind=kind)
    if cfg.post_norms:
        a = L.apply_norm(cfg, bp["ln1_post"], a)
    h = h + a
    y, _ = _ffn(cfg, bp, L.apply_norm(cfg, bp["ln2"], h), impl)
    if cfg.post_norms:
        y = L.apply_norm(cfg, bp["ln2_post"], y)
    return h + y, cache


# ---------------------------------------------------------------- embed/head

def embed_tokens(cfg: ModelConfig, params: Params, tokens, positions):
    e = params["embed"]["tok"][tokens].to(L._dt(cfg))
    if cfg.emb_scale:
        e = e * torch.tensor(math.sqrt(cfg.d_model), dtype=L._dt(cfg),
                             device=e.device)
    if cfg.rope_theta == 0:  # absolute sinusoidal positions
        e = e + L.sinusoidal_pos(positions, cfg.d_model).to(L._dt(cfg))
    return e


def lm_logits(cfg: ModelConfig, params: Params, h):
    """Full f32 logits (serve path)."""
    if cfg.tie_embeddings:
        logits = h.float() @ params["embed"]["tok"].float().T
    else:
        logits = h.float() @ params["head"].float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


# ---------------------------------------------------------------- forward

def forward(cfg: ModelConfig, params: Params, tokens, *, positions=None,
            seg_ids=None, cache_len: Optional[int] = None,
            impl: Optional[str] = None, remat: bool = False):
    """Returns dict with h (B,S,D final-normed), aux (scalar), cache (or None).

    ``cache_len``: when set, collect a decode cache (prefill mode); caches
    for global-attention layers are padded to this length.
    ``impl``: passed to every kernel wrapper on the path
    (``flash_attention``, ``linear_scan``, ``selective_scan``, ``gmm``):
    None (the tensors' device decides) or "ref" (the plain versions).
    ``remat``: recompute each block in the backward pass instead of keeping
    its activations (``models.remat``, which ``torch.func.vmap`` reaches),
    as the JAX package's ``remat="full"`` saves nothing inside a block.
    """
    if remat and cache_len is not None:
        raise ValueError("remat is for training; prefill collects a cache")
    _check_ported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    h = embed_tokens(cfg, params, tokens, positions)
    cache: Cache = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, bp in enumerate(params["layers"]):
        kind = cfg.layer_kind(i)
        if remat:
            def block(hh, bp, positions, seg_ids, kind=kind):
                out, a, _ = forward_block(cfg, bp, hh, kind,
                                          positions=positions,
                                          seg_ids=seg_ids, cache_len=None,
                                          impl=impl)
                return out, torch.as_tensor(a, dtype=torch.float32,
                                            device=out.device)
            h, a = _remat(block, h, bp, positions, seg_ids)
            c = None
        else:
            h, a, c = forward_block(cfg, bp, h, kind, positions=positions,
                                    seg_ids=seg_ids, cache_len=cache_len,
                                    impl=impl)
        aux = aux + a
        cache.append(c)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return {"h": h, "aux": aux,
            "cache": cache if cache_len is not None else None}


# ---------------------------------------------------------------- decode

def decode_step(cfg: ModelConfig, params: Params, cache: Cache, tokens,
                positions, impl: Optional[str] = None):
    """One token for the whole batch.  tokens: (B,1); positions: (B,)
    per-row offsets.  Returns (logits (B,1,V), cache updated in place).
    ``impl`` as in ``forward``."""
    h = embed_tokens(cfg, params, tokens, positions[:, None])
    new_cache: Cache = []
    for i, bp in enumerate(params["layers"]):
        h, c = decode_block(cfg, bp, h, cache[i], cfg.layer_kind(i),
                            positions=positions, impl=impl)
        new_cache.append(c)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return lm_logits(cfg, params, h), new_cache


# ---------------------------------------------------------------- cache init

def _block_cache_zeros(cfg: ModelConfig, kind: str, B: int, cache_len: int,
                       device) -> Params:
    dt = L._dt(cfg)
    KH, Dh = cfg.num_kv_heads, cfg.head_dim
    if kind == "local" and cfg.sliding_window:
        W = min(cfg.sliding_window, cache_len)
        return {"k": torch.zeros((B, W, KH, Dh), dtype=dt, device=device),
                "v": torch.zeros((B, W, KH, Dh), dtype=dt, device=device),
                "pos": torch.full((W,), -1, dtype=torch.int32, device=device)}
    if kind in _ATTN_KINDS:
        return {"k": torch.zeros((B, cache_len, KH, Dh), dtype=dt,
                                 device=device),
                "v": torch.zeros((B, cache_len, KH, Dh), dtype=dt,
                                 device=device)}
    if kind in _REC_KINDS:
        W = cfg.lru_width_ if kind == "rec" else cfg.d_inner
        h = (B, W) if kind == "rec" else (B, W, cfg.ssm_state)
        return {"h": torch.zeros(h, dtype=torch.float32, device=device),
                "conv": torch.zeros((B, cfg.ssm_conv - 1, W), dtype=dt,
                                    device=device)}
    raise NotImplementedError(f"layer kind {kind!r} is not ported yet")


def init_cache(cfg: ModelConfig, B: int, cache_len: int, device) -> Cache:
    return [_block_cache_zeros(cfg, cfg.layer_kind(i), B, cache_len, device)
            for i in range(cfg.num_layers)]

"""Model substrate layers: norms, rope, MLP variants, GQA attention (prefill
and single-token decode), the mixture-of-experts FFN, the Griffin RG-LRU
mixer and the Mamba-1 mixer.

Conventions (as in ``repro.models.layers``):
  * params stored in ``cfg.param_dtype``; compute in ``cfg.dtype``
    (norm/softmax/scan accumulation in float32).  The RG-LRU ``a_param``
    and Mamba's ``A_log``, ``D`` and ``dt_bias`` stay float32 whatever
    ``param_dtype`` is, as do the scan states.
  * activations layout (B, S, D); attention heads (B, S, H, head_dim).
  * params are plain dicts of tensors; randomness comes from an explicit
    ``torch.Generator`` on the device the tensors are made on.  The MoE
    router stays float32 too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba.ops import selective_scan, selective_step
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.kernels.rglru.ops import linear_scan

Params = Dict[str, Any]

RGLRU_C = 8.0  # Griffin's recurrent-gate temperature

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
        S = kc.shape[1]
        # a row past the cache's end (an emptied slot of the continuous
        # loop, still stepped) writes its last entry, as the JAX package's
        # dynamic_update_slice clamps its start
        at = pos.clamp(max=S - 1)
        kc.index_put_((rows, at), k[:, 0])
        vc.index_put_((rows, at), v[:, 0])
        mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
        new_cache = {"k": kc, "v": vc}
    out = _decode_attention(cfg, q, kc, vc, mask)
    return out @ cast(cfg, p["wo"]), new_cache


def attn_decode_cross(cfg: ModelConfig, p: Params, x, cache: Params):
    """Cross-attention decode (encoder-decoder models): not ported yet."""
    raise NotImplementedError("cross-attention decode is not ported yet")


# ---------------------------------------------------------------- MoE

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, Fe, E = cfg.d_model, cfg.expert_ff, cfg.num_experts
    std = 0.02
    std_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    p = {"router": _normal(gen, (D, E), std, torch.float32),
         "wi": _normal(gen, (E, D, Fe), std, _pd(cfg)),
         "wo": _normal(gen, (E, Fe, D), std_out, _pd(cfg))}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = _normal(gen, (E, D, Fe), std, _pd(cfg))
    return p


def _moe_local(cfg: ModelConfig, p: Params, xt, capacity_factor: float,
               impl: Optional[str] = None):
    """Sort+scatter dispatch over every expert, as
    ``repro.models.layers._moe_local`` with the whole expert population
    local (``e_base=0``, ``E_local=E``: its ``mesh=None`` branch).

    xt: (T, D) tokens.  Returns (y (T, D), aux load-balance loss).  The
    router runs in f32; top-k weights are renormalised; assignments past an
    expert's capacity C go to a spare row and are dropped.  Nothing here
    waits for the device: counts are built with ``scatter_add_`` and C
    depends only on T, k, E and ``capacity_factor``.

    The combine is deterministic (no atomics): each token's k contributions
    ``back * w`` (rounded to ``ye``'s dtype) are added one after another in
    xt's dtype, starting from 0, in their order in the sorted dispatch
    (ascending expert id).  That is the order and the rounding of the JAX
    reference's ``zeros.at[tid_s].add(...)`` on the CPU.
    """
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    dev = xt.device
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    wts, idx = torch.topk(probs, k, dim=-1, sorted=True)         # (T, k)
    wts = wts / wts.sum(-1, keepdim=True).clamp_min(1e-9)

    eids = idx.reshape(-1)                                       # (T*k,)
    tids = torch.arange(T, device=dev).repeat_interleave(k)
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).scatter_add_(
        0, eids, torch.ones_like(eids, dtype=torch.int32))
    # aux loss (switch-style)
    aux = E * (counts.float() / (T * k) * probs.mean(dim=0)).sum()

    order = torch.argsort(eids, stable=True)
    e_s = eids[order]
    tid_s = tids[order]
    w_s = wts.reshape(-1)[order]
    pos_in_e = (torch.arange(T * k, device=dev)
                - (torch.cumsum(counts, 0) - counts)[e_s])

    cap_block = 128 if T * k // E >= 128 else 8
    C = max(cap_block,
            _round_up(int(math.ceil(T * k / E * capacity_factor)), cap_block))
    keep = pos_in_e < C
    slot = torch.where(keep, e_s * C + pos_in_e, torch.full_like(e_s, E * C))

    xe = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=dev)
    xe[slot] = xt[tid_s] * keep[:, None].to(xt.dtype)
    xe = xe[:-1].reshape(E, C, D)
    group_sizes = torch.clamp(counts, max=C)

    hi = gmm(xe, cast(cfg, p["wi"]), group_sizes, impl=impl)
    hg = (gmm(xe, cast(cfg, p["wg"]), group_sizes, impl=impl)
          if "wg" in p else None)
    h = _mlp_act(cfg, hi, hg)
    ye = gmm(h, cast(cfg, p["wo"]), group_sizes, impl=impl)

    flat = torch.cat([ye.reshape(E * C, D),
                      torch.zeros((1, D), dtype=ye.dtype, device=dev)])
    contrib = flat[slot] * keep[:, None].to(ye.dtype) * w_s[:, None].to(
        ye.dtype)
    # each token's k positions in the sorted order, ascending
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=dev))
    rank = rank.view(T, k).sort(dim=1).values
    y = torch.zeros((T, D), dtype=xt.dtype, device=dev)
    for j in range(k):
        y = y + contrib[rank[:, j]]
    return y, aux


def apply_moe(cfg: ModelConfig, p: Params, x, *, mesh=None,
              capacity_factor: float = 1.25, impl: Optional[str] = None):
    """Returns (y, aux_loss).  The local dispatch (``mesh=None``) only:
    expert parallelism over a device mesh is not ported yet.  ``impl`` goes
    to ``gmm`` (None or "ref")."""
    if mesh is not None:
        raise NotImplementedError(
            "apply_moe over a device mesh (expert parallelism) is not "
            "ported yet")
    B, S, D = x.shape
    y, aux = _moe_local(cfg, p, x.reshape(-1, D), capacity_factor,
                        impl=impl)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------- conv1d

def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B,S,C); w: (cw, C); b: (C,).

    cw shifted elementwise multiply-accumulates in float32, as the JAX
    package writes it."""
    cw, _ = w.shape
    S = x.shape[1]
    xf = x.float()
    wf = w.float()
    acc = xf * wf[cw - 1]
    for j in range(1, cw):
        shifted = F.pad(xf, (0, 0, j, 0))[:, :S]
        acc = acc + shifted * wf[cw - 1 - j]
    return (acc + b.float()).to(x.dtype)


def conv1d_step(x1, buf, w, b):
    """Single-token conv step.  x1: (B,C); buf: (B,cw-1,C) past inputs.
    Returns (y (B,C), new buf)."""
    full = torch.cat([buf, x1[:, None, :]], dim=1)          # (B, cw, C)
    y = torch.einsum("bwc,wc->bc", full.float(), w.float())
    y = (y + b.float()).to(x1.dtype)
    return y, full[:, 1:]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


# ---------------------------------------------------------------- RG-LRU

def init_rglru(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, W = cfg.d_model, cfg.lru_width_
    std = 0.02
    std_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    # Lambda init so that a^c is in [0.9, 0.999]
    root = _uniform(gen, (W,), 0.9, 0.999) ** (1.0 / RGLRU_C)
    return {
        "wx": _normal(gen, (D, W), std, _pd(cfg)),
        "wy": _normal(gen, (D, W), std, _pd(cfg)),
        "conv_w": _normal(gen, (cfg.ssm_conv, W), std, _pd(cfg)),
        "conv_b": torch.zeros((W,), dtype=_pd(cfg), device=gen.device),
        "wa": _normal(gen, (W, W), std, _pd(cfg)),
        "wi_g": _normal(gen, (W, W), std, _pd(cfg)),
        "a_param": torch.log(root / (1.0 - root)),           # logit, f32
        "wo": _normal(gen, (W, D), std_out, _pd(cfg)),
    }


def _rglru_gates(p: Params, xb):
    """Returns (a, x_eff) for h_t = a_t h_{t-1} + x_eff_t (float32)."""
    xf = xb.float()
    r = torch.sigmoid(xf @ p["wa"].float())
    i = torch.sigmoid(xf @ p["wi_g"].float())
    log_a = RGLRU_C * r * F.logsigmoid(p["a_param"])[None]
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * xf


def apply_rglru(cfg: ModelConfig, p: Params, x, *, h0=None, conv_buf=None,
                return_state: bool = False, impl: Optional[str] = None):
    """Griffin recurrent mixer.  x: (B,S,D).  ``impl`` goes to
    ``linear_scan`` (None or "ref")."""
    B = x.shape[0]
    W = cfg.lru_width_
    xb = x @ cast(cfg, p["wx"])
    yb = F.gelu(x @ cast(cfg, p["wy"]), approximate="tanh")
    if conv_buf is not None:
        raise NotImplementedError(
            "stateful RG-LRU prefill (a conv buffer carried in): the JAX "
            "package does not have it either")
    a, x_eff = _rglru_gates(p, causal_conv1d(xb, p["conv_w"], p["conv_b"]))
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    h, h_last = linear_scan(x_eff, a, h0, impl=impl)
    out = (h.to(_dt(cfg)) * yb) @ cast(cfg, p["wo"])
    if return_state:
        # conv state: the last (cw-1) pre-conv inputs, copied out of xb
        buf = xb[:, -(cfg.ssm_conv - 1):, :].contiguous()
        return out, {"h": h_last, "conv": buf}
    return out


def rglru_decode(cfg: ModelConfig, p: Params, x, cache: Params):
    """x: (B,1,D).  cache: {"h": (B,W) f32, "conv": (B,cw-1,W)}."""
    x1 = x[:, 0, :]
    xb1 = x1 @ cast(cfg, p["wx"])
    yb1 = F.gelu(x1 @ cast(cfg, p["wy"]), approximate="tanh")
    xc, new_buf = conv1d_step(xb1, cache["conv"], p["conv_w"], p["conv_b"])
    a, x_eff = _rglru_gates(p, xc[:, None, :])
    h = a[:, 0] * cache["h"] + x_eff[:, 0]
    out = (h.to(_dt(cfg)) * yb1) @ cast(cfg, p["wo"])
    return out[:, None, :], {"h": h, "conv": new_buf}


# ---------------------------------------------------------------- Mamba

def init_mamba(cfg: ModelConfig, gen: torch.Generator) -> Params:
    D, di, n, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    dev = gen.device
    std = 0.02
    std_out = 0.02 / math.sqrt(2 * cfg.num_layers)
    A = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None].repeat(
        di, 1)
    dt = torch.exp(_uniform(gen, (di,), math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": _normal(gen, (D, 2 * di), std, _pd(cfg)),
        "conv_w": _normal(gen, (cfg.ssm_conv, di), std, _pd(cfg)),
        "conv_b": torch.zeros((di,), dtype=_pd(cfg), device=dev),
        "x_proj": _normal(gen, (di, dr + 2 * n), std, _pd(cfg)),
        "dt_proj": _normal(gen, (dr, di), dr ** -0.5, _pd(cfg)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),    # inverse softplus
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _normal(gen, (di, D), std_out, _pd(cfg)),
    }


def _mamba_bcdt(cfg: ModelConfig, p: Params, xin):
    """(dt f32, Bm, C) of the scan.  Bm and C are column slices of the
    ``x_proj`` output (not contiguous; the scan kernel reads them in place)."""
    n, dr = cfg.ssm_state, cfg.dt_rank_
    xdbc = xin @ cast(cfg, p["x_proj"])
    dt_r, Bm, Cc = torch.split(xdbc, [dr, n, n], dim=-1)
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float() + p["dt_bias"][None])
    return dt, Bm, Cc


def apply_mamba(cfg: ModelConfig, p: Params, x, *,
                return_state: bool = False, impl: Optional[str] = None):
    """Mamba-1 mixer.  x: (B,S,D).  ``impl`` goes to ``selective_scan``
    (None or "ref")."""
    B = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    xin, z = (x @ cast(cfg, p["in_proj"])).chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(xin, p["conv_w"], p["conv_b"]))
    dt, Bm, Cc = _mamba_bcdt(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    y, h_last = selective_scan(xc, dt, A, Bm, Cc, p["D"], h0, impl=impl)
    out = (y * F.silu(z)) @ cast(cfg, p["out_proj"])
    if return_state:
        # conv state: the last (cw-1) pre-conv inputs, copied out of xin
        buf = xin[:, -(cfg.ssm_conv - 1):, :].contiguous()
        return out, {"h": h_last, "conv": buf}
    return out


def mamba_decode(cfg: ModelConfig, p: Params, x, cache: Params):
    """x: (B,1,D).  cache: {"h": (B,di,n) f32, "conv": (B,cw-1,di)}."""
    xin, z = (x[:, 0, :] @ cast(cfg, p["in_proj"])).chunk(2, dim=-1)
    xc, new_buf = conv1d_step(xin, cache["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt, Bm, Cc = _mamba_bcdt(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    y, h = selective_step(xc, dt, A, Bm, Cc, p["D"], cache["h"])
    out = ((y * F.silu(z)) @ cast(cfg, p["out_proj"]))[:, None, :]
    return out, {"h": h, "conv": new_buf}

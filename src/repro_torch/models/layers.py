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
  * ``mesh``: the params are a rank's compute copies (``dist.spmd.
    gather_params``), each leaf the spec shards over ``model`` as its
    shard.  A layer whose weights are such shards computes on them
    Megatron-style (``spmd.TensorParallel``: column-parallel products
    after ``copy``, row-parallel ones before ``sum``).  Each layer is
    written once: with a ``model`` axis of one rank, or weights the spec
    leaves whole, its ``TensorParallel`` is ``spmd.ONE``, whose ops are
    identities, so it takes the unsharded ops.  Which leaves are shards
    is read from the specs (``TensorParallel.param_dim`` / ``over``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.spmd import ONE, tensor_parallel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba.ops import selective_scan, selective_step
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.kernels.rglru.ops import linear_scan
from repro_torch.models.remat import dot

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
    # The JAX package's compiled step computes 1 / theta ** (i / half) as
    # theta ** -(i * (1 / half)), one correctly rounded f32 power (XLA's
    # algebraic simplifier); past position 2^19 an ulp of the inverse
    # frequency moves the f32 angle by up to 0.03 rad, so the port rounds
    # the same value: the power in f64, rounded once.
    exps = torch.arange(half, dtype=torch.float32, device=x.device) \
        * (1.0 / half)
    inv = (theta ** -exps.double()).float()
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


def apply_mlp(cfg: ModelConfig, p: Params, x, mesh=None, keep_out=False):
    """Under ``mesh`` with ``d_ff`` split over ``model``: ``wi`` and ``wg``
    column-parallel, ``wo`` row-parallel.  ``wi``'s and ``wg``'s outputs
    are kept products (``models.remat.dot``); ``wo``'s only where
    ``keep_out`` (the caller's backward pass reads it)."""
    tp = tensor_parallel(mesh).over(cfg, ("mlp", "wo"),
                                    (cfg.d_ff, cfg.d_model))
    x = tp.copy(x)
    hi = dot(x, cast(cfg, p["wi"]), "wi")
    hg = dot(x, cast(cfg, p["wg"]), "wg") if "wg" in p else None
    h, wo = _mlp_act(cfg, hi, hg), cast(cfg, p["wo"])
    return tp.sum(dot(h, wo, "wo") if keep_out else h @ wo)


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


# ``wq``/``wk``/``wv`` are split over ``model`` on contiguous output columns
# and ``wo`` on its rows, whether or not heads divide.  With m model ranks:
#   (a) H % m == 0 and KH % m == 0: every head this rank computes is local;
#   (b) H % m == 0, KH % m != 0: the q heads are local; k and v (kv_dim
#       wide) are gathered and each rank keeps the kv heads its q heads
#       read (repeated per q head where its q heads straddle kv groups);
#   (c) H % m != 0: q, k and v are gathered and attention runs on every
#       head, replicated over ``model``; each rank takes its q_dim / m
#       columns of the output for the row-parallel ``wo``.
# m = 1 (``ONE``) is case (a) with every op the identity.

def _attn_tp(cfg: ModelConfig, mesh):
    """The ``TensorParallel`` an attention layer computes under: ``ONE``
    where the spec leaves ``wq`` whole (then ``wo`` is too)."""
    return tensor_parallel(mesh).over(cfg, ("attn", "wq"),
                                      (cfg.d_model, cfg.q_dim))


def _col(tp, x, w, name: str, split: bool, keep: bool):
    """``x @ w`` (the parameter ``name``) inside a tensor-parallel region:
    of a column shard ``w`` (``split``) this rank's columns where ``keep``,
    else every column, gathered; a whole ``w`` joins the region through
    ``copy``."""
    if not split:
        return dot(x, tp.copy(w), name)
    y = dot(x, w, name)
    return y if keep else tp.gather(y, -1)


def _kv_for_local_q(cfg: ModelConfig, tp, k):
    """Case (b): of every kv head ``k`` (B, S, KH, D), the ones this rank's
    H / m q heads read, so that the local heads fold as GQA."""
    H, KH, m = cfg.num_heads, cfg.num_kv_heads, tp.size
    Hl, G = H // m, H // KH
    first = tp.rank * Hl
    if Hl % G == 0:
        return k.narrow(2, first // G, Hl // G).contiguous()
    if G % Hl == 0:
        return k.narrow(2, first // G, 1).contiguous()
    idx = torch.div(torch.arange(first, first + Hl, device=k.device), G,
                    rounding_mode="floor")
    return k.index_select(2, idx)


def _qkv(cfg: ModelConfig, p: Params, xq, xkv, positions, kind: str, tp,
         local: bool):
    """(q, k, v, k_all, v_all) of this rank (``xq``, ``xkv`` already
    inside the region; a cross layer's k and v come from ``xkv``, without
    rope or qk-norm).  ``local``: q holds this rank's H / m heads and k, v
    the kv heads they read (cases (a), (b)); else every head (case (c)).
    ``k_all`` and ``v_all`` hold this rank's kv heads in case (a), every
    kv head otherwise (what a cache keeps its part of)."""
    B, S, _ = xq.shape
    Sk, hd = xkv.shape[1], cfg.head_dim
    kv_local = local and cfg.num_kv_heads % tp.size == 0
    kv_split = tp.param_dim(cfg, ("attn", "wk"),
                            (cfg.d_model, cfg.kv_dim)) is not None
    q = _col(tp, xq, cast(cfg, p["wq"]), "wq", tp is not ONE, local)
    q = q.reshape(B, S, -1, hd)
    k = _col(tp, xkv, cast(cfg, p["wk"]), "wk", kv_split, kv_local)
    v = _col(tp, xkv, cast(cfg, p["wv"]), "wv", kv_split, kv_local)
    k, v = k.reshape(B, Sk, -1, hd), v.reshape(B, Sk, -1, hd)
    if kind != "cross":
        if cfg.qk_norm:
            q = rms_head_norm(q, tp.copy(p["q_norm"]))
            k = rms_head_norm(k, tp.copy(p["k_norm"]))
        theta = _theta_for(cfg, kind)
        if theta:  # theta == 0 -> absolute sinusoidal positions (upstream)
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
    if local and not kv_local:
        return (q, _kv_for_local_q(cfg, tp, k), _kv_for_local_q(cfg, tp, v),
                k, v)
    return q, k, v, k, v


def _attn_out(cfg: ModelConfig, p: Params, o, tp, local: bool):
    """The row-parallel ``wo`` of attention output ``o`` (B, S, heads, D):
    this rank's q_dim / m columns of it (all of it for local heads),
    summed over ``model``."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    if not local:
        o = tp.shard(o, -1)
    return tp.sum(dot(o, cast(cfg, p["wo"]), "wo"))


def _kv_cache_dim(cfg: ModelConfig, tp) -> Optional[int]:
    """The dim of a (B, S, KH, D) kv cache that ``cache_spec`` splits over
    ``model``: 2 (kv heads), 3 (head_dim) or None (whole)."""
    return tp.cache_dim(cfg, ("k",), (1, 1, cfg.num_kv_heads,
                                       cfg.head_dim))


def cache_part(cfg: ModelConfig, tp, k_all):
    """A rank's part of k or v by ``cache_spec``: its kv heads (``k_all``
    is already so: case (a)), else its head_dim slice of every head, else
    all of it."""
    return tp.shard(k_all, -1) if _kv_cache_dim(cfg, tp) == 3 else k_all


def apply_attn(cfg: ModelConfig, p: Params, x, *, kind: str, positions,
               seg_ids=None, mem=None, mesh=None,
               impl: Optional[str] = None, return_kv: bool = False):
    """Self- or cross-attention.  kind: global | local | enc | cross
    (q from x, k and v from ``mem``, every pair attended, no segments).
    ``mesh``: the tensors are a rank's local shard and the kernel runs on
    them; with ``wq`` split over ``model``, tensor-parallel (cases (a) to
    (c) above).  ``return_kv``: (out, (k, v)), the roped k and v as a
    prefill's cache keeps them (this rank's part, ``cache_part``)."""
    tp = _attn_tp(cfg, mesh)
    local = cfg.num_heads % tp.size == 0
    cross = kind == "cross"
    xc = tp.copy(x)
    q, k, v, k_all, v_all = _qkv(cfg, p, xc, tp.copy(mem) if cross else xc,
                                 positions, kind, tp, local)
    o = flash_attention(q, k, v, causal=kind not in ("enc", "cross"),
                        window=cfg.sliding_window if kind == "local" else 0,
                        softcap=cfg.attn_softcap,
                        scale=cfg.attn_scale or None,
                        seg_q=None if cross else seg_ids,
                        seg_kv=None if cross else seg_ids, impl=impl)
    out = _attn_out(cfg, p, o, tp, local)
    if return_kv:
        return out, (cache_part(cfg, tp, k_all), cache_part(cfg, tp, v_all))
    return out


# -- decode (single new token against a cache) ------------------------------

def _decode_attention(cfg: ModelConfig, q, kc, vc, mask, tp=ONE):
    """q: (B,1,H,D); kc/vc: (B,Sc,KH,D); mask: broadcastable to (B,Sc).
    ``tp`` (not ``ONE``): q, kc and vc are this rank's head_dim slice of
    every head (the cache's head_dim split), so the scores are summed
    over ``model``; the output is then each head's slice."""
    B, _, H, Dh = q.shape
    KH = kc.shape[2]
    G = H // KH
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    qf = q.float().reshape(B, KH, G, Dh) * scale
    s = tp.sum(torch.einsum("bhgd,bshd->bhgs", qf, kc.float()))
    if cfg.attn_softcap:
        s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    pden = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", e / pden.clamp_min(1e-30), vc.float())
    return o.reshape(B, 1, H * Dh).to(q.dtype)


def _decode_out(cfg: ModelConfig, p: Params, q, kc, vc, mask, tp):
    """Decode attention of q (B,1,H or H/m,D) against a rank's cache part
    (``cache_part``), through the row-parallel ``wo``: with kv heads
    split, on the local heads; with head_dim split, partial scores summed
    and each head's output slice gathered; with the cache whole, on every
    head."""
    if _kv_cache_dim(cfg, tp) == 3:
        o = _decode_attention(cfg, tp.shard(q, -1), kc, vc, mask, tp)
        o = tp.gather(o.reshape(q.shape[0], 1, cfg.num_heads, -1), -1)
    else:
        o = _decode_attention(cfg, q, kc, vc, mask)
    return _attn_out(cfg, p, o, tp, cfg.num_kv_heads % tp.size == 0)


def attn_decode(cfg: ModelConfig, p: Params, x, cache: Params, positions,
                *, kind: str, mesh=None) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); positions: (B,) per-row cache positions.  Each row writes
    its k/v at its own offset and attends under its own causal mask.
    Sliding-window local layers stay batch-synchronized (positions[0]):
    their ring cache carries one shared ``pos`` vector.

    Unlike the JAX version, the cache tensors are updated IN PLACE (the
    returned dict holds the same tensors), which saves a copy of the whole
    cache per layer and step.  Under ``mesh`` the cache holds this rank's
    part (``cache_part``) and attention is tensor-parallel
    (``_decode_out``).  Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    if kind == "cross":
        raise ValueError("use attn_decode_cross")
    tp = _attn_tp(cfg, mesh)
    q, _, _, k, v = _qkv(cfg, p, x, x, positions[:, None], kind, tp,
                         cfg.num_kv_heads % tp.size == 0)
    k, v = cache_part(cfg, tp, k), cache_part(cfg, tp, v)
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
    return _decode_out(cfg, p, q, kc, vc, mask, tp), new_cache


def attn_decode_cross(cfg: ModelConfig, p: Params, x, cache: Params,
                      mesh=None):
    """Cross-attention decode: the encoder's k, v were cached at prefill
    (``xk``, ``xv``: (B,Sm,KH,D), a rank's part under ``mesh``) and every
    one of them is attended."""
    B = x.shape[0]
    xk = cache["xk"]
    mask = torch.ones((B, xk.shape[1]), dtype=torch.bool, device=x.device)
    tp = _attn_tp(cfg, mesh)
    q = _col(tp, x, cast(cfg, p["wq"]), "wq", tp is not ONE,
             cfg.num_kv_heads % tp.size == 0)
    q = q.reshape(B, 1, -1, cfg.head_dim)
    return _decode_out(cfg, p, q, xk, cache["xv"], mask, tp)


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


def _route(cfg: ModelConfig, p: Params, xt):
    """The router over every expert: (wts (T, k) renormalised top-k
    weights, eids (T*k,) their experts, aux switch-style load-balance
    loss over the counts of assignments per expert).  The router runs in f32;
    ``counts`` (integers, the reference's ``f``) carries no gradient,
    ``probs.mean`` does."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_tok
    logits = dot(xt.float(), p["router"].float(), "router")
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    wts, idx = torch.topk(probs, k, dim=-1, sorted=True)         # (T, k)
    wts = wts / wts.sum(-1, keepdim=True).clamp_min(1e-9)
    eids = idx.reshape(-1)                                       # (T*k,)
    counts = torch.zeros((E,), dtype=torch.int32,
                         device=xt.device).scatter_add(
        0, eids, torch.ones_like(eids, dtype=torch.int32))
    aux = E * (counts.float() / (T * k) * probs.mean(dim=0)).sum()
    return wts, eids, aux


def _dispatch(cfg: ModelConfig, p: Params, xt, wts, eids, e_base: int,
              E_local: int, capacity_factor: float,
              impl: Optional[str] = None):
    """Sort+scatter dispatch to the local experts [e_base, e_base+E_local)
    (``repro.models.layers._moe_local``'s dispatch): ``p["wi"/"wg"/"wo"]``
    hold those E_local experts.  Returns y (T, D), the sum of the local
    experts' weighted outputs (0 for a token none of whose experts is
    local).

    Assignments to other experts sort behind the local ones and are
    dropped, as are those past an expert's capacity C, which is reckoned
    from the local tokens T over all E experts.  Nothing here waits for
    the device: counts are built with ``scatter_add``.  Every write is out
    of place (``scatter_add``, ``index_put``, ``scatter``), so the dispatch
    runs under ``torch.func.vmap`` (a fused ensemble's member axis).  Under
    autograd or vmap the three ``gmm`` calls go through ``GroupedMatmul``
    (the backward kernels on CUDA).

    The combine is deterministic (no atomics): each token's k contributions
    ``back * w`` (rounded to ``ye``'s dtype) are added one after another in
    xt's dtype, starting from 0, in their order in the sorted dispatch
    (ascending expert id).  That is the order and the rounding of the JAX
    reference's ``zeros.at[tid_s].add(...)`` on the CPU.
    """
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    dev = xt.device
    tids = torch.arange(T, device=dev).repeat_interleave(k)
    el = eids - e_base
    inrange = (el >= 0) & (el < E_local)
    sort_key = torch.where(inrange, el, torch.full_like(el, E_local))
    order = torch.argsort(sort_key, stable=True)
    e_s = sort_key[order]
    tid_s = tids[order]
    w_s = wts.reshape(-1)[order]
    counts = torch.zeros((E_local + 1,), dtype=torch.int32,
                         device=dev).scatter_add(
        0, sort_key, torch.ones_like(sort_key, dtype=torch.int32))
    pos_in_e = (torch.arange(T * k, device=dev)
                - (torch.cumsum(counts, 0) - counts)[e_s])

    cap_block = 128 if T * k // max(E_local, 1) >= 128 else 8
    C = max(cap_block,
            _round_up(int(math.ceil(T * k / E * capacity_factor)), cap_block))
    keep = (pos_in_e < C) & (e_s < E_local)
    slot = torch.where(keep, e_s * C + pos_in_e,
                       torch.full_like(e_s, E_local * C))

    xe = torch.zeros((E_local * C + 1, D), dtype=xt.dtype,
                     device=dev).index_put(
        (slot,), xt[tid_s] * keep[:, None].to(xt.dtype))
    xe = xe[:-1].reshape(E_local, C, D)
    group_sizes = torch.clamp(counts[:E_local], max=C)

    hi = gmm(xe, cast(cfg, p["wi"]), group_sizes, impl=impl)
    hg = (gmm(xe, cast(cfg, p["wg"]), group_sizes, impl=impl)
          if "wg" in p else None)
    h = _mlp_act(cfg, hi, hg)
    ye = gmm(h, cast(cfg, p["wo"]), group_sizes, impl=impl)

    flat = torch.cat([ye.reshape(E_local * C, D),
                      torch.zeros((1, D), dtype=ye.dtype, device=dev)])
    contrib = flat[slot] * keep[:, None].to(ye.dtype) * w_s[:, None].to(
        ye.dtype)
    # each token's k positions in the sorted order, ascending
    rank = torch.empty_like(order).scatter(
        0, order, torch.arange(T * k, device=dev))
    rank = rank.view(T, k).sort(dim=1).values
    y = torch.zeros((T, D), dtype=xt.dtype, device=dev)
    for j in range(k):
        y = y + contrib[rank[:, j]]
    return y


def _moe_local(cfg: ModelConfig, p: Params, xt, capacity_factor: float,
               impl: Optional[str] = None):
    """Route and dispatch over every expert, as
    ``repro.models.layers._moe_local`` with the whole expert population
    local (``e_base=0``, ``E_local=E``: its ``mesh=None`` branch).

    xt: (T, D) tokens.  Returns (y (T, D), aux load-balance loss).
    """
    wts, eids, aux = _route(cfg, p, xt)
    y = _dispatch(cfg, p, xt, wts, eids, 0, cfg.num_experts,
                  capacity_factor, impl)
    return y, aux


def apply_moe(cfg: ModelConfig, p: Params, x, *, mesh=None,
              capacity_factor: float = 1.25, impl: Optional[str] = None):
    """Returns (y, aux_loss).  ``impl`` goes to ``gmm`` (None or "ref").

    With a ``mesh``, ``x`` holds this rank's tokens (its data shard) and
    the layer is the reference's shard_map:

    * ``tp_ep`` with a "model" axis: expert parallelism.  ``p``'s expert
      weights are this rank's ``E_local = E // model`` experts (their
      shard on the expert dim), model rank j owning experts ``[j *
      E_local, (j+1) * E_local)``.  Every model rank routes its tokens over
      all E experts (the router is replicated), dispatches to its own
      experts through the hand gmm kernel, and the outputs are summed over
      the model group (``lax.psum``; backward: each rank's region adds its
      part of the tokens' and weights' gradients, summed over the group).
    * ``tp`` with the expert FFN's F split over ``model``: every model
      rank routes its tokens over all E experts and dispatches them to
      every expert's F / m slice of ``wi``/``wg`` (E, D, F/m) and ``wo``
      (E, F/m, D) through the hand gmm; the partial outputs are summed
      over ``model`` (where F does not divide, the spec splits E: expert
      parallelism as ``tp_ep``).
    * no "model" axis, or one rank on it under ``tp``: the dispatch is
      local per data shard, over every expert.

    Capacity is reckoned from the local tokens, so a data-sharded run
    equals ``mesh=None`` runs on each data shard.  ``aux`` is averaged
    over the data axes (``lax.pmean``).
    """
    from repro_torch.dist import spmd
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    if mesh is None:
        y, aux = _moe_local(cfg, p, xt, capacity_factor, impl=impl)
        return y.reshape(B, S, D), aux
    E = cfg.num_experts
    mdim = spmd.model_dim(mesh)
    tp = tensor_parallel(mesh)
    split = tp.param_dim(cfg, ("moe", "wi"), (E, D, cfg.expert_ff))
    if mdim is not None and (cfg.sharding_profile == "tp_ep" or split == 0):
        mdl = int(mesh.shape[mdim])
        if E % mdl:
            raise ValueError(f"{E} experts do not split over {mdl} model "
                             "ranks")
        E_local = E // mdl
        if p["wi"].shape[0] != E_local:
            raise ValueError(f"expert weights hold {p['wi'].shape[0]} "
                             f"experts; model rank's shard is {E_local}")
        j = spmd.coordinate(mesh)[mdim]
        wts, eids, aux = _route(cfg, p, xt)
        y = _dispatch(cfg, p, spmd.copy_into(xt, mesh, [mdim]),
                      spmd.copy_into(wts, mesh, [mdim]), eids, j * E_local,
                      E_local, capacity_factor, impl)
        y = spmd.sum_across(y, mesh, [mdim])
    elif split == 2:                             # a model shard of F
        wts, eids, aux = _route(cfg, p, xt)
        y = tp.sum(_dispatch(cfg, p, tp.copy(xt), tp.copy(wts), eids, 0, E,
                             capacity_factor, impl))
    else:
        y, aux = _moe_local(cfg, p, xt, capacity_factor, impl=impl)
    aux = spmd.mean_across(aux, mesh, spmd.data_dims(mesh))
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


def _rglru_gates(p: Params, xb, xb_all, a_param):
    """Returns (a, x_eff) for h_t = a_t h_{t-1} + x_eff_t (float32).
    ``xb`` is this rank's channels, ``xb_all`` every channel (the gates'
    input; ``xb`` itself where the layer is whole), ``a_param`` this
    rank's slice."""
    xf = xb.float()
    xa = xf if xb_all is xb else xb_all.float()
    r = torch.sigmoid(dot(xa, p["wa"].float(), "wa"))
    i = torch.sigmoid(dot(xa, p["wi_g"].float(), "wi_g"))
    log_a = RGLRU_C * r * F.logsigmoid(a_param)[None]
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * xf


def _rglru_tp(cfg: ModelConfig, mesh):
    """The ``TensorParallel`` an RG-LRU layer computes under: ``ONE``
    unless the spec splits lru_width over ``model``."""
    return tensor_parallel(mesh).over(cfg, ("rec", "wx"),
                                      (cfg.d_model, cfg.lru_width_))


def apply_rglru(cfg: ModelConfig, p: Params, x, *, mesh=None, h0=None,
                conv_buf=None, return_state: bool = False,
                impl: Optional[str] = None):
    """Griffin recurrent mixer.  x: (B,S,D), a rank's local shard under
    ``mesh``.  ``impl`` goes to ``linear_scan`` (None or "ref").

    Tensor-parallel (lru_width split over ``model``): ``wx``, ``wy`` and
    ``conv_w`` column-parallel, so the rank computes its W / m channels
    (``conv_b`` and ``a_param`` sliced); the gates' ``wa`` and ``wi_g`` are
    column shards of a product over all W channels, so the conv output
    is gathered for them; ``linear_scan`` runs on the local channels and
    ``wo`` is row-parallel."""
    B = x.shape[0]
    tp = _rglru_tp(cfg, mesh)
    x = tp.copy(x)
    conv_b = tp.shard(tp.copy(p["conv_b"]))
    a_param = tp.shard(tp.copy(p["a_param"]))
    W = p["wx"].shape[-1]
    xb = dot(x, cast(cfg, p["wx"]), "wx")
    yb = F.gelu(dot(x, cast(cfg, p["wy"]), "wy"), approximate="tanh")
    if conv_buf is not None:
        raise NotImplementedError(
            "stateful RG-LRU prefill (a conv buffer carried in): the JAX "
            "package does not have it either")
    xc = causal_conv1d(xb, p["conv_w"], conv_b)
    a, x_eff = _rglru_gates(p, xc, tp.gather(xc), a_param)
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    h, h_last = linear_scan(x_eff, a, h0, impl=impl)
    out = tp.sum(dot(h.to(_dt(cfg)) * yb, cast(cfg, p["wo"]), "wo"))
    if return_state:
        # conv state: the last (cw-1) pre-conv inputs, copied out of xb
        buf = xb[:, -(cfg.ssm_conv - 1):, :].contiguous()
        return out, {"h": h_last, "conv": buf}
    return out


def rglru_decode(cfg: ModelConfig, p: Params, x, cache: Params, mesh=None):
    """x: (B,1,D).  cache: {"h": (B,W) f32, "conv": (B,cw-1,W)}, this
    rank's W / m channels when ``apply_rglru`` is tensor-parallel."""
    tp = _rglru_tp(cfg, mesh)
    conv_b, a_param = tp.shard(p["conv_b"]), tp.shard(p["a_param"])
    x1 = x[:, 0, :]
    xb1 = x1 @ cast(cfg, p["wx"])
    yb1 = F.gelu(x1 @ cast(cfg, p["wy"]), approximate="tanh")
    xc, new_buf = conv1d_step(xb1, cache["conv"], p["conv_w"], conv_b)
    xc = xc[:, None, :]
    a, x_eff = _rglru_gates(p, xc, tp.gather(xc), a_param)
    h = a[:, 0] * cache["h"] + x_eff[:, 0]
    out = tp.sum((h.to(_dt(cfg)) * yb1) @ cast(cfg, p["wo"]))
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


def _mamba_bcdt(cfg: ModelConfig, p: Params, xin, tp):
    """(dt f32, Bm, C) of the scan.  Bm and C are column slices of the
    ``x_proj`` output (not contiguous; the scan kernel reads them in place).
    ``tp``: ``xin`` is this rank's channels and ``x_proj`` its rows, so the
    product is summed over ``model`` (and rejoins the region through
    ``copy``); ``dt_proj`` is column-parallel, ``dt_bias`` sliced."""
    n, dr = cfg.ssm_state, cfg.dt_rank_
    xdbc = tp.copy(tp.sum(dot(xin, cast(cfg, p["x_proj"]), "x_proj")))
    dt_bias = tp.shard(tp.copy(p["dt_bias"]))
    dt_r, Bm, Cc = torch.split(xdbc, [dr, n, n], dim=-1)
    dt = F.softplus(dot(dt_r.float(), p["dt_proj"].float(), "dt_proj")
                    + dt_bias[None])
    return dt, Bm, Cc


def _mamba_tp(cfg: ModelConfig, mesh):
    """The ``TensorParallel`` a Mamba layer computes under: ``ONE`` unless
    the spec splits d_inner over ``model``."""
    return tensor_parallel(mesh).over(cfg, ("mamba", "conv_w"),
                                      (cfg.ssm_conv, cfg.d_inner))


def _mamba_in(cfg: ModelConfig, p: Params, x, tp):
    """(x, z) of ``in_proj``.  Tensor-parallel, ``in_proj``'s contiguous
    column shard holds x's channels on the first half of the ranks and
    z's on the rest, so this rank's d_inner / m channels of both come
    from a gather: of the product where it has no more rows than
    ``d_model`` (decode), else of the weight."""
    w = cast(cfg, p["in_proj"])
    if tp is ONE:
        return dot(x, w, "in_proj").chunk(2, dim=-1)
    di = cfg.d_inner
    n = di // tp.size
    lo = tp.rank * n
    if x.numel() // x.shape[-1] <= x.shape[-1]:
        xz = tp.gather(dot(x, w, "in_proj"), -1)
        return xz.narrow(-1, lo, n), xz.narrow(-1, di + lo, n)
    wf = tp.gather(w, -1)
    w = torch.cat([wf.narrow(-1, lo, n), wf.narrow(-1, di + lo, n)], -1)
    return dot(x, w, "in_proj").chunk(2, dim=-1)


def apply_mamba(cfg: ModelConfig, p: Params, x, *, mesh=None,
                return_state: bool = False, impl: Optional[str] = None):
    """Mamba-1 mixer.  x: (B,S,D), a rank's local shard under ``mesh``.
    ``impl`` goes to ``selective_scan`` (None or "ref").

    Tensor-parallel (d_inner split over ``model``): the rank computes its
    d_inner / m channels (``_mamba_in``, ``conv_w`` and ``dt_proj``
    column-parallel, ``A_log`` its rows, ``conv_b``, ``dt_bias`` and ``D``
    sliced), ``x_proj`` is row-parallel (``_mamba_bcdt``),
    ``selective_scan`` runs on the local channels and ``out_proj`` is
    row-parallel."""
    B = x.shape[0]
    n = cfg.ssm_state
    tp = _mamba_tp(cfg, mesh)
    x = tp.copy(x)
    conv_b, D = tp.shard(tp.copy(p["conv_b"])), tp.shard(tp.copy(p["D"]))
    di = p["conv_w"].shape[-1]
    xin, z = _mamba_in(cfg, p, x, tp)
    xc = F.silu(causal_conv1d(xin, p["conv_w"], conv_b))
    dt, Bm, Cc = _mamba_bcdt(cfg, p, xc, tp)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    y, h_last = selective_scan(xc, dt, A, Bm, Cc, D, h0, impl=impl)
    out = tp.sum((y * F.silu(z)) @ cast(cfg, p["out_proj"]))
    if return_state:
        # conv state: the last (cw-1) pre-conv inputs, copied out of xin
        buf = xin[:, -(cfg.ssm_conv - 1):, :].contiguous()
        return out, {"h": h_last, "conv": buf}
    return out


def mamba_decode(cfg: ModelConfig, p: Params, x, cache: Params, mesh=None):
    """x: (B,1,D).  cache: {"h": (B,di,n) f32, "conv": (B,cw-1,di)}, this
    rank's d_inner / m channels when ``apply_mamba`` is tensor-parallel."""
    tp = _mamba_tp(cfg, mesh)
    conv_b, D = tp.shard(p["conv_b"]), tp.shard(p["D"])
    xin, z = _mamba_in(cfg, p, x[:, 0, :], tp)
    xc, new_buf = conv1d_step(xin, cache["conv"], p["conv_w"], conv_b)
    xc = F.silu(xc)
    dt, Bm, Cc = _mamba_bcdt(cfg, p, xc, tp)
    A = -torch.exp(p["A_log"])
    y, h = selective_step(xc, dt, A, Bm, Cc, D, cache["h"])
    out = tp.sum((y * F.silu(z)) @ cast(cfg, p["out_proj"]))
    return out[:, None, :], {"h": h, "conv": new_buf}

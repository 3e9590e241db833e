"""Decoder (and encoder): parameter init, forward (prefill) and decode step.

Counterpart of ``repro.models.transformer`` for the layer kinds "global" and
"local" (attention, with a dense MLP or a mixture-of-experts FFN), "rec"
(RG-LRU, recurrentgemma) and "mamba" (Mamba-1, falcon-mamba).  Where the
JAX package scans stacked ``(G, ...)`` parameter groups with ``lax.scan``,
the port keeps one parameter dict per layer in ``params["layers"]`` (layer
``i`` has kind ``cfg.layer_kind(i)``) and loops over them in Python;
``models.convert`` maps between the two layouts.  The decode cache is
likewise a list with one dict per layer.

Encoder-decoder configs (``cfg.encoder_layers``, whisper) also hold
``params["enc"] = {"layers": [...], "final_norm": ...}``: non-causal "enc"
blocks over the frame embeddings (sinusoidal positions added when
``rope_theta == 0``), never with experts.  Their decoder attention blocks
carry ``lnx`` and ``xattn``, a cross-attention whose q comes from the
decoder and k, v from the encoder's output; a prefill given ``enc_frames``
caches those k, v as ``xk`` / ``xv`` (B, encoder_seq, KH, D), and a decode
step attends them where its layer's cache holds them.  VLM configs
(``cfg.vision_tokens``, internvl) splice ``vision_embeds`` over the first
positions of the token embeddings.

``mesh`` is threaded explicitly, as in the reference; ``None`` means one
device.  Under a mesh the tensors are a rank's local shards
(``repro_torch.dist.spmd``): the batch its data shard, every weight the
spec splits over ``model`` its ``model`` shard, on which the layers
compute tensor-parallel (``models.layers``), as the reference's GSPMD
splits each product over ``model``; the embedding lookup is
vocab-parallel (or, where the vocabulary does not divide, split on
d_model), and a prefill's cache holds this rank's part by ``cache_spec``.
``constrain_batch`` / ``constrain_logits`` stand where the reference
constrains its layout (they redistribute a DTensor and pass a local shard
through).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain_batch, constrain_logits
from repro_torch.dist.spmd import tensor_parallel
from repro_torch.models import layers as L
from repro_torch.models.remat import remat as _remat

Params = Dict[str, Any]
Cache = List[Params]

_ATTN_KINDS = ("global", "local")
_REC_KINDS = ("rec", "mamba")           # recurrent mixers with (h, conv) state


# ---------------------------------------------------------------- init

def _init_block(cfg: ModelConfig, gen: torch.Generator, kind: str, *,
                cross: bool = False, enc: bool = False) -> Params:
    """A block of ``kind``; ``cross`` gives an attention block ``lnx`` and
    ``xattn``, and an encoder block (``enc``) never takes experts."""
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
    if kind not in _ATTN_KINDS + ("enc",):
        raise ValueError(kind)
    p["attn"] = L.init_attn(cfg, gen)
    if cfg.post_norms:
        p["ln1_post"] = L.init_norm(cfg, dev)
    if cross:
        p["lnx"] = L.init_norm(cfg, dev)
        p["xattn"] = L.init_attn(cfg, gen, cross=True)
    p["ln2"] = L.init_norm(cfg, dev)
    if cfg.num_experts and not enc:
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
    D, V = cfg.d_model, cfg.vocab_size
    params: Params = {
        "embed": {"tok": L._normal(gen, (V, D), 0.02, L._pd(cfg))},
        "final_norm": L.init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._normal(gen, (D, V), 0.02, L._pd(cfg))
    cross = cfg.encoder_layers > 0
    params["layers"] = [_init_block(cfg, gen, cfg.layer_kind(i), cross=cross)
                        for i in range(cfg.num_layers)]
    if cfg.encoder_layers:
        params["enc"] = {
            "layers": [_init_block(cfg, gen, "enc", enc=True)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.init_norm(cfg, gen.device)}
    return params


# ---------------------------------------------------------------- blocks

def forward_block(cfg: ModelConfig, bp: Params, h, kind: str, *, positions,
                  seg_ids, cache_len: Optional[int], mem=None, mesh=None,
                  impl: Optional[str] = None):
    """Returns (h, aux, cache_or_None); aux is the MoE load-balance loss
    (0 without experts).  ``mem``: the encoder's output, which a block with
    ``xattn`` cross-attends (its k, v join the cache in prefill).
    ``impl`` goes to the block's kernels."""
    cache = None
    xin = L.apply_norm(cfg, bp["ln1"], h)
    if kind in _REC_KINDS:
        mixer = L.apply_rglru if kind == "rec" else L.apply_mamba
        if cache_len:
            m, cache = mixer(cfg, bp[kind], xin, mesh=mesh,
                             return_state=True, impl=impl)
        else:
            m = mixer(cfg, bp[kind], xin, mesh=mesh, impl=impl)
        return _rec_mlp(cfg, bp, h + m, mesh), 0.0, cache
    if cache_len:
        a, cache = _attn_with_cache(cfg, bp["attn"], xin, kind=kind,
                                    positions=positions, seg_ids=seg_ids,
                                    cache_len=cache_len, impl=impl,
                                    mesh=mesh)
    else:
        a = L.apply_attn(cfg, bp["attn"], xin, kind=kind, positions=positions,
                         seg_ids=seg_ids, mesh=mesh, impl=impl)
    if cfg.post_norms:
        a = L.apply_norm(cfg, bp["ln1_post"], a)
    h = h + a
    if "xattn" in bp and mem is not None:
        xin = L.apply_norm(cfg, bp["lnx"], h)
        if cache_len:
            xa, xkv = _cross_with_cache(cfg, bp["xattn"], xin, mem, impl,
                                        mesh)
            cache.update(xkv)
        else:
            xa = L.apply_attn(cfg, bp["xattn"], xin, kind="cross",
                              positions=positions, mem=mem, mesh=mesh,
                              impl=impl)
        h = h + xa
    y, aux = _ffn(cfg, bp, L.apply_norm(cfg, bp["ln2"], h), impl, mesh)
    if cfg.post_norms:
        y = L.apply_norm(cfg, bp["ln2_post"], y)
    return h + y, aux, cache


def _ffn(cfg: ModelConfig, bp: Params, x, impl: Optional[str], mesh=None):
    """The FFN half of an attention block: (y, aux), aux 0 for a dense MLP.
    Under post-norms the block's backward pass reads the MLP's output
    through its norm, so a dots remat keeps it (as the reference's)."""
    if "moe" in bp:
        return L.apply_moe(cfg, bp["moe"], x, mesh=mesh, impl=impl)
    return L.apply_mlp(cfg, bp["mlp"], x, mesh,
                       keep_out=cfg.post_norms), 0.0


def _rec_mlp(cfg: ModelConfig, bp: Params, h, mesh=None):
    """The MLP half of a Griffin residual block; Mamba blocks have none."""
    if "mlp" not in bp:
        return h
    return h + L.apply_mlp(cfg, bp["mlp"], L.apply_norm(cfg, bp["ln2"], h),
                           mesh)


def _attn_with_cache(cfg, p, x, *, kind, positions, seg_ids, cache_len,
                     impl=None, mesh=None):
    """Prefill: compute attention AND return the kv cache (roped keys);
    under ``mesh`` the cache holds this rank's part (``L.cache_part``)."""
    B, S, _ = x.shape
    out, (k, v) = L.apply_attn(cfg, p, x, kind=kind, positions=positions,
                               seg_ids=seg_ids, mesh=mesh, impl=impl,
                               return_kv=True)
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


def _cross_with_cache(cfg, p, x, mem, impl=None, mesh=None):
    """Prefill: cross-attention AND its k, v for the decode cache (this
    rank's part under ``mesh``)."""
    out, (k, v) = L.apply_attn(cfg, p, x, kind="cross", positions=None,
                               mem=mem, mesh=mesh, impl=impl,
                               return_kv=True)
    return out, {"xk": k, "xv": v}


def decode_block(cfg: ModelConfig, bp: Params, h, cache: Params, kind: str,
                 *, positions, mesh=None, impl: Optional[str] = None):
    """Single-token step.  h: (B,1,D).  Returns (h, cache).  ``impl`` goes
    to the block's kernels (the MoE FFN's ``gmm``)."""
    xin = L.apply_norm(cfg, bp["ln1"], h)
    if kind in _REC_KINDS:
        step = L.rglru_decode if kind == "rec" else L.mamba_decode
        m, cache = step(cfg, bp[kind], xin, cache, mesh)
        return _rec_mlp(cfg, bp, h + m, mesh), cache
    a, upd = L.attn_decode(cfg, bp["attn"], xin, cache, positions,
                           kind=kind, mesh=mesh)
    cache = {**cache, **upd}
    if cfg.post_norms:
        a = L.apply_norm(cfg, bp["ln1_post"], a)
    h = h + a
    if "xattn" in bp and "xk" in cache:
        xin = L.apply_norm(cfg, bp["lnx"], h)
        h = h + L.attn_decode_cross(cfg, bp["xattn"], xin, cache, mesh)
    y, _ = _ffn(cfg, bp, L.apply_norm(cfg, bp["ln2"], h), impl, mesh)
    if cfg.post_norms:
        y = L.apply_norm(cfg, bp["ln2_post"], y)
    return h + y, cache


# ---------------------------------------------------------------- embed/head

def embed_tokens(cfg: ModelConfig, params: Params, tokens, positions,
                 mesh=None):
    """The token embeddings (and sinusoidal positions).  Under ``mesh``
    with the table split over ``model``: vocab-parallel where its rows
    are split (ids outside this rank's rows give 0, summed over
    ``model``), else its d_model columns, gathered."""
    w = params["embed"]["tok"]
    tp = tensor_parallel(mesh)
    split = tp.param_dim(cfg, ("embed", "tok"), (cfg.vocab_size, cfg.d_model))
    if split == 0:
        n = w.shape[0]
        local = tokens.long() - tp.rank * n
        inside = (local >= 0) & (local < n)
        e = tp.sum(w[local.clamp(0, n - 1)]
                   * inside[..., None].to(w.dtype)).to(L._dt(cfg))
    elif split == 1:
        e = tp.whole(w[tokens], -1).to(L._dt(cfg))
    else:
        e = w[tokens].to(L._dt(cfg))
    if cfg.emb_scale:
        e = e * torch.tensor(math.sqrt(cfg.d_model), dtype=L._dt(cfg),
                             device=e.device)
    if cfg.rope_theta == 0:  # absolute sinusoidal positions
        e = e + L.sinusoidal_pos(positions, cfg.d_model).to(L._dt(cfg))
    return e


def lm_logits(cfg: ModelConfig, params: Params, h, *, mesh=None):
    """Full f32 logits (serve path).  Under ``mesh`` with the head split
    over ``model``: this rank's vocab columns gathered, or (d_model split)
    its part of the product summed."""
    tp = tensor_parallel(mesh)
    if cfg.tie_embeddings:
        wf = params["embed"]["tok"].float().T                   # (D, V)
        split = tp.param_dim(cfg, ("embed", "tok"),
                             (cfg.vocab_size, cfg.d_model))
        split = None if split is None else 1 - split
    else:
        wf = params["head"].float()
        split = tp.param_dim(cfg, ("head",), (cfg.d_model, cfg.vocab_size))
    if split == 1:                                   # vocab columns
        logits = tp.gather(h.float() @ wf, -1)
    elif split == 0:                                 # d_model rows
        logits = tp.sum(tp.shard(h.float(), -1) @ wf)
    else:
        logits = h.float() @ wf
    logits = constrain_logits(cfg, mesh, logits)
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


# ---------------------------------------------------------------- encoder

def embed_frames(cfg: ModelConfig, enc_frames):
    """The encoder's input: frame embeddings (B, S, d_model) cast to the
    compute dtype, with sinusoidal positions added when ``rope_theta ==
    0``; returns (h, positions)."""
    B, S, _ = enc_frames.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=enc_frames.device)[None].expand(B, S)
    h = enc_frames.to(L._dt(cfg))
    if cfg.rope_theta == 0:
        h = h + L.sinusoidal_pos(pos, cfg.d_model).to(L._dt(cfg))
    return h, pos


def encode(cfg: ModelConfig, params: Params, enc_frames, *, mesh=None,
           impl: Optional[str] = None, remat: bool = False,
           batch_kind: str = "train"):
    """The encoder: ``embed_frames``, non-causal "enc" blocks, then the
    encoder's final norm."""
    h, pos = embed_frames(cfg, enc_frames)
    h = constrain_batch(cfg, mesh, h, batch_kind)
    for bp in params["enc"]["layers"]:
        h = _run_block(cfg, bp, h, "enc", positions=pos, seg_ids=None,
                       mem=None, mesh=mesh, impl=impl, remat=remat)[0]
        h = constrain_batch(cfg, mesh, h, batch_kind)
    return L.apply_norm(cfg, params["enc"]["final_norm"], h)


def _run_block(cfg, bp, h, kind, *, positions, seg_ids, mem, impl, remat,
               cache_len=None, mesh=None):
    """``forward_block``, recomputed in the backward pass under ``remat``
    (every tensor it reads passed as an argument, ``mem`` too, so that the
    recompute's gradients reach the encoder); with ``cfg.remat == "dots"``
    the products the layers mark (``models.remat.dot``) are kept, not
    recomputed, as the reference's ``_remat_policy``."""
    if not remat:
        return forward_block(cfg, bp, h, kind, positions=positions,
                             seg_ids=seg_ids, cache_len=cache_len, mem=mem,
                             mesh=mesh, impl=impl)

    def block(hh, bp, positions, seg_ids, mem):
        out, a, _ = forward_block(cfg, bp, hh, kind, positions=positions,
                                  seg_ids=seg_ids, cache_len=None, mem=mem,
                                  mesh=mesh, impl=impl)
        return out, torch.as_tensor(a, dtype=torch.float32,
                                    device=out.device)
    out, a = _remat(block, h, bp, positions, seg_ids, mem,
                    policy="dots" if cfg.remat == "dots" else None)
    return out, a, None


# ---------------------------------------------------------------- forward

def forward(cfg: ModelConfig, params: Params, tokens, *, positions=None,
            seg_ids=None, vision_embeds=None, enc_frames=None,
            cache_len: Optional[int] = None, impl: Optional[str] = None,
            remat: bool = False, mesh=None, batch_kind: str = "train"):
    """Returns dict with h (B,S,D final-normed), aux (scalar), cache (or None).

    ``vision_embeds`` (B, vt, d_model) replace the first vt positions'
    embeddings (configs with ``vision_tokens``); ``enc_frames`` (B, Sm,
    d_model) run the encoder, whose output the decoder cross-attends
    (configs with ``encoder_layers``).
    ``cache_len``: when set, collect a decode cache (prefill mode); caches
    for global-attention layers are padded to this length.
    ``impl``: passed to every kernel wrapper on the path
    (``flash_attention``, ``linear_scan``, ``selective_scan``, ``gmm``):
    None (the tensors' device decides) or "ref" (the plain versions).
    ``remat``: recompute each block in the backward pass instead of keeping
    its activations (``models.remat``, which ``torch.func.vmap`` reaches),
    the encoder's blocks too: with ``cfg.remat`` "full" nothing inside a
    block is saved, with "dots" the outputs of its products with no batch
    dimensions that the backward pass reads, as the JAX package's
    policies.
    ``mesh``: the device mesh the call's tensors are local shards of (see
    the module docstring); ``batch_kind`` names the layout
    ``constrain_batch`` keeps ("train", "serve").
    """
    if remat and cache_len is not None:
        raise ValueError("remat is for training; prefill collects a cache")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    h = embed_tokens(cfg, params, tokens, positions, mesh)
    if vision_embeds is not None and cfg.vision_tokens:
        vt = vision_embeds.shape[1]
        h = torch.cat([vision_embeds.to(h.dtype), h[:, vt:]], dim=1)
    h = constrain_batch(cfg, mesh, h, batch_kind)
    mem = None
    if enc_frames is not None and cfg.encoder_layers:
        mem = encode(cfg, params, enc_frames, mesh=mesh, impl=impl,
                     remat=remat, batch_kind=batch_kind)
    cache: Cache = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, bp in enumerate(params["layers"]):
        h, a, c = _run_block(cfg, bp, h, cfg.layer_kind(i),
                             positions=positions, seg_ids=seg_ids, mem=mem,
                             impl=impl, remat=remat, cache_len=cache_len,
                             mesh=mesh)
        h = constrain_batch(cfg, mesh, h, batch_kind)
        aux = aux + a
        cache.append(c)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return {"h": h, "aux": aux,
            "cache": cache if cache_len is not None else None}


# ---------------------------------------------------------------- decode

def decode_step(cfg: ModelConfig, params: Params, cache: Cache, tokens,
                positions, impl: Optional[str] = None, *, mesh=None):
    """One token for the whole batch.  tokens: (B,1); positions: (B,)
    per-row offsets.  Returns (logits (B,1,V), cache updated in place).
    ``impl`` and ``mesh`` as in ``forward``."""
    h = embed_tokens(cfg, params, tokens, positions[:, None], mesh)
    h = constrain_batch(cfg, mesh, h, "serve")
    new_cache: Cache = []
    for i, bp in enumerate(params["layers"]):
        h, c = decode_block(cfg, bp, h, cache[i], cfg.layer_kind(i),
                            positions=positions, mesh=mesh, impl=impl)
        h = constrain_batch(cfg, mesh, h, "serve")
        new_cache.append(c)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return lm_logits(cfg, params, h, mesh=mesh), new_cache


# ---------------------------------------------------------------- cache init

def _block_cache_zeros(cfg: ModelConfig, kind: str, B: int, cache_len: int,
                       device) -> Params:
    dt = L._dt(cfg)
    KH, Dh = cfg.num_kv_heads, cfg.head_dim
    if kind in _REC_KINDS:
        W = cfg.lru_width_ if kind == "rec" else cfg.d_inner
        h = (B, W) if kind == "rec" else (B, W, cfg.ssm_state)
        return {"h": torch.zeros(h, dtype=torch.float32, device=device),
                "conv": torch.zeros((B, cfg.ssm_conv - 1, W), dtype=dt,
                                    device=device)}
    if kind not in _ATTN_KINDS:
        raise ValueError(kind)
    if kind == "local" and cfg.sliding_window:
        W = min(cfg.sliding_window, cache_len)
        c = {"k": torch.zeros((B, W, KH, Dh), dtype=dt, device=device),
             "v": torch.zeros((B, W, KH, Dh), dtype=dt, device=device),
             "pos": torch.full((W,), -1, dtype=torch.int32, device=device)}
    else:
        c = {"k": torch.zeros((B, cache_len, KH, Dh), dtype=dt,
                              device=device),
             "v": torch.zeros((B, cache_len, KH, Dh), dtype=dt,
                              device=device)}
    if cfg.encoder_layers:
        for key in ("xk", "xv"):
            c[key] = torch.zeros((B, cfg.encoder_seq, KH, Dh), dtype=dt,
                                 device=device)
    return c


def init_cache(cfg: ModelConfig, B: int, cache_len: int, device) -> Cache:
    return [_block_cache_zeros(cfg, cfg.layer_kind(i), B, cache_len, device)
            for i in range(cfg.num_layers)]

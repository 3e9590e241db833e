"""Plain PyTorch flash attention (naive materialized softmax, f32 math), and
its gradient.

Shapes (GQA layout):
  q: (B, Sq, H, D)    with H = KH * G
  k: (B, Sk, KH, D)
  v: (B, Sk, KH, D)
Returns (B, Sq, H, D) in q's dtype.

Masking: causal (q position i attends to kv position j <= i), optional
sliding window (i - j < window), optional segment ids (block-diagonal
packing), optional tanh logit softcap.  ``q_offset`` places the q block at
absolute positions offset..offset+Sq-1 against kv positions 0..Sk-1.
Fully masked rows give 0.

``attention_fwd_ref`` also returns the natural-log log-sum-exp of each
row's masked scores, f32 (B, H, Sq), -inf on fully masked rows;
``attention_bwd_ref`` recomputes P = exp(s - lse) from it and returns
(dq, dk, dv).  The kernels are held against these two.
"""
from __future__ import annotations

from typing import Optional

import torch


def _scores(q, k, *, causal, window, softcap, scale, q_offset, seg_q,
            seg_kv):
    """(s, mask, t): masked scores (B, KH, G, Sq, Sk) f32 (-inf where
    hidden), the mask, and tanh of the softcap (None without one)."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    qf = q.float().reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (qpos - kpos < window)
    mask = mask[None, None, None]
    if seg_q is not None:
        segm = seg_q[:, :, None] == seg_kv[:, None, :]   # (B, Sq, Sk)
        mask = mask & segm[:, None, None]
    return s.masked_fill(~mask, float("-inf")), mask, t


def attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: Optional[float] = None,
                      q_offset: int = 0, seg_q=None, seg_kv=None):
    """Returns (o (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32)."""
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s, _, _ = _scores(q, k, causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset, seg_q=seg_q,
                      seg_kv=seg_kv)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom.clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lse = torch.logsumexp(s, dim=-1)                      # (B, KH, G, Sq)
    return o.reshape(B, Sq, H, D).to(q.dtype), lse.reshape(B, H, Sq)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: Optional[float] = None,
                  q_offset: int = 0, seg_q=None, seg_kv=None):
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_offset=q_offset,
                             seg_q=seg_q, seg_kv=seg_kv)[0]


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      scale: Optional[float] = None, q_offset: int = 0,
                      seg_q=None, seg_kv=None):
    """(dq, dk, dv) in q's, k's and v's dtypes, given the forward's o and
    lse and the output gradient do.  P = exp(s - lse) (0 where masked),
    Delta = rowsum(do * o), dP = do . v^T, dS = P (dP - Delta) times the
    softcap's chain factor (1 - (s / softcap)^2) and the scale; dk and dv
    sum over the G q heads of each kv head.  Fully masked rows give 0."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    s, mask, t = _scores(q, k, causal=causal, window=window, softcap=softcap,
                         scale=scale, q_offset=q_offset, seg_q=seg_q,
                         seg_kv=seg_kv)
    lse5 = lse.float().reshape(B, KH, G, Sq)[..., None]
    lse5 = torch.where(torch.isfinite(lse5), lse5, torch.zeros_like(lse5))
    p = torch.where(mask, torch.exp(s - lse5), torch.zeros_like(s))
    dof = do.float().reshape(B, Sq, KH, G, D)
    delta = (dof * o.float().reshape(B, Sq, KH, G, D)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]          # (B, KH, G, Sq, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta) * scale
    if t is not None:
        ds = ds * (1.0 - t * t)
    qf = q.float().reshape(B, Sq, KH, G, D)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, Sq, H, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

"""Plain PyTorch flash attention (naive materialized softmax, f32 math).

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
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: Optional[float] = None,
                  q_offset: int = 0, seg_q=None, seg_kv=None):
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    scale = scale if scale is not None else D ** -0.5

    qf = q.float().reshape(B, Sq, KH, G, D)
    kf = k.float()
    vf = v.float()

    # scores: (B, KH, G, Sq, Sk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap

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
    s = s.masked_fill(~mask, float("-inf"))

    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom.clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Sq, H, D).to(q.dtype)

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

``attention_fwd_ref`` takes the query rows in chunks whose f32 scores
stay within ``CHUNK_BYTES`` (each row's softmax is its own, so the result
is the unchunked one's), and gives each chunk only the keys its causal
and window masks can leave live: at 32,768 positions one batch row of
gemma2-2b's 8 heads would otherwise hold 34 GB of scores.
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


# The f32 scores of one chunk of query rows in ``attention_fwd_ref`` stay
# within this many bytes (its exp and probabilities take as much again).
CHUNK_BYTES = 1 << 30


def _row_chunks(B, Sq, H, Sk, window):
    """Query-row chunks (i0, i1) of ``attention_fwd_ref``: as many rows as
    keep B * H * rows * keys f32 scores within CHUNK_BYTES, where a chunk
    of a windowed call sees at most window + rows <= 2 * window keys."""
    span = min(Sk, 2 * window) if window else Sk
    rows = max(1, CHUNK_BYTES // (4 * B * H * max(span, 1)))
    if window:
        rows = min(rows, window)
    return [(i, min(i + rows, Sq)) for i in range(0, Sq, rows)]


def _key_range(i0, i1, Sk, *, causal, window, q_offset):
    """[lo, hi): the keys that query rows i0 .. i1 - 1 may attend; the
    causal and window masks hide every key outside from each of them."""
    lo = min(Sk, max(0, q_offset + i0 - window + 1)) if window else 0
    hi = min(Sk, max(0, q_offset + i1)) if causal else Sk
    return lo, max(lo, hi)


def attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: Optional[float] = None,
                      q_offset: int = 0, seg_q=None, seg_kv=None):
    """Returns (o (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    o = torch.zeros_like(q)
    lse = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    kf, vf = k.float(), v.float()
    for i0, i1 in _row_chunks(B, Sq, H, Sk, window):
        lo, hi = _key_range(i0, i1, Sk, causal=causal, window=window,
                            q_offset=q_offset)
        if hi == lo:          # every row of the chunk fully masked
            continue
        s, _, _ = _scores(
            q[:, i0:i1], kf[:, lo:hi], causal=causal, window=window,
            softcap=softcap, scale=scale, q_offset=q_offset + i0 - lo,
            seg_q=None if seg_q is None else seg_q[:, i0:i1],
            seg_kv=None if seg_kv is None else seg_kv[:, lo:hi])
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.exp(s - m)
        denom = e.sum(dim=-1, keepdim=True)
        p = e / denom.clamp_min(1e-30)
        del e
        oc = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, lo:hi])
        del p
        o[:, i0:i1] = oc.reshape(B, i1 - i0, H, D).to(q.dtype)
        lse[:, :, i0:i1] = torch.logsumexp(s, dim=-1).reshape(B, H, i1 - i0)
    return o, lse


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

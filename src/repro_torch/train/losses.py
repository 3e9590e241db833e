"""Fused LM-head + softmax cross-entropy, chunked over the sequence, as
``repro.train.losses.chunked_softmax_xent``.

The (B, S, V) logits are never held whole: each sequence chunk's f32 logits
are computed from the final hidden states, reduced at once, and recomputed
in the backward pass (``torch.utils.checkpoint``, as the JAX package
``jax.checkpoint``s its chunk body).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig


def _head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["tok"], True      # (V, D), transpose at use
    return params["head"], False                 # (D, V)


def _chunk_nll(hc, lc, wf, transpose: bool, final_softcap: float):
    """Sum of the chunk's masked NLLs and its count of labels >= 0."""
    logits = hc.float() @ (wf.T if transpose else wf)
    if final_softcap:
        logits = torch.tanh(logits / final_softcap) * final_softcap
    lse = torch.logsumexp(logits, dim=-1)
    corr = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return torch.sum((lse - corr) * mask), torch.sum(mask)


def chunked_softmax_xent(cfg: ModelConfig, params, h, labels
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D) final-normed; labels: (B, S) (-1 = masked).
    Returns (mean nll, token count)."""
    B, S, D = h.shape
    w, transpose = _head_weight(cfg, params)
    wf = w.float()
    chunk = cfg.loss_chunk if (cfg.loss_chunk and S % cfg.loss_chunk == 0) \
        else S
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], wf, transpose,
                cfg.final_softcap)
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            nll, n = _chunk_nll(*args)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0), cnt

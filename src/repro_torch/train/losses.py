"""Fused LM-head + softmax cross-entropy, chunked over the sequence, as
``repro.train.losses.chunked_softmax_xent``.

The (B, S, V) logits are never held whole: each sequence chunk's f32 logits
are computed from the final hidden states, reduced at once, and recomputed
in the backward pass (``models.remat``, as the JAX package
``jax.checkpoint``s its chunk body).

Under a ``mesh`` the hidden states and labels are a rank's rows (its data
shard, ``dist.spmd``): the masked NLL sum and the label count are summed
over the data axes, so every rank holds the mean over the whole batch, and
each rank's gradient is its rows' part of it (``spmd.sum_across``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain_batch
from repro_torch.models.remat import remat


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


def chunked_softmax_xent(cfg: ModelConfig, params, h, labels, *, mesh=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D) final-normed; labels: (B, S) (-1 = masked).
    Returns (mean nll, token count), over every rank's rows under
    ``mesh``."""
    if mesh is not None:
        h = constrain_batch(cfg, mesh, h, "train")
        labels = constrain_batch(cfg, mesh, labels, "train")
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
            nll, n = remat(_chunk_nll, *args)
        else:
            nll, n = _chunk_nll(*args)
        tot = tot + nll
        cnt = cnt + n
    if mesh is not None:
        from repro_torch.dist import spmd
        dims = spmd.data_dims(mesh)
        tot = spmd.sum_across(tot, mesh, dims)
        cnt = spmd.all_reduce_(cnt.detach(), mesh, dims)
    return tot / torch.clamp(cnt, min=1.0), cnt

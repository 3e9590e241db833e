"""Fused LM-head + softmax cross-entropy, chunked over the sequence, as
``repro.train.losses.chunked_softmax_xent``.

The (B, S, V) logits are never held whole: each sequence chunk's f32 logits
are computed from the final hidden states, reduced at once, and recomputed
in the backward pass (``models.remat``, as the JAX package
``jax.checkpoint``s its chunk body).

Under a ``mesh`` the hidden states and labels are a rank's rows (its data
shard, ``dist.spmd``): the masked NLL sum and the label count are summed
over the data axes, so every rank holds the mean over the whole batch, and
each rank's gradient is its rows' part of it (``spmd.sum_across``).  With
the head split over ``model`` the cross-entropy is vocab-parallel, as the
JAX package's loss on its ``model``-sharded logits: each rank makes only
its vocab columns of a chunk's logits.
"""
from __future__ import annotations

from typing import Tuple

import torch
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain_batch
from repro_torch.dist.spmd import tensor_parallel
from repro_torch.models.remat import remat


def _head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["tok"], True      # (V, D), transpose at use
    return params["head"], False                 # (D, V)


def _chunk_nll(hc, lc, wf, transpose: bool, final_softcap: float, tp,
               vocab: bool):
    """Sum of the chunk's masked NLLs and its count of labels >= 0.
    ``vocab``: ``wf`` is this rank's vocab rows (or columns) and
    the cross-entropy is vocab-parallel: the row max and the sum of
    exponentials reduced over ``model``, the target's logit from the rank
    that holds it."""
    logits = hc.float() @ (wf.T if transpose else wf)
    if final_softcap:
        logits = torch.tanh(logits / final_softcap) * final_softcap
    mask = (lc >= 0).float()
    if vocab:
        n = logits.shape[-1]
        mx = tp.max(logits.amax(dim=-1, keepdim=True))
        lse = torch.log(tp.sum(torch.exp(logits - mx).sum(-1))) + mx[..., 0]
        local = lc.long() - tp.rank * n
        inside = ((local >= 0) & (local < n)).float()
        corr = tp.sum(torch.gather(logits, -1, local.clamp(0, n - 1)[
            ..., None])[..., 0] * inside)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        corr = torch.gather(logits, -1,
                            lc.clamp(min=0).long()[..., None])[..., 0]
    return torch.sum((lse - corr) * mask), torch.sum(mask)


def chunked_softmax_xent(cfg: ModelConfig, params, h, labels, *, mesh=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D) final-normed; labels: (B, S) (-1 = masked).
    Returns (mean nll, token count), over every rank's rows under
    ``mesh``; with the head's vocab split over ``model``, vocab-parallel
    (where the spec split d_model instead, on full logits, the table's
    columns joined for them)."""
    if mesh is not None:
        h = constrain_batch(cfg, mesh, h, "train")
        labels = constrain_batch(cfg, mesh, labels, "train")
    B, S, D = h.shape
    w, transpose = _head_weight(cfg, params)
    wf = w.float()
    tp = tensor_parallel(mesh)
    V = cfg.vocab_size
    split = (tp.param_dim(cfg, ("embed", "tok"), (V, D)) if transpose
             else tp.param_dim(cfg, ("head",), (D, V)))
    vocab = split == (0 if transpose else 1)
    if vocab:
        h = tp.copy(h)
    elif split is not None:      # full logits: the table's columns joined
        wf = tp.whole(wf, split)
    chunk = cfg.loss_chunk if (cfg.loss_chunk and S % cfg.loss_chunk == 0) \
        else S
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], wf, transpose,
                cfg.final_softcap, tp, vocab)
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

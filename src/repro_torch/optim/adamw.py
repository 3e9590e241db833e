"""AdamW with dtype-configurable moments, as ``repro.optim.adamw``: the same
f32 arithmetic per leaf, decay skipping 1-D leaves, ``count`` incremented
before the bias correction.  Which leaves decay can be given as a tree of
bools (``decay``): the train step passes the JAX package's choice, made
in its layer-stacked layout (``train.step.decay_mask``).

Params, grads and moments are trees of dicts and lists of tensors (the
port's parameter layout).  Unlike the JAX package, ``adamw_update`` and
``clip_by_global_norm`` update their tensors in place (the state of a
full-width model is tens of GB; a second copy would not fit beside it) and
return the same trees; the update is elementwise and runs over a large
leaf in slices, which bounds its temporaries and changes no value.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import torch

OptState = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SLICE = 1 << 26      # elements per slice of a leaf's update


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_zip(*trees) -> Iterator[tuple]:
    """The leaves of trees of one structure, matched by key and index (not
    by order: two dicts may hold their keys in different orders)."""
    first = trees[0]
    if isinstance(first, dict):
        for k in first:
            yield from tree_zip(*(t[k] for t in trees))
    elif isinstance(first, (list, tuple)):
        for i in range(len(first)):
            yield from tree_zip(*(t[i] for t in trees))
    else:
        yield trees


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def adamw_init(params, moment_dtype: str = "float32") -> OptState:
    md = _DTYPES[moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=md, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(tree_leaves(params)).device)}


@torch.no_grad()
def adamw_update(grads, opt: OptState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1,
                 decay=None):
    """One step on every leaf, in place; returns (params, opt).  ``decay``:
    a tree of bools like params (default: leaves of 2 or more dims)."""
    count = opt["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)

    def upd(g, m, v, p, decay):
        gf = g.float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / c1
        vhat = vf / c2
        step = mhat / (torch.sqrt(vhat) + eps)
        # decoupled weight decay (skip 1-D params: norms, biases, gates)
        if decay:
            step = step + wd * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(mf)
        v.copy_(vf)

    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    for p, g, m, v, d in tree_zip(params, grads, opt["m"], opt["v"], decay):
        flat = [t.reshape(-1) for t in (g, m, v, p)]
        for i in range(0, p.numel(), _SLICE):
            upd(*(t[i:i + _SLICE] for t in flat), d)
    opt["count"] = count
    return params, opt


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scales every leaf by min(1, max_norm / norm), in place; returns
    (grads, norm).  ``norm``: the global norm where the caller reckons it
    (local shards of a mesh, ``dist.spmd.global_norm``)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.copy_(g.float() * scale)
    return grads, norm

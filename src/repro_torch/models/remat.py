"""Rematerialisation that composes with ``torch.func.vmap``.

``remat(fn, *args)`` returns ``fn(*args)`` and keeps only its inputs for the
backward pass, which runs ``fn`` again under grad mode and differentiates
that (the JAX package's ``jax.checkpoint``).  It is an ``autograd.Function``
with a ``vmap`` rule, so under ``vmap`` the recompute runs under the same
transform that recorded it: the rule wraps ``fn`` in ``vmap`` with the
arguments' batch axes and applies the function to the unwrapped tensors.
(``torch.utils.checkpoint`` recomputes outside the ``vmap`` that recorded
it, on tensors that transform has released.)

``args`` may be trees of dicts, lists and tuples; their tensors are the
function's inputs, and everything else is passed through as it is.  ``fn``
must not close over tensors of a transform: pass them as arguments.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


def remat(fn, *args):
    leaves, spec = tree_flatten(args)
    is_tensor = [isinstance(v, torch.Tensor) for v in leaves]
    others = [v for v, t in zip(leaves, is_tensor) if not t]

    def flat_fn(*tensors):
        ts, os = iter(tensors), iter(others)
        full = [next(ts) if t else next(os) for t in is_tensor]
        return fn(*tree_unflatten(full, spec))
    return _Remat.apply(flat_fn, *(v for v, t in zip(leaves, is_tensor) if t))


class _Remat(torch.autograd.Function):
    """outputs = fn(*tensors), recomputed in the backward."""

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *tensors = inputs
        ctx.fn = fn
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grad_outputs):
        need = ctx.needs_input_grad[1:]
        tensors = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.fn(*tensors)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs)
                 if isinstance(o, torch.Tensor) and o.requires_grad]
        wrt = [t for t, n in zip(tensors, need) if n]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return (None, *(next(grads) if n else None for n in need))

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        vfn = torch.func.vmap(fn, in_dims=tuple(in_dims[1:]),
                              randomness=info.randomness)
        out = _Remat.apply(vfn, *tensors)
        return out, (tuple(0 for _ in out) if isinstance(out, tuple) else 0)

"""Rematerialisation that composes with ``torch.func.vmap``.

``remat(fn, *args)`` returns ``fn(*args)`` and keeps only its inputs for the
backward pass, which runs ``fn`` again under grad mode and differentiates
that (the JAX package's ``jax.checkpoint``).  It is an ``autograd.Function``
with a ``vmap`` rule, so under ``vmap`` the recompute runs under the same
transform that recorded it: the rule wraps ``fn`` in ``vmap`` with the
arguments' batch axes and applies the function to the unwrapped tensors.
(``torch.utils.checkpoint`` recomputes outside the ``vmap`` that recorded
it, on tensors that transform has released.)

``remat(fn, *args, policy="dots")`` also keeps the outputs of the products
``fn`` computes through ``dot`` (the reference's
``dots_with_no_batch_dims_saveable``: the model code marks each product
with no batch dimensions whose output the backward pass reads).  The
recompute takes each kept output in place of running its product again,
and ``_Kept`` carries its gradient to the product's input and weight.  The
kept outputs leave the function as outputs of the ``autograd.Function`` (a
``vmap`` rule unwraps them to the outer level, and the recompute is handed
them back under the same ``vmap``), so none escapes its transform.  With
no policy the same function runs with no tape: ``dot`` is the plain
product and nothing is kept.

``args`` may be trees of dicts, lists and tuples; their tensors are the
function's inputs, and everything else is passed through as it is.  ``fn``
must not close over tensors of a transform: pass them as arguments.
"""
from __future__ import annotations

import contextlib
import threading
from functools import partial

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

# The products the dots remat this thread is running keeps (``_Keep``) or
# hands back (``_Replay``); None outside one.
_TAPE = threading.local()


def remat(fn, *args, policy=None):
    if policy not in (None, "dots"):
        raise ValueError(f"remat policy {policy!r}: None or 'dots'")
    leaves, spec = tree_flatten(args)
    is_tensor = [isinstance(v, torch.Tensor) for v in leaves]
    others = [v for v, t in zip(leaves, is_tensor) if not t]

    def flat_fn(*tensors):
        ts, os = iter(tensors), iter(others)
        full = [next(ts) if t else next(os) for t in is_tensor]
        return fn(*tree_unflatten(full, spec))
    tensors = [v for v, t in zip(leaves, is_tensor) if t]
    run = _Run(flat_fn, dots=policy == "dots")
    out = _Remat.apply(run, *tensors)[:run.n_out]
    return out if run.tuple_out else out[0]


def dot(x, w, name):
    """``x @ w`` (``w`` a matrix, the parameter ``name``): a product whose
    output a dots remat keeps for the backward pass; elsewhere the plain
    product."""
    tape = getattr(_TAPE, "tape", None)
    return x @ w if tape is None else tape(x, w, name)


@contextlib.contextmanager
def _taping(tape):
    prev = getattr(_TAPE, "tape", None)
    _TAPE.tape = tape
    try:
        yield tape
    finally:
        _TAPE.tape = prev


class _Keep:
    """The forward pass: each product computed and kept, in order, with
    its weight's name."""

    def __init__(self):
        self.kept, self.names = [], []

    def __call__(self, x, w, name):
        y = x @ w
        self.kept.append(y)
        self.names.append(name)
        return y


class _Replay:
    """The recompute: each product's kept output, in the same order; a
    product of another weight or shape than the forward pass's raises."""

    def __init__(self, names, kept):
        self.todo = iter(zip(names, kept))

    def __call__(self, x, w, name):
        want, y = next(self.todo, (None, None))
        if want != name or y.shape != x.shape[:-1] + w.shape[-1:]:
            _diverged()
        return _Kept.apply(x, w, y)

    def done(self):
        if next(self.todo, None) is not None:
            _diverged()


def _diverged():
    raise RuntimeError("a dots remat's recompute took another path than "
                       "its forward pass")


class _Run:
    """``fn`` under a policy.  ``keep`` runs it and returns its outputs,
    then the products it kept (none unless ``dots``); ``replay`` runs it
    again on those products (``n_in`` tensors, then the kept ones)."""

    def __init__(self, fn, dots):
        self.fn, self.dots = fn, dots
        self.n_out = self.tuple_out = None
        self.names = ()

    def _outs(self, out):
        self.tuple_out = isinstance(out, tuple)
        return out if self.tuple_out else (out,)

    def keep(self, *tensors):
        with _taping(_Keep() if self.dots else None) as tape:
            out = self._outs(self.fn(*tensors))
        self.n_out = len(out)
        if tape is None:
            return out
        self.names = tuple(tape.names)
        return (*out, *tape.kept)

    def replay(self, n_in, *args):
        tape = _Replay(self.names, args[n_in:]) if self.dots else None
        with _taping(tape):
            out = self._outs(self.fn(*args[:n_in]))
        if tape is not None:
            tape.done()
        return out


class _VmappedRun:
    """A ``_Run`` under ``vmap``: its inputs batched along ``dims``, its
    outputs and kept products along 0."""

    def __init__(self, run, dims, randomness):
        self.run, self.dims, self.randomness = run, dims, randomness

    @property
    def n_out(self):
        return self.run.n_out

    @property
    def dots(self):
        return self.run.dots

    def keep(self, *tensors):
        return torch.func.vmap(self.run.keep, in_dims=self.dims,
                               randomness=self.randomness)(*tensors)

    def replay(self, n_in, *args):
        dims = self.dims + (0,) * (len(args) - n_in)
        return torch.func.vmap(partial(self.run.replay, n_in), in_dims=dims,
                               randomness=self.randomness)(*args)


def _grads(outs, grad_outputs, tensors, need):
    """The gradients of ``outs`` (weighted by ``grad_outputs``) to the
    ``tensors`` marked in ``need``; None for the others.  An output whose
    gradient is None (not materialised) adds nothing."""
    pairs = [(o, g) for o, g in zip(outs, grad_outputs)
             if isinstance(o, torch.Tensor) and o.requires_grad
             and g is not None]
    wrt = [t for t, n in zip(tensors, need) if n]
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], wrt, [g for _, g in pairs],
        allow_unused=True) if pairs and wrt else [None] * len(wrt))
    return tuple(next(grads) if n else None for n in need)


class _Remat(torch.autograd.Function):
    """(*outputs, *kept) = run.keep(*tensors); the backward recomputes the
    outputs from the tensors and the kept products."""

    @staticmethod
    def forward(run, *tensors):
        return run.keep(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *tensors = inputs
        ctx.run, ctx.n_out = run, run.n_out
        ctx.kept = list(output[run.n_out:])
        ctx.mark_non_differentiable(*ctx.kept)
        ctx.set_materialize_grads(False)   # no zeros for the kept products
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grad_outputs):
        # The kept products are the node's own, not saved tensors, so that
        # the recompute's graph holds each only until its last reader's
        # backward has run (as a recomputed product would be held); they go
        # with the first backward, and a node that kept none may run again.
        kept = ctx.kept
        if kept is None:
            raise RuntimeError("a dots remat's backward ran twice; its kept "
                               "products went with the first")
        if kept:
            ctx.kept = None
        need = ctx.needs_input_grad[1:]
        tensors = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.run.replay(len(tensors), *tensors, *kept)
        del kept
        return (None, *_grads(outs, grad_outputs[:ctx.n_out], tensors,
                              need))

    @staticmethod
    def vmap(info, in_dims, run, *tensors):
        vrun = _VmappedRun(run, tuple(in_dims[1:]), info.randomness)
        out = _Remat.apply(vrun, *tensors)
        return out, tuple(0 for _ in out)


class _Kept(torch.autograd.Function):
    """``x @ w`` whose output ``y`` the forward pass kept: ``y`` itself,
    with the product's gradients to ``x`` and ``w`` (as autograd's ``mm``
    backward takes them, on ``x`` folded to a matrix)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g @ w.mT
        if ctx.needs_input_grad[1]:
            gw = x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return gx, gw, None

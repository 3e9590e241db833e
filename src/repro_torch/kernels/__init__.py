"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on a CUDA
tensor (and nothing else), so a run can show that its main path went
through the kernels; "flash_attention.<variant>", "flash_attention_bwd.
<variant>" and "gmm.<variant>" count the launches of each of their
kernels besides.  Wrappers count through ``count_launch``, under a lock, so
tasks that launch from several threads at once lose no count.
``reset_launches`` sets every count to 0.

The wrappers with a gradient (flash attention and the two scans) are
``autograd.Function``s in the ``setup_context`` form with a ``vmap`` rule,
so ``torch.func.vmap`` (the fused ensemble's member axis) reaches them;
``fold_members`` and ``unfold_members`` are the rules' shared reshapes.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention.wgmma": 0,
                             "flash_attention.mma_sync": 0,
                             "flash_attention.f32": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bwd.wgmma": 0,
                             "flash_attention_bwd.mma_sync": 0,
                             "flash_attention_bwd.f32": 0, "linear_scan": 0,
                             "linear_scan_bwd": 0, "selective_scan": 0,
                             "selective_scan_bwd": 0, "gmm": 0, "gmm.wgmma": 0,
                             "gmm.mma_sync": 0, "gmm.f32": 0}


_LAUNCH_LOCK = threading.Lock()


def count_launch(*names: str) -> None:
    """Add one to the count of each of ``names``: one kernel launch."""
    with _LAUNCH_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def grad_required(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` now: grad mode is on
    and one of them requires grad.  A wrapper whose kernel has no backward
    raises on CUDA inputs for which this holds."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def transformed(*tensors) -> bool:
    """Whether one of ``tensors`` is wrapped by a ``torch.func`` transform
    (``vmap``): a kernel cannot take it, so the wrapper goes through its
    ``autograd.Function``, whose ``vmap`` rule unwraps it.  (Inside
    ``vmap`` a tensor's ``requires_grad`` reads False, so ``grad_required``
    cannot tell.)"""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def fold_members(t, in_dim, n: int):
    """A vmap rule's argument with its member axis (``in_dim``; None: not
    batched, the same for every member) folded into the batch axis:
    (n, B, ...) -> (n * B, ...).  None stays None."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def unfold_members(t, n: int):
    """(n * B, ...) -> (n, B, ...): a folded result split into members."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])

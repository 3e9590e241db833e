"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on a CUDA
tensor (and nothing else), so a run can show that its main path went
through the kernels; "flash_attention.<variant>", "flash_attention_bwd.
<variant>", "gmm.<variant>" and "gmm_bwd.<variant>" count the launches of
each of their kernels besides.  A ``gmm_bwd`` call launches two kernels,
counted once each as "gmm_bwd.dx" and "gmm_bwd.dw".  Wrappers count through ``count_launch``, under a lock, so
tasks that launch from several threads at once lose no count.
``reset_launches`` sets every count to 0.

A launcher given ``FakeTensor`` inputs (``torch._subclasses.FakeTensorMode``:
``launch.dryrun``'s route) runs its checks and makes its outputs and
workspaces, then returns before its library, any ``data_ptr()`` or
``torch.cuda`` call: it records the call in ``FAKE_CALLS`` (the keys of
``LAUNCHES``) through ``count_fake``, which also hands the kernel's
``cost()`` (FLOPs, bytes) and its launch parameters to every active cost
sink (``cost_sink``: ``roofline.op_costs.OpCounter``, ``launch.dryrun``).
``LAUNCHES`` counts real launches only.

The wrappers with a gradient (flash attention, the two scans and gmm) are
``autograd.Function``s in the ``setup_context`` form with a ``vmap`` rule,
so ``torch.func.vmap`` (the fused ensemble's member axis) reaches them;
``fold_members`` and ``unfold_members`` are the rules' shared reshapes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention.wgmma": 0,
                             "flash_attention.mma_sync": 0,
                             "flash_attention.f32": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bwd.wgmma": 0,
                             "flash_attention_bwd.mma_sync": 0,
                             "flash_attention_bwd.f32": 0, "linear_scan": 0,
                             "linear_scan_bwd": 0, "selective_scan": 0,
                             "selective_scan_bwd": 0, "gmm": 0, "gmm.wgmma": 0,
                             "gmm.mma_sync": 0, "gmm.f32": 0, "gmm_bwd": 0,
                             "gmm_bwd.dx": 0, "gmm_bwd.dw": 0,
                             "gmm_bwd.wgmma": 0, "gmm_bwd.mma_sync": 0,
                             "gmm_bwd.f32": 0}


# the calls a launcher took on fake tensors, with LAUNCHES' keys
FAKE_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LAUNCH_LOCK = threading.Lock()
# callables (kernel name, flops, bytes, launch parameters) that take each
# fake call's cost
_COST_SINKS: List[Callable[[str, float, float, dict], None]] = []


def count_launch(*names: str) -> None:
    """Add one to the count of each of ``names``: one kernel launch."""
    with _LAUNCH_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def is_fake(*tensors) -> bool:
    """Whether a launcher's inputs are fake tensors (a dry run)."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def count_fake(cost, *names: str, launch: Optional[dict] = None) -> None:
    """A launcher's call on fake tensors: add one to ``FAKE_CALLS`` of each
    of ``names`` and hand ``cost`` = (flops, bytes) and ``launch`` (the
    launch's parameters, where a sink needs them) to the active sinks
    under the first name."""
    with _LAUNCH_LOCK:
        for name in names:
            FAKE_CALLS[name] += 1
        sinks = list(_COST_SINKS)
    for sink in sinks:
        sink(names[0], *cost, launch or {})


def reset_fake_calls() -> None:
    with _LAUNCH_LOCK:
        for name in FAKE_CALLS:
            FAKE_CALLS[name] = 0


@contextlib.contextmanager
def cost_sink(fn: Callable[[str, float, float, dict], None]):
    """While the block runs, ``fn(name, flops, bytes, launch)`` takes the
    cost of every fake kernel call."""
    with _LAUNCH_LOCK:
        _COST_SINKS.append(fn)
    try:
        yield fn
    finally:
        with _LAUNCH_LOCK:
            _COST_SINKS.remove(fn)


# devices a dry run's fake tensors may stand on: the card's, or the meta
# device, which stands in for it (``launch.dryrun.FAKE_DEVICE``)
FAKE_DEVICES = ("cuda", "meta")


def check_device(fake: bool, **tensors) -> None:
    """Raise unless every tensor given (None skipped) lies on one CUDA
    device; with ``fake``, on one of ``FAKE_DEVICES``.  A CPU tensor
    always raises, and so does a DTensor: the kernels take a rank's local
    shards (``repro_torch.dist.spmd``)."""
    from torch.distributed.tensor import DTensor
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor; a kernel takes local "
                            "tensors (to_local() / spmd.gather)")
        if t.device.type != "cuda" and not (
                fake and t.device.type in FAKE_DEVICES):
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{', '.join(tensors)} must be on one device")
        dev = t.device


def aligned16(t) -> bool:
    """Whether ``t`` starts on a 16-byte boundary of its storage (the
    allocator's blocks start on one), read without ``data_ptr()``."""
    return t.storage_offset() * t.element_size() % 16 == 0


def grad_required(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` now: grad mode is on
    and one of them requires grad.  Where it holds, a wrapper goes through
    its ``autograd.Function``."""
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

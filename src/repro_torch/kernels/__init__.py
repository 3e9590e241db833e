"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on a CUDA
tensor (and nothing else), so a run can show that its main path went
through the kernels; "flash_attention.<variant>", "flash_attention_bwd.
<variant>" and "gmm.<variant>" count the launches of each of their
kernels besides.  Wrappers count through ``count_launch``, under a lock, so
tasks that launch from several threads at once lose no count.
``reset_launches`` sets every count to 0.
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
                             "selective_scan": 0, "gmm": 0, "gmm.wgmma": 0,
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

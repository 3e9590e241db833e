"""Device resolution.

The JAX package picks an implementation from the backend and environment
(``repro/flags.py``).  The port has one rule instead: its entry points run on
the CUDA device unless the caller asks for the CPU.  There is no environment
default and no capability check that silently selects the plain path; on a
CUDA tensor a kernel wrapper launches its kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this PyTorch build or machine has no "
            "GPU. Pass device='cpu' to run the plain PyTorch path.")
    return dev

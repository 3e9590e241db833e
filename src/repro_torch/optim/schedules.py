"""LR schedules: cosine (default) and WSD (warmup-stable-decay, MiniCPM), as
``repro.optim.schedules``: ``step`` is an int tensor (or int) and the rate
a float32 tensor computed in the JAX package's order of operations."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def linear_warmup(step, warmup: int):
    return torch.clamp((_step(step) + 1) / max(warmup, 1), max=1.0)


def cosine(step, *, base_lr: float, warmup: int, total_steps: int,
           min_ratio: float = 0.1):
    w = linear_warmup(step, warmup)
    t = torch.clamp((_step(step) - warmup) / max(total_steps - warmup, 1),
                    0.0, 1.0)
    c = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * w * c


def wsd(step, *, base_lr: float, warmup: int, total_steps: int,
        decay_frac: float = 0.1, min_ratio: float = 0.1):
    """Warmup-Stable-Decay [arXiv:2404.06395]: warmup, long flat stable
    phase, short (default 10%) exponential-ish decay to min_ratio."""
    step = _step(step)
    w = linear_warmup(step, warmup)
    decay_steps = max(int(total_steps * decay_frac), 1)
    decay_start = total_steps - decay_steps
    t = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
    d = torch.where(step < decay_start, torch.ones_like(t), min_ratio ** t)
    return base_lr * w * d


def make_schedule(name: str, **kw):
    if name == "cosine":
        return lambda step: cosine(step, **kw)
    if name == "wsd":
        return lambda step: wsd(step, **kw)
    if name == "constant":
        return lambda step: kw["base_lr"] * linear_warmup(step,
                                                          kw.get("warmup", 0))
    raise ValueError(name)

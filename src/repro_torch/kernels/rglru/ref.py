"""Plain PyTorch RG-LRU linear recurrence: h_t = a_t * h_{t-1} + x_t.

All per-channel (diagonal).  Shapes: x, a: (B, T, C); h0: (B, C).
Returns (y, h_last) with y[:, t] = h_t in x's dtype and h_last in h0's
dtype.  A sequential loop over T in float32, as ``repro.kernels.rglru.ref``.
"""
from __future__ import annotations

import torch


def linear_scan_ref(x, a, h0):
    xf = x.float()
    af = a.float()
    h = h0.float()
    ys = torch.empty_like(xf)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys[:, t] = h
    return ys.to(x.dtype), h.to(h0.dtype)

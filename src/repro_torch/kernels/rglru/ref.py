"""Plain PyTorch RG-LRU linear recurrence: h_t = a_t * h_{t-1} + x_t.

All per-channel (diagonal).  Shapes: x, a: (B, T, C); h0: (B, C).
Returns (y, h_last) with y[:, t] = h_t in x's dtype and h_last in h0's
dtype.  A sequential loop over T in float32, as ``repro.kernels.rglru.ref``
(float64 when an input is float64, so ``gradcheck`` can hold the
gradient).
"""
from __future__ import annotations

import torch


def acc_dtype(*tensors) -> torch.dtype:
    """float64 if any of ``tensors`` is, else float32."""
    return (torch.float64 if any(t is not None and t.dtype == torch.float64
                                 for t in tensors) else torch.float32)


def linear_scan_ref(x, a, h0):
    f = acc_dtype(x, a, h0)
    xf = x.to(f)
    af = a.to(f)
    h = h0.to(f)
    ys = torch.empty_like(xf)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys[:, t] = h
    return ys.to(x.dtype), h.to(h0.dtype)


def linear_scan_bwd_ref(x, a, h0, dy, dh_last=None):
    """Gradient of ``linear_scan_ref``: (dx, da, dh0) from the output
    gradients dy (B, T, C) and dh_last (B, C) (None: zero), by an explicit
    reverse scan in float32 (float64 for float64 inputs).  With g_T = dy_T + dh_last and
    g_t = dy_t + a_{t+1} g_{t+1}: dx_t = g_t, da_t = g_t h_{t-1} (h_0 = h0,
    the states recomputed in float32 from x, a, h0) and dh0 = a_1 g_1;
    each cast to its input's dtype."""
    f = acc_dtype(x, a, h0, dy, dh_last)
    xf, af = x.to(f), a.to(f)
    T = x.shape[1]
    hs = torch.empty_like(xf)
    h = h0.to(f)
    for t in range(T):
        h = af[:, t] * h + xf[:, t]
        hs[:, t] = h
    dyf = dy.to(f)
    carry = (torch.zeros_like(h) if dh_last is None else dh_last.to(f))
    dx, da = torch.empty_like(xf), torch.empty_like(af)
    for t in reversed(range(T)):
        g = dyf[:, t] + carry
        dx[:, t] = g
        da[:, t] = g * (hs[:, t - 1] if t else h0.to(f))
        carry = af[:, t] * g
    return dx.to(x.dtype), da.to(a.dtype), carry.to(h0.dtype)

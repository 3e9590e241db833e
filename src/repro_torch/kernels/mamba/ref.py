"""Plain PyTorch Mamba-1 selective scan (sequential; nothing beyond the
running state is materialised), as ``repro.kernels.mamba.ref``:

  h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
  y_t = C_t . h_t + D * x_t

Shapes: x, dt: (B, T, d);  A: (d, n);  Bm, C: (B, T, n);  D: (d,);
h0: (B, d, n).  Returns y: (B, T, d) in x's dtype and h_last: (B, d, n) in
h0's dtype.  All arithmetic in float32 (float64 when an input is float64,
so ``gradcheck`` can hold the gradient).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru.ref import acc_dtype


def selective_scan_ref(x, dt, A, Bm, C, D, h0):
    f = acc_dtype(x, dt, A, Bm, C, D, h0)
    xf, dtf, Af = x.to(f), dt.to(f), A.to(f)
    Bf, Cf, Df = Bm.to(f), C.to(f), D.to(f)
    h = h0.to(f)
    ys = torch.empty(x.shape, dtype=f, device=x.device)
    for t in range(x.shape[1]):
        xt, dtt = xf[:, t], dtf[:, t]                     # (B, d)
        da = torch.exp(dtt[..., None] * Af)               # (B, d, n)
        db = (dtt * xt)[..., None] * Bf[:, t, None, :]    # (B, d, n)
        h = da * h + db
        ys[:, t] = (h @ Cf[:, t, :, None])[..., 0] + Df * xt
    return ys.to(x.dtype), h.to(h0.dtype)


def selective_scan_bwd_ref(x, dt, A, Bm, C, D, h0, dy, dh_last=None):
    """Gradient of ``selective_scan_ref`` in (x, dt, A, Bm, C, D, h0) from
    the output gradients dy (B, T, d) and dh_last (B, d, n) (None: zero),
    by the explicit reverse recurrence in float32.  The states are
    recomputed from h0 and kept, (T + 1, B, d, n).  With g the gradient of
    h_t (from dh_last at T), each step t from the last: g += dy_t C_t;
    dC_t = sum_d dy_t h_t; dD += dy_t x_t; with e = exp(dt_t A),
    dA += g h_{t-1} e dt_t; ddt_t = sum_n g (h_{t-1} e A + x_t B_t);
    dx_t = dt_t sum_n g B_t + D dy_t; dB_t = sum_d g dt_t x_t; then
    g *= e, and dh0 is the last g.  Each gradient in its input's dtype
    (float64 arithmetic for float64 inputs)."""
    f = acc_dtype(x, dt, A, Bm, C, D, h0, dy, dh_last)
    xf, dtf, Af = x.to(f), dt.to(f), A.to(f)
    Bf, Cf, Df = Bm.to(f), C.to(f), D.to(f)
    dyf = dy.to(f)
    T = x.shape[1]
    hs = torch.empty((T + 1,) + tuple(h0.shape), dtype=f, device=x.device)
    hs[0] = h0.to(f)
    for t in range(T):
        da = torch.exp(dtf[:, t, :, None] * Af)
        hs[t + 1] = da * hs[t] + (dtf[:, t] * xf[:, t])[..., None] \
            * Bf[:, t, None, :]
    g = torch.zeros_like(hs[0]) if dh_last is None else dh_last.to(f)
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA, dD = torch.zeros_like(Af), torch.zeros_like(Df)
    for t in reversed(range(T)):
        dyt, xt, dtt = dyf[:, t], xf[:, t], dtf[:, t]
        bt, ct = Bf[:, t, None, :], Cf[:, t, None, :]
        g = g + dyt[..., None] * ct
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyt)
        dD += (dyt * xt).sum(0)
        e = torch.exp(dtt[..., None] * Af)
        ghe = g * hs[t] * e
        dA += (ghe * dtt[..., None]).sum(0)
        gb = (g * bt).sum(-1)
        ddt[:, t] = (ghe * Af).sum(-1) + gb * xt
        dx[:, t] = gb * dtt + dyt * Df
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtt * xt)
        g = g * e
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(C.dtype), dD.to(D.dtype),
            g.to(h0.dtype))

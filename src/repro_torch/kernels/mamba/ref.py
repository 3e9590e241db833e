"""Plain PyTorch Mamba-1 selective scan (sequential; nothing beyond the
running state is materialised), as ``repro.kernels.mamba.ref``:

  h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
  y_t = C_t . h_t + D * x_t

Shapes: x, dt: (B, T, d);  A: (d, n);  Bm, C: (B, T, n);  D: (d,);
h0: (B, d, n).  Returns y: (B, T, d) in x's dtype and h_last: (B, d, n) in
h0's dtype.  All arithmetic in float32.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x, dt, A, Bm, C, D, h0):
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf, Df = Bm.float(), C.float(), D.float()
    h = h0.float()
    ys = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[1]):
        xt, dtt = xf[:, t], dtf[:, t]                     # (B, d)
        da = torch.exp(dtt[..., None] * Af)               # (B, d, n)
        db = (dtt * xt)[..., None] * Bf[:, t, None, :]    # (B, d, n)
        h = da * h + db
        ys[:, t] = (h @ Cf[:, t, :, None])[..., 0] + Df * xt
    return ys.to(x.dtype), h.to(h0.dtype)

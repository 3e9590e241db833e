"""Plain PyTorch grouped matmul of the MoE expert FFN (capacity layout), and
its gradient.

x: (E, C, D) expert-batched tokens (rows at or past ``group_sizes[e]`` are
padding), w: (E, D, F), group_sizes: (E,).  ``gmm_ref`` returns (E, C, F)
in x's dtype: an f32 einsum with the padding rows set to exactly 0, as
``repro.kernels.moe_gmm.ref``.  ``gmm_bwd_ref`` is its vector-Jacobian
product, the one ``jax.vjp`` of that reference gives.
"""
from __future__ import annotations

import torch


def _live(x, group_sizes):
    """(E, C, 1) bool: row r of expert e holds a token (r < size)."""
    C = x.shape[1]
    return (torch.arange(C, device=x.device)[None, :]
            < group_sizes[:, None])[..., None]


def gmm_ref(x, w, group_sizes):
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return torch.where(_live(x, group_sizes), y,
                       torch.zeros((), device=y.device)).to(x.dtype)


def gmm_bwd_ref(x, w, group_sizes, dy):
    """(dx, dw) of ``gmm_ref`` at (x, w) for the output gradient dy
    (E, C, F): dy is masked to the live rows first, then in f32
    dx = mask(dy) . w^T (E, C, D), rows at or past the size exactly 0, and
    dw = x^T . mask(dy) (E, D, F), summed over live rows only; dx in x's
    dtype, dw in w's."""
    live = _live(x, group_sizes)
    zero = torch.zeros((), device=x.device)
    dym = torch.where(live, dy.float(), zero)
    dx = torch.where(live, torch.einsum("ecf,edf->ecd", dym, w.float()), zero)
    dw = torch.einsum("ecd,ecf->edf", torch.where(live, x.float(), zero), dym)
    return dx.to(x.dtype), dw.to(w.dtype)

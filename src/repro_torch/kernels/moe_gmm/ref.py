"""Plain PyTorch grouped matmul of the MoE expert FFN (capacity layout).

x: (E, C, D) expert-batched tokens (rows at or past ``group_sizes[e]`` are
padding), w: (E, D, F), group_sizes: (E,).  Returns (E, C, F) in x's dtype:
an f32 einsum with the padding rows set to exactly 0, as
``repro.kernels.moe_gmm.ref``.
"""
from __future__ import annotations

import torch


def gmm_ref(x, w, group_sizes):
    C = x.shape[1]
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    valid = torch.arange(C, device=x.device)[None, :] < group_sizes[:, None]
    return torch.where(valid[..., None], y, torch.zeros((), device=y.device)
                       ).to(x.dtype)

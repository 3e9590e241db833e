"""LM kernel plugins: the science workloads an ensemble schedules.

Only ``lm.decode`` is ported so far; it serves every ported arch
(gemma2-2b, recurrentgemma-2b, falcon-mamba-7b, qwen3-moe-30b-a3b,
serve-tiny, and the ``reduced:<arch>`` forms).  ``lm.train``, ``lm.eval`` and ``lm.checkpoint``
come with the training port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.kernel_plugin import register_kernel
from repro_torch.flags import resolve_device


def resolve_cfg(name: str):
    if name.startswith("reduced:"):
        return reduced(get_config(name.split(":", 1)[1]))
    return get_config(name)


@register_kernel("lm.decode", description="batched greedy decode")
def lm_decode(args, ctx):
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedServer, Request
    cfg = resolve_cfg(args.get("arch", "reduced:gemma2-2b"))
    device = resolve_device(args.get("device"))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    S0 = int(args.get("prompt_len", 8))
    B = int(args.get("batch", 2))
    new = int(args.get("new_tokens", 4))
    srv = BatchedServer(cfg, params, batch=B, prompt_len=S0,
                        max_len=S0 + new + 1, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, S0),
                    max_new_tokens=new)
            for i in range(int(args.get("requests", 2)))]
    srv.submit(reqs)
    done = srv.run()
    return {"served": len(done), "stats": srv.stats,
            "tokens": {r.rid: list(r.out_tokens) for r in done}}

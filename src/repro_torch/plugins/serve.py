"""Serving kernels: traffic-window source + continuous-batch decode (own
copy of ``repro.plugins.serve``).

Both kernels regenerate their window's requests from the seedable
TrafficModel carried in ``arguments["model"]`` (a dataclass dict) — no
request payloads travel through the graph.  In DES mode neither function
body runs (the task's ``sim_duration`` models it); in real mode
``serve.decode`` drives an actual ``BatchedServer`` through the port's
kernels.  ``serve.decode`` takes the JAX package's arguments plus
``device`` (default ``cuda``), as the ``lm.*`` kernels do.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.kernel_plugin import register_kernel
from repro_torch.flags import resolve_device

# real-mode decode params cache: one model per (arch, seed, device), shared
# across the many per-window decode tasks of a run.  Two windows may start
# at once on the pilot's threads, so it is filled under a lock (a race
# would build a full-width model's params twice).
_PARAMS_CACHE: Dict[Any, Any] = {}
_PARAMS_LOCK = threading.Lock()


def _serve_cfg(arch):
    from repro_torch.plugins.lm import resolve_cfg
    return resolve_cfg(arch or "serve-tiny")


def _params(cfg, seed: int, device: torch.device):
    from repro_torch.models import init_params
    key = (cfg.name, seed, device.type)
    with _PARAMS_LOCK:
        if key not in _PARAMS_CACHE:
            _PARAMS_CACHE[key] = init_params(
                cfg, torch.Generator(device=device).manual_seed(seed))
        return _PARAMS_CACHE[key]


@register_kernel("serve.source",
                 description="regenerate one traffic window's requests")
def serve_source(args, ctx):
    from repro_torch.serving.traffic import TrafficModel
    m = TrafficModel(**args["model"])
    sla = args.get("sla")
    reqs = m.requests(int(args["window"]), sla)
    return {"window": int(args["window"]), "sla": sla, "n": len(reqs),
            "prompt_tokens": sum(r.prompt_tokens for r in reqs),
            "nbytes": m.batch_nbytes(reqs)}


@register_kernel("serve.decode",
                 description="continuous-batch decode one traffic window")
def serve_decode(args, ctx):
    from repro_torch.serve import BatchedServer, Request
    from repro_torch.serving.traffic import TrafficModel

    m = TrafficModel(**args["model"])
    reqs = m.requests(int(args["window"]), args.get("sla"))
    if not reqs:
        return {"served": 0, "tokens": 0}
    cfg = _serve_cfg(args.get("arch"))
    device = resolve_device(args.get("device"))
    params = _params(cfg, int(args.get("param_seed", 0)), device)
    S0 = int(args.get("prompt_len", 8))
    max_new = max(r.max_new_tokens for r in reqs)
    srv = BatchedServer(cfg, params,
                        batch=int(args.get("decode_slots", 4)),
                        prompt_len=S0, max_len=S0 + max_new, device=device)
    srv.submit([Request(rid=r.rid,
                        prompt=np.random.default_rng(r.rid).integers(
                            0, cfg.vocab_size, S0),
                        max_new_tokens=r.max_new_tokens, sla=r.sla)
                for r in reqs])
    done = srv.run()
    return {"served": len(done),
            "tokens": sum(len(r.out_tokens) for r in done),
            "stats": srv.stats}

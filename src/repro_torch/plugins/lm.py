"""LM kernel plugins: the science workloads an ensemble schedules.

``lm.train``, ``lm.eval`` and ``lm.decode`` take the JAX package's
arguments and defaults (``repro/plugins/lm.py``) plus ``device`` (default
``cuda``, see ``flags.resolve_device``); ``lm.train`` also takes
``microbatches`` (default: the config's).  Step functions and live train
states are cached in module stores keyed by (ensemble, member), the
in-memory analogue of the paper's staged files; ``lm.decode`` serves the
member's trained params when it has a state, and seed-0 params otherwise.
They run every ported arch (gemma2-2b, recurrentgemma-2b, falcon-mamba-7b,
qwen3-moe-30b-a3b, serve-tiny, and the ``reduced:<arch>`` forms); training
the scan and MoE archs on CUDA waits for their backward kernels.
``lm.checkpoint`` is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.kernel_plugin import register_kernel
from repro_torch.data import SyntheticLM
from repro_torch.flags import resolve_device
from repro_torch.train import (
    TrainHyper,
    build_eval_step,
    build_train_step,
    make_train_state,
)

# live member states (the "staging area"); keyed by (ensemble_id, member_id)
STATE_STORE: Dict[Tuple[str, int], Any] = {}
_STEP_CACHE: Dict[Tuple, Any] = {}


def resolve_cfg(name: str):
    if name.startswith("reduced:"):
        return reduced(get_config(name.split(":", 1)[1]))
    return get_config(name)


def _steps(cfg, kind: str, hyper: TrainHyper = TrainHyper()):
    key = (cfg, kind, hyper)
    if key not in _STEP_CACHE:
        if kind == "train":
            _STEP_CACHE[key] = build_train_step(cfg, hyper=hyper)
        else:
            _STEP_CACHE[key] = build_eval_step(cfg)
    return _STEP_CACHE[key]


def _shape(args, cfg) -> ShapeSpec:
    return ShapeSpec("task", "train",
                     int(args.get("seq", 64)), int(args.get("batch", 4)))


def _sid(args) -> Tuple[str, int]:
    return (args.get("ensemble", "default"), int(args.get("member", 0)))


@register_kernel("lm.train", description="train an LM for n steps")
def lm_train(args, ctx):
    cfg = resolve_cfg(args.get("arch", "reduced:gemma2-2b"))
    if "microbatches" in args:
        cfg = cfg.replace(microbatches=int(args["microbatches"]))
    device = resolve_device(args.get("device"))
    hyper = TrainHyper(base_lr=float(args.get("lr", 3e-4)), warmup=2,
                       total_steps=int(args.get("total_steps", 1000)),
                       schedule=args.get("schedule", "cosine"))
    sid = _sid(args)
    state = STATE_STORE.get(sid)
    if state is None:
        seed = int(args.get("seed", 0)) + sid[1]
        state = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(seed))
    step = _steps(cfg, "train", hyper)
    data = SyntheticLM(cfg, _shape(args, cfg),
                       seed=int(args.get("data_seed", 0)), device=device)
    start = int(state["step"])
    m = {}
    for i in range(int(args.get("steps", 2))):
        state, m = step(state, data.batch_at(start + i))
    STATE_STORE[sid] = state
    return {"loss": float(m["loss"]) if m else float("nan"),
            "step": int(state["step"]), "member": sid[1]}


@register_kernel("lm.eval", description="eval an LM member")
def lm_eval(args, ctx):
    cfg = resolve_cfg(args.get("arch", "reduced:gemma2-2b"))
    device = resolve_device(args.get("device"))
    sid = _sid(args)
    state = STATE_STORE.get(sid)
    if state is None:
        raise RuntimeError(f"no live state for member {sid}")
    step = _steps(cfg, "eval")
    data = SyntheticLM(cfg, _shape(args, cfg),
                       seed=int(args.get("data_seed", 1)), device=device)
    out = step(state["params"], data.batch_at(int(args.get("batch_idx", 0))))
    return {"loss": float(out["loss"]), "member": sid[1]}


@register_kernel("lm.decode", description="batched greedy decode")
def lm_decode(args, ctx):
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedServer, Request
    cfg = resolve_cfg(args.get("arch", "reduced:gemma2-2b"))
    device = resolve_device(args.get("device"))
    state = STATE_STORE.get(_sid(args))
    if state is None:
        params = init_params(cfg,
                             torch.Generator(device=device).manual_seed(0))
        served = "seed 0"
    else:
        params = state["params"]
        served = f"member state at step {int(state['step'])}"
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
    return {"served": len(done), "stats": srv.stats, "params": served,
            "tokens": {r.rid: list(r.out_tokens) for r in done}}

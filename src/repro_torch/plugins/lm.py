"""LM kernel plugins: the science workloads an ensemble schedules.

``lm.train``, ``lm.eval``, ``lm.checkpoint`` and ``lm.decode`` take the
JAX package's arguments and defaults (``repro/plugins/lm.py``) plus
``device`` (default ``cuda``, see ``flags.resolve_device``; not on
``lm.checkpoint``, which writes to disk); ``lm.train`` also takes
``microbatches`` (default: the config's).  Step functions and live train
states are cached in module stores keyed by (ensemble, member), the
in-memory analogue of the paper's staged files; ``lm.train`` records each
member's config beside its state (``CONFIG_STORE``), which ``lm.checkpoint``
needs to write the JAX package's layer-stacked layout; ``lm.decode``
serves the member's trained params when it has a state, and seed-0 params
otherwise.  They run every ported arch (gemma2-2b, gemma3-4b, minicpm-2b,
nemotron-4-15b, recurrentgemma-2b, falcon-mamba-7b, qwen3-moe-30b-a3b,
grok-1-314b, whisper-large-v3, internvl2-26b, serve-tiny, and the
``reduced:<arch>`` forms) on CUDA and on the CPU; the MoE archs train
through gmm's backward kernels, and the stubbed-frontend archs on
``SyntheticLM``'s frame or vision embeddings (``lm.decode`` serves tokens
alone, as the JAX package does).

The pilot runs tasks on threads of their own, so the step cache is filled
under a lock.  A preempted ``lm.train`` attempt cannot be stopped (the
executor turns it into a zombie): it runs on and writes the member's state
while its retry trains too, as in the JAX package.  The port's train step
updates a state in place, so the tasks of one member take turns on a
per-member lock; the retry then trains from the state the zombie left,
the outcome the JAX package gives when its zombie writes first.
"""
from __future__ import annotations

import threading
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
# each member's config, keyed like STATE_STORE (filled under _STEP_LOCK)
CONFIG_STORE: Dict[Tuple[str, int], Any] = {}
_STEP_CACHE: Dict[Tuple, Any] = {}
_STEP_LOCK = threading.Lock()
_MEMBER_LOCKS: Dict[Tuple[str, int], threading.Lock] = {}


def resolve_cfg(name: str):
    if name.startswith("reduced:"):
        return reduced(get_config(name.split(":", 1)[1]))
    return get_config(name)


def _steps(cfg, kind: str, hyper: TrainHyper = TrainHyper()):
    key = (cfg, kind, hyper)
    with _STEP_LOCK:
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


def _member_lock(sid) -> threading.Lock:
    """The lock the tasks of member ``sid`` hold while they use its state."""
    with _STEP_LOCK:
        return _MEMBER_LOCKS.setdefault(sid, threading.Lock())


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
    with _member_lock(sid):
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
        with _STEP_LOCK:
            CONFIG_STORE[sid] = cfg
        return {"loss": float(m["loss"]) if m else float("nan"),
                "step": int(state["step"]), "member": sid[1]}


@register_kernel("lm.eval", description="eval an LM member")
def lm_eval(args, ctx):
    cfg = resolve_cfg(args.get("arch", "reduced:gemma2-2b"))
    device = resolve_device(args.get("device"))
    sid = _sid(args)
    with _member_lock(sid):
        state = STATE_STORE.get(sid)
        if state is None:
            raise RuntimeError(f"no live state for member {sid}")
        step = _steps(cfg, "eval")
        data = SyntheticLM(cfg, _shape(args, cfg),
                           seed=int(args.get("data_seed", 1)), device=device)
        out = step(state["params"],
                   data.batch_at(int(args.get("batch_idx", 0))))
        return {"loss": float(out["loss"]), "member": sid[1]}


@register_kernel("lm.checkpoint", description="checkpoint a member state")
def lm_checkpoint(args, ctx):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.convert import train_state_to_flat
    sid = _sid(args)
    with _member_lock(sid):
        state = STATE_STORE[sid]
        ck = Checkpointer(args["dir"], keep=int(args.get("keep", 2)))
        path = ck.save(train_state_to_flat(state, CONFIG_STORE[sid]),
                       int(state["step"]))
    return {"path": path}


@register_kernel("lm.decode", description="batched greedy decode")
def lm_decode(args, ctx):
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedServer, Request
    cfg = resolve_cfg(args.get("arch", "reduced:gemma2-2b"))
    device = resolve_device(args.get("device"))
    sid = _sid(args)
    with _member_lock(sid):
        state = STATE_STORE.get(sid)
        if state is None:
            params = init_params(
                cfg, torch.Generator(device=device).manual_seed(0))
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

"""Training entry point (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --batch 4 --seq 1024 --steps 4 [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --reduced --steps 6 --batch 4 --seq 64 --device cpu

The JAX package's CLI and printed lines, with ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path).  The schedule is the
config module's ``SCHEDULE`` (minicpm-2b: ``wsd``) unless ``--schedule``
names one; warmup is ``min(100, steps // 10 + 1)``; the config's own
``microbatches``; batches from ``SyntheticLM.batches`` (seed 0); the state
from ``make_train_state`` with seed 0, or the latest checkpoint of
``--ckpt-dir``, saved every ``--ckpt-every`` steps and at the end.

As in the reference, the state after step i is saved under label i, and a
resumed run starts at that label: it trains batch i again, its state's
step one ahead of the label, and ends one optimizer step past ``--steps``
(ROADMAP C12; kept so that the two packages stay comparable).

``--mesh prod`` trains on the production mesh (``pod16x16``, or
``pod2x16x16`` with ``--multi-pod``) over the default process group, which
the launcher of each rank initialises first (``torch.distributed.
init_process_group`` with its store, rank and world size of 256 or 512):
the state is laid out by ``state_shardings``, every rank steps on the same
global batches and takes its own rows (``build_train_step(cfg,
mesh=...)``), and a checkpoint gathers each leaf whole.
"""
from __future__ import annotations

import argparse
import importlib
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data import SyntheticLM
from repro_torch.flags import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import (
    train_state_from_numpy,
    train_state_to_flat,
)
from repro_torch.train import TrainHyper, build_train_step, make_train_state


def arch_schedule(arch: str) -> str:
    """The config module's ``SCHEDULE`` (default cosine)."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    return getattr(mod, "SCHEDULE", "cosine")


def make_hyper(steps: int, lr: float, schedule: str) -> TrainHyper:
    return TrainHyper(base_lr=lr, warmup=min(100, steps // 10 + 1),
                      total_steps=steps, schedule=schedule)


def train_loop(cfg: ModelConfig, shape: ShapeSpec, state, *, steps: int,
               hyper: TrainHyper, start: int = 0, device=None,
               ckpt: Optional[Checkpointer] = None, ckpt_every: int = 100,
               on_step: Optional[Callable[[int, dict], None]] = None,
               log: Callable[[str], None] = print, mesh=None) -> List[dict]:
    """Steps ``start`` .. ``steps - 1`` of ``build_train_step(cfg, hyper)``
    on ``state`` (updated in place) from ``SyntheticLM``'s seed-0 batches,
    with the reference's lines and checkpoints.  Returns each step's
    {"step", "loss", "lr"}; ``on_step(i, metrics)`` sees every step.
    ``mesh``: the state (plain tensors, the same on every rank) is laid
    out by ``state_shardings`` on it first."""
    step_fn = build_train_step(cfg, hyper, mesh=mesh)
    flat = (lambda st: train_state_to_flat(st, cfg))
    if mesh is not None:
        from repro_torch.dist import spmd
        from repro_torch.dist.sharding import state_shardings
        from repro_torch.optim.adamw import tree_map
        state = spmd.distribute_tree(state, state_shardings(cfg, mesh,
                                                            state))
        flat = (lambda st: train_state_to_flat(
            tree_map(lambda x: x.full_tensor(), st), cfg))
    data = SyntheticLM(cfg, shape, seed=0, device=device)
    history = []
    t0 = time.time()
    batches = data.batches(start)
    try:
        for i in range(start, steps):
            state, m = step_fn(state, next(batches))
            if on_step is not None:
                on_step(i, m)
            history.append({"step": i, "loss": float(m["loss"]),
                            "lr": float(m["lr"])})
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:5d} loss {float(m['loss']):.4f} "
                    f"lr {float(m['lr']):.2e}")
            if ckpt and i and i % ckpt_every == 0:
                ckpt.save(flat(state), i, blocking=False)
    finally:
        batches.close()
    if ckpt:
        ckpt.save(flat(state), steps)
        ckpt.wait()
    n = steps - start
    log(f"{n} steps in {time.time()-t0:.1f}s "
        f"({(time.time()-t0)/max(n,1):.2f}s/step)")
    return history


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None):
    """The CLI; returns ``train_loop``'s history.  ``on_step`` (for a
    caller in the same process) goes to ``train_loop``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", choices=("local", "prod"), default="local")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    if args.mesh == "prod":
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = ShapeSpec("cli", "train", args.seq or shape.seq_len,
                          args.batch or shape.global_batch)
    schedule = args.schedule or arch_schedule(args.arch)
    hyper = make_hyper(args.steps, args.lr, schedule)

    start = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        flat, start = ck.restore(None, device=device)
        state = train_state_from_numpy(flat, cfg, device)
        print(f"restored step {start}")
    else:
        state = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(0))
    return train_loop(cfg, shape, state, steps=args.steps, hyper=hyper,
                      start=start, device=device, ckpt=ck,
                      ckpt_every=args.ckpt_every, on_step=on_step,
                      log=lambda s: print(s, flush=True), mesh=mesh)


if __name__ == "__main__":
    main()

"""End-to-end training driver on the port: a ~100M-parameter gemma2-family
model trained for a few hundred steps on synthetic data, with
checkpointing + restart (``examples/train_100m.py``'s options and printed
lines, plus ``--device``; checkpoints in the JAX package's layout, so
either package resumes from the other's).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --quick
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLM
from repro_torch.flags import resolve_device
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_flat)
from repro_torch.train import TrainHyper, build_train_step, make_train_state


def model_100m():
    """~110M params, gemma2 family structure."""
    return get_config("gemma2-2b").replace(
        name="gemma2-100m",
        num_layers=10,
        d_model=640,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2560,
        vocab_size=50_257,
        sliding_window=256,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        microbatches=1,
        loss_chunk=256,
    )


def restore_template(cfg):
    """The checkpoint's leaves as ``make_train_state`` makes them (keys,
    shapes, dtypes), as tensors on the meta device: the state is made
    under ``FakeTensorMode``, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        flat = train_state_to_flat(
            make_train_state(cfg, torch.Generator().manual_seed(0)), cfg)
        specs = {k: (v.shape, v.dtype) for k, v in flat.items()}
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def restore(ck, cfg, device):
    """(state, step) from the newest checkpoint, held to the template."""
    template = restore_template(cfg)
    flat, start = ck.restore(template, device=device)
    for k, t in template.items():
        if flat[k].shape != t.shape:
            raise ValueError(f"checkpoint leaf {k}: {tuple(flat[k].shape)}, "
                             f"the model's {tuple(t.shape)}")
    return train_state_from_numpy(flat, cfg, device), start


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.steps, args.batch, args.seq = 10, 2, 128
    device = resolve_device(args.device)

    cfg = model_100m()
    n = cfg.param_count()
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    shape = ShapeSpec("drv", "train", args.seq, args.batch)
    hyper = TrainHyper(base_lr=6e-4, warmup=20, total_steps=args.steps,
                       schedule="cosine")
    step = build_train_step(cfg, hyper=hyper)
    ck = Checkpointer(args.ckpt_dir, keep=2)

    if ck.latest_step() is not None:
        state, start = restore(ck, cfg, device)
        print(f"restored checkpoint at step {start}")
    else:
        state, start = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(0)), 0

    data = SyntheticLM(cfg, shape, seed=0, device=device)
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    batches = data.batches(start=start)
    try:
        for i, batch in enumerate(batches):
            s = start + i
            if s >= args.steps:
                break
            state, m = step(state, batch)
            if s % 10 == 0 or s == args.steps - 1:
                loss = float(m["loss"])
                dt = time.time() - t0
                tps = tokens_per_step * (i + 1) / max(dt, 1e-9)
                print(f"step {s:4d}  loss {loss:.4f}  "
                      f"lr {float(m['lr']):.2e}  "
                      f"gnorm {float(m['grad_norm']):.3f}  tok/s {tps:,.0f}")
            if s and s % args.ckpt_every == 0:
                ck.save(train_state_to_flat(state, cfg), s, blocking=False)
    finally:
        batches.close()
    ck.save(train_state_to_flat(state, cfg), args.steps)
    ck.wait()
    print(f"done in {time.time()-t0:.1f}s; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()

"""Calibrated synthetic kernels for the scaling benchmarks (Fig. 7-10).

In sim (DES) mode the kernel supplies ``sim_duration`` and the runtime
advances a virtual clock — orchestration overheads stay real, execution time
is modeled (documented in DESIGN.md §8.5).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.kernel_plugin import register_kernel


@register_kernel("synthetic.sleep", description="busy-wait for `seconds`")
def sleep(args, ctx):
    time.sleep(float(args.get("seconds", 0.0)))
    return {"slept": float(args.get("seconds", 0.0))}


@register_kernel("synthetic.flops", description="dense matmul burner")
def flops(args, ctx):
    n = int(args.get("n", 256))
    reps = int(args.get("reps", 1))
    rng = np.random.default_rng(int(args.get("seed", 0)))
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    for _ in range(reps):
        a = np.tanh(a @ b)
    return {"checksum": float(a.sum()), "flops": 2.0 * n ** 3 * reps}


@register_kernel("synthetic.noop", description="empty task (overhead probe)")
def noop(args, ctx):
    return {}


@register_kernel("synthetic.echo",
                 description="returns `value` + any bound input ports")
def echo(args, ctx):
    """Data-flow probe: result carries the payload and whatever arrived on
    the task's input ports (ctx["inputs"], see core/flow.py)."""
    out = {"value": args.get("value")}
    inputs = ctx.get("inputs") or {}
    if inputs:
        out["inputs"] = inputs
    return out


@register_kernel("synthetic.fail", idempotent=True,
                 description="fails `fail_times` times, then succeeds")
def fail(args, ctx):
    task = ctx.get("task")
    fail_times = int(args.get("fail_times", 1))
    if task is not None and task.attempts <= fail_times:
        raise RuntimeError(f"injected failure (attempt {task.attempts})")
    return {"recovered_after": fail_times}

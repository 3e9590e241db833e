"""Where the serve time goes: profile one prefill wave and a run of decode
steps of a full-width model (bf16 params, random weights from seed 0) on
the GPU, and print one JSON line per step kind.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch gemma2-2b|recurrentgemma-2b|falcon-mamba-7b|qwen3-moe-30b-a3b]

The shape is the serve phases of ``chip_smoke.py``: batch 4, prompt 1024,
8 decode steps.  Each line holds the host wall time per call (ending in a
synchronize), the summed device time of the kernels that ran (one stream,
so kernels do not overlap), the device's idle share of the wall time, and
the device time by kernel group and by the heaviest kernel names, from
``torch.profiler``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve import build_prefill_step, build_serve_step

B, S0, DECODE_STEPS = 4, 1024, 8
_GROUPS = (("flash_attention", ("flash_attention_fwd",)),
           ("flash_attention_bwd", ("flash_attention_bwd",)),
           ("linear_scan", ("linear_scan_kernel",)),
           ("linear_scan_bwd", ("linear_scan_bwd_",)),
           ("selective_scan", ("selective_scan_kernel",)),
           ("selective_scan_bwd", ("selective_scan_bwd_",)),
           ("gmm_bwd", ("gmm_bwd_",)),
           ("gmm", ("gmm_wgmma", "gmm_tc", "gmm_cc")),
           ("matmul_f32", ("sgemm", "f32f32")),
           ("matmul", ("gemm", "gemv", "nvjet", "sm90", "cutlass", "xmma",
                       "cublas")),
           ("copy_cast", ("copy", "convert", "cast")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _profile(fn, calls: int, dev):
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / calls
    busy = sum(kernels.values())
    groups: dict = {}
    for name, ms in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms,
            "device_ms": busy if busy else "not measured",
            "idle_share": 1 - busy / wall_ms if busy else "not measured",
            "device_ms_by_group": groups,
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the GPU; CUDA is missing")
    dev = torch.device("cuda")
    cfg = get_config(args.arch).replace(param_dtype="bfloat16")
    max_len = S0 + DECODE_STEPS + 2
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S0))).to(dev)
    prefill = build_prefill_step(cfg, cache_len=max_len)
    step = build_serve_step(cfg)
    with torch.inference_mode():
        out = prefill(params, {"tokens": tokens})
        cache, last = out["cache"], out["logits"][:, 0].argmax(-1)
        pos = {"t": S0}

        def decode():
            p = torch.full((B,), pos["t"], dtype=torch.int32, device=dev)
            step(params, cache, last[:, None], p)
            pos["t"] += 1

        res = {"prefill": _profile(lambda: prefill(params,
                                                   {"tokens": tokens}), 2,
                                   dev),
               "decode_step": _profile(decode, DECODE_STEPS - 1, dev)}
    for kind, r in res.items():
        print(json.dumps({"profile": kind, "arch": cfg.name, "batch": B,
                          "prompt_len": S0, "device":
                          torch.cuda.get_device_name(dev), **r}), flush=True)


if __name__ == "__main__":
    main()

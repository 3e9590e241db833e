"""Where the serve time goes: profile one prefill wave and a run of decode
steps of a full-width model (bf16 params, random weights from seed 0) on
the GPU, and print one JSON line per step kind.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch gemma2-2b|...|grok-1-314b-L4] [--shape serve|prefill_32k|decode_32k]

``--arch`` takes a registered config or a depth cut ``<base>-L<n>``.
``--shape serve`` (the default) is the serve phases of ``chip_smoke.py``:
batch 4, prompt 1024, 8 decode steps.  ``prefill_32k`` is the reference's
cell of that name as ``chip_smoke.py``'s long phases run it: a wave of
``LONG_BATCH`` prompts of 32,768 - 9 tokens (one prefill after a warm-up
one), then 7 decode steps over its cache.  ``decode_32k``: decode steps
at position 32,767 of a 32,768-position cache filled from a 16-token
prompt (``launch.dryrun``'s form of the cell: an encoder's cross k, v
from stand-in frames of zeros), at its ``LONG_BATCH``.  Prompts are
tokens alone, as the server's.
Each line holds the host wall time per call (ending in a synchronize),
the summed device time of the kernels that ran (one stream, so kernels do
not overlap), the device's idle share of the wall time, and the device
time by kernel group and by the heaviest kernel names, from
``torch.profiler``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import SHAPES, resolve_config
from repro_torch.models import init_params
from repro_torch.serve import build_prefill_step, build_serve_step

B, S0, DECODE_STEPS = 4, 1024, 8
# The batch of each long serving cell: the largest power of two, up to the
# cell's global batch, whose launch.dryrun peak stays under 76 GB of the
# card's 80 (chip_smoke.py's long phases check the rule on their run's
# reckonings).
LONG_BATCH = {
    "prefill_32k": {"gemma2-2b": 8, "recurrentgemma-2b": 16,
                    "falcon-mamba-7b": 8, "qwen3-moe-30b-a3b": 1,
                    "gemma3-4b": 8, "minicpm-2b": 4, "nemotron-4-15b": 4,
                    "whisper-large-v3": 8, "internvl2-26b": 2,
                    "grok-1-314b-L4": 1},
    "decode_32k": {"gemma2-2b": 16, "recurrentgemma-2b": 128,
                   "falcon-mamba-7b": 128, "qwen3-moe-30b-a3b": 4,
                   "gemma3-4b": 64, "minicpm-2b": 4, "nemotron-4-15b": 8,
                   "whisper-large-v3": 8, "internvl2-26b": 4,
                   "grok-1-314b-L4": 32}}
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
    from repro_torch.launch.dryrun import PROMPT
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shape", default="serve",
                    choices=("serve", *LONG_BATCH))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the GPU; CUDA is missing")
    dev = torch.device("cuda")
    cfg = resolve_config(args.arch).replace(param_dtype="bfloat16")
    if args.shape == "serve":
        batch, prompt, max_len = B, S0, S0 + DECODE_STEPS + 2
    else:
        batch = LONG_BATCH[args.shape][args.arch]
        max_len = SHAPES[args.shape].seq_len
        prompt = (max_len - DECODE_STEPS - 1 if args.shape == "prefill_32k"
                  else PROMPT)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt))).to(dev)
    inputs = {"tokens": tokens}
    if args.shape == "decode_32k" and cfg.encoder_layers:
        inputs["enc_frames"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    prefill = build_prefill_step(cfg, cache_len=max_len)
    step = build_serve_step(cfg)
    res = {}
    with torch.inference_mode():
        held = {}

        def pre():
            held.pop("out", None)     # one cache at a time
            held["out"] = prefill(params, inputs)
        if args.shape == "decode_32k":
            pre()
        else:
            res["prefill"] = _profile(pre, 2 if args.shape == "serve" else 1,
                                      dev)
        out = held.pop("out")
        cache, last = out["cache"], out["logits"][:, 0].argmax(-1)
        del out
        first = prompt if args.shape != "decode_32k" else max_len - 1
        pos = {"t": first}

        def decode():
            p = torch.full((batch,), pos["t"], dtype=torch.int32, device=dev)
            step(params, cache, last[:, None], p)
            pos["t"] = min(pos["t"] + 1, max_len - 1)

        res["decode_step"] = _profile(decode, DECODE_STEPS - 1, dev)
    for kind, r in res.items():
        print(json.dumps({"profile": kind, "arch": cfg.name,
                          "shape": args.shape, "batch": batch,
                          "prompt_len": prompt, "cache_len": max_len,
                          "device": torch.cuda.get_device_name(dev),
                          "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                          / 1e9, **r}), flush=True)


if __name__ == "__main__":
    main()

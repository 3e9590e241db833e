#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--baseline NAME=OLD.cu ...]

Phases, one JSON line each (any failure raises and exits non-zero):
  build          compile every CUDA kernel from the sources in this checkout
                 (one nvcc per source, all started together) and report
                 each kernel's registers, spills and shared memory (ptxas;
                 the flash and gmm wgmma kernels' dynamic shared memory as
                 the library states it)
  kernel ...     hold each kernel (flash_attention, flash_attention_bwd,
                 linear_scan, selective_scan, gmm) against its plain
                 PyTorch version on the card at the main paths' shapes, and
                 time kernel, plain version, the nearest PyTorch library
                 call (where one computes the same function) and the card's
                 bound.  Flash attention's cases include packed segment ids
                 and check the forward's log-sum-exp; the backward's check
                 dq, dk, dv (relative Frobenius distance and largest
                 error, beside the plain gradient's rms; one case puts the
                 scores at the softcap) and that two calls give
                 bitwise-equal gradients, against SDPA's forward and
                 backward; the backward's reported case is the train step's
                 own (one segment of all-zero ids, as SyntheticLM gives).
                 Kernel
                 and library times are device times: the timed calls queue
                 behind a sleep kernel, so host launch overhead is not in
                 them.  Flash attention and gmm report the kernel variant
                 each case took (wgmma, mma_sync, f32; the launch counter
                 must show it, and for gmm the library's own rule must name
                 it), flash also TFLOP/s; flash, selective_scan and gmm
                 give the wrapper's host-inclusive time per call beside
                 the device time.  ``--baseline NAME=PATH`` (NAME one of
                 flash_attention, flash_attention_bwd, selective_scan,
                 gmm; repeatable) builds an earlier version of that
                 kernel's ``.cu`` (same C entry) and times it on every
                 case of its phase in the same run, with its error against
                 the plain version (flash_attention: cases without segment
                 ids, through the older entry flash_attention_fwd;
                 flash_attention_bwd: every case, through the entry
                 flash_attention_bwd; it also runs the wgmma backward at
                 more shapes than its launcher keeps plans for, and the
                 first shape again, bitwise, after its plan was evicted).
                 The selective_scan phase includes a
                 case with T * d > 2^32 (64-bit offsets in a batch row):
                 its last 256 steps must equal, bitwise, a run on them
                 alone from the state the first T - 256 steps leave
  train gemma2-2b
                 ``lm.train`` of full-width gemma2-2b (f32 master params
                 and Adam moments, bf16 compute, remat, batch 4 of 1024
                 tokens in 2 microbatches) for 3 steps, one task each, then
                 ``lm.eval`` and ``lm.decode`` of the same member: step ms,
                 tokens/s, peak memory, losses, flash launches per step
                 (every one a hand kernel); then one microbatch's loss,
                 grad norm and leaf grads against ``impl="ref"``
  serve <arch>   full-width gemma2-2b, recurrentgemma-2b, falcon-mamba-7b
                 and qwen3-moe-30b-a3b (bf16, random weights from seed 0;
                 qwen3 needs ~65 GB) through ``BatchedServer``: 8 requests,
                 batch 4, prompt 1024, 16 new tokens; asserts the loop (wave
                 or continuous) and each kernel's launches per prefill and
                 per decode step (flash attention's all through the wgmma
                 variant, gmm's through wgmma in prefill and mma_sync in
                 decode); then one prefill of the first wave with
                 ``impl="ref"`` (the plain versions): prefill logits within a
                 stated tolerance, and greedy tokens decoded from its cache
                 by ``impl="ref"`` decode steps against the served ones
  task           ``Kernel("lm.decode")`` on gemma2-2b on the card
  continuous     the continuous-batching loop on ``serve-tiny`` on the card
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when CUDA is missing or the port's package is not beside this script.
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# special-function unit: 16 results per SM and clock, 132 SMs, 1.98 GHz boost
PEAK_EXP = 16 * 132 * 1.98e9

KERNELS = {   # name: (source, the TPU kernel it replaces, its case in the line)
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention/pallas_kernel.py:100", "serve"),
    # the gradient of that kernel, which the JAX package takes by XLA
    # autodiff of its chunked path (flash_attention/xla.py:118-126); its
    # case is the train step's own problem
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/pallas_kernel.py:100",
        "gemma2_step"),
    "linear_scan": ("src/repro_torch/kernels/rglru/csrc/linear_scan.cu",
                    "src/repro/kernels/rglru/pallas_kernel.py:34", "serve"),
    "selective_scan": ("src/repro_torch/kernels/mamba/csrc/selective_scan.cu",
                       "src/repro/kernels/mamba/pallas_kernel.py:41",
                       "serve"),
    "gmm": ("src/repro_torch/kernels/moe_gmm/csrc/gmm.cu",
            "src/repro/kernels/moe_gmm/pallas_kernel.py:45", "serve"),
}

# name, B, Sq, Sk, H, KH, D, causal, window, softcap, scale, q_offset, dtype,
# tolerance, and "seg": the number of packed segments a row (sorted segment
# ids, cut at random points; absent: no segment ids).  bf16: one rounding of
# an O(1) output (3e-2, as the CPU tests); f32: summation order over up to
# 1024 keys plus tanhf/expf against torch.  Every case also holds the
# forward's log-sum-exp against attention_fwd_ref's (LSE_TOL; -inf rows
# must match).
G2 = dict(H=8, KH=4, D=256, softcap=50.0, scale=1.0 / 16)
RG = dict(H=10, KH=1, D=256, softcap=0.0, scale=1.0 / 16)   # G = 10 q heads
# softcap_saturated: gemma2's widths with scale 2, so scale . q.k has a
# standard deviation of 32 and most rows' maxima reach the cap (|tanh| of
# 0.95 and more), where an error of the kernel's tanh weighs most in p.  d64 and
# g64: the wgmma kernel's smallest head dim and largest group (64 q heads
# per kv head, rows past the window's reach fully masked).
FA_CASES = [
    dict(name="serve", B=4, Sq=1024, Sk=1024, causal=True, window=4096,
         q_offset=0, dtype="bfloat16", tol=3e-2, **G2),
    dict(name="window_lt_seq", B=1, Sq=8192, Sk=8192, causal=True,
         window=4096, q_offset=0, dtype="bfloat16", tol=3e-2, **G2),
    dict(name="q_offset", B=4, Sq=128, Sk=1024, causal=True, window=4096,
         q_offset=896, dtype="bfloat16", tol=3e-2, **G2),
    dict(name="non_causal", B=2, Sq=512, Sk=512, causal=False, window=0,
         q_offset=0, dtype="bfloat16", tol=3e-2, **G2),
    dict(name="ragged", B=2, Sq=1000, Sk=1000, causal=True, window=300,
         q_offset=0, dtype="bfloat16", tol=3e-2, **G2),
    dict(name="f32", B=2, Sq=512, Sk=512, causal=True, window=4096,
         q_offset=0, dtype="float32", tol=1e-4, **G2),
    dict(name="serve_tiny", B=2, Sq=8, Sk=8, H=2, KH=1, D=16, causal=True,
         window=0, softcap=0.0, scale=None, q_offset=0, dtype="bfloat16",
         tol=3e-2),
    dict(name="recurrentgemma_serve", B=4, Sq=1024, Sk=1024, causal=True,
         window=2048, q_offset=0, dtype="bfloat16", tol=3e-2, **RG),
    dict(name="recurrentgemma_window", B=1, Sq=4096, Sk=4096, causal=True,
         window=2048, q_offset=0, dtype="bfloat16", tol=3e-2, **RG),
    dict(name="qwen3_serve", B=4, Sq=1024, Sk=1024, H=32, KH=4, D=128,
         causal=True, window=0, softcap=0.0, scale=128 ** -0.5, q_offset=0,
         dtype="bfloat16", tol=3e-2),
    dict(name="softcap_saturated", B=2, Sq=512, Sk=512, causal=True,
         window=4096, q_offset=0, dtype="bfloat16", tol=3e-2,
         **{**G2, "scale": 2.0}),
    dict(name="d64_ragged", B=2, Sq=300, Sk=333, H=6, KH=2, D=64,
         causal=True, window=0, softcap=0.0, scale=None, q_offset=33,
         dtype="bfloat16", tol=3e-2),
    dict(name="g64", B=3, Sq=200, Sk=77, H=64, KH=1, D=128, causal=True,
         window=50, softcap=0.0, scale=None, q_offset=0, dtype="bfloat16",
         tol=3e-2),
    dict(name="seg_gemma2_train", B=2, Sq=1024, Sk=1024, causal=True,
         window=4096, q_offset=0, dtype="bfloat16", tol=3e-2, seg=4, **G2),
    dict(name="seg_qwen3", B=2, Sq=1024, Sk=1024, H=32, KH=4, D=128,
         causal=True, window=0, softcap=0.0, scale=128 ** -0.5, q_offset=0,
         dtype="bfloat16", tol=3e-2, seg=3),
    dict(name="seg_d64", B=2, Sq=300, Sk=300, H=6, KH=2, D=64, causal=True,
         window=100, softcap=30.0, scale=None, q_offset=0, dtype="bfloat16",
         tol=3e-2, seg=4),
    dict(name="seg_f32", B=2, Sq=512, Sk=512, causal=True, window=4096,
         q_offset=0, dtype="float32", tol=1e-4, seg=3, **G2),
]
# lse: both sides form f32 scores of the same inputs; they differ by the
# order of the dot's sums (~1e-6 relative of |s| <= 50) and the kernel's
# tanh (1e-6 of the softcap, 5e-5) and ex2 (2^-22 relative).
LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-4}

# Backward cases: the train step's own problem (gemma2_step: one segment,
# all-zero ids, as SyntheticLM gives them), the train shapes of the three
# attention models with packed segment ids, gemma2's widths with scale 2 so
# that most scores sit near the softcap (where 1 - t^2, the softcap's chain
# factor, is far from 1: the other cases' |s| of ~1 against a cap of 50
# leave it within 0.1%), recurrentgemma's local window shorter than the
# sequence, and the small head dims.
FA_BWD_CASES = [
    dict(name="gemma2_step", B=2, Sq=1024, Sk=1024, causal=True,
         window=4096, q_offset=0, dtype="bfloat16", seg=1, **G2),
    dict(name="gemma2_train", B=2, Sq=1024, Sk=1024, causal=True,
         window=4096, q_offset=0, dtype="bfloat16", seg=4, **G2),
    dict(name="softcap_saturated", B=2, Sq=512, Sk=512, causal=True,
         window=4096, q_offset=0, dtype="bfloat16", seg=3,
         **{**G2, "scale": 2.0}),
    dict(name="recurrentgemma_train", B=2, Sq=1024, Sk=1024, causal=True,
         window=2048, q_offset=0, dtype="bfloat16", seg=3, **RG),
    dict(name="qwen3_train", B=2, Sq=1024, Sk=1024, H=32, KH=4, D=128,
         causal=True, window=0, softcap=0.0, scale=128 ** -0.5, q_offset=0,
         dtype="bfloat16", seg=3),
    dict(name="window_lt_seq", B=1, Sq=2048, Sk=2048, causal=True,
         window=512, q_offset=0, dtype="bfloat16", seg=2, **RG),
    dict(name="d64_ragged", B=2, Sq=300, Sk=333, H=6, KH=2, D=64,
         causal=True, window=0, softcap=0.0, scale=None, q_offset=33,
         dtype="bfloat16", seg=0),
    dict(name="d32_window", B=2, Sq=200, Sk=200, H=4, KH=2, D=32,
         causal=True, window=50, softcap=30.0, scale=None, q_offset=0,
         dtype="bfloat16", seg=3),
    dict(name="d16_non_causal", B=2, Sq=100, Sk=100, H=4, KH=2, D=16,
         causal=False, window=0, softcap=0.0, scale=None, q_offset=0,
         dtype="bfloat16", seg=3),
    dict(name="f32", B=2, Sq=256, Sk=256, causal=True, window=100,
         q_offset=0, dtype="float32", seg=3, **G2),
]
# Backward tolerances, (relative, largest) for each of dq, dk, dv against
# attention_bwd_ref: the relative Frobenius distance |a - r| / |r| and the
# largest error over the largest gradient, max |a - r| / max |r|.  Most
# elements of a gradient are far below its largest (the first rows of a
# segment, where P is concentrated), so the relative distance holds the
# bulk and the second bound holds single elements.  bf16: the kernel rounds
# P and dS to bf16 for their products and its outputs to bf16, the plain
# version neither; the outputs' rounding alone is ~2^-9 of each element, so
# 1e-2, and two bf16 steps of the largest gradient, 2^-6.  f32: summation
# order over up to 64 heads x 1024 positions, 1e-4 for both (the f32 case's
# softcap factor differs from 1 by ~4e-4, so it holds that factor too).
BWD_TOL = {"bfloat16": (1e-2, 2.0 ** -6), "float32": (1e-4, 1e-4)}


def grad_check(a, r, dtype: str) -> dict:
    """Gradient ``a`` against its plain version ``r`` under BWD_TOL[dtype]:
    the measures, the bounds, r's rms and max, and ok."""
    import torch
    a, r = a.double(), r.double()
    diff = a - r
    r_norm, r_max = float(r.norm()), float(r.abs().max())
    rel = float(diff.norm()) / r_norm if r_norm else float(diff.norm())
    rel_tol, max_tol = BWD_TOL[dtype]
    max_err = float(diff.abs().max())
    return {"rel_err": rel, "rel_tol": rel_tol, "max_abs_err": max_err,
            "max_abs_tol": max_tol * r_max,
            "ref_rms": r_norm / r.numel() ** 0.5, "ref_max": r_max,
            "ok": bool(torch.isfinite(a).all()) and rel <= rel_tol
            and max_err <= max_tol * r_max}


# Scan cases.  Tolerances: a float32 output at 1e-4 (the serial chain is the
# same; FMA contraction and the order of C . h differ); a bf16 output at one
# bf16 step of its largest value, 2**-7 * max(1, max |ref|), since kernel and
# plain version round f32 values that agree to ~1e-6 and may land on the two
# sides of a rounding boundary.
LS_CASES = [   # the serve shape of recurrentgemma-2b: x_eff and a in f32
    dict(name="serve", B=4, T=1024, C=2560, dtype="float32"),
    dict(name="ragged", B=2, T=1000, C=1000, dtype="float32"),
    dict(name="single_step", B=4, T=1, C=2560, dtype="float32"),
    dict(name="bf16", B=4, T=1024, C=2560, dtype="bfloat16"),
]
SS_CASES = [   # the serve shape of falcon-mamba-7b: x, Bm, C bf16, Bm and C
               # column slices of one (B, T, dt_rank + 2n) x_proj output
    dict(name="serve", B=4, T=1024, d=8192, n=16, dtype="bfloat16"),
    dict(name="ragged", B=2, T=1000, d=1000, n=12, dtype="bfloat16"),
    dict(name="single_step", B=4, T=1, d=8192, n=16, dtype="bfloat16"),
    dict(name="f32", B=2, T=512, d=1024, n=16, dtype="float32"),
]
DT_RANK = 256
# A batch row past 2^32 elements (falcon-mamba's d, T = 2^32 / d + 256:
# 8.6 GB of x and of y, 17.2 GB of dt): the kernel's 64-bit row offsets,
# where 32-bit unsigned ones would wrap for the last 256 steps
SS_LONG = dict(name="long_row", B=1, T=2 ** 32 // 8192 + 256, d=8192, n=16,
               dtype="bfloat16", tail=256)

# Grouped-matmul cases, x (E, C, D) @ w (E, D, F) with per-expert sizes.
# "route": (T, k), the sizes of T tokens each sent to k distinct experts
# drawn at random, as a random-weight router sends them, clipped to C; the
# serve shapes are qwen3-moe-30b-a3b's: prefill (B=4, prompt 1024: T=4096,
# C=384) for wi/wg and wo, and a decode step (T=4, C=8, ~28 live experts).
# x ~ N(0, 1), w ~ 0.02 N(0, 1) as the model's weights.  Tolerances: bf16
# one bf16 step of the largest output (kernel and plain version round f32
# sums that agree to ~1e-6); f32 1e-4 (summation order).  Padding rows must
# be exactly 0.
GMM_CASES = [
    dict(name="serve", E=128, C=384, D=2048, F=768, route=(4096, 8),
         dtype="bfloat16"),
    dict(name="wo", E=128, C=384, D=768, F=2048, route=(4096, 8),
         dtype="bfloat16"),
    dict(name="decode", E=128, C=8, D=2048, F=768, route=(4, 8),
         dtype="bfloat16"),
    dict(name="ragged", E=5, C=100, D=200, F=300, sizes=[0, 100, 37, 64, 1],
         dtype="bfloat16"),
    dict(name="ragged_aligned", E=6, C=200, D=136, F=264,
         sizes=[200, 0, 129, 64, 1, 63], dtype="bfloat16"),
    dict(name="empty", E=128, C=384, D=2048, F=768, sizes=[0] * 128,
         dtype="bfloat16"),
    dict(name="f32", E=8, C=256, D=512, F=384, route=(512, 2),
         dtype="float32"),
]

# serve phases: arch, the loop it must run, kernel launches per prefill and
# per decode step ("flash_attention.wgmma": the launches of flash attention's
# wgmma kernel, which must be all of them; "gmm.wgmma" / "gmm.mma_sync":
# gmm's launches through its prefill and decode kernels)
SERVE = [
    ("gemma2-2b", "wave",
     {"flash_attention": 26, "flash_attention.wgmma": 26}, {}),
    ("recurrentgemma-2b", "wave",
     {"linear_scan": 18, "flash_attention": 8, "flash_attention.wgmma": 8},
     {}),
    ("falcon-mamba-7b", "continuous", {"selective_scan": 64}, {}),
    ("qwen3-moe-30b-a3b", "continuous",
     {"flash_attention": 48, "flash_attention.wgmma": 48, "gmm": 144,
      "gmm.wgmma": 144},
     {"gmm": 144, "gmm.mma_sync": 144}),
]
# Prefill logits, kernels against plain versions, bf16 through every layer:
# the two round their outputs to bf16 at different elements, and the
# residual stream carries that on (measured 0.05 to 0.11 on the three models).
LOGIT_TOL = 0.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` over ``iters`` calls, by CUDA events, host
    launch gaps included (model calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (kernels): the calls
    are queued behind ~20 ms of a sleep kernel, so the card runs them back
    to back however slowly the host launches them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        kernel_bwd_smem_bytes,
        kernel_smem_bytes,
    )
    from repro_torch.kernels.moe_gmm.ops import kernel_smem_bytes as gmm_smem
    t0 = time.perf_counter()
    info = _build.build()
    # dynamic shared memory per block (ptxas reports only static memory)
    smem = {f"flash_attention_fwd_wgmma<{D}>":
            kernel_smem_bytes(torch.bfloat16, D) for D in (64, 128, 256)}
    smem.update({f"flash_attention_bwd_wgmma<{D}>": kernel_bwd_smem_bytes(D)
                 for D in (64, 128, 256)})
    smem["gmm_wgmma"] = gmm_smem()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                        for k, v in info.items()},
          "ptxas": {k: ptxas_report(v["ptxas"]) for k, v in info.items()},
          "dynamic_smem_bytes": smem})


def ptxas_report(log: str) -> dict:
    """Registers and spills per kernel instantiation from ``-Xptxas=-v``."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"(flash_attention_fwd_(?:wgmma|tc|cc)|"
                          r"flash_attention_bwd_(?:dkdv_tc|dq_tc|dkdv_cc|"
                          r"dq_cc|delta|wgmma)|"
                          r"linear_scan_kernel|selective_scan_kernel|gmm_tc)"
                          r"I(?:Li)?(.+?)EE+v", entry[1])
            plain = [k for k in ("gmm_cc", "gmm_wgmma",
                                 "flash_attention_bwd_reduce")
                     if k in entry[1]]
            args = re.sub(r"ELb([01])", r",\1", m[2]) if m else ""
            name = (f"{m[1]}<{args}>" if m else
                    plain[0] if plain else entry[1])
        elif name and ("registers" in line or "spill" in line
                       or "smem" in line or "Performance Loss" in line):
            out[name] = (out.get(name, "") + " " +
                         line.split(":", 1)[-1].strip()).strip()
    return out


def _mask(c, device, seg_q=None, seg_kv=None):
    """The case's (Sq, Sk) mask, or (B, 1, Sq, Sk) with segment ids."""
    import torch
    qpos = c["q_offset"] + torch.arange(c["Sq"], device=device)[:, None]
    kpos = torch.arange(c["Sk"], device=device)[None, :]
    m = torch.ones((c["Sq"], c["Sk"]), dtype=torch.bool, device=device)
    if c["causal"]:
        m &= kpos <= qpos
    if c["window"]:
        m &= qpos - kpos < c["window"]
    if seg_q is not None:
        m = m & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return m


def _segments(B, S, n, gen, device):
    """(B, S) int32 sorted segment ids, n segments a row cut at random
    points (None for n = 0)."""
    import torch
    if not n:
        return None
    cuts = torch.sort(torch.randint(1, S, (B, n - 1), generator=gen,
                                    device=device), 1).values
    pos = torch.arange(S, device=device)[None, :, None]
    return (pos >= cuts[:, None, :]).sum(-1).to(torch.int32).contiguous()


# --baseline NAME: (library name, module of the wrapper, its CUDA entry);
# flash attention's older forward sources are called through the C entry
# that every one has, flash_attention_fwd (no segment ids, no lse)
BASELINES = {
    "flash_attention": ("flash_attention_fwd", None, None),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "repro_torch.kernels.flash_attention.ops",
                            "flash_attention_bwd_cuda"),
    "selective_scan": ("selective_scan", "repro_torch.kernels.mamba.ops",
                       "selective_scan_cuda"),
    "gmm": ("gmm", "repro_torch.kernels.moe_gmm.ops", "gmm_cuda"),
}


def _baseline(name, path):
    """A CUDA entry for kernel ``name`` on an earlier ``.cu`` (same C
    interface), built here with the repo's nvcc flags; None without a
    path."""
    if path is None:
        return None
    import ctypes
    import importlib

    from repro_torch.kernels import _build
    libname, module, entry = BASELINES[name]
    out = _build.BUILD_DIR / f"lib{libname}_baseline-{time.time_ns()}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    if name == "flash_attention":
        return _flash_baseline(lib)
    mine = _build.load(libname)
    fn = getattr(importlib.import_module(module), entry)

    def run(*args, **kw):
        _build._LOADED[libname] = lib
        try:
            return fn(*args, **kw)
        finally:
            _build._LOADED[libname] = mine
    return run


def _flash_baseline(lib):
    """o = attention(q, k, v) through an older flash library's C entry
    flash_attention_fwd(q, k, v, o, <ops.SCALARS>)."""
    import ctypes

    import torch

    from repro_torch.kernels.flash_attention.ops import _DTYPES, SCALARS
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + SCALARS
    fn.restype = ctypes.c_int

    def run(q, k, v, *, causal, window, softcap, scale, q_offset, **_):
        B, Sq, H, D = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPES[q.dtype], B, Sq, k.shape[1], H, k.shape[2], D,
                 int(causal), window, softcap,
                 scale if scale is not None else D ** -0.5, q_offset,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline flash_attention_fwd failed ({err})")
        return o
    return run


def phase_kernel_flash_attention(dev, baseline=None):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_cuda,
        variant,
    )
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    old = _baseline("flash_attention", baseline)
    results = {}
    for c in FA_CASES:
        dt = getattr(torch, c["dtype"])
        B, Sq, Sk, H, KH, D = (c[k] for k in ("B", "Sq", "Sk", "H", "KH", "D"))
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Sk, KH, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Sk, KH, D), generator=gen, device=dev).to(dt)
        seg_q = _segments(B, Sq, c.get("seg", 0), gen, dev)
        seg_kv = seg_q if Sk == Sq else _segments(B, Sk, c.get("seg", 0),
                                                  gen, dev)
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"], scale=c["scale"],
                  q_offset=c["q_offset"], seg_q=seg_q, seg_kv=seg_kv)
        kind = variant(dt, D)
        counter = f"flash_attention.{kind}"
        before = LAUNCHES[counter]
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if LAUNCHES[counter] != before + 1:
            raise AssertionError(f"flash_attention case {c['name']} did not "
                                 f"launch the {kind} kernel")
        ref, lse_ref = attention_fwd_ref(q, k, v, **kw)
        err = float((out.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(out.float()).all())
        out_l, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        live = torch.isfinite(lse_ref)
        lse_err = (float((lse[live] - lse_ref[live]).abs().max())
                   if live.any() else 0.0)
        lse_inf_match = bool(torch.equal(torch.isfinite(lse), live))
        out_l_same = bool(torch.equal(out_l, out))
        old_c = old if seg_q is None else None   # an older C interface
        baseline_err = (float((old_c(q, k, v, **kw).float() - ref.float())
                              .abs().max()) if old_c else None)
        del ref, lse_ref, out_l, lse
        big = Sq * Sk > 4_000_000
        ms = device_ms(lambda: flash_attention(q, k, v, **kw), 3 if big else 10)
        host_ms = time_ms(lambda: flash_attention(q, k, v, **kw),
                          3 if big else 10)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), 2 if big else 5)
        baseline_ms = (device_ms(lambda: old_c(q, k, v, **kw),
                                 3 if big else 10) if old_c else None)

        # yardstick: one SDPA call, same q/k/v and masks, without softcap
        mask = _mask(c, dev, seg_q, seg_kv)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KH, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KH, dim=2).transpose(1, 2).contiguous()
        plain_causal = (c["causal"] and c["q_offset"] == 0 and Sq == Sk
                        and (not c["window"] or c["window"] >= Sk)
                        and seg_q is None)
        if plain_causal:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=c["scale"])
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=c["scale"])
        library_ms = device_ms(lib, 3 if big else 10)

        pairs = int(mask.sum()) * (1 if seg_q is not None else B)
        flops = 4 * D * pairs * H
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        if seg_q is not None:
            nbytes += 4 * (seg_q.numel() + seg_kv.numel())
        t_ops = flops / PEAK_FLOPS[c["dtype"]]
        t_bytes = nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        ok = (finite and err <= c["tol"] and lse_inf_match and out_l_same
              and lse_err <= LSE_TOL[c["dtype"]])
        row = {"phase": "kernel flash_attention", "case": c["name"],
               "shape": {n: c[n] for n in ("B", "Sq", "Sk", "H", "KH", "D")},
               "causal": c["causal"], "window": c["window"],
               "softcap": c["softcap"], "q_offset": c["q_offset"],
               "scale": c["scale"], "dtype": c["dtype"], "variant": kind,
               "segments": c.get("seg", 0),
               "max_abs_err": err, "tol": c["tol"], "lse_max_abs_err": lse_err,
               "lse_tol": LSE_TOL[c["dtype"]],
               "lse_inf_rows_match": lse_inf_match,
               "o_with_lse_equal": out_l_same, "ok": ok, "ms": ms,
               "host_ms": host_ms, "tflops": flops / ms / 1e9,
               "baseline_ms": baseline_ms,
               "baseline_max_abs_err": baseline_err, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "scaled_dot_product_attention, no softcap"
                          + (", segment mask as attn_mask" if seg_q is not None
                             else ""),
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "f32_matmul_precision": torch.get_float32_matmul_precision(),
               "tf32": torch.backends.cuda.matmul.allow_tf32}
        emit(row)
        if not ok:
            raise AssertionError(f"flash_attention case {c['name']}: "
                                 f"max error {err} (tol {c['tol']}), lse "
                                 f"error {lse_err}, -inf rows match "
                                 f"{lse_inf_match}, o with lse equal "
                                 f"{out_l_same}, finite={finite}")
        results[c["name"]] = row
        del q, k, v, out, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return results


def phase_kernel_flash_attention_bwd(dev, baseline=None):
    """dq, dk, dv of the backward kernels against attention_bwd_ref on the
    same q, k, v, do and the forward kernel's o and lse; bitwise equality
    of two calls; device time against the bound and against SDPA's forward
    and backward (causal, no softcap, no segments) at the same shape; an
    older source's time and checks where ``baseline`` names one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention.ops import (
        bwd_variant,
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    old = _baseline("flash_attention_bwd", baseline)
    results = {}
    for c in FA_BWD_CASES:
        dt = getattr(torch, c["dtype"])
        B, Sq, Sk, H, KH, D = (c[k] for k in ("B", "Sq", "Sk", "H", "KH", "D"))
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Sk, KH, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Sk, KH, D), generator=gen, device=dev).to(dt)
        do = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        seg_q = _segments(B, Sq, c["seg"], gen, dev)
        seg_kv = seg_q if Sk == Sq else _segments(B, Sk, c["seg"], gen, dev)
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"], scale=c["scale"],
                  q_offset=c["q_offset"], seg_q=seg_q, seg_kv=seg_kv)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        kind = bwd_variant(dt, D)
        before = LAUNCHES[f"flash_attention_bwd.{kind}"]
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if LAUNCHES[f"flash_attention_bwd.{kind}"] != before + 2:
            raise AssertionError(f"flash_attention_bwd case {c['name']} did "
                                 f"not launch the {kind} kernels")
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        refs = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        checks = {name: grad_check(a, r, c["dtype"])
                  for name, a, r in zip(("dq", "dk", "dv"), grads, refs)}
        base_checks = ({name: grad_check(a, r, c["dtype"]) for name, a, r in
                        zip(("dq", "dk", "dv"),
                            old(q, k, v, o, lse, do, **kw), refs)}
                       if old else None)
        del refs, grads
        big = Sq * Sk * H * B > 20_000_000
        ms = device_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        **kw), 5 if big else 20)
        host_ms = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse,
                                                           do, **kw),
                          5 if big else 20)
        plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                     **kw), 2 if big else 5)
        baseline_ms = (device_ms(lambda: old(q, k, v, o, lse, do, **kw),
                                 5 if big else 20) if old else None)

        # yardstick: SDPA forward + backward at the same shape, causal, no
        # softcap, no segments, kv heads repeated to H
        with torch.enable_grad():
            qt = q.transpose(1, 2).contiguous().requires_grad_(True)
            kt = (k.repeat_interleave(H // KH, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True))
            vt = (v.repeat_interleave(H // KH, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True))
            dot = do.transpose(1, 2).contiguous()

            def lib():
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=c["scale"])
                return torch.autograd.grad(out, (qt, kt, vt), dot)
            library_ms = device_ms(lib, 5 if big else 20)
        del qt, kt, vt, dot

        live = int(_mask(c, dev, seg_q, seg_kv).sum()) * (
            1 if seg_q is not None else B)
        flops = 5 * 2 * D * live * H        # s, dP, dv, dk, dq
        nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
                  + lse.numel() * 4)          # q o do dq, k v dk dv, lse
        if seg_q is not None:
            nbytes += 4 * (seg_q.numel() + seg_kv.numel())
        t_ops = flops / PEAK_FLOPS[c["dtype"]]
        t_bytes = nbytes / PEAK_BYTES
        ok = bitwise and all(ch["ok"] for ch in checks.values())
        row = {"phase": "kernel flash_attention_bwd", "case": c["name"],
               "shape": {n: c[n] for n in ("B", "Sq", "Sk", "H", "KH", "D")},
               "causal": c["causal"], "window": c["window"],
               "softcap": c["softcap"], "q_offset": c["q_offset"],
               "scale": c["scale"], "dtype": c["dtype"], "variant": kind,
               "segments": c["seg"],
               "max_abs_err": max(ch["max_abs_err"] for ch in checks.values()),
               "checks": checks, "bitwise_equal_calls": bitwise,
               "ok": ok, "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
               "baseline_ms": baseline_ms, "baseline_checks": base_checks,
               "library_ms": library_ms,
               "library": "scaled_dot_product_attention forward + backward, "
                          "is_causal, no softcap, no segments, kv heads "
                          "repeated",
               "live_pairs": live, "gflop": flops / 1e9,
               "mbytes": nbytes / 1e6, "tflops": flops / ms / 1e9,
               "baseline_tflops": baseline_ms and flops / baseline_ms / 1e9,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit(row)
        if not ok:
            raise AssertionError(f"flash_attention_bwd case {c['name']}: "
                                 f"{checks}, bitwise {bitwise}")
        results[c["name"]] = row
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    results["plan_eviction"] = _bwd_plan_eviction(dev, gen)
    return results


# Launch shapes of the plan-eviction check: more than the wgmma backward's
# launcher keeps plans for (kMaxPlans = 32 in flash_attention_bwd.cu)
PLAN_SHAPES = 40


def _bwd_plan_eviction(dev, gen):
    """The wgmma backward at PLAN_SHAPES small shapes (B=1, S = 64 + 8 i,
    H=2, KH=1, D=64, causal), each against the plain version; then the
    first shape again, after its plan was evicted and is rebuilt: its
    gradients must equal the first call's bitwise."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    kw = dict(causal=True, window=0, softcap=0.0, scale=0.125, q_offset=0)
    first, worst, ok = None, 0.0, True
    for i in range(PLAN_SHAPES):
        S = 64 + 8 * i
        q, do = (torch.randn((1, S, 2, 64), generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((1, S, 1, 64), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        args = (q, k, v, o, lse, do)
        grads = flash_attention_bwd_cuda(*args, **kw)
        for a, r in zip(grads, attention_bwd_ref(*args, **kw)):
            ch = grad_check(a, r, "bfloat16")
            ok = ok and ch["ok"]
            worst = max(worst, ch["rel_err"])
        if first is None:
            first = (args, grads)
    again = flash_attention_bwd_cuda(*first[0], **kw)
    bitwise = all(torch.equal(a, b) for a, b in zip(again, first[1]))
    row = {"phase": "kernel flash_attention_bwd", "case": "plan_eviction",
           "shapes": PLAN_SHAPES, "worst_rel_err": worst,
           "rel_tol": BWD_TOL["bfloat16"][0],
           "bitwise_after_eviction": bitwise, "ok": ok and bitwise}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"flash_attention_bwd plan eviction: {row}")
    return row


# train phase: lm.train's arguments, flash launches per train step (26
# layers; forward twice a microbatch under remat, backward once; 2
# microbatches), and the tolerances of the kernel path against impl="ref"
# on one microbatch.  Both paths compute in bf16 with f32 accumulation and
# differ only inside attention (the kernels round P and dS to bf16 for their
# products, the plain versions do not), each difference a relative 2^-9;
# 26 layers of bf16 residual stream carry such differences on.  The loss, a
# mean of 2048 f32 log-sum-exps of ~12.5, moves by far less than 0.01;
# gradients (relative Frobenius distance) by a few bf16 steps, 0.05.
TRAIN_STEPS = 3   # at profile_train.TRAIN, the shape that profile_train times
TRAIN_LAUNCHES = {"flash_attention": 26 * 2 * 2,
                  "flash_attention.wgmma": 26 * 2 * 2,
                  "flash_attention_bwd": 26 * 2,
                  "flash_attention_bwd.wgmma": 26 * 2}
TRAIN_LOSS_TOL = 0.01
TRAIN_GRAD_RTOL = 0.05


def phase_train(dev):
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.kernel_plugin import Kernel
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.profile_train import TRAIN
    from repro_torch.optim.adamw import global_norm, tree_leaves
    from repro_torch.plugins import lm
    from repro_torch.train import compute_cast
    from repro_torch.train.step import lm_loss

    args = {"arch": TRAIN["arch"], "device": str(dev), "steps": 1,
            "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "microbatches": TRAIN["microbatches"], "ensemble": "chip_smoke",
            "member": 0}
    torch.cuda.synchronize(dev)   # initialises CUDA when this phase is first
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    reset_launches()
    for i in range(TRAIN_STEPS):
        before = dict(LAUNCHES)
        k = Kernel("lm.train")
        k.arguments = dict(args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = k.execute()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t)
        steps.append({"step": out["step"], "loss": out["loss"],
                      "ms": step_ms,
                      "tokens_per_s": TRAIN["batch"] * TRAIN["seq"]
                      / (step_ms / 1e3),
                      "launches": {n: LAUNCHES[n] - before[n]
                                   for n in LAUNCHES
                                   if LAUNCHES[n] != before[n]}})
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    sid = (args["ensemble"], args["member"])
    state = lm.STATE_STORE[sid]
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves([state["params"], state["opt"]["m"],
                                state["opt"]["v"]])) / 1e9

    ev = Kernel("lm.eval")
    ev.arguments = {n: args[n] for n in ("arch", "device", "batch", "seq",
                                         "ensemble", "member")}
    eval_out = ev.execute()
    dec = Kernel("lm.decode")
    dec.arguments = {n: args[n] for n in ("arch", "device", "ensemble",
                                          "member")}
    dec_out = dec.execute()
    torch.cuda.synchronize()

    # one microbatch, kernels against the plain versions, in turn
    cfg = lm.resolve_cfg(args["arch"])
    params = state["params"]
    mb = SyntheticLM(cfg, ShapeSpec("train", "train", TRAIN["seq"],
                                    TRAIN["batch"]), device=dev).batch_at(0)
    mb = {n: t[:TRAIN["batch"] // TRAIN["microbatches"]]
          for n, t in mb.items()}
    layer0 = params["layers"][0]["attn"]
    picked = {"embed": params["embed"]["tok"], **{
        f"layer0/{w}": layer0[w] for w in ("wq", "wk", "wv", "wo")}}

    def grads_of(impl):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        try:
            loss, _, _ = lm_loss(cfg, compute_cast(cfg, params), mb, impl,
                                 remat=True)
            loss.backward()
            with torch.no_grad():
                norm = float(global_norm([p.grad for p in leaves]))
                out = {n: t.grad.clone() for n, t in picked.items()}
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        _release()
        return float(loss), norm, out
    loss_k, norm_k, g_k = grads_of(None)
    loss_r, norm_r, g_r = grads_of("ref")
    grad_rel = {n: float((g_k[n] - g_r[n]).norm() / g_r[n].norm())
                for n in picked}
    del g_k, g_r

    losses = [s_["loss"] for s_ in steps]
    per_step_ok = all(s_["launches"] == TRAIN_LAUNCHES for s_ in steps)
    ok = (all(map(math.isfinite, losses)) and per_step_ok
          and math.isfinite(eval_out["loss"])
          and dec_out["params"] == f"member state at step {TRAIN_STEPS}"
          and dec_out["served"] == 2
          and abs(loss_k - loss_r) <= TRAIN_LOSS_TOL
          and abs(norm_k - norm_r) <= TRAIN_GRAD_RTOL * norm_r
          and all(r <= TRAIN_GRAD_RTOL for r in grad_rel.values()))
    row = {"phase": f"train {TRAIN['arch']}", "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "optstate_dtype": cfg.optstate_dtype, "remat": cfg.remat,
           "params": n_params, "state_gb": state_gb, **TRAIN,
           "steps": TRAIN_STEPS,
           "train_tasks": "lm.train, one step a task",
           "steps_run": steps, "losses": losses,
           "step_ms_steady": sum(s_["ms"] for s_ in steps[1:])
           / max(1, len(steps) - 1),
           "launches": launches, "launches_per_step": TRAIN_LAUNCHES,
           "peak_mem_gb": peak_gb, "eval": eval_out,
           "decode": {n: dec_out[n] for n in ("served", "params", "tokens")},
           "vs_ref": {"loss_kernels": loss_k, "loss_ref": loss_r,
                      "loss_tol": TRAIN_LOSS_TOL, "grad_norm_kernels": norm_k,
                      "grad_norm_ref": norm_r,
                      "grad_rel_frobenius": grad_rel,
                      "grad_rtol": TRAIN_GRAD_RTOL},
           "ok": ok}
    emit(row)
    lm.STATE_STORE.clear()
    lm._STEP_CACHE.clear()
    del state, params, picked, layer0
    _release()
    if not ok:
        raise AssertionError(f"train phase failed: {row}")
    return row


def _scan_check(name, case, kernel, plain, y_dtype, nbytes, flops, extra,
                old=None):
    """Run ``kernel`` and ``plain`` on the same inputs, compare (y, h_last),
    time both (and ``old``, an earlier kernel, where given) and emit the
    row."""
    import torch

    def errors(fn):
        y, h = fn()
        torch.cuda.synchronize()
        return (float((y.float() - y_ref.float()).abs().max()),
                float((h - h_ref).abs().max()),
                bool(torch.isfinite(y.float()).all()
                     and torch.isfinite(h).all()))
    y_ref, h_ref = plain()
    y_err, h_err, finite = errors(kernel)
    scale = max(1.0, float(y_ref.float().abs().max()))
    y_tol = 1e-4 if y_dtype == "float32" else 2.0 ** -7 * scale
    ok = finite and y_err <= y_tol and h_err <= 1e-4
    base_err = errors(old)[:2] if old else None
    del y_ref, h_ref
    ms = device_ms(kernel, 20)
    host_ms = time_ms(kernel, 20)
    baseline_ms = device_ms(old, 20) if old else None
    plain_ms = time_ms(plain, 2)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS["float32"]
    row = {"phase": f"kernel {name}", "case": case["name"],
           "shape": {k: v for k, v in case.items() if k != "name"},
           "max_abs_err": y_err, "tol": y_tol, "h_last_err": h_err,
           "h_last_tol": 1e-4, "ok": ok, "ms": ms, "host_ms": host_ms,
           "baseline_ms": baseline_ms, "baseline_max_abs_err": base_err,
           "plain_ms": plain_ms, "library_ms": None,
           "library": "none: no single PyTorch call computes the recurrence",
           "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", **extra}
    emit(row)
    if not ok:
        raise AssertionError(f"{name} case {case['name']}: y error {y_err} "
                             f"(tol {y_tol}), h_last error {h_err} (tol 1e-4), "
                             f"finite={finite}")
    return row


def phase_kernel_linear_scan(dev):
    import torch

    from repro_torch.kernels.rglru import linear_scan, linear_scan_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for c in LS_CASES:
        dt = getattr(torch, c["dtype"])
        B, T, C = c["B"], c["T"], c["C"]
        x = torch.randn((B, T, C), generator=gen, device=dev).to(dt)
        a = (0.5 + 0.49 * torch.rand((B, T, C), generator=gen,
                                     device=dev)).to(dt)
        h0 = torch.randn((B, C), generator=gen, device=dev)
        nbytes = 3 * x.numel() * x.element_size() + 2 * h0.numel() * 4
        results[c["name"]] = _scan_check(
            "linear_scan", c, lambda: linear_scan(x, a, h0),
            lambda: linear_scan_ref(x, a, h0), c["dtype"], nbytes,
            2 * B * T * C, {})
        del x, a, h0
        torch.cuda.empty_cache()
    return results


def phase_kernel_selective_scan(dev, baseline=None):
    import torch

    from repro_torch.kernels.mamba import selective_scan, selective_scan_ref
    from repro_torch.kernels.mamba.ops import variant
    gen = torch.Generator(device=dev).manual_seed(2)
    old = _baseline("selective_scan", baseline)
    results = {}
    for c in SS_CASES:
        dt_ = getattr(torch, c["dtype"])
        B, T, d, n = c["B"], c["T"], c["d"], c["n"]
        x = torch.randn((B, T, d), generator=gen, device=dev).to(dt_)
        dt = 1e-3 + 0.099 * torch.rand((B, T, d), generator=gen, device=dev)
        A = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev)[None].repeat(d, 1)
        xdbc = torch.randn((B, T, DT_RANK + 2 * n), generator=gen,
                           device=dev).to(dt_)
        Bm, Cc = xdbc[..., DT_RANK:DT_RANK + n], xdbc[..., DT_RANK + n:]
        D = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        h0 = torch.randn((B, d, n), generator=gen, device=dev)
        args = (x, dt, A, Bm, Cc, D, h0)
        esz = x.element_size()
        nbytes = (2 * x.numel() * esz + dt.numel() * 4 + A.numel() * 4
                  + 2 * B * T * n * Bm.element_size() + D.numel() * 4
                  + 2 * h0.numel() * 4)
        exps = B * T * d * n
        extra = {"variant": variant(n), "exponentials": exps,
                 "exp_bound_ms": 1e3 * exps / PEAK_EXP,
                 "bm_c": "column slices of one x_proj-shaped tensor, "
                         "read in place through their strides"}
        results[c["name"]] = _scan_check(
            "selective_scan", c, lambda: selective_scan(*args),
            lambda: selective_scan_ref(*args), c["dtype"], nbytes,
            B * T * d * (7 * n + 3), extra,
            old=(lambda: old(*args)) if old else None)
        del x, dt, A, xdbc, Bm, Cc, D, h0, args
        torch.cuda.empty_cache()
    results[SS_LONG["name"]] = _selective_scan_long_row(dev, gen)
    return results


def _selective_scan_long_row(dev, gen):
    """selective_scan on a batch row of T * d > 2^32 elements: the last
    ``tail`` steps of the whole run must equal, bitwise, a run on those steps
    alone from the state that a run on the first T - tail steps leaves (a
    run of at least 2^32 elements too); that tail run is held against the
    plain version.  x and dt are made in place, with no f32 copy of x and
    no temporaries of dt's size."""
    import torch

    from repro_torch.kernels.mamba import selective_scan, selective_scan_ref
    c = SS_LONG
    B, T, d, n, tail = c["B"], c["T"], c["d"], c["n"], c["tail"]
    T0 = T - tail
    x = torch.randn((B, T, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    dt = torch.rand((B, T, d), generator=gen, device=dev).mul_(0.099).add_(
        1e-3)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None].repeat(
        d, 1)
    xdbc = torch.randn((B, T, DT_RANK + 2 * n), generator=gen,
                       device=dev).to(torch.bfloat16)
    Bm, Cc = xdbc[..., DT_RANK:DT_RANK + n], xdbc[..., DT_RANK + n:]
    D = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    h0 = torch.randn((B, d, n), generator=gen, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    y, h_last = selective_scan(x, dt, A, Bm, Cc, D, h0)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    y_tail = y[:, T0:].clone()
    del y
    y_head, h_head = selective_scan(x[:, :T0], dt[:, :T0], A, Bm[:, :T0],
                                    Cc[:, :T0], D, h0)
    del y_head
    tail_args = (x[:, T0:].contiguous(), dt[:, T0:].contiguous(), A,
                 Bm[:, T0:], Cc[:, T0:], D, h_head)
    del x, dt
    torch.cuda.empty_cache()
    y_t, h_t = selective_scan(*tail_args)
    y_r, h_r = selective_scan_ref(*tail_args)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(y_t, y_tail) and torch.equal(h_t, h_last))
    y_err = float((y_t.float() - y_r.float()).abs().max())
    h_err = float((h_t - h_r).abs().max())
    y_tol = 2.0 ** -7 * max(1.0, float(y_r.float().abs().max()))
    ok = (bitwise and y_err <= y_tol and h_err <= 1e-4
          and bool(torch.isfinite(y_t.float()).all()))
    row = {"phase": "kernel selective_scan", "case": c["name"],
           "shape": {k: c[k] for k in ("B", "T", "d", "n")},
           "row_elements": T * d, "dtype": c["dtype"],
           "tail_bitwise_equal": bitwise, "tail_max_abs_err": y_err,
           "tol": y_tol, "tail_h_last_err": h_err, "h_last_tol": 1e-4,
           "ok": ok, "ms": ms}
    emit(row)
    del tail_args, y_t, h_t, y_r, h_r, y_tail, h_last, h_head, xdbc, Bm, Cc
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"selective_scan long row: {row}")
    return row


def _gmm_sizes(c, gen, dev):
    import torch
    if "sizes" in c:
        return torch.tensor(c["sizes"], dtype=torch.int32, device=dev)
    T, k = c["route"]
    idx = torch.rand((T, c["E"]), generator=gen, device=dev).topk(k).indices
    counts = torch.zeros(c["E"], dtype=torch.int32, device=dev).scatter_add_(
        0, idx.reshape(-1), torch.ones(T * k, dtype=torch.int32, device=dev))
    return counts.clamp(max=c["C"])


def phase_kernel_gmm(dev, baseline=None):
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    from repro_torch.kernels.moe_gmm.ops import kernel_variant, variant
    gen = torch.Generator(device=dev).manual_seed(3)
    old = _baseline("gmm", baseline)
    results = {}
    for c in GMM_CASES:
        dt = getattr(torch, c["dtype"])
        E, C, D, F = c["E"], c["C"], c["D"], c["F"]
        x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
        w = (0.02 * torch.randn((E, D, F), generator=gen, device=dev)).to(dt)
        sizes = _gmm_sizes(c, gen, dev)
        kind = variant(dt, E, C, D, F)
        if kernel_variant(dt, E, C, D, F) != kind:
            raise AssertionError(f"gmm case {c['name']}: the library's rule "
                                 f"names {kernel_variant(dt, E, C, D, F)}, "
                                 f"ops.variant {kind}")
        before = LAUNCHES[f"gmm.{kind}"]
        out = gmm(x, w, sizes)
        torch.cuda.synchronize()
        if LAUNCHES[f"gmm.{kind}"] != before + 1:
            raise AssertionError(f"gmm case {c['name']} did not launch the "
                                 f"{kind} kernel")
        ref = gmm_ref(x, w, sizes)
        scale = max(1.0, float(ref.float().abs().max()))
        tol = 2.0 ** -7 * scale if c["dtype"] == "bfloat16" else 1e-4
        valid = torch.arange(C, device=dev)[None, :] < sizes[:, None]

        def check(y):
            return (float((y.float() - ref.float()).abs().max()),
                    bool((y[~valid] == 0).all()),
                    bool(torch.isfinite(y.float()).all()))
        err, padding_zero, finite = check(out)
        base_check = check(old(x, w, sizes)) if old else None
        del ref
        big = E * C * D > 10_000_000
        ms = device_ms(lambda: gmm(x, w, sizes), 10 if big else 50)
        host_ms = time_ms(lambda: gmm(x, w, sizes), 10 if big else 50)
        baseline_ms = (device_ms(lambda: old(x, w, sizes), 10 if big else 50)
                       if old else None)
        plain_ms = time_ms(lambda: gmm_ref(x, w, sizes), 2 if big else 10)
        library_ms = device_ms(lambda: torch.bmm(x, w), 10 if big else 50)

        live_rows = int(sizes.sum())
        live_experts = int((sizes > 0).sum())
        esz = x.element_size()
        flops = 2 * live_rows * D * F
        nbytes = (live_rows * D + live_experts * D * F + E * C * F) * esz \
            + 4 * E
        t_ops = flops / PEAK_FLOPS[c["dtype"]]
        t_bytes = nbytes / PEAK_BYTES
        ok = finite and padding_zero and err <= tol
        row = {"phase": "kernel gmm", "case": c["name"],
               "shape": {n: c[n] for n in ("E", "C", "D", "F")},
               "dtype": c["dtype"], "variant": kind, "live_rows": live_rows,
               "live_experts": live_experts, "max_abs_err": err, "tol": tol,
               "all_padding_zero": padding_zero, "ok": ok, "ms": ms,
               "host_ms": host_ms, "baseline_ms": baseline_ms,
               "baseline_max_abs_err": base_check and base_check[0],
               "baseline_padding_zero": base_check and base_check[1],
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "torch.bmm in x's dtype over every row and expert",
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit(row)
        if not ok:
            raise AssertionError(f"gmm case {c['name']}: max error {err} > "
                                 f"{tol}, padding rows zero={padding_zero}, "
                                 f"finite={finite}")
        results[c["name"]] = row
        del x, w, sizes, out, valid
        torch.cuda.empty_cache()
    return results


def _requests(cfg, n, S0, new, seed=0):
    import numpy as np

    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, S0),
                    max_new_tokens=new) for i in range(n)]


def _greedy(step, params, out, S0, new, dev):
    """Greedy tokens decoded from a prefill's cache, as the server does."""
    import torch
    cache, last = out["cache"], out["logits"][:, 0].argmax(-1)
    toks = []
    for t in range(new):
        pos = torch.full((last.shape[0],), S0 + t, dtype=torch.int32,
                         device=dev)
        logits, cache = step(params, cache, last[:, None], pos)
        last = logits[:, 0].argmax(-1)
        toks.append(last)
    return torch.stack(toks, 1).tolist()


def phase_serve(dev, arch, loop, per_prefill, per_decode):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.serve import (
        BatchedServer,
        build_prefill_step,
        build_serve_step,
    )

    cfg = get_config(arch).replace(param_dtype="bfloat16")
    B, S0, NEW, NREQ = 4, 1024, 16, 8
    max_len = S0 + NEW + 1
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))

    def server():
        return BatchedServer(cfg, params, batch=B, prompt_len=S0,
                             max_len=max_len, device=dev)

    # warm-up (library handles, allocator), outside the counted run
    warm = server()
    warm.submit(_requests(cfg, B, S0, 2))
    warm.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    srv = server()
    srv.submit(_requests(cfg, NREQ, S0, NEW))
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = {r.rid: r.out_tokens for r in done}
    prefills, steps = srv.stats["prefills"], srv.stats["decode_steps"]
    want = {k: per_prefill.get(k, 0) * prefills + per_decode.get(k, 0) * steps
            for k in launches}
    if srv.continuous != (loop == "continuous") or prefills != 2 \
            or launches != want:
        raise AssertionError(f"{arch}: continuous={srv.continuous}, "
                             f"{prefills} prefills, {steps} decode steps, "
                             f"launches {launches}; expected the {loop} "
                             f"loop, 2 prefills, {want}")
    ntok = sum(len(t) for t in tokens.values())
    if len(tokens) != NREQ or any(len(t) != NEW or min(t) < 0 or
                                  max(t) >= cfg.vocab_size
                                  for t in tokens.values()):
        raise AssertionError(f"bad serve output: {tokens}")

    # one prefill of the first wave, kernels against plain versions
    wave = torch.stack([torch.as_tensor(r.prompt) for r in
                        _requests(cfg, B, S0, NEW)]).to(dev)
    with torch.inference_mode():
        pre_k = build_prefill_step(cfg, cache_len=max_len)
        pre_r = build_prefill_step(cfg, cache_len=max_len, impl="ref")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_r = pre_r(params, {"tokens": wave})
        torch.cuda.synchronize()
        prefill_ref_ms = 1e3 * (time.perf_counter() - t)
        lr = out_r["logits"]
        ref_tokens = _greedy(build_serve_step(cfg, impl="ref"), params,
                             out_r, S0, NEW, dev)
        del out_r
        lk = pre_k(params, {"tokens": wave})["logits"]
        logit_err = float((lk - lr).abs().max())
        finite = bool(torch.isfinite(lk).all())
        top2 = lk[:, 0].topk(2, dim=-1).values
        argmax_same = float((lk[:, 0].argmax(-1) == lr[:, 0].argmax(-1))
                            .float().mean())
        served = [tokens[i] for i in range(B)]
        same = sum(a == b for s, r in zip(served, ref_tokens)
                   for a, b in zip(s, r))
        prefill_ms = time_ms(lambda: pre_k(params, {"tokens": wave}), 3)
        out = pre_k(params, {"tokens": wave})
        cache, last = out["cache"], out["logits"][:, 0].argmax(-1)
        state = {"pos": S0}

        def step():
            pos = torch.full((B,), state["pos"], dtype=torch.int32,
                             device=dev)
            srv.step(params, cache, last[:, None], pos)
            state["pos"] += 1
        decode_ms = time_ms(step, NEW - 2)
    tol = LOGIT_TOL
    row = {"phase": f"serve {arch}", "arch": cfg.name, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "lru_width": cfg.lru_width,
           "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
           "num_experts": cfg.num_experts,
           "experts_per_tok": cfg.experts_per_tok,
           "expert_ff": cfg.expert_ff if cfg.num_experts else 0,
           "params": n_params,
           "param_gb": n_bytes / 1e9, "init_s": init_s, "batch": B,
           "requests": NREQ, "prompt_len": S0, "new_tokens": NEW,
           "loop": "continuous" if srv.continuous else "wave",
           "stats": srv.stats, "launches": launches,
           "launches_per_prefill": per_prefill,
           "launches_per_decode_step": per_decode,
           "wall_s": wall, "tokens_per_s": ntok / wall,
           "prefill_ms": prefill_ms, "prefill_ref_ms": prefill_ref_ms,
           "decode_step_ms": decode_ms,
           "prefill_logit_max_abs_err": logit_err, "logit_tol": tol,
           "greedy_token_agreement": same / (B * NEW),
           "prefill_argmax_agreement": argmax_same,
           "prefill_top2_gap_min": float((top2[:, 0] - top2[:, 1]).min()),
           "greedy_compared": "first wave's served tokens (kernels) against "
                              "tokens decoded by impl='ref' decode steps "
                              "(plain versions) from the impl='ref' "
                              "prefill's cache",
           "peak_mem_gb": peak_gb}
    emit(row)
    if not finite or logit_err > tol:
        raise AssertionError(f"{arch} prefill logits: kernels vs ref "
                             f"{logit_err} > {tol} (finite={finite})")
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_task(dev):
    import torch

    from repro_torch.core.kernel_plugin import Kernel
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.plugins.lm import resolve_cfg
    k = Kernel("lm.decode")
    k.arguments = {"arch": "gemma2-2b", "device": str(dev), "prompt_len": 256,
                   "batch": 2, "requests": 2, "new_tokens": 4}
    reset_launches()
    out = k.execute()
    torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    emit({"phase": "task", "kernel": "lm.decode", "arguments": k.arguments,
          "result": out, "flash_attention_launches": launches,
          "exec_s": k.timings["exec"]})
    per_prefill = resolve_cfg(k.arguments["arch"]).num_layers
    if out["served"] != 2 or launches != per_prefill * out["stats"]["prefills"]:
        raise AssertionError(f"lm.decode: {out}, {launches} launches")
    return launches


def phase_continuous(dev):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedServer, Request
    cfg = get_config("serve-tiny")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    new = [3, 5, 2, 4, 3]
    S0 = 8

    def serve(impl):
        import numpy as np
        rng = np.random.default_rng(0)
        srv = BatchedServer(cfg, params, batch=2, prompt_len=S0,
                            max_len=S0 + max(new), device=dev, impl=impl)
        srv.submit([Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, S0),
                            max_new_tokens=n) for i, n in enumerate(new)])
        return srv, {r.rid: r.out_tokens for r in srv.run()}

    reset_launches()
    srv, tokens = serve(None)
    torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    _, tokens_ref = serve("ref")
    same = sum(a == b for rid in tokens
               for a, b in zip(tokens[rid], tokens_ref[rid]))
    emit({"phase": "continuous", "arch": cfg.name,
          "continuous": srv.continuous, "stats": srv.stats,
          "flash_attention_launches": launches, "tokens": tokens,
          "greedy_token_agreement_with_ref": same / sum(new)})
    if (not srv.continuous or [len(tokens[i]) for i in range(len(new))] != new
            or launches != cfg.num_layers * srv.stats["prefills"]):
        raise AssertionError(f"continuous loop: {srv.stats}, {launches}")
    return launches


def _release():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="NAME=PATH",
                    help="an earlier .cu of kernel NAME (flash_attention, "
                         "flash_attention_bwd, selective_scan, gmm; same C "
                         "entry) to time beside the kernel on its cases; "
                         "repeatable")
    args = ap.parse_args()
    baselines = {}
    for spec in args.baseline:
        name, sep, path = spec.partition("=")
        if not sep or name not in BASELINES or not Path(path).is_file():
            ap.error(f"--baseline {spec!r}: want NAME=PATH with NAME in "
                     f"{sorted(BASELINES)} and PATH an existing file")
        baselines[name] = Path(path)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    phase_build()
    with torch.inference_mode():
        cases = {"flash_attention": phase_kernel_flash_attention(
                     dev, baselines.get("flash_attention")),
                 "linear_scan": phase_kernel_linear_scan(dev),
                 "selective_scan": phase_kernel_selective_scan(
                     dev, baselines.get("selective_scan")),
                 "gmm": phase_kernel_gmm(dev, baselines.get("gmm"))}
        _release()
    cases["flash_attention_bwd"] = phase_kernel_flash_attention_bwd(
        dev, baselines.get("flash_attention_bwd"))
    _release()
    launches = {name: {} for name in KERNELS}
    row = phase_train(dev)
    for name, n in row["launches"].items():
        if n and name in launches:
            launches[name][row["phase"]] = n
    with torch.inference_mode():
        for arch, loop, per_prefill, per_decode in SERVE:
            row = phase_serve(dev, arch, loop, per_prefill, per_decode)
            for name, n in row["launches"].items():
                if n and name in launches:
                    launches[name][arch] = n
            _release()
        phase_task(dev)
        phase_continuous(dev)

    kernels = []
    for name, (source, replaces, case) in KERNELS.items():
        s = cases[name][case]
        if not launches[name]:
            raise AssertionError(f"kernel {name} was not launched on its "
                                 "main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "case": case,
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            **{k: s[k] for k in ("variant", "host_ms") if k in s}})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t0})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

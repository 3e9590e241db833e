#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--baseline NAME=OLD.cu ...]

Phases, one JSON line each (any failure raises and exits non-zero):
  build          compile every CUDA kernel from the sources in this checkout
                 (one nvcc per source, all started together) and report
                 each kernel's registers, spills and shared memory (ptxas;
                 the flash, gmm and gmm_bwd wgmma kernels' dynamic shared
                 memory as the library states it)
  kernel ...     hold each kernel (flash_attention, flash_attention_bwd,
                 linear_scan, selective_scan, gmm, linear_scan_bwd,
                 selective_scan_bwd, gmm_bwd) against its plain
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
                 them.  Flash attention, gmm and gmm_bwd report the kernel
                 variant each case took (wgmma, mma_sync, f32; the launch
                 counter must show it, and for gmm and gmm_bwd the
                 library's own rule must name it), flash also TFLOP/s;
                 flash, selective_scan and gmm give the wrapper's
                 host-inclusive time per call beside the device time.
                 ``--baseline NAME=PATH`` (NAME one of
                 flash_attention, flash_attention_bwd, selective_scan,
                 gmm, linear_scan_bwd, selective_scan_bwd, gmm_bwd;
                 repeatable)
                 builds an earlier version of that
                 kernel's ``.cu`` (same C entry) and times it on every
                 case of its phase in the same run, with its error against
                 the plain version (flash_attention: cases without segment
                 ids, through the older entry flash_attention_fwd;
                 flash_attention_bwd: every case, through the entry
                 flash_attention_bwd; it also runs the wgmma backward at
                 more shapes than its launcher keeps plans for, and the
                 first shape again, bitwise, after its plan was evicted;
                 gmm_bwd: every case, through the entry gmm_bwd, with the
                 phase's own checks).
                 The selective_scan phase includes a
                 case with T * d > 2^32 (64-bit offsets in a batch row):
                 its last 256 steps must equal, bitwise, a run on them
                 alone from the state the first T - 256 steps leave.  The
                 scans' backward phases hold their gradients by the flash
                 backward's measures with bitwise repeats;
                 selective_scan_bwd's includes a batch row of T * d >=
                 2^31, whose last 256 steps' gradients must equal, bitwise,
                 a backward of those steps alone.  gmm's cases include
                 group sizes from qwen3-moe-30b-a3b's own layer-0 router
                 (seed-0 weights, a SyntheticLM batch) at the serve shape
                 (C = 384) and the train microbatch's (C = 80); gmm_bwd's
                 (dx and dw) are held by the flash backward's measures,
                 with dx's padding rows and empty experts' dw exactly 0,
                 bitwise repeats and nonzero dy on the padding rows, at
                 qwen3's train, eval and fused shapes, grok-1-314b's
                 expert shape (E=8, D=6144, F=32768), every tail of the
                 wgmma kernels (``ragged_wgmma``), NaN in x's and dy's
                 padding rows (``nan_padding``), ragged (F % 8 != 0),
                 empty and f32, against the bound and a torch.bmm pair
  train gemma2-2b
                 ``lm.train`` of full-width gemma2-2b (f32 master params
                 and Adam moments, bf16 compute, remat, batch 4 of 1024
                 tokens in 2 microbatches) for 3 steps, one task each, then
                 ``lm.eval`` and ``lm.decode`` of the same member: step ms,
                 tokens/s, peak memory, losses, flash launches per step
                 (every one a hand kernel); then one microbatch's loss,
                 grad norm and leaf grads against ``impl="ref"`` (on the
                 eval's batch, which no step saw)
  train recurrentgemma-2b, train falcon-mamba-7b-L24
                 the same for the scan archs (full-width recurrentgemma-2b;
                 falcon-mamba-7b cut to 24 layers, one microbatch), 2
                 steps and lm.eval: exact launches of the scans' forward,
                 recompute and backward kernels and of flash
  train qwen3-moe-30b-a3b-L4
                 full-width qwen3-moe-30b-a3b cut to 4 of 48 layers, batch
                 4 x 1024 in the config's 4 microbatches, 2 steps and
                 lm.eval: exact launches of gmm (forward), gmm_bwd (dx,
                 dw) and flash a step; the comparison with impl="ref"
                 includes layer 0's router and experts
  train whisper-large-v3
                 full-width whisper-large-v3 (4 x 1024 tokens and 4 x
                 1500 frames, one microbatch), 2 steps and lm.eval: 192
                 forward and 96 backward flash launches a step (encoder,
                 decoder self- and cross-attention); the comparison with
                 impl="ref" includes the first encoder layer's and the
                 cross-attention's gradients
  dryrun         after each train phase, launch train and each fused
                 population: repro_torch.launch.dryrun's reckoning of that
                 cell (its config, shape, microbatches or members; fake
                 tensors on the meta device, nothing allocated, computed
                 in worker processes that see no card while the kernel
                 phases run): the reckoned peak beside
                 max_memory_allocated (within 5%), the flash backward's
                 C-side bytes on their own, the tally of
                 kernel calls beside each step's (cycle's) measured
                 launches and the hand counts (equal); for the train
                 phases the roofline of the step (t_compute, t_memory, the
                 counted FLOPs, model_flops) and the model-FLOP share,
                 model_flops / (warm step s x 989 TFLOP/s), beside the
                 card's name and power limit
  launch train   repro_torch.launch.train's main() in this process:
                 full-width gemma2-2b, 4 steps of 4 x 1024 (2 x 1024 when
                 the dry run reckons 4 over 76 GB) at the config's one
                 microbatch on the card: finite losses, 52 flash forward
                 and 26 backward launches a step (wgmma), steps and
                 tokens a second, peak
  ensemble       replica exchange (4 members, 2 cycles) and a
                 simulation-analysis loop (2 members, 2 iterations, then
                 ``lm.eval``) of full-width gemma2-2b members cut to 4
                 layers, through the port's pilot (``repro_torch.core``)
                 on a ``cuda.h100`` resource with 2 slots: two members
                 train at once on the card, one ``lm.train`` step of batch
                 2 of 1024 tokens a task, the exchange on the host.  Per
                 app: the TTC decomposition, utilization, losses,
                 temperatures (replayed on the host from the losses),
                 tokens/s over the TTC, peak memory, and flash launches
                 (exactly the per-step counts times the steps, all wgmma);
                 member 0's first task run again alone gives its loss
  federation     the ensemble phase's replica exchange on a fleet of two
                 one-slot pilots on the card (``repro_torch.federation``),
                 each with its own journal, under a ``repro_torch.obs``
                 tracer: run 1 as it is (its losses the ensemble phase's,
                 both pilots dispatched), run 2 losing pilot p2 once its
                 first ``lm.train`` attempt runs (the attempt ends
                 pod_lost, its retry runs on p1, the lost attempt trains
                 on as a zombie).  Per run: TTC and its decomposition,
                 dispatch per pilot, cross-pilot bytes, the timeline's
                 samples, exact flash launches, the port's ``obs
                 decompose`` and ``analysis sanitize`` over the journals
                 (the journals' per-slot decomposition against the live
                 tracer's), peak, wall seconds
  fused          a FusedEnsemble of 4 full-width gemma2-2b members cut
                 to 2 layers (one vmapped train step for all a cycle, the
                 swap on the device), 2 cycles of batch 1 of 1024 tokens:
                 per cycle the losses, temperatures, accepted pairs and
                 seconds until the metrics return and until the device is
                 idle; the flash launches of a cycle are one member's, the
                 swaps replay on the host, the peak; then the same members
                 in task mode (RE on a 2-slot pilot: TTC and dispatch per
                 cycle) and one re.exchange task on the card; then a
                 FusedEnsemble of 2 full-width qwen3-moe-30b-a3b members
                 cut to 1 layer (batch 1 x 1024, 2 cycles): gmm and
                 gmm_bwd launch once a call for both members (the member
                 axis folded into the experts'), swaps replayed from loss
                 + 0.01 aux
  serve_ensemble examples/serve_ensemble.py's co-tenant application in
                 real mode (its traffic, Channels and staging layer; 4 of
                 its 8 windows): serve windows of two SLA classes decoded
                 by full-width minicpm-2b at 16 slots, beside 2
                 gemma2-2b-L4 members trained for 2 cycles and then
                 checkpointed by lm.checkpoint, on a 4-slot cuda.h100
                 pilot with preempt=True.  The TTC decomposition,
                 preemptions, zombie threads, per-class latency, TTFT and
                 goodput, each window's seconds beside its cost-model
                 makespan, members' final steps; checks the example's
                 assertions, full token counts, flash launches over every
                 attempt, the checkpoints restored bitwise
  serve <arch>   full-width gemma2-2b, recurrentgemma-2b, falcon-mamba-7b,
                 qwen3-moe-30b-a3b, gemma3-4b, minicpm-2b, nemotron-4-15b,
                 whisper-large-v3 and internvl2-26b (bf16, random weights
                 from seed 0;
                 qwen3 needs ~65 GB) through ``BatchedServer``: 8 requests,
                 batch 4, prompt 1024, 16 new tokens; asserts the loop (wave
                 or continuous) and each kernel's launches per prefill and
                 per decode step (flash attention's all through the wgmma
                 variant, gmm's through wgmma in prefill and mma_sync in
                 decode); then one prefill of the first wave with
                 ``impl="ref"`` (the plain versions): every position's final
                 hidden states within the arch's limit (relative Frobenius
                 distance), each off-by-one control above it, the last
                 position's logits within a stated tolerance, and greedy
                 tokens decoded from its cache by ``impl="ref"`` decode
                 steps against the served ones; recurrentgemma-2b's hidden
                 states are read right after its first (recurrent) block
                 too, under a limit of their own, against that block's
                 linear_scan control; whisper's and internvl's checked
                 prefill takes their stub inputs (frames, vision
                 embeddings) through build_prefill_step (launches
                 asserted), decodes on from its cache (whisper: the cross
                 k, v), adds a control that reads q late on the non-causal
                 flash calls; whisper also reads its first attention
                 sublayers' outputs, internvl2-26b its first block's
                 update; internvl2-26b's final hidden states after 1, 12
                 and 48 layers and its last logits, and whisper's final
                 states, are held against an f32 plain run (the kernels'
                 distance from it within 1.25x the plain versions')
  task           ``Kernel("lm.decode")`` on gemma2-2b on the card
  continuous     the continuous-batching loop on ``serve-tiny`` on the card
  mesh           the mesh code paths (``repro_torch.dist``) on a one-rank
                 NCCL group (a FileStore in a temporary directory; no
                 network, no MASTER_ADDR) and its ``make_host_mesh((1, 1),
                 ("data", "model"))`` on the card: (a) full-width gemma2-2b
                 (fsdp), 2 steps of ``build_train_step(cfg, mesh=...)`` on
                 DTensor state laid out by ``state_shardings``, on the
                 ``train gemma2-2b`` phase's seed-0 state and batches:
                 losses within MESH_LOSS_RTOL of that phase's, its flash
                 launches a step; (b) qwen3-moe-30b-a3b-L4 (tp_ep), one
                 step through the expert-parallel branch at model = 1: its
                 loss within MESH_LOSS_RTOL of the ``train`` phase's first,
                 its gmm / gmm_bwd / flash launches; (c)
                 ``BatchedServer(mesh=...)`` of gemma2-2b: the ``serve
                 gemma2-2b`` phase's greedy tokens exactly, its launches;
                 (d) the RE app (2 gemma2-2b-L4 members, one cycle) on
                 ``PilotRuntime(topology=SlotTopology.even([0], 1))``: no
                 failed task, ``re.exchange`` swapping on the granted
                 submesh's card, the host replaying the same swap from the
                 losses and the card's uniforms.
                 Step ms, peak GB and launches beside the unsharded
                 phases'
Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when CUDA is missing or the port's package is not beside this script.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
    # the scans' gradients, which the JAX package takes by XLA autodiff of
    # its scans (rglru/xla.py, mamba/xla.py:19-51); their cases are the
    # train phases' shapes
    "linear_scan_bwd": ("src/repro_torch/kernels/rglru/csrc/linear_scan_bwd.cu",
                        "src/repro/kernels/rglru/pallas_kernel.py:34",
                        "train"),
    "selective_scan_bwd": (
        "src/repro_torch/kernels/mamba/csrc/selective_scan_bwd.cu",
        "src/repro/kernels/mamba/pallas_kernel.py:41", "train"),
    # the gradient of gmm, which the JAX package takes by XLA autodiff of
    # its einsum (moe_gmm/ref.py, moe_gmm/ops.py:24-25); its case is the
    # qwen3 train microbatch's wi/wg product
    "gmm_bwd": ("src/repro_torch/kernels/moe_gmm/csrc/gmm_bwd.cu",
                "src/repro/kernels/moe_gmm/pallas_kernel.py:45", "train_wi"),
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
    # the serve prefill shapes of minicpm-2b (MHA: G = 1, D = 64),
    # nemotron-4-15b (G = 6: 126 of a wgmma item's 128 rows live) and
    # gemma3-4b (window 1024, no softcap; 2048 positions, so that the
    # window bites)
    dict(name="minicpm_serve", B=4, Sq=1024, Sk=1024, H=36, KH=36, D=64,
         causal=True, window=0, softcap=0.0, scale=1.0 / 8, q_offset=0,
         dtype="bfloat16", tol=3e-2),
    dict(name="nemotron_serve", B=4, Sq=1024, Sk=1024, H=48, KH=8, D=128,
         causal=True, window=0, softcap=0.0, scale=128 ** -0.5, q_offset=0,
         dtype="bfloat16", tol=3e-2),
    dict(name="gemma3_serve", B=4, Sq=2048, Sk=2048, H=8, KH=4, D=256,
         causal=True, window=1024, softcap=0.0, scale=1.0 / 16, q_offset=0,
         dtype="bfloat16", tol=3e-2),
    # minicpm-2b's admission prefill in serve_ensemble: 16 slots of 32-token
    # prompts, so a work item holds 32 live rows of its 128
    dict(name="minicpm_admit", B=16, Sq=32, Sk=32, H=36, KH=36, D=64,
         causal=True, window=0, softcap=0.0, scale=1.0 / 8, q_offset=0,
         dtype="bfloat16", tol=3e-2),
    # whisper-large-v3's encoder (non-causal over its 1500 frames: 1500 =
    # 23 * 64 + 28, a ragged tail at every tile) and its decoder's
    # cross-attention (1024 queries over the 1500 encoder positions); MHA,
    # D = 64
    dict(name="whisper_encoder", B=4, Sq=1500, Sk=1500, H=20, KH=20, D=64,
         causal=False, window=0, softcap=0.0, scale=None, q_offset=0,
         dtype="bfloat16", tol=3e-2),
    dict(name="whisper_cross", B=4, Sq=1024, Sk=1500, H=20, KH=20, D=64,
         causal=False, window=0, softcap=0.0, scale=None, q_offset=0,
         dtype="bfloat16", tol=3e-2),
]
# rows of a wgmma forward work item: the G heads of a kv head folded, 128 / G
# positions each (flash_attention_fwd.cu); an item holds G x min(Sq, 128 / G)
# live rows
WGMMA_ROWS = 128
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
    # whisper-large-v3's train microbatch (4 x 1024 tokens, 4 x 1500
    # frames): the encoder's non-causal self-attention and the decoder's
    # cross-attention (Sq != Sk, every pair live, no segment ids)
    dict(name="whisper_encoder", B=4, Sq=1500, Sk=1500, H=20, KH=20, D=64,
         causal=False, window=0, softcap=0.0, scale=None, q_offset=0,
         dtype="bfloat16", seg=0),
    dict(name="whisper_cross", B=4, Sq=1024, Sk=1500, H=20, KH=20, D=64,
         causal=False, window=0, softcap=0.0, scale=None, q_offset=0,
         dtype="bfloat16", seg=0),
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
    the measures, the bounds, r's rms and max, and ok.  Summed in float64
    over chunks of 2^27 elements, so a gradient of billions of elements
    (grok's dw) needs no float64 copy of itself."""
    import torch
    sq_diff = sq_ref = max_err = r_max = 0.0
    finite = True
    for a_, r_ in zip(a.reshape(-1).split(2 ** 27),
                      r.reshape(-1).split(2 ** 27)):
        a_, r_ = a_.double(), r_.double()
        diff = a_ - r_
        sq_diff += float((diff * diff).sum())
        sq_ref += float((r_ * r_).sum())
        max_err = max(max_err, float(diff.abs().max()))
        r_max = max(r_max, float(r_.abs().max()))
        finite = finite and bool(torch.isfinite(a_).all())
    r_norm = sq_ref ** 0.5
    rel = sq_diff ** 0.5 / r_norm if r_norm else sq_diff ** 0.5
    rel_tol, max_tol = BWD_TOL[dtype]
    return {"rel_err": rel, "rel_tol": rel_tol, "max_abs_err": max_err,
            "max_abs_tol": max_tol * r_max,
            "ref_rms": r_norm / r.numel() ** 0.5, "ref_max": r_max,
            "ok": finite and rel <= rel_tol and max_err <= max_tol * r_max}


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
# C=384) for wi/wg and wo, and a decode step (T=4, C=8, ~28 live experts);
# the train shape is a microbatch of 1 x 1024 (T=1024: C=80).  "router":
# the sizes qwen3's own layer-0 router gives (``_router_sizes``) at the
# serve shape or the train microbatch, so that the kernel's time predicts
# the model's.
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
    dict(name="serve_router", E=128, C=384, D=2048, F=768, router="serve",
         dtype="bfloat16"),
    dict(name="train", E=128, C=80, D=2048, F=768, route=(1024, 8),
         dtype="bfloat16"),
    dict(name="train_router", E=128, C=80, D=2048, F=768, router="train",
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

# Grouped-matmul backward cases (dx and dw), as GMM_CASES; dy ~ N(0, 1) on
# every row, the padding rows too.  "members": the sizes of that many
# members' routes side by side, as the vmap rule folds a fused
# population's experts; "variant": the kernels ``ops.bwd_variant`` and the
# library's rule must give the case; "nan_padding": x's and dy's padding
# rows are NaN.  Tolerances: BWD_TOL (dx sums F products, dw up to C; bf16
# outputs are one rounding of f32 sums).
GMM_BWD_CASES = [
    # qwen3-moe-30b-a3b's train microbatch (T=1024, top-8: C=80): the
    # backward of wi / wg (D=2048, F=768) and of wo (D=768, F=2048)
    dict(name="train_wi", E=128, C=80, D=2048, F=768, route=(1024, 8),
         dtype="bfloat16", variant="wgmma"),
    dict(name="train_wo", E=128, C=80, D=768, F=2048, route=(1024, 8),
         dtype="bfloat16", variant="wgmma"),
    dict(name="train_router", E=128, C=80, D=2048, F=768, router="train",
         dtype="bfloat16", variant="wgmma"),
    dict(name="eval", E=128, C=384, D=2048, F=768, route=(4096, 8),
         dtype="bfloat16", variant="wgmma"),
    dict(name="fused", E=256, C=80, D=2048, F=768, route=(1024, 8),
         members=2, dtype="bfloat16", variant="wgmma"),
    # grok-1-314b's experts (8 of d_ff 32768, top-2) at 4096 tokens: C=1280
    dict(name="grok", E=8, C=1280, D=6144, F=32768, route=(4096, 2),
         dtype="bfloat16", variant="wgmma"),
    # every tail of the wgmma kernels: sizes 0, 1, 63 / 64 / 65 around a
    # box, C (two boxes, the second past C), clipped -3 and 150; D = 184:
    # dx's last 128-column item and dw's last 128-row item hold one live
    # 64-wide box; F = 520: dw's last 256-column item holds one
    dict(name="ragged_wgmma", E=16, C=100, D=184, F=520,
         sizes=[0, 1, 15, 17, 63, 64, 65, 100, 2, 31, 33, 99, -3, 48, 80,
                150], dtype="bfloat16", variant="wgmma"),
    # x's and dy's padding rows NaN: no padding value may reach dx or dw
    dict(name="nan_padding", E=128, C=80, D=2048, F=768, route=(1024, 8),
         nan_padding=True, dtype="bfloat16", variant="wgmma"),
    dict(name="ragged", E=5, C=100, D=200, F=300, sizes=[0, 100, 37, 64, 1],
         dtype="bfloat16", variant="mma_sync"),
    dict(name="empty", E=128, C=80, D=2048, F=768, sizes=[0] * 128,
         dtype="bfloat16", variant="wgmma"),
    dict(name="f32", E=8, C=256, D=512, F=384, route=(512, 2),
         dtype="float32", variant="f32"),
]

# serve phases: batch, prompt length, new tokens a request, requests
SERVE_SHAPE = dict(batch=4, prompt=1024, new=16, requests=8)
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
    ("gemma3-4b", "wave",
     {"flash_attention": 34, "flash_attention.wgmma": 34}, {}),
    ("minicpm-2b", "continuous",
     {"flash_attention": 40, "flash_attention.wgmma": 40}, {}),
    ("nemotron-4-15b", "continuous",
     {"flash_attention": 32, "flash_attention.wgmma": 32}, {}),
    # the server prefills tokens alone, as the JAX package's does: whisper
    # runs no encoder there (32 decoder self-attention launches) and
    # internvl no vision embeddings
    ("whisper-large-v3", "continuous",
     {"flash_attention": 32, "flash_attention.wgmma": 32}, {}),
    ("internvl2-26b", "continuous",
     {"flash_attention": 48, "flash_attention.wgmma": 48}, {}),
]
# The checked prefill of an arch with a stubbed frontend takes its stub
# inputs (random, 0.02 std, seed 0) through build_prefill_step: whisper's
# frames (B, 1500, 1280) run the encoder (32 non-causal launches) and the
# decoder's cross-attention (32 more), internvl's vision embeddings (B,
# 256, 6144) replace the first 256 positions.  Its launches, those of the
# serve_step decode that follows it (whisper: cross-attention over the
# cached xk, xv), and greedy tokens against impl="ref" from impl="ref"'s
# prefill of the same inputs.
STUB_PREFILL = {
    "whisper-large-v3": {"flash_attention": 96, "flash_attention.wgmma": 96},
    "internvl2-26b": {"flash_attention": 48, "flash_attention.wgmma": 48}}
# Prefill, kernels against plain versions, bf16 through every layer.  Two
# checks.  (1) The final hidden states of every position of the first
# wave's prompts, h (B, S, d_model) before the LM head: their relative
# Frobenius distance from the plain versions' must stay under the arch's
# PREFILL_H_LIMIT, and each control must read above it.  A control is the
# same prefill with one off-by-one fault put in (LOGIT_CONTROL: the model's
# calls of that kernel wrapper read their per-position inputs one position
# late); every kernel of the arch's prefill that LOGIT_CONTROL names gets
# one.  Each limit lies between the arch's sound reading and its smallest
# control reading (PERF.md).  (2) As before, the last position's
# logits within LOGIT_TOL (measured 0.058 to 0.218 on the seven models,
# against largest logits of 4.4 to 39.6), reported beside each control's
# distance there; that check alone let an off-by-one in recurrentgemma-2b's
# attention through (0.057).
LOGIT_TOL = 0.25
LOGIT_CONTROL = {"flash_attention": (1, 2),        # k, v
                 "linear_scan": (0, 1),            # x, a
                 "selective_scan": (0, 1, 3, 4)}   # x, dt, B, C
# Over every key of a non-causal call, k and v read late change one pair of
# ~1500 (the set of keys barely moves), so that control is blind to
# whisper's encoder and cross-attention; theirs reads q late (each query
# takes its neighbour's output), on the calls with causal=False alone.
NONCAUSAL_Q_CONTROL = "flash_attention_q"
# Each limit near the geometric mean of the arch's sound reading and its
# smallest control reading on an H100 (sound / control, deterministic
# from call to call): gemma2-2b 0.0187 / 0.378, recurrentgemma-2b 0.0115 /
# 0.0132 (linear_scan; flash 0.0217), falcon-mamba-7b 0.0146 / 1.121,
# qwen3-moe 0.0153 / 0.339, gemma3-4b 0.0208 / 0.388, minicpm-2b 0.0402 /
# 0.509, nemotron-4-15b 0.0256 / 0.188, whisper-large-v3 0.0122 / 0.0178
# (q; flash 0.0185), internvl2-26b 0.0854 / 0.775.  recurrentgemma-2b's
# linear_scan control is 15% above its sound reading: an RG-LRU state
# decays slowly, so h read a step late is close to h.
PREFILL_H_LIMIT = {"gemma2-2b": 0.08, "recurrentgemma-2b": 0.0123,
                   "falcon-mamba-7b": 0.13, "qwen3-moe-30b-a3b": 0.07,
                   "gemma3-4b": 0.09, "minicpm-2b": 0.14,
                   "nemotron-4-15b": 0.07, "whisper-large-v3": 0.0147,
                   "internvl2-26b": 0.26}
# (3) Where a control reads close to the sound reading at the end of the
# model, the first block's update of the residual stream as well (its
# output less the embeddings it took in), under a limit of its own,
# against the control of the kernel that block runs: there the off-by-one
# is diluted neither by the later layers nor by the embeddings.
# recurrentgemma-2b's first block is recurrent (linear_scan); its limit
# lies near the geometric mean of the block's sound reading and its
# control reading on an H100: 0.000323 / 0.01024 (the model's end reads
# 0.0115 / 0.0132).  internvl2-26b's final hidden states drift with depth
# (0.006 after its first block, 0.034 after 12, 0.085 after 48: bf16
# through 48 layers of d_model 6144), so its first block is read too:
# 0.00608 / 0.137 (flash).
PREFILL_H1 = {"recurrentgemma-2b": ("linear_scan", 0.0018),
              "internvl2-26b": ("flash_attention", 0.029)}
# (4) Random whisper-large-v3 adds O(1) sinusoidal positions to 0.02-std
# embeddings and frames, and its attention updates barely move them (in
# bf16 most are under half a unit in the last place of the stream), so at
# the model's end the controls read only 1.5x its sound reading.  It also
# reads the outputs of its first attention sublayers (before the residual
# add), each on the input the model gives it: the first encoder layer's
# self-attention (non-causal; q control), the first decoder layer's
# self-attention (causal; k, v control) and its cross-attention (on lnx of
# the embeddings, over the encoder's output from impl="ref"; q control).
# The limit near the geometric mean of their sound readings and controls
# on an H100: 0.0015 / 0.0332, 0.0018 / 0.0325, 0.0014 / 0.0269.
PREFILL_ATTN1 = {"whisper-large-v3": 0.007}
# the last position's logits of internvl2-26b move with its drift (0.085
# relative after 48 layers): 0.652 against logits of up to 7.54, its flash
# control 4.39; the limit near their geometric mean
LOGIT_TOL_ARCH = {"internvl2-26b": 1.5}
# (5) Both readings above (internvl2-26b's drift with depth and its last
# logits, whisper-large-v3's thin margin at the model's end) are held
# against an f32 plain run, as the whisper train phase holds its f32_held
# leaves: the kernels' bf16 distance from the f32 run no more than
# F32_HELD_RATIO times the plain versions' bf16 distance from it.  bf16
# rounding puts both at about the same distance; a fault that grows with
# depth puts the kernels further.  internvl2-26b is read after the layers
# in F32_HELD_DEPTHS, its weights upcast to f32 one layer at a time as the
# stack runs (all of them in f32 would take ~79 GB); whisper-large-v3 (3
# GB) is upcast whole and read at the model's end.
F32_HELD_DEPTHS = {"internvl2-26b": (1, 12, 48)}
F32_HELD_FINAL = ("whisper-large-v3",)


def _to_f32(tree):
    """``tree`` with every floating-point tensor in f32."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_f32(v) for v in tree)
    return tree.float() if tree.is_floating_point() else tree


def _f32_held(x) -> dict:
    """The kernels' and the plain versions' bf16 readings ``x["kernels"]``,
    ``x["ref"]`` against the f32 plain run's ``x["f32"]``."""
    k, r = rel_fro(x["kernels"], x["f32"]), rel_fro(x["ref"], x["f32"])
    return {"kernels_vs_f32": k, "ref_vs_f32": r,
            "kernels_vs_ref": rel_fro(x["kernels"], x["ref"]),
            "ratio": k / r}


def _f32_depth_drift(cfg, params, wave, stubs, depths):
    """F32_HELD_DEPTHS: the kernels' bf16 stack, the plain versions' bf16
    stack and the plain versions' f32 stack, run side by side a layer at a
    time (each layer's weights upcast just before the f32 run takes it);
    after each depth in ``depths`` the final norm of each stream, and after
    the last layer the last position's logits, held by ``_f32_held``."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.transformer import (
        embed_tokens,
        forward_block,
        lm_logits,
    )
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    top32 = {k: _to_f32(v) for k, v in params.items()
             if k not in ("layers", "enc")}
    runs = {"kernels": (cfg, params, None), "ref": (cfg, params, "ref"),
            "f32": (c32, top32, "ref")}
    B, S = wave.shape
    pos = torch.arange(S, dtype=torch.int32, device=wave.device)[None].expand(
        B, S)
    h = {}
    for name, (c, p, _) in runs.items():
        x = embed_tokens(c, p, wave, pos)
        if "vision_embeds" in stubs:
            x = torch.cat([stubs["vision_embeds"].to(x.dtype),
                           x[:, cfg.vision_tokens:]], dim=1)
        h[name] = x
    rows = {}
    for i, bp in enumerate(params["layers"]):
        blocks = {"kernels": bp, "ref": bp, "f32": _to_f32(bp)}
        for name, (c, _, impl) in runs.items():
            h[name] = forward_block(c, blocks[name], h[name],
                                    cfg.layer_kind(i), positions=pos,
                                    seg_ids=None, cache_len=None,
                                    impl=impl)[0]
        del blocks
        if i + 1 not in depths:
            continue
        final = {n: L.apply_norm(c, p["final_norm"], h[n])
                 for n, (c, p, _) in runs.items()}
        rows[f"h after {i + 1} layers"] = _f32_held(final)
        if i + 1 == cfg.num_layers:
            rows["last logits"] = _f32_held(
                {n: lm_logits(c, p, final[n][:, -1:])
                 for n, (c, p, _) in runs.items()})
        del final
    return rows


def rel_fro(a, r) -> float:
    """||a - r||_F / ||r||_F, in float64."""
    a, r = a.double(), r.double()
    return float((a - r).norm() / r.norm())


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


# device_ms times batches of calls until two in a row agree within
# SETTLE_RTOL (at most SETTLE_ROUNDS batches): after one warm-up call the
# first case of a kernel phase read high (gmm serve 0.2674 ms against
# 0.2415 when timed later, gmm_bwd train_wi 0.4139 against 0.3461 on an
# H100 at 700 W) while the card's clocks and caches settled.
SETTLE_RTOL = 0.02
SETTLE_ROUNDS = 6


def device_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (kernels): the calls
    are queued behind ~20 ms of a sleep kernel, so the card runs them back
    to back however slowly the host launches them.  Batches of ``iters``
    calls are timed until the time settles (SETTLE_RTOL); the last batch's
    mean is returned."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    prev = None
    for _ in range(SETTLE_ROUNDS):
        ms = _device_batch_ms(fn, iters)
        if prev is not None and abs(ms - prev) <= SETTLE_RTOL * prev:
            break
        prev = ms
    return ms


def _device_batch_ms(fn, iters: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops, nbytes, dtype: str):
    """(bound ms, "operations" or "bytes") of a kernel's work, its
    ``cost()``, at the card's data-sheet peaks (``repro_torch.launch.mesh.
    HW``: bf16 on the tensor cores, anything else on the CUDA cores in f32,
    HBM3)."""
    from repro_torch.launch.mesh import HW
    peak = HW.peak_flops if dtype == "bfloat16" else HW.peak_flops_f32
    t_ops, t_bytes = flops / peak, nbytes / HW.hbm_bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_build():
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        kernel_bwd_smem_bytes,
        kernel_smem_bytes,
    )
    from repro_torch.kernels.mamba.ops import (
        kernel_bwd_smem_bytes as ss_bwd_smem,
    )
    from repro_torch.kernels.moe_gmm.ops import (
        kernel_bwd_smem_bytes as gmm_bwd_smem,
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
    smem.update(gmm_bwd_smem())
    smem["selective_scan_bwd_kernel"] = ss_bwd_smem()
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
                          r"linear_scan_kernel|selective_scan_kernel|gmm_tc|"
                          r"gmm_bwd_d[xw]_tc|gmm_bwd_dx_wgmma)"
                          r"I(?:Li)?(.+?)EE+v", entry[1])
            plain = [k for k in ("gmm_cc", "gmm_wgmma", "gmm_bwd_dx_cc",
                                 "gmm_bwd_dw_cc", "gmm_bwd_dw_wgmma",
                                 "gmm_bwd_dw_pp_wgmma",
                                 "flash_attention_bwd_reduce")
                     if k in entry[1]]
            args = re.sub(r"^Lb([01])", r"\1",
                          re.sub(r"ELb([01])", r",\1", m[2])) if m else ""
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


# --baseline NAME: (library name, module of the wrapper, its CUDA entry,
# the wrapper's module constants set while the older source runs); flash
# attention's older forward sources are called through the C entry that
# every one has, flash_attention_fwd (no segment ids, no lse).  The
# selective-scan backward's earlier source (commit 2eb802b) has the same C
# entry but summed dBm and dC over blocks of 64 channels and read
# checkpoints of 16 steps: its scratch is allocated for 64 and its
# checkpoints are written every 16.
BASELINES = {
    "flash_attention": ("flash_attention_fwd", None, None, {}),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "repro_torch.kernels.flash_attention.ops",
                            "flash_attention_bwd_cuda", {}),
    "selective_scan": ("selective_scan", "repro_torch.kernels.mamba.ops",
                       "selective_scan_cuda", {}),
    "gmm": ("gmm", "repro_torch.kernels.moe_gmm.ops", "gmm_cuda", {}),
    "gmm_bwd": ("gmm_bwd", "repro_torch.kernels.moe_gmm.ops", "gmm_bwd_cuda",
                {}),
    "linear_scan_bwd": ("linear_scan_bwd", "repro_torch.kernels.rglru.ops",
                        "linear_scan_bwd_cuda", {}),
    "selective_scan_bwd": ("selective_scan_bwd",
                           "repro_torch.kernels.mamba.ops",
                           "selective_scan_bwd_cuda",
                           {"BWD_CHANNELS": 64, "CKPT_STEPS": 16}),
}


def _baseline(name, path):
    """A CUDA entry for kernel ``name`` on an earlier ``.cu`` (same C
    interface), built here with the repo's nvcc flags; None without a
    path.  Its ``patched()`` sets the wrapper module's constants that the
    earlier source needs (``BASELINES``) for other calls too."""
    if path is None:
        return None
    import ctypes
    import importlib

    from repro_torch.kernels import _build
    libname, module, entry, consts = BASELINES[name]
    out = _build.BUILD_DIR / f"lib{libname}_baseline-{time.time_ns()}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    if name == "flash_attention":
        return _flash_baseline(lib)
    mine = _build.load(libname)
    mod = importlib.import_module(module)
    fn = getattr(mod, entry)

    @contextlib.contextmanager
    def patched():
        own = {k: getattr(mod, k) for k in consts}
        for k, v in consts.items():
            setattr(mod, k, v)
        try:
            yield
        finally:
            for k, v in own.items():
                setattr(mod, k, v)

    def run(*args, **kw):
        _build._LOADED[libname] = lib
        try:
            with patched():
                return fn(*args, **kw)
        finally:
            _build._LOADED[libname] = mine
    run.patched = patched
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


def _sdpa_unmasked(c, seg_q) -> bool:
    """Whether SDPA's own masks (``is_causal`` or none) give case ``c``'s
    mask: no segment ids, no window that bites, and a causal case square
    with no query offset."""
    return (seg_q is None and (not c["window"] or c["window"] >= c["Sk"])
            and (not c["causal"] or (c["q_offset"] == 0
                                     and c["Sq"] == c["Sk"])))


def phase_kernel_flash_attention(dev, baseline=None):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ops import (
        cost,
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
        if _sdpa_unmasked(c, seg_q):
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=c["causal"], scale=c["scale"])
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=c["scale"])
        library_ms = device_ms(lib, 3 if big else 10)

        pairs = int(mask.sum()) * (1 if seg_q is not None else B)
        flops, nbytes = cost(B, Sq, Sk, H, KH, D, q.element_size(),
                             causal=c["causal"], window=c["window"],
                             q_offset=c["q_offset"],
                             segments=seg_q is not None, live_pairs=pairs)
        bound_ms, bound_by = _bound(flops, nbytes, c["dtype"])
        ok = (finite and err <= c["tol"] and lse_inf_match and out_l_same
              and lse_err <= LSE_TOL[c["dtype"]])
        row = {"phase": "kernel flash_attention", "case": c["name"],
               "shape": {n: c[n] for n in ("B", "Sq", "Sk", "H", "KH", "D")},
               "causal": c["causal"], "window": c["window"],
               "softcap": c["softcap"], "q_offset": c["q_offset"],
               "scale": c["scale"], "dtype": c["dtype"], "variant": kind,
               "segments": c.get("seg", 0),
               "item_rows_used": ((H // KH) * min(Sq, WGMMA_ROWS // (H // KH))
                                  if kind == "wgmma" else None),
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
               "bound_by": bound_by,
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
        bwd_cost,
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

        # yardstick: SDPA forward + backward at the same shape, causal as
        # the case, no softcap, no segments, kv heads repeated to H
        with torch.enable_grad():
            qt = q.transpose(1, 2).contiguous().requires_grad_(True)
            kt = (k.repeat_interleave(H // KH, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True))
            vt = (v.repeat_interleave(H // KH, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True))
            dot = do.transpose(1, 2).contiguous()

            def lib():
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=c["causal"], scale=c["scale"])
                return torch.autograd.grad(out, (qt, kt, vt), dot)
            library_ms = device_ms(lib, 5 if big else 20)
        del qt, kt, vt, dot

        live = int(_mask(c, dev, seg_q, seg_kv).sum()) * (
            1 if seg_q is not None else B)
        flops, nbytes = bwd_cost(B, Sq, Sk, H, KH, D, q.element_size(),
                                 causal=c["causal"], window=c["window"],
                                 q_offset=c["q_offset"],
                                 segments=seg_q is not None, live_pairs=live)
        bound_ms, bound_by = _bound(flops, nbytes, c["dtype"])
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
                          f"is_causal={c['causal']}, no softcap, no "
                          "segments, kv heads repeated",
               "live_pairs": live, "gflop": flops / 1e9,
               "mbytes": nbytes / 1e6, "tflops": flops / ms / 1e9,
               "baseline_tflops": baseline_ms and flops / baseline_ms / 1e9,
               "bound_ms": bound_ms, "bound_by": bound_by}
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


# train phases: lm.train's arguments, kernel launches per train step, and
# the tolerances of the kernel path against impl="ref" on one microbatch.
# Under remat every forward kernel runs twice a microbatch (the forward and
# its recompute) and every backward kernel once.  Both paths compute in
# bf16 with f32 accumulation and differ only inside the kernels (flash
# rounds P and dS to bf16 for its products; the scans' outputs are rounded
# at other elements), each difference a relative 2^-9 that the bf16
# residual stream carries on.  The loss, a mean of f32 log-sum-exps of
# ~11-12.5, moves by far less than 0.01; gradients (relative Frobenius
# distance) by a few bf16 steps, 0.05.
TRAIN_LOSS_TOL = 0.01
TRAIN_GRAD_RTOL = 0.05
# A phase's "f32_held" leaves have gradients that bf16 cannot resolve
# after its steps: whisper-large-v3's cross-attention q and k projections,
# whose true gradient falls 1000x in two AdamW steps (its cross-attention
# turns uniform over the 1500 frames: the largest P of a row 1/1335), so
# that the kernels' and the plain versions' bf16 gradients both lie 1.4
# (relative Frobenius distance) from an f32 plain run's and 0.45 from each
# other.  Such a leaf is held against the f32 plain run: the kernels' bf16
# gradient no further from it than F32_HELD_RATIO times the plain
# versions' (measured 1.014 after two steps, 1.055 after one).
F32_HELD_RATIO = 1.25


_FAMILIES = {"flash": ("flash_attention", "flash_attention_bwd"),
             "rec": ("linear_scan", "linear_scan_bwd"),
             "mamba": ("selective_scan", "selective_scan_bwd"),
             "moe": ("gmm", "gmm_bwd")}
# calls of a family's wrapper a layer: an MoE layer's wi, wg and wo
_CALLS = {"moe": 3}


def _launches(**per):
    """Launch counts of a train step: per[family] = (layers, microbatches);
    the forward kernel twice a layer and microbatch (remat), the backward
    once (gmm: three products a layer, each backward call launching its
    dx and dw kernels once); flash's all through its wgmma kernels, gmm's
    forward through wgmma (the train shape's C = 80 > 16) and its backward
    through wgmma too."""
    out = {}
    for family, (layers, mb) in per.items():
        fwd, bwd = _FAMILIES[family]
        calls = _CALLS.get(family, 1) * layers * mb
        out[fwd] = 2 * calls
        out[bwd] = calls
        if family == "flash":
            out[f"{fwd}.wgmma"] = out[fwd]
            out[f"{bwd}.wgmma"] = out[bwd]
        if family == "moe":
            out["gmm.wgmma"] = out[fwd]
            for name in ("dx", "dw", "wgmma"):
                out[f"gmm_bwd.{name}"] = calls
    return out


# full-width falcon-mamba-7b cut in depth (7.27B params at 18 B a param,
# 131 GB, would not fit): FALCON_LAYERS of 64 layers, registered by the
# script (PERF.md has the reckoning)
FALCON_LAYERS = 24
# full-width qwen3-moe-30b-a3b cut in depth (30.5B params at 14 B a param,
# 427 GB, would not fit): QWEN_LAYERS of 48 layers, 3.115B params
QWEN_LAYERS = 4
TRAIN_PHASES = [
    # gemma2-2b at profile_train.TRAIN (batch 4 x 1024 in 2 microbatches),
    # the shape that profile_train times; then lm.eval and lm.decode
    dict(arch="gemma2-2b", steps=3, decode=True,
         launches=_launches(flash=(26, 2)), mixer="attn",
         picked=("wq", "wk", "wv", "wo")),
    # recurrentgemma-2b at the same shape: 18 RG-LRU layers, 8 local
    # attention layers (MQA, window 2048)
    dict(arch="recurrentgemma-2b", steps=2, decode=False,
         launches=_launches(flash=(8, 2), rec=(18, 2)), mixer="rec",
         picked=("wx", "wy", "wa", "a_param", "wo")),
    # falcon-mamba-7b-L<FALCON_LAYERS>, its config's microbatches=1
    dict(arch=f"falcon-mamba-7b-L{FALCON_LAYERS}", base="falcon-mamba-7b",
         layers=FALCON_LAYERS, steps=2, decode=False, microbatches=1,
         launches=_launches(mamba=(FALCON_LAYERS, 1)), mixer="mamba",
         picked=("in_proj", "x_proj", "dt_proj", "A_log", "D", "out_proj")),
    # qwen3-moe-30b-a3b-L<QWEN_LAYERS>, the config's 4 microbatches of
    # 1 x 1024 (T = 1024 a microbatch: C = 80); "a/b" picks leaf b of
    # layer 0's subtree a
    dict(arch=f"qwen3-moe-30b-a3b-L{QWEN_LAYERS}", base="qwen3-moe-30b-a3b",
         layers=QWEN_LAYERS, steps=2, decode=False, microbatches=4,
         launches=_launches(flash=(QWEN_LAYERS, 4), moe=(QWEN_LAYERS, 4)),
         mixer="attn",
         picked=("wq", "wk", "wv", "wo", "moe/router", "moe/wi", "moe/wg",
                 "moe/wo")),
    # whisper-large-v3 at full width (1.53 B params: 24.5 GB of f32 params,
    # gradients and moments), batch 4 x 1024 tokens and 4 x 1500 frames in
    # its config's one microbatch: 96 flash calls a forward (32 encoder,
    # 32 decoder self- and 32 cross-attention), each run twice under remat;
    # "enc:a/b" picks leaf b of the first encoder layer's subtree a
    dict(arch="whisper-large-v3", steps=2, decode=False, microbatches=1,
         launches=_launches(flash=(96, 1)), mixer="attn",
         picked=("wq", "wv", "xattn/wv", "xattn/wo", "enc:attn/wq",
                 "enc:attn/wk", "enc:attn/wv", "enc:attn/wo", "enc:mlp/wi"),
         f32_held=("xattn/wq", "xattn/wk")),
]


def _cut_cfg(name, base, layers):
    """Config ``name``: the full-width ``base`` config at ``layers``
    layers, registered once."""
    from repro_torch.configs import get_config, register
    try:
        return get_config(name)
    except KeyError:
        return register(get_config(base).replace(name=name,
                                                 num_layers=layers))


@contextlib.contextmanager
def _routing(log, replay=False):
    """The MoE routers' top-k (the only ``torch.topk`` calls of a train
    step) append their indices to ``log``; with ``replay`` they take
    ``log``'s in order instead, the weights gathered from this run's
    probabilities, so that a second run routes every token as the first
    did (its remat recompute too)."""
    import torch
    real, it = torch.topk, iter(list(log))

    def topk(t, k, *args, **kw):
        if replay:
            idx = next(it)
            return t.gather(-1, idx), idx
        vals, idx = real(t, k, *args, **kw)
        log.append(idx)
        return vals, idx
    torch.topk = topk
    try:
        yield
    finally:
        torch.topk = real
    if replay and next(it, None) is not None:
        raise AssertionError("a replayed run took fewer routes than given")


@contextlib.contextmanager
def _recording_sizes(out):
    """The model's gmm calls append their group sizes to ``out``."""
    from repro_torch.models import layers
    real = layers.gmm

    def recording(x, w, group_sizes, **kw):
        out.append(group_sizes.detach().clone())
        return real(x, w, group_sizes, **kw)
    layers.gmm = recording
    try:
        yield
    finally:
        layers.gmm = real


def phase_train(dev, spec=TRAIN_PHASES[0]):
    """``spec["steps"]`` lm.train tasks of one step each at
    profile_train.TRAIN's batch and sequence (``spec`` may set its own
    microbatches), exact kernel launches a step, ``lm.eval`` (and
    ``lm.decode`` where ``spec["decode"]``), then one microbatch's loss,
    grad norm and the layer-0 mixer's leaf grads against ``impl="ref"``."""
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

    if "base" in spec:
        _cut_cfg(spec["arch"], spec["base"], spec["layers"])
    mbs = spec.get("microbatches", TRAIN["microbatches"])
    args = {"arch": spec["arch"], "device": str(dev), "steps": 1,
            "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "microbatches": mbs, "ensemble": "chip_smoke", "member": 0}
    steps_n, want_step = spec["steps"], spec["launches"]
    cfg = lm.resolve_cfg(args["arch"])
    torch.cuda.synchronize(dev)   # initialises CUDA when this phase is first
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    reset_launches()
    for i in range(steps_n):
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
    train_launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    sid = (args["ensemble"], args["member"])
    state = lm.STATE_STORE[sid]
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    held_gb = sum(t.numel() * t.element_size() for t in
                  tree_leaves([state["params"], state["opt"]["m"],
                               state["opt"]["v"]])) / 1e9

    ev = Kernel("lm.eval")
    ev.arguments = {n: args[n] for n in ("arch", "device", "batch", "seq",
                                         "ensemble", "member")}
    eval_out = ev.execute()
    dec_out = None
    if spec["decode"]:
        dec = Kernel("lm.decode")
        dec.arguments = {n: args[n] for n in ("arch", "device", "ensemble",
                                              "member")}
        dec_out = dec.execute()
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}

    # one microbatch, kernels against the plain versions, in turn, of the
    # eval's batch (data seed 1): the steps trained on seed 0's batches 0
    # and 1, and after two steps falcon-mamba-7b-L24's loss on its batch 0
    # read 1.1e-6, with a grad norm of 2e-4 (H100 80GB HBM3)
    params = state["params"]
    mb = SyntheticLM(cfg, ShapeSpec("train", "train", TRAIN["seq"],
                                    TRAIN["batch"]), seed=1,
                     device=dev).batch_at(0)
    mb = {n: t[:TRAIN["batch"] // mbs] for n, t in mb.items()}
    layer0 = params["layers"][0]

    def leaf(w):
        first = layer0
        if w.startswith("enc:"):
            first, w = params["enc"]["layers"][0], w[len("enc:"):]
        a, _, b = w.rpartition("/")
        return first[a or spec["mixer"]][b]
    held = [f"layer0/{w}" for w in spec.get("f32_held", ())]
    picked = {"embed": params["embed"]["tok"],
              **{f"layer0/{w}": leaf(w) for w in spec["picked"]},
              **{n: leaf(n[len("layer0/"):]) for n in held}}
    # an MoE arch's group sizes, gmm call by call, of each run: top-k
    # near-ties can route a few assignments differently in the two
    routed = {}

    def grads_of(impl, tag, routes, replay=False, c=cfg, batch=mb):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        try:
            with _routing(routes, replay):   # the recompute's top-k too
                with _recording_sizes(routed.setdefault(tag, [])):
                    loss, _, _ = lm_loss(c, compute_cast(c, params), batch,
                                         impl, remat=True)
                loss.backward()
            with torch.no_grad():
                norm = float(global_norm([p.grad for p in leaves]))
                out = {n: t.grad.clone() for n, t in picked.items()}
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        _release()
        return float(loss.detach()), norm, out

    def rel(a, b):
        return {n: float((a[n] - b[n]).norm() / b[n].norm()) for n in picked}
    # the plain versions route as the kernels did (the MoE routers' top-k
    # replayed): the comparison holds the kernels, not bf16 near-ties of
    # the f32 router
    routes = []
    loss_k, norm_k, g_k = grads_of(None, "kernels", routes)
    loss_r, norm_r, g_r = grads_of("ref", "ref", routes, replay=True)
    grad_rel = rel(g_k, g_r)
    f32_held = None
    if held:   # and an f32 plain run for the leaves bf16 cannot resolve
        mb32 = {n: t.float() if t.is_floating_point() else t
                for n, t in mb.items()}
        _, _, g_f = grads_of("ref", "ref_f32", [], c=cfg.replace(
            dtype="float32"), batch=mb32)
        to_f32 = {"kernels": rel(g_k, g_f), "ref": rel(g_r, g_f)}
        f32_held = {n: {"kernels_vs_ref": grad_rel.pop(n),
                        "kernels_vs_f32": to_f32["kernels"][n],
                        "ref_vs_f32": to_f32["ref"][n],
                        "f32_norm": float(g_f[n].norm()),
                        "ratio": to_f32["kernels"][n] / to_f32["ref"][n]}
                    for n in held}
        del g_f
    del g_r
    free = None
    if cfg.num_experts:   # and routing freely, for the record
        loss_f, norm_f, g_f = grads_of("ref", "ref_free", [])
        # assignments routed to another expert: half the summed changes of
        # the group sizes (the forward's gmm calls)
        moved = sum(int((a - b).abs().sum()) for a, b in
                    zip(routed["kernels"], routed["ref_free"])) // 2
        free = {"loss_ref": loss_f, "grad_norm_ref": norm_f,
                "grad_rel_frobenius": rel(g_k, g_f),
                "assignments_routed_elsewhere": moved,
                # the forward's, of the recorded top-k (forward and
                # recompute each route every assignment once)
                "assignments": sum(r.numel() for r in routes) // 2}
        del g_f
    del g_k

    losses = [s_["loss"] for s_ in steps]
    per_step_ok = all(s_["launches"] == want_step for s_ in steps)
    decode_ok = dec_out is None or (
        dec_out["params"] == f"member state at step {steps_n}"
        and dec_out["served"] == 2)
    ok = (all(map(math.isfinite, losses)) and per_step_ok and decode_ok
          and math.isfinite(eval_out["loss"])
          and abs(loss_k - loss_r) <= TRAIN_LOSS_TOL
          and abs(norm_k - norm_r) <= TRAIN_GRAD_RTOL * norm_r
          and all(r <= TRAIN_GRAD_RTOL for r in grad_rel.values())
          and all(h["ratio"] <= F32_HELD_RATIO
                  for h in (f32_held or {}).values())
          and peak_gb <= ENS_PEAK_LIMIT_GB)
    row = {"phase": f"train {spec['arch']}", "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
           "lru_width": cfg.lru_width, "d_inner": cfg.d_inner,
           "ssm_state": cfg.ssm_state,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "optstate_dtype": cfg.optstate_dtype, "remat": cfg.remat,
           "params": n_params, "state_gb": held_gb,
           "batch": TRAIN["batch"], "seq": TRAIN["seq"],
           "microbatches": mbs, "steps": steps_n,
           "train_tasks": "lm.train, one step a task",
           "steps_run": steps, "losses": losses,
           "step_ms_steady": sum(s_["ms"] for s_ in steps[1:])
           / max(1, len(steps) - 1),
           "launches": launches, "train_launches": train_launches,
           "launches_per_step": want_step,
           "peak_mem_gb": peak_gb, "peak_limit_gb": ENS_PEAK_LIMIT_GB,
           "eval": eval_out,
           "decode": dec_out and {n: dec_out[n]
                                  for n in ("served", "params", "tokens")},
           "vs_ref": {"microbatch": TRAIN["batch"] // mbs,
                      "loss_kernels": loss_k, "loss_ref": loss_r,
                      "loss_tol": TRAIN_LOSS_TOL, "grad_norm_kernels": norm_k,
                      "grad_norm_ref": norm_r,
                      "grad_rel_frobenius": grad_rel,
                      "grad_rtol": TRAIN_GRAD_RTOL,
                      "f32_held": f32_held,
                      "f32_held_ratio": F32_HELD_RATIO,
                      "routing": "the plain run replays the kernel run's "
                                 "top-k",
                      "gmm_calls": len(routed["kernels"]),
                      "same_group_sizes": all(
                          torch.equal(a, b) for a, b in
                          zip(routed["kernels"], routed["ref"])),
                      "free_routing": free},
           "ok": ok}
    emit(row)
    lm.STATE_STORE.clear()
    lm.CONFIG_STORE.clear()
    lm._STEP_CACHE.clear()
    del state, params, picked, layer0
    _release()
    if not ok:
        raise AssertionError(f"train phase failed: {row}")
    return row


# dryrun phase: each train and fused phase's cell (its config, shape,
# microbatches or members) is reckoned by repro_torch.launch.dryrun on fake
# tensors on the meta device, nothing allocated, in worker processes that
# see no card (so they start no CUDA context beside the phases), started
# after the build so that they run beside the kernel phases, and awaited
# before the first train phase so that no timed step shares the host with
# them.  After the
# phase its reckoned peak is held against max_memory_allocated within
# DRYRUN_PEAK_RTOL, and its tally of kernel calls must equal each measured
# step's (or cycle's) launches and the hand counts.  Train phases also get
# the roofline of the reckoned step beside the warm step's time: the
# model-FLOP share, model_flops / (step_s * HW.peak_flops).
DRYRUN_PEAK_RTOL = 0.05
DRYRUN_WORKERS = 4
# launch train: full-width gemma2-2b through repro_torch.launch.train's
# CLI at the config's one microbatch, LAUNCH_TRAIN["batch"] x 1024 when the
# dry run reckons it under ENS_PEAK_LIMIT_GB, else "fallback_batch"
LAUNCH_TRAIN = dict(arch="gemma2-2b", batch=4, fallback_batch=2, seq=1024,
                    steps=4)


def _dryrun_init(src: str) -> None:
    """A dry-run worker: no card visible (set before torch is imported)."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if src not in sys.path:
        sys.path.insert(0, src)


def _reckon(arch, batch, seq, microbatches=None, members=0, steps=1):
    """``launch.dryrun.reckon`` of a phase's cell: ``arch`` a registered
    name or ``<base>-L<n>`` (``profile_train.train_config``)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import reckon
    from repro_torch.launch.profile_train import train_config
    t = time.perf_counter()
    out = reckon(train_config(arch),
                 ShapeSpec("chip_smoke", "train", seq, batch),
                 microbatches=microbatches, members=members,
                 steps_per_cycle=steps)
    return {**out, "reckon_s": time.perf_counter() - t}


def _reckon_cells():
    """The cells of the dryrun phase: key -> ``_reckon``'s arguments."""
    from repro_torch.launch.profile_train import TRAIN
    cells = {}
    for spec in TRAIN_PHASES:
        cells[f"train {spec['arch']}"] = dict(
            arch=spec["arch"], batch=TRAIN["batch"], seq=TRAIN["seq"],
            microbatches=spec.get("microbatches", TRAIN["microbatches"]))
    for F in (FUSED, FUSED_MOE):
        cells[f"fused {F['arch']}"] = dict(
            arch=F["arch"], batch=F["batch"], seq=F["seq"],
            members=F["members"], steps=F["steps"])
    for b in (LAUNCH_TRAIN["batch"], LAUNCH_TRAIN["fallback_batch"]):
        cells[f"launch train {b}"] = dict(arch=LAUNCH_TRAIN["arch"], batch=b,
                                          seq=LAUNCH_TRAIN["seq"])
    return cells


class _Reckonings:
    """The dryrun phase's reckonings, computed in worker processes (spawned,
    no card visible); ``get(key)`` waits for one, ``wait`` for all (the
    seconds waited), ``close`` stops them."""

    def __init__(self, cells):
        import concurrent.futures
        import multiprocessing
        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=DRYRUN_WORKERS,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_dryrun_init, initargs=(str(ROOT / "src"),))
        self._futures = {k: self._pool.submit(_reckon, **kw)
                         for k, kw in cells.items()}

    def get(self, key):
        return self._futures[key].result()

    def wait(self) -> float:
        """Wait for every reckoning (raising any one's error); returns the
        seconds waited."""
        t = time.perf_counter()
        for f in self._futures.values():
            f.result()
        return time.perf_counter() - t

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


@functools.lru_cache(maxsize=None)
def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_dryrun(of, reckoning, peak_gb, measured, hand, step_ms=None):
    """The dryrun row of phase ``of``: the reckoned peak beside the
    measured ``peak_gb`` (within DRYRUN_PEAK_RTOL), the C launchers' bytes
    on their own, the tally of fake kernel calls beside the ``measured``
    launches of each step or cycle (a list) and the ``hand`` counts (all
    equal); with ``step_ms`` (a warm step), the roofline row and the
    model-FLOP share beside the card's nvidia-smi line."""
    from repro_torch.launch.mesh import HW
    calls = reckoning["kernel_calls"]
    reckoned_gb = reckoning["peak_bytes"] / 1e9
    rel = reckoned_gb / peak_gb - 1 if peak_gb else float("inf")
    tally_equal = all(m == calls for m in measured) and calls == hand
    row = {"phase": "dryrun", "of": of, "arch": reckoning["arch"],
           **{k: reckoning[k] for k in ("batch", "seq", "microbatches",
                                        "members", "device")},
           "reckoned_peak_gb": reckoned_gb, "measured_peak_gb": peak_gb,
           "peak_rel_diff": rel, "peak_rtol": DRYRUN_PEAK_RTOL,
           "param_gb": reckoning["param_bytes"] / 1e9,
           "state_gb": reckoning["state_bytes"] / 1e9,
           "host_alloc_bytes": reckoning["host_alloc"],
           "fake_calls": calls, "measured_launches": measured,
           "hand_counts": hand, "tally_equal": tally_equal,
           "reckon_s": reckoning.get("reckon_s")}
    if step_ms is not None:
        r = reckoning["roofline"]
        step_s = step_ms / 1e3
        row["roofline"] = {
            "flops": r["flops_per_dev"], "bytes": r["bytes_per_dev"],
            "t_compute_ms": 1e3 * r["t_compute"],
            "t_memory_ms": 1e3 * r["t_memory"],
            "bottleneck": r["bottleneck"], "model_flops": r["model_flops_total"],
            "useful_ratio": r["useful_ratio"], "step_ms": step_ms,
            "peak_flops": HW.peak_flops,
            "model_flop_share": r["model_flops_total"]
            / (step_s * HW.peak_flops),
            "card": _card()}
    row["ok"] = tally_equal and abs(rel) <= DRYRUN_PEAK_RTOL
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"dryrun of {of}: {row}")
    return row


def phase_launch_train(dev, reckonings):
    """``repro_torch.launch.train``'s ``main`` in this process: full-width
    gemma2-2b, LAUNCH_TRAIN's steps at the config's one microbatch, on the
    card (batch LAUNCH_TRAIN["batch"] where the dry run reckons it under
    ENS_PEAK_LIMIT_GB); finite losses, the flash launches of every step
    (all wgmma), steps and tokens a second; then its dryrun row.  Returns
    the launches."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train
    L = LAUNCH_TRAIN
    batch = L["batch"]
    why = None
    reckoning = reckonings.get(f"launch train {batch}")
    if reckoning["peak_bytes"] / 1e9 > ENS_PEAK_LIMIT_GB:
        why = (f"batch {batch} reckoned at {reckoning['peak_bytes'] / 1e9:.2f}"
               f" GB, over {ENS_PEAK_LIMIT_GB} GB")
        batch = L["fallback_batch"]
        reckoning = reckonings.get(f"launch train {batch}")
    from repro_torch.configs import get_config
    want = _launches(flash=(get_config(L["arch"]).num_layers, 1))
    steps = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    mark = {"t": time.perf_counter(), "launches": dict(LAUNCHES)}

    def on_step(i, m):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        steps.append({"step": i, "loss": float(m["loss"]),
                      "ms": 1e3 * (now - mark["t"]),
                      "launches": {n: LAUNCHES[n] - mark["launches"][n]
                                   for n in LAUNCHES
                                   if LAUNCHES[n] != mark["launches"][n]}})
        mark.update(t=time.perf_counter(), launches=dict(LAUNCHES))
    history = launch_train.main(
        ["--arch", L["arch"], "--batch", str(batch), "--seq", str(L["seq"]),
         "--steps", str(L["steps"]), "--device", str(dev)], on_step=on_step)
    torch.cuda.synchronize(dev)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {n: c for n, c in LAUNCHES.items() if c}
    _release()
    warm = [s_["ms"] for s_ in steps[1:]] or [steps[0]["ms"]]
    step_ms = sum(warm) / len(warm)
    tokens = batch * L["seq"]
    losses = [h["loss"] for h in history]
    ok = (len(steps) == L["steps"] and all(map(math.isfinite, losses))
          and all(s_["launches"] == want for s_ in steps)
          and peak_gb <= ENS_PEAK_LIMIT_GB)
    row = {"phase": "launch train", "arch": L["arch"], "batch": batch,
           "seq": L["seq"], "microbatches": 1, "steps": L["steps"],
           "batch_fallback_reason": why, "history": history,
           "steps_run": steps, "launches": launches,
           "launches_per_step": want, "step_ms_steady": step_ms,
           "steps_per_s": 1e3 / step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "peak_mem_gb": peak_gb,
           "peak_limit_gb": ENS_PEAK_LIMIT_GB, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"launch train phase failed: {row}")
    phase_dryrun("launch train", reckoning, peak_gb,
                 [s_["launches"] for s_ in steps], want, step_ms=step_ms)
    return launches


# ensemble phase: RE and SAL apps of full-width gemma2-2b members cut to 4
# layers (two local/global pairs; a full-depth member holds 31.4 GB of
# state, so four would not fit), run by the port's pilot with two member
# tasks at once on the card.  One lm.train step of a member at one
# microbatch launches the flash forward twice a layer (remat recomputes it
# in the backward) and the backward once; lm.eval launches the forward once
# a layer.  The peak is reckoned as the members' f32 params and Adam
# moments (12 bytes a parameter) plus ENS_STEP_GB for each step in flight.
ENSEMBLE = dict(base="gemma2-2b", arch="gemma2-2b-L4", layers=4, replicas=4,
                cycles=2, sal_sims=2, sal_iters=2, cores=2, batch=2,
                seq=1024, microbatches=1, seed=0)
ENS_TRAIN_LAUNCHES = _launches(flash=(ENSEMBLE["layers"],
                                      ENSEMBLE["microbatches"]))
ENS_EVAL_LAUNCHES = {"flash_attention": 4, "flash_attention.wgmma": 4}
SAL_MAX_ITERS = 5   # the loop's own rule stops it after sal_iters
ENS_STEP_GB = 15.0
ENS_PEAK_LIMIT_GB = 76.0
ENS_RERUN_RTOL = 1e-3


# the ensemble phase's replica-exchange losses and temperatures, which the
# federation phase's first run must give again
ENSEMBLE_RE = {}


def _ensemble_cfg():
    """``ENSEMBLE["arch"]``: the full-width base config at ``layers``
    layers, registered once."""
    return _cut_cfg(ENSEMBLE["arch"], ENSEMBLE["base"], ENSEMBLE["layers"])


def _expected_launches(train_steps, evals):
    out = {}
    for per, n in ((ENS_TRAIN_LAUNCHES, train_steps),
                   (ENS_EVAL_LAUNCHES, evals)):
        for name, k in per.items():
            out[name] = out.get(name, 0) + k * n
    return out


def _run_app(dev, app, ensemble):
    """Run ``app`` on a ``cuda.`` pilot with ``ENSEMBLE["cores"]`` slots
    from all-zero launch counts and peak; return (profile, launches, peak
    GB), raising with the journal's errors if a task failed or was retried.
    The member states of ``ensemble`` stay in ``lm.STATE_STORE``."""
    import tempfile

    import torch

    from repro_torch.core import SingleClusterEnvironment
    from repro_torch.kernels import LAUNCHES, reset_launches
    with tempfile.TemporaryDirectory() as tmp:
        cl = SingleClusterEnvironment(resource="cuda.h100",
                                      cores=ENSEMBLE["cores"],
                                      database_url=tmp, database_name=ensemble)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        cl.allocate()
        try:
            prof = cl.run(app)
        finally:
            cl.deallocate()
        torch.cuda.synchronize(dev)
        launches = {n: c for n, c in LAUNCHES.items() if c}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if prof.n_failed or prof.n_retries:
            with open(cl.journal_path) as f:
                errors = [json.loads(line).get("error") for line in f]
            raise AssertionError(
                f"ensemble {ensemble}: {prof.n_failed} failed, "
                f"{prof.n_retries} retried: {[e for e in errors if e]}")
    return prof, launches, peak_gb


def _re_app(replicas, cycles, train, ensemble, seed, temps):
    """The RE pattern of tests/test_system.py: ``replicas`` members trained
    by ``lm.train`` tasks with ``train``'s arguments at their temperatures
    (learning rates, from ``temps``), and the host exchange after each
    cycle; ``temp_history`` records the temperatures."""
    from repro_torch.core import Kernel, ReplicaExchange

    class PBT(ReplicaExchange):
        def __init__(self):
            super().__init__(cycles, replicas)
            self.temps = list(temps)
            self.temp_history = [list(self.temps)]

        def prepare_replica_for_md(self, r):
            k = Kernel("lm.train")
            k.arguments = {**train, "member": r.id, "ensemble": ensemble,
                           "lr": self.temps[r.id]}
            return k

        def prepare_exchange(self, replicas_):
            k = Kernel("re.exchange")     # the host swap: no "device"
            k.arguments = {"replicas": len(replicas_),
                           "cycle": replicas_[0].cycle, "temps": self.temps,
                           "ensemble": ensemble, "seed": seed}
            return k

        def apply_exchange(self, result, replicas_):
            self.temps = result["temps"]
            self.temp_history.append(list(self.temps))
    return PBT()


def _ttc(prof):
    """The paper's TTC decomposition and the run's counts."""
    return {"ttc": prof.ttc, "t_exec": prof.t_exec, "t_data": prof.t_data,
            "t_enmd_overhead": prof.t_enmd_overhead,
            "t_core_overhead": prof.t_core_overhead,
            "t_pattern_overhead": prof.t_pattern_overhead,
            "t_rts_overhead": prof.t_rts_overhead,
            "utilization": prof.utilization, "n_tasks": prof.n_tasks,
            "n_failed": prof.n_failed, "n_retries": prof.n_retries}


def _drop_members(ensemble):
    from repro_torch.plugins import lm
    for sid in [s for s in lm.STATE_STORE if s[0] == ensemble]:
        del lm.STATE_STORE[sid]
        lm.CONFIG_STORE.pop(sid, None)
    _release()


def phase_ensemble(dev):
    """RE and SAL ensembles of ``ENSEMBLE["arch"]`` members through the
    port's front end (``repro_torch.core``), two tasks at once on the card;
    one JSON line per app.  Raises unless every task succeeded with a finite
    loss, the swaps kept the temperature multiset and replay from the
    recorded losses, every attention call went through the hand kernels
    (exact launch counts, taken under concurrency), member 0's first task
    run again alone gives its loss, and the peak stays under the limit."""
    import torch

    from repro_torch.core import Kernel, SimulationAnalysisLoop
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.plugins import lm
    from repro_torch.plugins.re_exchange import metropolis_swaps

    cfg = _ensemble_cfg()
    E = ENSEMBLE
    train = {"arch": cfg.name, "device": str(dev), "steps": 1,
             "batch": E["batch"], "seq": E["seq"],
             "microbatches": E["microbatches"], "seed": E["seed"]}
    tokens = E["batch"] * E["seq"]
    state_gb = 12 * cfg.param_count() / 1e9
    predicted = {"state_gb_per_member": state_gb,
                 "peak_gb": E["replicas"] * state_gb
                 + E["cores"] * ENS_STEP_GB}
    emit({"phase": "ensemble", "predicted": predicted, "config": E})

    class TrainUntil(SimulationAnalysisLoop):
        def simulation_stage(self, it, i):
            k = Kernel("lm.train")
            k.arguments = {**train, "member": i, "ensemble": "ens_sal"}
            return k

        def analysis_stage(self, it, j):
            k = Kernel("lm.eval")
            k.arguments = {n: train[n] for n in ("arch", "device", "batch",
                                                 "seq")}
            k.arguments.update(member=j, ensemble="ens_sal")
            return k

        def should_continue(self, it, results):   # as tests/test_system.py
            return results[0]["loss"] > 1.0 and it < E["sal_iters"] - 1

    path_launches = {}

    def report(row):
        emit(row)
        for name, n in row["launches"].items():
            path_launches[name] = path_launches.get(name, 0) + n
        return row

    # ---- replica exchange
    app = _re_app(E["replicas"], E["cycles"], train, "ens_re", E["seed"],
                  [3e-4 * 1.5 ** i for i in range(E["replicas"])])
    prof, launches, peak_gb = _run_app(dev, app, "ens_re")
    members = [lm.STATE_STORE[("ens_re", i)] for i in range(E["replicas"])]
    n_params = sum(p.numel() for p in tree_leaves(members[0]["params"]))
    held_gb = sum(t.numel() * t.element_size() for m in members
                  for t in tree_leaves([m["params"], m["opt"]["m"],
                                        m["opt"]["v"]])) / 1e9
    del members
    _drop_members("ens_re")
    steps = E["replicas"] * E["cycles"]
    xs = [prof.results[f"exchange_{c}"] for c in range(E["cycles"])]
    losses = [x["losses"] for x in xs]
    replay = [list(app.temp_history[0])]
    for c, x in enumerate(xs):
        new, _ = metropolis_swaps(x["losses"], replay[-1], c, E["seed"])
        replay.append([float(t) for t in new])
    # member 0's first task again, alone, from the same seed
    k = Kernel("lm.train")
    k.arguments = {**train, "member": 0, "ensemble": "ens_rerun",
                   "lr": app.temp_history[0][0]}
    rerun = k.execute()["loss"]
    torch.cuda.synchronize(dev)
    _drop_members("ens_rerun")
    first = losses[0][0]
    want = _expected_launches(steps, 0)
    ok = (all(math.isfinite(v) for c in losses for v in c)
          and all(sorted(t) == sorted(app.temp_history[0])
                  for t in app.temp_history)
          and replay == app.temp_history and launches == want
          and abs(rerun - first) <= ENS_RERUN_RTOL * abs(first)
          and peak_gb <= ENS_PEAK_LIMIT_GB)
    ENSEMBLE_RE.update(losses=losses, temps=app.temp_history)
    re_row = report({"phase": "ensemble", "app": "replica_exchange",
                     "arch": cfg.name, "layers": cfg.num_layers,
                     "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                     "params": n_params, "members": E["replicas"],
                     "cycles": E["cycles"], "cores": E["cores"],
                     "batch": E["batch"], "seq": E["seq"], **_ttc(prof),
                     "train_steps": steps,
                     "tokens_per_s": steps * tokens / prof.ttc,
                     "losses": losses, "temps": app.temp_history,
                     "temps_replayed": replay,
                     "accepted": [x["accepted"] for x in xs],
                     "states_gb": held_gb, "peak_mem_gb": peak_gb,
                     "predicted_peak_gb": predicted["peak_gb"],
                     "peak_limit_gb": ENS_PEAK_LIMIT_GB,
                     "launches": launches, "launches_expected": want,
                     "rerun_alone": {"loss": rerun, "in_ensemble": first,
                                     "rel_diff": abs(rerun - first) / abs(first),
                                     "rtol": ENS_RERUN_RTOL,
                                     "bitwise_equal": rerun == first},
                     "ok": ok})
    # ---- simulation-analysis loop
    prof, launches, peak_gb = _run_app(dev, TrainUntil(
        SAL_MAX_ITERS, E["sal_sims"], 1), "ens_sal")
    _drop_members("ens_sal")
    iters = sum(1 for c in range(SAL_MAX_ITERS)
                if f"analysis_{c}" in prof.results)
    steps = iters * E["sal_sims"]
    sim_losses = [[prof.results["tasks"][f"iter{it:04d}.sim{i:05d}"]["loss"]
                   for i in range(E["sal_sims"])] for it in range(iters)]
    eval_losses = [[r["loss"] for r in prof.results[f"analysis_{it}"]]
                   for it in range(iters)]
    want = _expected_launches(steps, iters)
    sal_ok = (iters == E["sal_iters"]
              and all(math.isfinite(v) for c in sim_losses + eval_losses
                      for v in c)
              and launches == want and peak_gb <= ENS_PEAK_LIMIT_GB)
    sal_row = report({"phase": "ensemble", "app": "simulation_analysis_loop",
                      "arch": cfg.name, "layers": cfg.num_layers,
                      "members": E["sal_sims"], "iterations": iters,
                      "cores": E["cores"], "batch": E["batch"], "seq": E["seq"],
                      **_ttc(prof), "train_steps": steps,
                      "tokens_per_s": steps * tokens / prof.ttc,
                      "train_losses": sim_losses, "eval_losses": eval_losses,
                      "peak_mem_gb": peak_gb, "launches": launches,
                      "launches_expected": want, "ok": sal_ok})
    lm._STEP_CACHE.clear()
    _release()
    if not (ok and sal_ok):
        raise AssertionError(f"ensemble phase failed: {[re_row, sal_row]}")
    return path_launches


# federation phase: the ensemble phase's RE app (ENSEMBLE's gemma2-2b-L4
# members, batch, seq, seed and temperatures) on a fleet of two pilots of
# one slot each, both on the one card (repro_torch.federation.build_fleet
# (2, slots=1, mode="real")): every task late-binds to a pilot when it
# launches, each pilot writes its own journal, and a repro_torch.obs.Tracer
# records the fleet.  Run 1 runs the app as it is.  Run 2 loses pilot
# FED["lost"] once its first lm.train attempt runs (Fleet.
# inject_pilot_failure from the pilots' on_schedule hook): that attempt's
# span ends "pod_lost" and its retry runs on the other pilot, while the
# lost attempt, which cannot be stopped, trains on as a zombie (ROADMAP
# C5), so that its member ends one step further than the others.  Run 1
# gives the ensemble phase's losses: a member's step runs the same kernels
# (the flash backward repeats bitwise) on the same state, batch and
# learning rate whichever pilot runs it, two steps at a time on the card
# in both phases.
FED = dict(pilots=2, slots=1, lost="p2")
FED_LOSS_RTOL = ENS_RERUN_RTOL
# a slot's exec seconds by its pilot's journal (time.time stamps) against
# the live tracer's (perf_counter): the two are stamped a few statements
# apart when an attempt launches and when it ends, but the journal's write
# can hand the interpreter lock to another task's thread for a switch
# interval (5 ms) in between, so within FED_DECOMP_TOL_S an attempt (on
# an H100 80GB HBM3 at 700 W: at most 0.24 ms an attempt)
FED_DECOMP_TOL_S = 0.02
ZOMBIE_JOIN_S = 300.0


def _fleet_run(dev, app, tag, jdir, lose=None):
    """Run the pattern ``app`` on a new fleet of FED's pilots, journals
    under ``jdir``, a Tracer attached, from all-zero launch counts and
    peak; ``lose`` names a pilot lost once its first lm.train attempt runs.
    Joins the lost attempt's thread.  Returns (profile, fleet, tracer,
    launches, peak GB, wall s, {"task", "attempt"} of the lost attempt)."""
    import os
    from unittest import mock

    import torch

    from repro_torch.core import AppManager
    from repro_torch.core.execution_plugin import get_plugin
    from repro_torch.federation import build_fleet
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import Tracer
    from repro_torch.runtime.states import TaskState

    with mock.patch.dict(os.environ, {"REPRO_JOURNAL_DIR": jdir}):
        fleet = build_fleet(FED["pilots"], slots=FED["slots"], mode="real",
                            journal_base=tag)
    fleet.tracer = tracer = Tracer()
    lost = {}

    def chaos(rt, graph, now):
        if lost:
            return
        for t in graph.tasks.values():
            if (t.state == TaskState.RUNNING and ".md" in t.name
                    and t.meta.get("pilot") == lose):
                lost.update(task=t.name, attempt=t.attempts)
                fleet.inject_pilot_failure(lose)
                return
    if lose is not None:
        for rt in fleet.pilots.values():
            rt.on_schedule = chaos
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    try:
        plugin = get_plugin(app, fleet)       # as plugin.execute() runs it
        pipes = plugin.compile()
        plugin.profile.t_pattern_overhead += time.perf_counter() - t0
        am = AppManager(fleet, profile=plugin.profile)
        prof = am.run(pipes)
        for th in list(am.session._zombie_threads):
            th.join(ZOMBIE_JOIN_S)
            if th.is_alive():
                raise AssertionError(f"{tag}: the lost attempt's thread "
                                     f"still runs after {ZOMBIE_JOIN_S} s")
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        fleet.close()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    return prof, fleet, tracer, launches, peak_gb, wall, lost


def _journal_checks(jdir, tracer):
    """The port's own ``obs decompose`` (JSON) and ``analysis sanitize``
    over a run's journals, their exit codes, and each slot's decomposition
    against the live tracer's (attempt counts equal, exec seconds within
    FED_DECOMP_TOL_S an attempt)."""
    import io

    from repro_torch.analysis.__main__ import main as analysis_cli
    from repro_torch.obs import decompose
    from repro_torch.obs.__main__ import main as obs_cli
    from repro_torch.obs.report import segment_from_tracer
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_decompose = obs_cli(["decompose", jdir, "--json"])
    journals = [json.loads(line) for line in out.getvalue().splitlines()]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_sanitize = analysis_cli(["sanitize", jdir])
    live = decompose(segment_from_tracer(tracer))["slots"]
    slots = {label: c for j in journals for label, c in j["slots"].items()}
    counts = ("n_attempts", "n_preempted", "n_pod_lost")
    # the largest difference of a slot's exec seconds, per attempt
    exec_diff = max((abs(slots[n][k] - live[n][k])
                     / max(slots[n]["n_attempts"], 1)
                     for n in slots if n in live
                     for k in ("t_exec", "t_exec_lost")), default=math.inf)
    same = (sorted(slots) == sorted(live)
            and all(slots[n][k] == live[n][k] for n in slots
                    for k in counts)
            and exec_diff <= FED_DECOMP_TOL_S)
    return {"decompose_rc": rc_decompose, "sanitize_rc": rc_sanitize,
            "sanitize": out.getvalue().splitlines(),
            "journals": {j["journal"]: {"window_s": j["window"][1]
                                        - j["window"][0],
                                        "residual_max": j["residual_max"],
                                        "n_open": j["n_open"],
                                        "totals": j["totals"]}
                         for j in journals},
            "slots": {n: {k: c[k] for k in ("t_exec", "t_exec_lost",
                                             *counts)}
                      for n, c in slots.items()},
            "slots_live": {n: {k: c[k] for k in ("t_exec", "t_exec_lost",
                                                  *counts)}
                           for n, c in live.items()},
            "exec_s_max_diff_per_attempt": exec_diff,
            "exec_s_tol_per_attempt": FED_DECOMP_TOL_S,
            "journals_equal_tracer": same}


def phase_federation(dev):
    """The ensemble phase's RE app on a two-pilot fleet on the card, twice
    (FED; the second run loses a pilot mid-task); one JSON line per run
    after the card's line.  Raises unless no task failed, both pilots took
    work in run 1, the swaps kept the temperature multiset and replay from
    the recorded losses, run 1's losses are the ensemble phase's
    (``ENSEMBLE_RE``) within FED_LOSS_RTOL and its temperatures equal, the
    flash launches are exact (the lost attempt's step included), the lost
    attempt's span ended pod_lost and its retry ran on the other pilot,
    the members end at their steps, the journals decompose (exit 0) as
    the tracer does and pass the sanitizer, and the peak stays under
    ENS_PEAK_LIMIT_GB.
    Returns the flash launches of both runs."""
    import os
    import tempfile

    from repro_torch.plugins import lm
    from repro_torch.plugins.re_exchange import metropolis_swaps

    cfg = _ensemble_cfg()
    E = ENSEMBLE
    train = {"arch": cfg.name, "device": str(dev), "steps": 1,
             "batch": E["batch"], "seq": E["seq"],
             "microbatches": E["microbatches"], "seed": E["seed"]}
    temps0 = [3e-4 * 1.5 ** i for i in range(E["replicas"])]
    emit({"phase": "federation", "config": {**FED, **E}})
    print(_card(), flush=True)
    path_launches, rows = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for run, lose in ((1, None), (2, FED["lost"])):
            tag = f"fed_run{run}"
            jdir = os.path.join(tmp, tag)
            app = _re_app(E["replicas"], E["cycles"], train, tag, E["seed"],
                          temps0)
            prof, fleet, tracer, launches, peak_gb, wall, lost = _fleet_run(
                dev, app, tag, jdir, lose)
            steps_held = {i: int(lm.STATE_STORE[(tag, i)]["step"])
                          for i in range(E["replicas"])}
            _drop_members(tag)
            md = [s for s in tracer.spans
                  if s["cat"] == "task" and ".md" in s["task"]]
            xs = [prof.results[f"exchange_{c}"] for c in range(E["cycles"])]
            losses = [x["losses"] for x in xs]
            replay = [list(app.temp_history[0])]
            for c, x in enumerate(xs):
                new, _ = metropolis_swaps(x["losses"], replay[-1], c,
                                          E["seed"])
                replay.append([float(t) for t in new])
            want = _expected_launches(len(md), 0)
            dispatch = prof.results["federation"]["dispatch"]
            checks = _journal_checks(jdir, tracer)
            want_steps = {i: E["cycles"] for i in range(E["replicas"])}
            ok = (prof.n_failed == 0
                  and all(math.isfinite(v) for c in losses for v in c)
                  and all(sorted(t) == sorted(temps0)
                          for t in app.temp_history)
                  and replay == app.temp_history and launches == want
                  and peak_gb <= ENS_PEAK_LIMIT_GB
                  and checks["decompose_rc"] == 0
                  and checks["sanitize_rc"] == 0
                  and checks["journals_equal_tracer"]
                  and not [s for s in tracer.unpaired()
                           if s["cat"] == "task"])
            row = {"phase": "federation", "run": run, "lost_pilot": lose,
                   "arch": cfg.name, "members": E["replicas"],
                   "cycles": E["cycles"], "pilots": FED["pilots"],
                   "slots_per_pilot": FED["slots"], "batch": E["batch"],
                   "seq": E["seq"], **_ttc(prof),
                   "dispatch": dispatch,
                   "bytes_cross_pilot":
                       fleet.staging.planner.summary()["bytes_cross_pilot"],
                   "timeline_samples":
                       prof.results["timeseries"]["n_samples"],
                   "trace": prof.results["trace"],
                   "train_attempts": len(md),
                   "tokens_per_s": E["replicas"] * E["cycles"] * E["batch"]
                   * E["seq"] / prof.ttc,
                   "losses": losses, "temps": app.temp_history,
                   "temps_replayed": replay,
                   "accepted": [x["accepted"] for x in xs],
                   "member_steps": steps_held,
                   "peak_mem_gb": peak_gb,
                   "peak_limit_gb": ENS_PEAK_LIMIT_GB, "wall_s": wall,
                   "launches": launches, "launches_expected": want,
                   **checks}
            if run == 1:
                got = [v for c in losses for v in c]
                ref = [v for c in ENSEMBLE_RE["losses"] for v in c]
                row["ensemble_phase"] = {
                    "losses": ENSEMBLE_RE["losses"],
                    "max_rel_diff": max(abs(a - b) / abs(b)
                                        for a, b in zip(got, ref)),
                    "rtol": FED_LOSS_RTOL,
                    "bitwise_equal": got == ref,
                    "temps_equal": app.temp_history == ENSEMBLE_RE["temps"]}
                ok = (ok and prof.n_retries == 0
                      and len(dispatch) == FED["pilots"]
                      and min(dispatch.values()) >= 1
                      and row["ensemble_phase"]["max_rel_diff"]
                      <= FED_LOSS_RTOL
                      and row["ensemble_phase"]["temps_equal"]
                      and steps_held == want_steps)
            else:
                spans = [s for s in md if s["task"] == lost.get("task")]
                member = int(lost["task"].rpartition("md")[2]) if lost \
                    else None
                want_steps[member] = E["cycles"] + 1
                row["lost_attempt"] = {**lost, "member": member,
                                       "spans": spans}
                ok = (ok and prof.n_retries == 1
                      and [(s["attempt"], s["pilot"], s["outcome"])
                           for s in spans]
                      == [(1, lose, "pod_lost"), (2, "p1", "done")]
                      and steps_held == want_steps)
            row["member_steps_expected"] = want_steps
            row["ok"] = ok
            emit(row)
            rows.append(row)
            for name, n in launches.items():
                path_launches[name] = path_launches.get(name, 0) + n
            _release()
    lm._STEP_CACHE.clear()
    _release()
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"federation phase failed: {rows}")
    return path_launches


# fused phase: a FusedEnsemble of FUSED["members"] full-width gemma2-2b
# members cut to FUSED["layers"] layers (core/ensemble.py: members stacked on
# a leading axis, one vmapped train step for all, the exchange on the
# device), FUSED["cycles"] cycles of FUSED["steps"] step at batch 1 of 1024
# tokens, as tests/test_system.py's RE pattern has 4 members; then the same
# members and config in task mode (the RE pattern on a 2-slot cuda.h100
# pilot, as the ensemble phase runs it), then one re.exchange task with
# device="cuda".  The flash launches of a fused step are one member's
# (two forward, one backward a layer): the vmap rule folds the members into
# the kernel's batch.  4 members at 4 layers (gemma2-2b-L4, reckoned 69.5
# GB) peaked at 76.7 GB on the H100, over the 76 GB limit, so the depth is
# cut to 2 layers (one local, one global).  The peak is reckoned
# (PERF.md) at the loss's backward: the
# members' f32 params and Adam moments (12 bytes a parameter), the tied
# LM head's f32 gradient (V x d_model, 4 bytes, a member) and four
# logits-sized f32 temporaries of a member's loss chunk (1024 x V); at the
# end of the backward: every gradient (16 bytes a parameter in all) and the
# embedding gather's dense gradient, one more V x d_model a member.
FUSED = dict(base="gemma2-2b", arch="gemma2-2b-L2", layers=2, members=4,
             cycles=2, steps=1, batch=1, seq=1024, seed=0, task_mode=True)
# An MoE population: 2 full-width qwen3-moe-30b-a3b members cut to 1
# layer (1.245B params each, reckoned at 42.3 GB; 3 members would reckon
# to ~64 GB, too near the limit), no task mode.  gmm's vmap rule folds the
# members into its expert axis (2 x 128 experts): one launch a call for
# both members, the forward on wgmma.
FUSED_MOE = dict(base="qwen3-moe-30b-a3b", arch="qwen3-moe-30b-a3b-L1",
                 layers=1, members=2, cycles=2, steps=1, batch=1, seq=1024,
                 seed=0, task_mode=False)


def phase_fused(dev, F=FUSED, rows=None):
    """FusedEnsemble of ``F`` through ``_build_cycle`` (the reference
    benchmark's entry, benchmarks/fused_dispatch.py): per cycle the losses
    (cross-entropy + 0.01 aux), temperatures, accepted pairs, the seconds
    until the cycle returns its metrics to the host and until the device is
    idle, the launches; asserts one member's kernel launches a step (flash,
    and an MoE arch's gmm and gmm_bwd), the temperature multiset, the swaps
    replayed on the host from the losses and uniforms, finite losses and
    the peak.  Then, where ``F["task_mode"]``, task mode and re.exchange
    on the device.  Returns the launches; ``rows`` (a list) also takes the
    phase's row."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import FusedEnsemble, Kernel
    from repro_torch.core.ensemble import (
        _stack_steps,
        draw_uniforms,
        metropolis_swap_device,
    )
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.plugins.re_exchange import exchange_uniforms

    cfg = _cut_cfg(F["arch"], F["base"], F["layers"])
    n = F["members"]
    per = {"flash": (F["layers"], F["steps"])}
    if cfg.num_experts:
        per["moe"] = (F["layers"], F["steps"])
    want = _launches(**per)   # one member's
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fe = FusedEnsemble(cfg, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(F["seed"])
    t = time.perf_counter()
    ens = fe.init(gen)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    temps0 = ens["temps"].cpu()
    shape = ShapeSpec("fused", "train", F["seq"], F["batch"])
    cyc = fe._build_cycle(F["steps"], shape)
    data = [SyntheticLM(cfg, shape, seed=i, device=dev) for i in range(n)]
    cycles, ok = [], True
    for c in range(F["cycles"]):
        batches = {k: torch.stack([_stack_steps(d, c * F["steps"],
                                                F["steps"])[k] for d in data])
                   for k in ("tokens", "labels")}
        u = draw_uniforms(n, gen)
        u_host, temps_before = u.cpu(), ens["temps"].cpu()
        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        ens, m = cyc(ens, batches, u)
        return_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        total_s = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        new_t, n_acc = metropolis_swap_device(
            torch.from_numpy(m["losses"]), temps_before, c, u_host)
        replayed = (np.array_equal(new_t.numpy(), m["temps"])
                    and int(n_acc) == m["accepted"])
        kept = sorted(m["temps"].tolist()) == sorted(temps0.tolist())
        finite = bool(np.isfinite(m["losses"]).all())
        ok = ok and replayed and kept and finite and launches == want
        cycles.append({"cycle": c, "losses": m["losses"].tolist(),
                       "temps": m["temps"].tolist(),
                       "accepted": m["accepted"], "uniforms": u_host.tolist(),
                       "return_s": return_s, "total_s": total_s,
                       "launches": launches, "swaps_replayed": replayed,
                       "temps_multiset_kept": kept, "finite": finite})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = ens["members"]["step"].tolist()
    ok = ok and steps == [F["cycles"] * F["steps"]] * n \
        and peak_gb <= ENS_PEAK_LIMIT_GB
    last = cycles[-1]
    del ens, fe, batches, data
    _release()

    row = {"phase": "fused", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "num_experts": cfg.num_experts, "params": cfg.param_count(),
           "members": n, "cycles": F["cycles"],
           "steps_per_cycle": F["steps"], "batch": F["batch"],
           "seq": F["seq"], "init_s": init_s, "fused_cycles": cycles,
           "launches_per_cycle_expected": want, "peak_mem_gb": peak_gb,
           "peak_limit_gb": ENS_PEAK_LIMIT_GB, "member_steps": steps,
           "per_cycle": {"fused_return_s": [c_["return_s"] for c_ in cycles],
                         "fused_total_s": [c_["total_s"] for c_ in cycles]}}
    path = {}
    if F["task_mode"]:
        # the same members and config in task mode, on a 2-slot pilot
        train = {"arch": cfg.name, "device": str(dev), "steps": F["steps"],
                 "batch": F["batch"], "seq": F["seq"], "microbatches": 1,
                 "seed": F["seed"]}
        app = _re_app(n, F["cycles"], train, "fused_task", F["seed"],
                      temps0.tolist())
        prof, task_launches, task_peak_gb = _run_app(dev, app, "fused_task")
        _drop_members("fused_task")
        task_want = {k: v * n * F["cycles"] for k, v in want.items()}
        task = {**_ttc(prof), "ttc_per_cycle": prof.ttc / F["cycles"],
                "dispatch_per_cycle": (prof.t_rts_overhead
                                       + prof.t_pattern_overhead)
                / F["cycles"],
                "temps": app.temp_history, "launches": task_launches,
                "launches_expected": task_want, "peak_mem_gb": task_peak_gb}
        ok = ok and task_launches == task_want
        path = dict(task_launches)

        # one re.exchange task on the device, from the fused run's last
        # cycle
        k = Kernel("re.exchange")
        k.arguments = {"replicas": n, "cycle": F["cycles"],
                       "temps": last["temps"], "losses": last["losses"],
                       "device": str(dev), "seed": F["seed"]}
        x = k.execute()
        u = exchange_uniforms(n, F["seed"], F["cycles"], dev)
        new_t, n_acc = metropolis_swap_device(
            torch.tensor(last["losses"], dtype=torch.float32, device=dev),
            torch.tensor(last["temps"], dtype=torch.float32, device=dev),
            F["cycles"], u)
        x_same = (np.array_equal(np.float32(x["temps"]), new_t.cpu().numpy())
                  and len(x["accepted"]) == int(n_acc))
        ok = ok and x_same
        row["task_mode"] = task
        row["per_cycle"].update(task_ttc_s=task["ttc_per_cycle"],
                                task_dispatch_s=task["dispatch_per_cycle"])
        row["exchange_on_device"] = {"result": x, "same_as_swap": x_same,
                                     "uniforms": u.cpu().tolist()}
    row["ok"] = ok
    emit(row)
    if rows is not None:
        rows.append(row)
    _release()
    if not ok:
        raise AssertionError(f"fused phase failed: {row}")
    for c_ in cycles:
        for name, v in c_["launches"].items():
            path[name] = path.get(name, 0) + v
    return path


# serve_ensemble phase: examples/serve_ensemble.py's application in real
# mode on a cuda.h100 pilot with preempt=True.  Its traffic (SE_TRAFFIC), the
# Channel budget, the deadlines, the pilot's staging layer and the serving
# app's DES cost model are the example's.  Cuts: its first SE["windows"] of
# 8 windows; decode_slots 16 (benchmarks/serve.py's SERVE_ARGS); 4 pilot
# slots for the example's 8 (sized to the card: two members' train steps
# and one 2-core serve window fill it, so latency windows evict their way
# in, as the example's training bag makes them).  The example's
# synthetic.noop training bag becomes SE["members"] gemma2-2b-L4 members
# (the ensemble phase's config) trained for SE["cycles"] lm.train cycles of
# one step, then checkpointed by lm.checkpoint, all at sla "throughput".
# Each serve.decode decodes its window with full-width minicpm-2b (the
# config's f32 params, seed 0).  The peak is reckoned as the members' f32
# params and Adam moments, minicpm-2b's params, the decode caches of the
# servers that may run at once (two windows and their zombies) and
# ENS_STEP_GB for each train step in flight: at most one a member, since
# the tasks of a member (a preempted attempt's zombie among them) take
# turns on its lock.
SE_TRAFFIC = dict(seed=11, window_s=5.0, base_rps=4.0, peak_rps=16.0,
                  period_s=120.0, burst_prob=0.1, prompt_tokens=32,
                  latency_new_tokens=8, throughput_new_tokens=24)
SE = dict(arch="minicpm-2b", windows=4, decode_slots=16, serve_cores=2,
          slots=4, capacity_bytes=64 << 10, step_cost_s=0.02,
          prefill_cost_s=0.05, deadlines={"latency": 8.0, "throughput": 120.0},
          members=2, cycles=2, batch=2, seq=1024, microbatches=1, seed=0,
          servers_at_once=4)


def _journal_walls(path):
    """{task: wall seconds of its finished attempt} from a journal (a
    preempted attempt's zombie writes no record)."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == "finished":
                out[rec["task"]] = rec["wall"]
    return out


def _decode_alone(dev, cfg, params):
    """ms of one prefill of SE["decode_slots"] prompts and of one decode
    step over them, with nothing else on the card (after the app)."""
    import torch

    from repro_torch.serve import build_prefill_step, build_serve_step
    B, S0 = SE["decode_slots"], SE_TRAFFIC["prompt_tokens"]
    max_len = S0 + SE_TRAFFIC["throughput_new_tokens"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    prefill = build_prefill_step(cfg, cache_len=max_len)
    step = build_serve_step(cfg)
    with torch.inference_mode():
        prefill_ms = time_ms(lambda: prefill(params, {"tokens": tokens}), 3)
        out = prefill(params, {"tokens": tokens})
        cache, last = out["cache"], out["logits"][:, 0].argmax(-1)
        pos = torch.full((B,), S0, dtype=torch.int32, device=dev)
        decode_ms = time_ms(lambda: step(params, cache, last[:, None], pos),
                            8)
    return {"batch": B, "prompt_len": S0, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms,
            "step_cost_ms_assumed": 1e3 * SE["step_cost_s"],
            "prefill_cost_ms_assumed": 1e3 * SE["prefill_cost_s"]}


def _admission_check(dev, cfg, params, model):
    """The first admission prefill of the phase's largest window, rebuilt
    from the inputs ``serve.decode`` gave it (16 slots of 32-token prompts,
    empty slots all zero), through the kernels and through the plain
    versions: the logits' largest difference, within LOGIT_TOL."""
    import numpy as np
    import torch

    from repro_torch.serve import build_prefill_step
    sla, k = max(((sla, k) for sla in ("latency", "throughput")
                  for k in range(SE["windows"])),
                 key=lambda w: len(model.requests(w[1], w[0])))
    reqs = model.requests(k, sla)
    B, S0 = SE["decode_slots"], SE_TRAFFIC["prompt_tokens"]
    rows = [torch.as_tensor(np.random.default_rng(r.rid).integers(
                0, cfg.vocab_size, S0)) for r in reqs[:B]]
    rows += [torch.zeros(S0, dtype=torch.int64)] * (B - len(rows))
    tokens = torch.stack(rows).to(dev)
    max_len = S0 + max(r.max_new_tokens for r in reqs)
    with torch.inference_mode():
        lk = build_prefill_step(cfg, cache_len=max_len)(
            params, {"tokens": tokens})["logits"]
        lr = build_prefill_step(cfg, cache_len=max_len, impl="ref")(
            params, {"tokens": tokens})["logits"]
    live = min(len(reqs), B)
    err = float((lk - lr).abs().max())
    return {"window": f"serve.{sla}.w{k:05d}", "batch": B, "prompt_len": S0,
            "joiners": live, "logit_max_abs_err": err,
            "logit_ref_max_abs": float(lr.abs().max()), "tol": LOGIT_TOL,
            "finite": bool(torch.isfinite(lk).all()),
            "argmax_agreement": float((lk[:live, 0].argmax(-1)
                                       == lr[:live, 0].argmax(-1))
                                      .float().mean())}


def _latency_bound(metrics, graph, deadlines):
    """Per class, each request's latency up to the end of its window's
    ``serve.decode`` task, on the wall clock (arrivals placed as
    ``ServingMetrics`` places them in real mode): a measured upper bound,
    where ``prof.results["serving"]`` places the finishes by the cost
    model's offsets."""
    import numpy as np

    from repro_torch.runtime.states import TaskState
    per = {}
    w_s = metrics.model.window_s
    for e in metrics.entries:
        t, src = graph.get(e.task), graph.get(e.source)
        if not (t and src and t.state == TaskState.DONE
                and src.state == TaskState.DONE):
            continue
        acc = per.setdefault(e.sla, {"lat": [], "tokens": 0, "met": 0})
        for r in metrics.model.requests(e.window, e.sla):
            lat = t.t_finished - (src.t_finished - (w_s - r.offset_s))
            acc["lat"].append(lat)
            acc["tokens"] += r.max_new_tokens
            if lat <= deadlines[e.sla]:
                acc["met"] += r.max_new_tokens
    return {sla: {"n": len(a["lat"]),
                  "p50_s": float(np.percentile(a["lat"], 50)),
                  "p99_s": float(np.percentile(a["lat"], 99)),
                  "max_s": float(max(a["lat"])), "tokens": a["tokens"],
                  "tokens_within_deadline": a["met"],
                  "deadline_s": deadlines[sla]}
            for sla, a in sorted(per.items())}


def phase_serve_ensemble(dev):
    """``examples/serve_ensemble.py``'s co-tenant application in real mode:
    traffic windows of two SLA classes through byte-metered Channels into
    ``serve.decode`` tasks (full-width minicpm-2b, continuous batching), on
    one preemptive ``cuda.h100`` pilot with a training ensemble of
    gemma2-2b-L4 members that ends in ``lm.checkpoint``.  Raises unless the
    example's assertions hold, every window served its full token count,
    the flash launches are exactly those of every attempt (a preempted
    attempt runs on as a zombie), the checkpoints restore bitwise into
    fresh states, the losses are finite, the peak stays under the limit
    and the largest window's first admission prefill, rebuilt from its
    inputs, gives the plain versions' logits within LOGIT_TOL.  Prints,
    beside the serving metrics (finishes placed by the cost model), each
    class's latency measured up to its windows' task ends."""
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import (
        AppManager,
        Kernel,
        PipelineSpec,
        Stage,
        TaskSpec,
    )
    from repro_torch.core.resource_handler import Pilot, ResourceSpec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim.adamw import tree_leaves, tree_zip
    from repro_torch.plugins import lm, serve
    from repro_torch.runtime.executor import PilotRuntime
    from repro_torch.runtime.journal import Journal
    from repro_torch.serving import (
        TrafficModel,
        build_serving_app,
        simulate_continuous,
    )
    from repro_torch.staging import LocalityMap, StagingLayer

    E = SE
    cfg = _ensemble_cfg()
    scfg = lm.resolve_cfg(E["arch"])
    model = TrafficModel(**SE_TRAFFIC)
    ensemble = "serve_ens"
    max_len = SE_TRAFFIC["prompt_tokens"] + SE_TRAFFIC["throughput_new_tokens"]
    cache_gb = (E["decode_slots"] * max_len * scfg.num_layers * 2
                * scfg.kv_dim * 2) / 1e9
    predicted = {
        "members_gb": E["members"] * 12 * cfg.param_count() / 1e9,
        "serve_params_gb": 4 * scfg.param_count() / 1e9,
        "caches_gb": E["servers_at_once"] * cache_gb,
        "steps_in_flight": E["members"], "step_gb": ENS_STEP_GB}
    predicted["peak_gb"] = (predicted["members_gb"]
                            + predicted["serve_params_gb"]
                            + predicted["caches_gb"]
                            + E["members"] * ENS_STEP_GB)
    emit({"phase": "serve_ensemble", "predicted": predicted, "config": E,
          "traffic": SE_TRAFFIC})

    with tempfile.TemporaryDirectory() as tmp:
        serving, channels, metrics = build_serving_app(
            model, E["windows"], decode_slots=E["decode_slots"],
            cores=E["serve_cores"], step_cost_s=E["step_cost_s"],
            prefill_cost_s=E["prefill_cost_s"],
            capacity_bytes=E["capacity_bytes"], deadlines=E["deadlines"])
        for p in serving:
            for st in p.stages:
                for sp in st.tasks:
                    if sp.kernel.name == "serve.decode":
                        sp.kernel.arguments.update(
                            arch=E["arch"], device=str(dev),
                            prompt_len=SE_TRAFFIC["prompt_tokens"])
        train_args = {"arch": cfg.name, "device": str(dev), "steps": 1,
                      "batch": E["batch"], "seq": E["seq"],
                      "microbatches": E["microbatches"], "seed": E["seed"],
                      "ensemble": ensemble}

        def task(name, kname, **args):
            k = Kernel(kname)
            k.arguments = args
            return TaskSpec(k, name=name, sla="throughput")

        train = PipelineSpec(
            [Stage([task(f"train.c{c}.m{m}", "lm.train", **train_args,
                         member=m) for m in range(E["members"])],
                   name=f"cycle{c}") for c in range(E["cycles"])]
            + [Stage([task(f"train.ckpt.m{m}", "lm.checkpoint",
                           dir=f"{tmp}/m{m}", member=m, ensemble=ensemble)
                      for m in range(E["members"])], name="checkpoint")],
            name="train")
        journal = f"{tmp}/serve_ensemble.jsonl"
        rt = PilotRuntime(
            slots=E["slots"], mode="real", preempt=True,
            staging=StagingLayer(
                locality=LocalityMap(E["slots"], slots_per_pod=2),
                threshold_bytes=1 << 10),
            journal=Journal(journal))
        am = AppManager(Pilot(ResourceSpec("cuda.h100", cores=E["slots"]),
                              rt, dev))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        prof = am.run([*serving, train], validate="error")
        wall = time.perf_counter() - t0
        zombies = list(am.session._zombie_threads)
        for th in zombies:           # preempted attempts run to their end
            th.join()
        torch.cuda.synchronize(dev)
        launches = {n: c for n, c in LAUNCHES.items() if c}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        metrics.install(am, prof)
        walls = _journal_walls(journal)
        graph = am.session.graph.tasks
        results = prof.results["tasks"]

        # every window served in full; each attempt's flash launches
        windows, want, problems = [], {}, []

        def add(per, n):
            for name, k in per.items():
                want[name] = want.get(name, 0) + k * n
        for sla in ("latency", "throughput"):
            for k in range(E["windows"]):
                reqs = model.requests(k, sla)
                if not reqs:
                    continue
                name = f"serve.{sla}.w{k:05d}"
                out, t = results.get(name, {}), graph[name]
                sim = simulate_continuous(reqs, E["decode_slots"],
                                          step_cost_s=E["step_cost_s"],
                                          prefill_cost_s=E["prefill_cost_s"])
                stats = out.get("stats", {})
                full = sum(r.max_new_tokens for r in reqs)
                if out.get("served") != len(reqs) or out.get("tokens") != full:
                    problems.append(f"{name} served {out}, want "
                                    f"{len(reqs)} requests, {full} tokens")
                add({"flash_attention": scfg.num_layers,
                     "flash_attention.wgmma": scfg.num_layers},
                    t.attempts * stats.get("prefills", 0))
                windows.append({
                    "task": name, "requests": len(reqs), "tokens": full,
                    "attempts": t.attempts, "stats": stats,
                    "measured_s": walls.get(name),
                    "sim_makespan_s": sim.makespan_s,
                    "sim_steps": sim.steps, "sim_prefills": sim.prefills,
                    "ms_per_step": (1e3 * walls[name] / stats["decode_steps"]
                                    if name in walls and stats else None),
                    "step_cost_ms_assumed": 1e3 * E["step_cost_s"]})
        train_walls = {n: walls.get(n) for n in graph
                       if n.startswith("train.")}
        attempts = {m: sum(graph[f"train.c{c}.m{m}"].attempts
                           for c in range(E["cycles"]))
                    for m in range(E["members"])}
        add(ENS_TRAIN_LAUNCHES, sum(attempts.values()))
        losses = {n: results[n]["loss"] for n in
                  (f"train.c{c}.m{m}" for c in range(E["cycles"])
                   for m in range(E["members"]))}

        # the checkpoints, restored into fresh states, against the members
        members = []
        for m in range(E["members"]):
            sid = (ensemble, m)
            live = lm.STATE_STORE[sid]
            ck = Checkpointer(f"{tmp}/m{m}")
            flat, step = ck.restore(None, device="cpu")
            fresh = train_state_from_numpy(flat, cfg, dev)
            del flat
            pairs = list(tree_zip(live, fresh))
            bitwise = all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in pairs)
            members.append({
                "member": m, "step": int(live["step"]),
                "planned_step": E["cycles"], "train_attempts": attempts[m],
                "checkpoint": results.get(f"train.ckpt.m{m}"),
                "checkpoint_step": step, "leaves": len(pairs),
                "restored_bitwise_equal": bitwise})
            del fresh, pairs, live
            _release()
    latency_bound = _latency_bound(metrics, graph, E["deadlines"])
    admission = _admission_check(dev, scfg, serve._params(scfg, 0, dev),
                                 model)
    decode = _decode_alone(dev, scfg, serve._params(scfg, 0, dev))
    summary = prof.results["serving"]
    total = model.total_requests(E["windows"])
    ok = (prof.n_failed == 0 and not problems
          and all(i["state"] == "done"
                  for i in prof.results["pipelines"].values())
          and sum(c["n"] for c in summary["classes"].values()) == total
          and all(ch.peak_unconsumed_bytes <= E["capacity_bytes"]
                  and ch.n_unconsumed() == 0 for ch in channels.values())
          and launches == want
          and all(math.isfinite(v) for v in losses.values())
          and all(r["restored_bitwise_equal"] for r in members)
          and all(r["step"] == r["train_attempts"] for r in members)
          and peak_gb <= ENS_PEAK_LIMIT_GB
          and admission["finite"]
          and admission["logit_max_abs_err"] <= LOGIT_TOL)
    row = {"phase": "serve_ensemble", "serve_arch": scfg.name,
           "serve_layers": scfg.num_layers, "serve_d_model": scfg.d_model,
           "serve_params": scfg.param_count(),
           "member_arch": cfg.name, "members": E["members"],
           "cycles": E["cycles"], "slots": E["slots"],
           "requests": total, **_ttc(prof),
           "n_preempted": prof.n_preempted, "zombie_threads": len(zombies),
           "wall_s": wall, "serving": summary,
           "serving_placed_by": "the cost model's per-request offsets "
                                "from each task's start (step_cost_s)",
           "latency_measured_bound": latency_bound,
           "admission_prefill": admission, "windows": windows,
           "channels": {n: {"peak_unconsumed_bytes": ch.peak_unconsumed_bytes,
                            "unconsumed": ch.n_unconsumed(),
                            "budget": E["capacity_bytes"]}
                        for n, ch in channels.items()},
           "decode_alone": decode, "train_walls_s": train_walls,
           "train_losses": losses, "members_final": members,
           "launches": launches, "launches_expected": want,
           "peak_mem_gb": peak_gb, "predicted_peak_gb": predicted["peak_gb"],
           "peak_limit_gb": ENS_PEAK_LIMIT_GB, "problems": problems,
           "ok": ok}
    emit(row)
    _drop_members(ensemble)
    serve._PARAMS_CACHE.clear()
    lm._STEP_CACHE.clear()
    _release()
    if not ok:
        raise AssertionError(f"serve_ensemble phase failed: {row}")
    return launches


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
    bound_ms, bound_by = _bound(flops, nbytes, "float32")
    row = {"phase": f"kernel {name}", "case": case["name"],
           "shape": {k: v for k, v in case.items() if k != "name"},
           "max_abs_err": y_err, "tol": y_tol, "h_last_err": h_err,
           "h_last_tol": 1e-4, "ok": ok, "ms": ms, "host_ms": host_ms,
           "baseline_ms": baseline_ms, "baseline_max_abs_err": base_err,
           "plain_ms": plain_ms, "library_ms": None,
           "library": "none: no single PyTorch call computes the recurrence",
           "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
           "bound_ms": bound_ms, "bound_by": bound_by, **extra}
    emit(row)
    if not ok:
        raise AssertionError(f"{name} case {case['name']}: y error {y_err} "
                             f"(tol {y_tol}), h_last error {h_err} (tol 1e-4), "
                             f"finite={finite}")
    return row


def phase_kernel_linear_scan(dev):
    import torch

    from repro_torch.kernels.rglru import linear_scan, linear_scan_ref
    from repro_torch.kernels.rglru.ops import cost
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for c in LS_CASES:
        dt = getattr(torch, c["dtype"])
        B, T, C = c["B"], c["T"], c["C"]
        x = torch.randn((B, T, C), generator=gen, device=dev).to(dt)
        a = (0.5 + 0.49 * torch.rand((B, T, C), generator=gen,
                                     device=dev)).to(dt)
        h0 = torch.randn((B, C), generator=gen, device=dev)
        flops, nbytes = cost(B, T, C, x.element_size())
        results[c["name"]] = _scan_check(
            "linear_scan", c, lambda: linear_scan(x, a, h0),
            lambda: linear_scan_ref(x, a, h0), c["dtype"], nbytes,
            flops, {})
        del x, a, h0
        torch.cuda.empty_cache()
    return results


def phase_kernel_selective_scan(dev, baseline=None):
    import torch

    from repro_torch.kernels.mamba import selective_scan, selective_scan_ref
    from repro_torch.kernels.mamba.ops import cost, variant
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
        flops, nbytes = cost(B, T, d, n, x.element_size(), Bm.element_size())
        exps = B * T * d * n
        extra = {"variant": variant(n), "exponentials": exps,
                 "exp_bound_ms": 1e3 * exps / PEAK_EXP,
                 "bm_c": "column slices of one x_proj-shaped tensor, "
                         "read in place through their strides"}
        results[c["name"]] = _scan_check(
            "selective_scan", c, lambda: selective_scan(*args),
            lambda: selective_scan_ref(*args), c["dtype"], nbytes,
            flops, extra,
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


# Scan backward cases: the train shapes of recurrentgemma-2b (a microbatch
# of 2 of 1024 tokens, lru_width 2560; x_eff and a f32, as the model gives
# them) and falcon-mamba-7b (batch 4 of 1024, d_inner 8192, n 16; x, Bm, C
# bf16 with Bm and C column slices of one x_proj output), a bf16 case and a
# ragged one each.  The gradients are held by the flash backward's measures
# (grad_check; BWD_TOL of the gradient's dtype): float32 gradients are the
# same reverse sums in another order (dA, dD over B * T, dBm and dC over d
# channels), bf16 ones are rounded once at the end.
LS_BWD_CASES = [
    dict(name="train", B=2, T=1024, C=2560, dtype="float32"),
    dict(name="bf16", B=2, T=1024, C=2560, dtype="bfloat16"),
    dict(name="ragged", B=3, T=1000, C=1000, dtype="float32"),
]
SS_BWD_CASES = [
    dict(name="train", B=4, T=1024, d=8192, n=16, dtype="bfloat16"),
    dict(name="f32", B=2, T=512, d=1024, n=16, dtype="float32"),
    dict(name="ragged", B=2, T=1000, d=1000, n=12, dtype="bfloat16"),
]
# past T * d >= 2^31 at B = 1 (the backward's 64-bit row offsets): its last
# 256 steps' gradients must equal, bitwise, a run on those steps alone from
# the state the forward kept before them; that run is held against the
# plain version
SS_BWD_LONG = dict(name="long_row", B=1, T=2 ** 31 // 8192 + 256, d=8192,
                   n=16, dtype="bfloat16", tail=256)


def _bwd_row(name, c, grads, again, refs, names, dtypes, nbytes, flops,
             kernel, plain, extra, old=None):
    """Check ``grads`` against ``refs`` and ``again`` bitwise, time
    ``kernel`` and ``plain`` (and ``old``, an earlier kernel on the same
    inputs, where given, with its checks), emit and return the row."""
    import torch
    checks = {n: grad_check(g, r, dt) for n, g, r, dt in
              zip(names, grads, refs, dtypes)}
    bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
    base_checks = ({n: grad_check(g, r, dt) for n, g, r, dt in
                    zip(names, old(), refs, dtypes)} if old else None)
    ms = device_ms(kernel, 10)
    baseline_ms = device_ms(old, 10) if old else None
    host_ms = time_ms(kernel, 10)
    plain_ms = time_ms(plain, 1)
    bound_ms, bound_by = _bound(flops, nbytes, "float32")
    ok = bitwise and all(ch["ok"] for ch in checks.values())
    row = {"phase": f"kernel {name}", "case": c["name"],
           "shape": {k: v for k, v in c.items() if k not in ("name",
                                                             "dtype")},
           "dtype": c["dtype"],
           "max_abs_err": max(ch["max_abs_err"] for ch in checks.values()),
           "checks": checks, "bitwise_equal_calls": bitwise, "ok": ok,
           "ms": ms, "host_ms": host_ms, "baseline_ms": baseline_ms,
           "baseline_checks": base_checks, "plain_ms": plain_ms,
           "library_ms": None,
           "library": "none: no single PyTorch call computes the gradient "
                      "of the recurrence",
           "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
           "bound_ms": bound_ms, "bound_by": bound_by, **extra}
    emit(row)
    if not ok:
        raise AssertionError(f"{name} case {c['name']}: {checks}, bitwise "
                             f"{bitwise}")
    return row


def phase_kernel_linear_scan_bwd(dev, baseline=None):
    """dx, da, dh0 of the reverse-scan kernel against linear_scan_bwd_ref
    on the same inputs, the forward kernel's y and random output
    gradients; bitwise repeats; device time against the bound (and an
    older source's time and checks where ``baseline`` names one)."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rglru import linear_scan_bwd_ref
    from repro_torch.kernels.rglru.ops import (
        bwd_cost,
        linear_scan_bwd_cuda,
        linear_scan_cuda,
    )
    gen = torch.Generator(device=dev).manual_seed(5)
    old = _baseline("linear_scan_bwd", baseline)
    results = {}
    for c in LS_BWD_CASES:
        dt = getattr(torch, c["dtype"])
        B, T, C = c["B"], c["T"], c["C"]
        x = torch.randn((B, T, C), generator=gen, device=dev).to(dt)
        a = (0.5 + 0.49 * torch.rand((B, T, C), generator=gen,
                                     device=dev)).to(dt)
        h0 = torch.randn((B, C), generator=gen, device=dev)
        dy = torch.randn((B, T, C), generator=gen, device=dev).to(dt)
        dh = torch.randn((B, C), generator=gen, device=dev)
        y, _ = linear_scan_cuda(x, a, h0)
        args = (x, a, h0, y, dy, dh)
        before = LAUNCHES["linear_scan_bwd"]
        grads = linear_scan_bwd_cuda(*args)
        again = linear_scan_bwd_cuda(*args)
        torch.cuda.synchronize()
        if LAUNCHES["linear_scan_bwd"] != before + 2:
            raise AssertionError("linear_scan_bwd did not count its launches")
        refs = linear_scan_bwd_ref(x, a, h0, dy, dh)
        flops, nbytes = bwd_cost(B, T, C, x.element_size())
        results[c["name"]] = _bwd_row(
            "linear_scan_bwd", c, grads, again, refs, ("dx", "da", "dh0"),
            (c["dtype"], c["dtype"], "float32"), nbytes, flops,
            lambda: linear_scan_bwd_cuda(*args),
            lambda: linear_scan_bwd_ref(x, a, h0, dy, dh),
            {"blocks": -(-B * C // 32)},
            old=(lambda: old(*args)) if old else None)
        del x, a, h0, dy, dh, y, args, grads, again, refs
        torch.cuda.empty_cache()
    return results


def _patched_ms(old, fn):
    """Device ms of ``fn`` with ``old``'s constants set (None without
    ``old``)."""
    if not old:
        return None
    with old.patched():
        return device_ms(fn, 10)


def _ss_inputs(c, gen, dev, T=None):
    """x, dt, A, Bm, C, D, h0 of a selective-scan case (Bm and C column
    slices of one x_proj-shaped tensor), made in place."""
    import torch
    dt_ = getattr(torch, c["dtype"])
    B, d, n = c["B"], c["d"], c["n"]
    T = T or c["T"]
    x = torch.randn((B, T, d), generator=gen, device=dev, dtype=dt_)
    dt = torch.rand((B, T, d), generator=gen, device=dev).mul_(0.099).add_(
        1e-3)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None].repeat(
        d, 1)
    xdbc = torch.randn((B, T, DT_RANK + 2 * n), generator=gen, device=dev,
                       dtype=dt_)
    Bm, Cc = xdbc[..., DT_RANK:DT_RANK + n], xdbc[..., DT_RANK + n:]
    D = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    h0 = torch.randn((B, d, n), generator=gen, device=dev)
    return x, dt, A, Bm, Cc, D, h0


SS_GRADS = ("dx", "ddt", "dA", "dBm", "dC", "dD", "dh0")


def phase_kernel_selective_scan_bwd(dev, baseline=None):
    """The seven gradients of the selective-scan backward kernel against
    selective_scan_bwd_ref on the same inputs (the forward kernel's
    checkpoints) and random output gradients; bitwise repeats; device time
    against the bound and the special-function floor (and an older
    source's time and checks where ``baseline`` names one); then the long
    row."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.mamba import selective_scan_bwd_ref
    from repro_torch.kernels.mamba.ops import (
        BWD_CHANNELS,
        BWD_STATES,
        bwd_cost,
        selective_scan_bwd_cuda,
        selective_scan_cuda,
    )
    gen = torch.Generator(device=dev).manual_seed(6)
    old = _baseline("selective_scan_bwd", baseline)
    results = {}
    for c in SS_BWD_CASES:
        args = _ss_inputs(c, gen, dev)
        x = args[0]
        B, T, d, n = c["B"], c["T"], c["d"], c["n"]
        dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        dh = torch.randn(args[6].shape, generator=gen, device=dev)
        _, _, ckpt = selective_scan_cuda(*args, checkpoints=True)
        ck_old = None
        if old:     # the earlier kernel's checkpoints, at its interval
            with old.patched():
                _, _, ck_old = selective_scan_cuda(*args, checkpoints=True)
        before = LAUNCHES["selective_scan_bwd"]
        grads = selective_scan_bwd_cuda(*args, ckpt, dy, dh)
        again = selective_scan_bwd_cuda(*args, ckpt, dy, dh)
        torch.cuda.synchronize()
        if LAUNCHES["selective_scan_bwd"] != before + 2:
            raise AssertionError("selective_scan_bwd did not count its "
                                 "launches")
        refs = selective_scan_bwd_ref(*args, dy, dh)
        flops, nbytes = bwd_cost(B, T, d, n, x.element_size(),
                                 args[3].element_size())
        # the function's exponentials, the recompute's and the reverse's
        # (the floor every row is held to), and those the kernel evaluates:
        # each of the recompute's once, over n padded to BWD_STATES
        exps = 2 * B * T * d * n
        design_exps = B * T * d * BWD_STATES
        dtypes = (c["dtype"], "float32", "float32", c["dtype"], c["dtype"],
                  "float32", "float32")
        results[c["name"]] = _bwd_row(
            "selective_scan_bwd", c, grads, again, refs, SS_GRADS, dtypes,
            nbytes, flops,
            lambda: selective_scan_bwd_cuda(*args, ckpt, dy, dh),
            lambda: selective_scan_bwd_ref(*args, dy, dh),
            {"variant": f"np{BWD_STATES}", "exponentials": exps,
             "exp_bound_ms": 1e3 * exps / PEAK_EXP,
             "design_exponentials": design_exps,
             "design_exp_bound_ms": 1e3 * design_exps / PEAK_EXP,
             "blocks": B * -(-d // BWD_CHANNELS),
             "part_bc_mbytes": B * -(-d // BWD_CHANNELS) * T * 2 * BWD_STATES
             * 4 / 1e6,
             "checkpoint_mbytes": ckpt.numel() * 4 / 1e6,
             # the forward that writes the checkpoints, at this kernel's
             # interval and (with --baseline) the earlier kernel's
             "forward_ckpt_ms": device_ms(
                 lambda: selective_scan_cuda(*args, checkpoints=True), 10),
             "baseline_forward_ckpt_ms": _patched_ms(
                 old, lambda: selective_scan_cuda(*args, checkpoints=True))},
            old=(lambda: old(*args, ck_old, dy, dh)) if old else None)
        del args, x, dy, dh, ckpt, ck_old, grads, again, refs
        torch.cuda.empty_cache()
    results[SS_BWD_LONG["name"]] = _selective_scan_bwd_long_row(dev, gen)
    return results


def _selective_scan_bwd_long_row(dev, gen):
    """The backward on a batch row of T * d >= 2^31 elements: the gradients
    of the last ``tail`` steps (dx, ddt, dBm, dC) must equal, bitwise, a
    backward of those steps alone from the state the forward kept before
    them, with the same output gradients; that tail run is held against
    the plain version."""
    import torch

    from repro_torch.kernels.mamba import selective_scan_bwd_ref
    from repro_torch.kernels.mamba.ops import (
        CKPT_STEPS,
        selective_scan_bwd_cuda,
        selective_scan_cuda,
    )
    c = SS_BWD_LONG
    T, tail = c["T"], c["tail"]
    T0 = T - tail
    args = _ss_inputs(c, gen, dev)
    x = args[0]
    dy = torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
    dh = torch.randn(args[6].shape, generator=gen, device=dev)
    y, _, ckpt = selective_scan_cuda(*args, checkpoints=True)
    del y
    h_T0 = ckpt[:, T0 // CKPT_STEPS].contiguous()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    full = selective_scan_bwd_cuda(*args, ckpt, dy, dh)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    full_tail = [g[:, T0:].clone() for g in (full[0], full[1], full[3],
                                             full[4])]
    del full, ckpt
    x_, dt_, A, Bm, Cc, D, _ = args
    tail_args = (x_[:, T0:].contiguous(), dt_[:, T0:].contiguous(), A,
                 Bm[:, T0:], Cc[:, T0:], D, h_T0)
    dy_t = dy[:, T0:].contiguous()
    del args, x, x_, dt_, dy
    torch.cuda.empty_cache()
    _, _, ck_t = selective_scan_cuda(*tail_args, checkpoints=True)
    got = selective_scan_bwd_cuda(*tail_args, ck_t, dy_t, dh)
    refs = selective_scan_bwd_ref(*tail_args, dy_t, dh)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in
                  zip((got[0], got[1], got[3], got[4]), full_tail))
    dtypes = (c["dtype"], "float32", "float32", c["dtype"], c["dtype"],
              "float32", "float32")
    checks = {n: grad_check(g, r, dt) for n, g, r, dt in
              zip(SS_GRADS, got, refs, dtypes)}
    ok = bitwise and all(ch["ok"] for ch in checks.values())
    row = {"phase": "kernel selective_scan_bwd", "case": c["name"],
           "shape": {k: c[k] for k in ("B", "T", "d", "n")},
           "row_elements": T * c["d"], "dtype": c["dtype"],
           "tail_bitwise_equal": bitwise, "tail_checks": checks, "ok": ok,
           "ms": ms}
    emit(row)
    del tail_args, dy_t, ck_t, got, refs, full_tail, h_T0, dh
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"selective_scan_bwd long row: {row}")
    return row


ROUTER = dict(base="qwen3-moe-30b-a3b", arch="qwen3-moe-30b-a3b-L1",
              layers=1, batch=4, seq=1024, seed=0)


def _router_sizes(dev):
    """{"serve", "train"}: the group sizes of qwen3-moe-30b-a3b's layer-0
    router (full width, bf16 params from seed 0: layer 0 of the config cut
    to one layer, which init_params draws as the full model's) on
    SyntheticLM's batch 0 (seed 0, 4 x 1024 tokens): all of it, the serve
    shape (T=4096, C=384), and its first row, the train microbatch (T=1024,
    C=80)."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.models import forward, init_params
    R = ROUTER
    cfg = _cut_cfg(R["arch"], R["base"], R["layers"]).replace(
        param_dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        R["seed"]))
    tokens = SyntheticLM(cfg, ShapeSpec("router", "train", R["seq"],
                                        R["batch"]), seed=R["seed"],
                         device=dev).batch_at(0)["tokens"]
    sizes = {}
    for name, rows in (("serve", tokens), ("train", tokens[:1])):
        seen = []
        with _recording_sizes(seen), torch.inference_mode():
            forward(cfg, params, rows)
        sizes[name] = seen[0]
    del params
    _release()
    return sizes


def _route(E, C, T, k, gen, dev):
    import torch
    idx = torch.rand((T, E), generator=gen, device=dev).topk(k).indices
    counts = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, idx.reshape(-1), torch.ones(T * k, dtype=torch.int32, device=dev))
    return counts.clamp(max=C)


def _gmm_sizes(c, gen, dev, router):
    """A case's group sizes: given, ``router[c["router"]]`` (the
    ``_router_sizes`` of the run), or routed at random."""
    import torch
    if "sizes" in c:
        return torch.tensor(c["sizes"], dtype=torch.int32, device=dev)
    if "router" in c:
        sizes = router[c["router"]]
        if sizes.shape != (c["E"],) or int(sizes.max()) > c["C"]:
            raise AssertionError(f"router sizes {sizes.tolist()} do not fit "
                                 f"case {c}")
        return sizes
    n = c.get("members", 1)
    return torch.cat([_route(c["E"] // n, c["C"], *c["route"], gen, dev)
                      for _ in range(n)])


def phase_kernel_gmm(dev, router, baseline=None):
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    from repro_torch.kernels.moe_gmm.ops import cost, kernel_variant, variant
    gen = torch.Generator(device=dev).manual_seed(3)
    old = _baseline("gmm", baseline)
    results = {}
    for c in GMM_CASES:
        dt = getattr(torch, c["dtype"])
        E, C, D, F = c["E"], c["C"], c["D"], c["F"]
        x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
        w = (0.02 * torch.randn((E, D, F), generator=gen, device=dev)).to(dt)
        sizes = _gmm_sizes(c, gen, dev, router)
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
        flops, nbytes = cost(E, C, D, F, x.element_size(),
                             live_rows=live_rows, live_experts=live_experts)
        bound_ms, bound_by = _bound(flops, nbytes, c["dtype"])
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
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        if not ok:
            raise AssertionError(f"gmm case {c['name']}: max error {err} > "
                                 f"{tol}, padding rows zero={padding_zero}, "
                                 f"finite={finite}")
        results[c["name"]] = row
        del x, w, sizes, out, valid
        torch.cuda.empty_cache()
    return results


def phase_kernel_gmm_bwd(dev, router, baseline=None):
    """dx and dw of the grouped-matmul backward kernels against gmm_bwd_ref
    on the card (GMM_BWD_CASES): the case's variant by ``ops.bwd_variant``,
    the library's own rule and the launch counters; the flash backward's
    measures, dx's padding rows and the dw of empty experts exactly 0, two
    calls bitwise equal; device, host-inclusive, plain and torch.bmm-pair
    times beside the bound, and an earlier source's time and checks where
    ``baseline`` names one."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.moe_gmm import gmm_bwd_ref
    from repro_torch.kernels.moe_gmm.ops import (
        bwd_cost,
        bwd_variant,
        gmm_bwd_cuda,
        kernel_bwd_variant,
    )
    gen = torch.Generator(device=dev).manual_seed(5)
    old = _baseline("gmm_bwd", baseline)
    results = {}
    for c in GMM_BWD_CASES:
        dt = getattr(torch, c["dtype"])
        E, C, D, F = c["E"], c["C"], c["D"], c["F"]
        x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
        w = (0.02 * torch.randn((E, D, F), generator=gen, device=dev)).to(dt)
        dy = torch.randn((E, C, F), generator=gen, device=dev).to(dt)
        sizes = _gmm_sizes(c, gen, dev, router)
        valid = torch.arange(C, device=dev)[None, :] < sizes[:, None]
        if c.get("nan_padding"):
            x[~valid] = float("nan")
            dy[~valid] = float("nan")
        kind = bwd_variant(dt, E, C, D, F)
        lib_kind = kernel_bwd_variant(dt, E, C, D, F)
        if not kind == lib_kind == c["variant"]:
            raise AssertionError(f"gmm_bwd case {c['name']}: ops.bwd_variant "
                                 f"names {kind}, the library {lib_kind}, "
                                 f"the case {c['variant']}")
        names = ("gmm_bwd", "gmm_bwd.dx", "gmm_bwd.dw", f"gmm_bwd.{kind}")
        before = [LAUNCHES[n] for n in names]
        dx, dw = gmm_bwd_cuda(x, w, sizes, dy)
        torch.cuda.synchronize()
        if [LAUNCHES[n] for n in names] != [b + 1 for b in before]:
            raise AssertionError(f"gmm_bwd case {c['name']} did not launch "
                                 f"its {kind} kernels once each")
        rx, rw = gmm_bwd_ref(x, w, sizes, dy)

        def check(dx, dw, again):
            """The measures of one kernel's (dx, dw) and a second call's."""
            dx2, dw2 = again()
            out = {"checks": {"dx": grad_check(dx, rx, c["dtype"]),
                              "dw": grad_check(dw, rw, c["dtype"])},
                   "bitwise_repeat": bool(torch.equal(dx, dx2)
                                          and torch.equal(dw, dw2)),
                   "dx_padding_rows_zero": bool((dx[~valid] == 0).all()),
                   "dw_empty_experts_zero": bool((dw[sizes == 0] == 0).all())}
            out["ok"] = all(v["ok"] for v in out["checks"].values()) and all(
                out[k] for k in ("bitwise_repeat", "dx_padding_rows_zero",
                                 "dw_empty_experts_zero"))
            return out
        mine = check(dx, dw, lambda: gmm_bwd_cuda(x, w, sizes, dy))
        del dx, dw
        base = None
        if old:
            base = check(*old(x, w, sizes, dy), lambda: old(x, w, sizes, dy))
        del rx, rw
        torch.cuda.empty_cache()
        big = E * D * F > 100_000_000

        def kernel():
            return gmm_bwd_cuda(x, w, sizes, dy)

        def library():
            return torch.bmm(dy, w.mT), torch.bmm(x.mT, dy)
        n_it = 5 if big else 20
        ms = device_ms(kernel, n_it)
        host_ms = time_ms(kernel, n_it)
        dx_ms = device_ms(lambda: gmm_bwd_cuda(x, w, sizes, dy,
                                               need_dw=False), n_it)
        dw_ms = device_ms(lambda: gmm_bwd_cuda(x, w, sizes, dy,
                                               need_dx=False), n_it)
        baseline_ms = (device_ms(lambda: old(x, w, sizes, dy), n_it)
                       if old else None)
        plain_ms = time_ms(lambda: gmm_bwd_ref(x, w, sizes, dy), 2)
        library_ms = device_ms(library, n_it)

        live = sizes.clamp(0, C)
        rows = int(live.sum())
        live_experts = int((live > 0).sum())
        flops, nbytes = bwd_cost(E, C, D, F, x.element_size(),
                                 live_rows=rows, live_experts=live_experts)
        bound_ms, bound_by = _bound(flops, nbytes, c["dtype"])
        row = {"phase": "kernel gmm_bwd", "case": c["name"],
               "shape": {n: c[n] for n in ("E", "C", "D", "F")},
               "dtype": c["dtype"], "variant": kind, "live_rows": rows,
               "live_experts": live_experts, **mine,
               "max_abs_err": max(v["max_abs_err"]
                                  for v in mine["checks"].values()),
               "ms": ms, "dx_ms": dx_ms, "dw_ms": dw_ms,
               "host_ms": host_ms, "baseline_ms": baseline_ms,
               "baseline": base, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "torch.bmm(dy, w.mT) + torch.bmm(x.mT, dy) in x's "
                          "dtype over every row and expert",
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": flops / ms / 1e9,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        if not mine["ok"]:
            raise AssertionError(f"gmm_bwd case {c['name']}: {row}")
        results[c["name"]] = row
        del x, w, dy, sizes, valid
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def _off_by_one(name):
    """The model's calls of kernel wrapper ``name`` read their arguments at
    ``LOGIT_CONTROL[name]`` ((B, T, ...) each) one position late, as a
    kernel whose tile loads are off by one would; NONCAUSAL_Q_CONTROL: the
    flash calls with causal=False read q late."""
    import torch

    from repro_torch.models import layers, transformer
    wrapper, late_args = ((name, LOGIT_CONTROL[name]) if name in LOGIT_CONTROL
                          else ("flash_attention", (0,)))
    only_noncausal = name == NONCAUSAL_Q_CONTROL
    mods = [m for m in (layers, transformer) if hasattr(m, wrapper)]
    saved = [getattr(m, wrapper) for m in mods]

    def late(fn):
        def run(*args, **kw):
            a = list(args)
            if not (only_noncausal and kw.get("causal", True)):
                for i in late_args:
                    a[i] = torch.cat([a[i][:, :1], a[i][:, :-1]], dim=1)
            return fn(*a, **kw)
        return run
    for m, fn in zip(mods, saved):
        setattr(m, wrapper, late(fn))
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            setattr(m, wrapper, fn)


def _controls(cfg, per_prefill):
    """The controls of an arch's prefill check: each LOGIT_CONTROL wrapper
    its prefill launches, and the non-causal q control where it has an
    encoder."""
    return ([n for n in LOGIT_CONTROL if n in per_prefill]
            + ([NONCAUSAL_Q_CONTROL] if cfg.encoder_layers else []))


def _stub_inputs(cfg, B, dev):
    """Random stub inputs of the frontends (0.02 std, seed 0, bf16):
    ``enc_frames`` for an encoder, ``vision_embeds`` for a VLM."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for key, on, S in (("vision_embeds", cfg.vision_tokens,
                        cfg.vision_tokens),
                       ("enc_frames", cfg.encoder_layers, cfg.encoder_seq)):
        if on:
            out[key] = (0.02 * torch.randn((B, S, cfg.d_model),
                                           generator=gen, device=dev)
                        ).to(torch.bfloat16)
    return out


def _attn_sublayers(cfg, params, wave, frames, limit):
    """PREFILL_ATTN1's readings: the first encoder layer's and the first
    decoder layer's attention sublayers' outputs, kernels against
    impl="ref", and under each one's control."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models.transformer import (
        embed_frames,
        embed_tokens,
        encode,
    )
    mem = encode(cfg, params, frames, impl="ref")
    enc, dec = params["enc"]["layers"][0], params["layers"][0]
    he, pe = embed_frames(cfg, frames)
    B, S = wave.shape
    pd = torch.arange(S, dtype=torch.int32, device=wave.device)[None].expand(
        B, S)
    hd = embed_tokens(cfg, params, wave, pd)
    calls = {
        "encoder 0 self-attention": (
            enc["attn"], layers.apply_norm(cfg, enc["ln1"], he), "enc", pe,
            None, NONCAUSAL_Q_CONTROL),
        "decoder 0 self-attention": (
            dec["attn"], layers.apply_norm(cfg, dec["ln1"], hd), "global",
            pd, None, "flash_attention"),
        "decoder 0 cross-attention": (
            dec["xattn"], layers.apply_norm(cfg, dec["lnx"], hd), "cross",
            pd, mem, NONCAUSAL_Q_CONTROL)}
    rows = {}
    for name, (p, x, kind, pos, m, control) in calls.items():
        def out(impl=None):
            return layers.apply_attn(cfg, p, x, kind=kind, positions=pos,
                                     mem=m, impl=impl)
        ref = out("ref")
        row = {"h_rel_frobenius": rel_fro(out(), ref), "limit": limit}
        with _off_by_one(control):
            row["controls"] = {control: rel_fro(out(), ref)}
        rows[name] = row
    return rows


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
    from repro_torch.models import forward, init_params
    from repro_torch.models.transformer import (
        embed_tokens,
        forward_block,
        lm_logits,
    )
    from repro_torch.serve import (
        BatchedServer,
        build_prefill_step,
        build_serve_step,
    )

    cfg = get_config(arch).replace(param_dtype="bfloat16")
    B, S0, NEW, NREQ = (SERVE_SHAPE[k] for k in ("batch", "prompt", "new",
                                                 "requests"))
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

    # one prefill of the first wave, kernels against plain versions: the
    # prefill step's own two lines (forward, then the last position's
    # logits), keeping every position's final hidden states; an arch with a
    # stubbed frontend takes its stub inputs
    wave = torch.stack([torch.as_tensor(r.prompt) for r in
                        _requests(cfg, B, S0, NEW)]).to(dev)
    stubs = _stub_inputs(cfg, B, dev)
    batch = {"tokens": wave, **stubs}
    check_want = STUB_PREFILL.get(arch, per_prefill)

    def prefill(impl=None, cache=True):
        out = forward(cfg, params, wave, cache_len=max_len if cache else None,
                      impl=impl, **stubs)
        return ({"logits": lm_logits(cfg, params, out["h"][:, -1:]),
                 "cache": out["cache"]}, out["h"])
    with torch.inference_mode():
        pre_k = build_prefill_step(cfg, cache_len=max_len)
        # the prefill step users call, on the checked batch: its launches
        reset_launches()
        out = pre_k(params, batch)
        torch.cuda.synchronize()
        check_launches = {n: c for n, c in LAUNCHES.items() if c}
        del out
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_r, h_r = prefill("ref")
        torch.cuda.synchronize()
        prefill_ref_ms = 1e3 * (time.perf_counter() - t)
        lr = out_r["logits"]
        ref_tokens = _greedy(build_serve_step(cfg, impl="ref"), params,
                             out_r, S0, NEW, dev)
        del out_r
        out_k, h_k = prefill()
        lk = out_k["logits"]
        # the served tokens; with stub inputs, serve_step's decode from the
        # checked prefill's cache
        served = ([tokens[i] for i in range(B)] if not stubs else
                  _greedy(srv.step, params, out_k, S0, NEW, dev))
        del out_k
        logit_err = float((lk - lr).abs().max())
        h_rel = rel_fro(h_k, h_r)
        h_err = float((h_k.float() - h_r.float()).abs().max())
        finite = bool(torch.isfinite(lk).all()
                      and torch.isfinite(h_k.float()).all())
        f32 = {}
        if arch in F32_HELD_FINAL:    # the whole model upcast to f32
            h_f = forward(cfg.replace(dtype="float32", param_dtype="float32"),
                          _to_f32(params), wave, impl="ref", **stubs)["h"]
            f32["h after the model"] = _f32_held(
                {"kernels": h_k, "ref": h_r, "f32": h_f})
            del h_f
            _release()
        del h_k
        controls = {}
        for control in _controls(cfg, per_prefill):
            with _off_by_one(control):
                out_c, h_c = prefill(cache=False)
            controls[control] = {
                "inputs_delayed": LOGIT_CONTROL.get(control, (0,)),
                "calls": ("causal=False" if control == NONCAUSAL_Q_CONTROL
                          else "all"),
                "h_rel_frobenius": rel_fro(h_c, h_r),
                "last_logit_max_abs_err":
                    float((out_c["logits"] - lr).abs().max())}
            del out_c, h_c
        h_ref_max = float(h_r.float().abs().max())
        del h_r
        first = {}
        if arch in PREFILL_H1:
            control, limit1 = PREFILL_H1[arch]
            kind = cfg.layer_kind(0)
            pos = torch.arange(S0, dtype=torch.int32,
                               device=dev)[None].expand(B, S0)
            h0 = embed_tokens(cfg, params, wave, pos)
            if cfg.vision_tokens:
                h0 = torch.cat([stubs["vision_embeds"].to(h0.dtype),
                                h0[:, cfg.vision_tokens:]], dim=1)

            def update(impl=None):
                h1, _, _ = forward_block(cfg, params["layers"][0], h0, kind,
                                         positions=pos, seg_ids=None,
                                         cache_len=None, impl=impl)
                return h1.float() - h0.float()
            u_r = update("ref")
            first = {"blocks": 1, "kind": kind,
                     "compared": "the first block's update of the residual "
                                 "stream (its output less its input)",
                     "h_rel_frobenius": rel_fro(update(), u_r),
                     "limit": limit1, "controls": {}}
            with _off_by_one(control):
                first["controls"][control] = rel_fro(update(), u_r)
            del u_r, h0
        attn1 = (_attn_sublayers(cfg, params, wave, stubs["enc_frames"],
                                 PREFILL_ATTN1[arch])
                 if arch in PREFILL_ATTN1 else {})
        if arch in F32_HELD_DEPTHS:
            f32 = _f32_depth_drift(cfg, params, wave, stubs,
                                   F32_HELD_DEPTHS[arch])
            _release()
        top2 = lk[:, 0].topk(2, dim=-1).values
        argmax_same = float((lk[:, 0].argmax(-1) == lr[:, 0].argmax(-1))
                            .float().mean())
        same = sum(a == b for s, r in zip(served, ref_tokens)
                   for a, b in zip(s, r))
        prefill_ms = time_ms(lambda: pre_k(params, batch), 3)
        out = pre_k(params, batch)
        cache, last = out["cache"], out["logits"][:, 0].argmax(-1)
        state = {"pos": S0}

        def step():
            pos = torch.full((B,), state["pos"], dtype=torch.int32,
                             device=dev)
            srv.step(params, cache, last[:, None], pos)
            state["pos"] += 1
        decode_ms = time_ms(step, NEW - 2)
    tol = LOGIT_TOL_ARCH.get(arch, LOGIT_TOL)
    limit = PREFILL_H_LIMIT[arch]
    row = {"phase": f"serve {arch}", "arch": cfg.name, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers,
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
           "served_tokens": tokens,
           "launches_per_prefill": per_prefill,
           "launches_per_decode_step": per_decode,
           "stub_inputs": {k: list(v.shape) for k, v in stubs.items()},
           "checked_prefill_launches": check_launches,
           "checked_prefill_launches_expected": check_want,
           "wall_s": wall, "tokens_per_s": ntok / wall,
           "prefill_ms": prefill_ms, "prefill_ref_ms": prefill_ref_ms,
           "decode_step_ms": decode_ms,
           "prefill_h_rel_frobenius": h_rel, "prefill_h_limit": limit,
           "prefill_h_max_abs_err": h_err, "prefill_h_ref_max_abs": h_ref_max,
           "prefill_h_compared": "final hidden states of every position of "
                                 "the first wave, kernels against "
                                 "impl='ref'",
           "controls": controls, "first_block": first,
           "first_attention_sublayers": attn1,
           "f32_held": f32, "f32_held_ratio": F32_HELD_RATIO,
           "controls_compared": "the kernels' prefill with the named "
                                "wrapper's arguments delayed one position, "
                                "against impl='ref'",
           "prefill_logit_max_abs_err": logit_err, "logit_tol": tol,
           "prefill_logit_ref_max_abs": float(lr.abs().max()),
           "greedy_token_agreement": same / (B * NEW),
           "prefill_argmax_agreement": argmax_same,
           "prefill_top2_gap_min": float((top2[:, 0] - top2[:, 1]).min()),
           "greedy_compared": ("first wave's served tokens (kernels) "
                               if not stubs else
                               "serve_step's tokens (kernels) from the "
                               "checked prefill's cache ")
           + "against tokens decoded by impl='ref' decode steps (plain "
             "versions) from the impl='ref' prefill's cache",
           "peak_mem_gb": peak_gb}
    emit(row)
    if check_launches != check_want:
        raise AssertionError(f"{arch} checked prefill launched "
                             f"{check_launches}, expected {check_want}")
    if not finite or logit_err > tol or h_rel > limit:
        raise AssertionError(f"{arch} prefill: hidden states {h_rel} "
                             f"(limit {limit}), last logits {logit_err} "
                             f"(tol {tol}), finite={finite}")
    blind = [n for n, c in controls.items() if c["h_rel_frobenius"] <= limit]
    if not controls or blind:
        raise AssertionError(f"{arch} prefill: the controls {blind or 'none'}"
                             f" do not read above the limit {limit}: "
                             f"{controls}")
    if first and not (first["h_rel_frobenius"] <= first["limit"] <
                      min(first["controls"].values())):
        raise AssertionError(f"{arch} prefill after the first block: "
                             f"{first}")
    for name, sub in attn1.items():
        if not sub["h_rel_frobenius"] <= sub["limit"] < min(
                sub["controls"].values()):
            raise AssertionError(f"{arch} prefill, {name}: {sub}")
    far = {n: h for n, h in f32.items() if not h["ratio"] <= F32_HELD_RATIO}
    if far:
        raise AssertionError(f"{arch} prefill against an f32 plain run: "
                             f"the kernels lie further from it than "
                             f"{F32_HELD_RATIO} x the plain versions: {far}")
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


# mesh phase: the mesh code paths on a one-rank NCCL group; losses of the
# mesh steps against the unsharded train phases' (the same seed-0 state,
# batches and kernels: one rank moves no bytes and reorders no sum)
MESH = dict(shape=(1, 1), axes=("data", "model"), gemma_steps=2,
            qwen_steps=1, re_members=2, re_seed=5)
MESH_LOSS_RTOL = 1e-3


def _mesh_group(dev, tmp):
    """A one-rank NCCL default group through a FileStore in ``tmp``."""
    import os

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)


def _mesh_train(dev, mesh, spec, ref, steps):
    """``steps`` steps of ``build_train_step(cfg, mesh=mesh)`` from the
    ``lm.train`` task's seed-0 state on its batches; the row."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import state_shardings
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.profile_train import TRAIN
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.plugins import lm
    from repro_torch.train import TrainHyper, build_train_step
    from repro_torch.train import make_train_state

    mbs = spec.get("microbatches", TRAIN["microbatches"])
    cfg = lm.resolve_cfg(spec["arch"]).replace(microbatches=mbs)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    shardings = state_shardings(cfg, mesh, state)
    state = spmd.distribute_tree(state, shardings)
    leaves = list(tree_leaves(state))
    placed = all(spmd.is_dtensor(x) for x in leaves)
    step = build_train_step(cfg, TrainHyper(base_lr=3e-4, warmup=2,
                                            total_steps=1000), mesh=mesh)
    data = SyntheticLM(cfg, ShapeSpec("train", "train", TRAIN["seq"],
                                      TRAIN["batch"]), seed=0, device=dev)
    runs = []
    for i in range(steps):
        batch = data.batch_at(i)
        torch.cuda.synchronize(dev)
        reset_launches()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize(dev)
        runs.append({"loss": loss, "ms": 1e3 * (time.perf_counter() - t),
                     "launches": {n: c for n, c in LAUNCHES.items() if c}})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = ref["losses"][:steps]
    rel = [abs(r["loss"] - w) / abs(w) for r, w in zip(runs, want)]
    row = {"part": f"train {spec['arch']}", "profile": cfg.sharding_profile,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "state_dtensors": placed, "placements": sorted(
               {str(x.placements) for x in leaves}),
           "local_state_gb": sum(x.to_local().numel() * x.element_size()
                                 for x in leaves) / 1e9,
           "losses": [r["loss"] for r in runs], "losses_unsharded": want,
           "loss_rel": rel, "loss_rtol": MESH_LOSS_RTOL,
           "step_ms": [r["ms"] for r in runs],
           "step_ms_unsharded": [s_["ms"] for s_ in ref["steps_run"]],
           "peak_gb": peak_gb, "peak_gb_unsharded": ref["peak_mem_gb"],
           "launches_per_step": [r["launches"] for r in runs],
           "launches_per_step_unsharded": spec["launches"]}
    row["ok"] = (placed and all(r <= MESH_LOSS_RTOL for r in rel)
                 and len(rel) == steps
                 and all(r["launches"] == spec["launches"] for r in runs))
    del state, leaves, step
    _release()
    return row


def _mesh_serve(dev, mesh, ref):
    """``BatchedServer(mesh=mesh)`` of the ``serve gemma2-2b`` phase's
    params and requests; the row."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import spmd
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve import BatchedServer

    cfg = get_config("gemma2-2b").replace(param_dtype="bfloat16")
    B, S0, NEW, NREQ = (SERVE_SHAPE[k] for k in ("batch", "prompt", "new",
                                                 "requests"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    srv = BatchedServer(cfg, params, batch=B, prompt_len=S0,
                        max_len=S0 + NEW + 1, device=dev, mesh=mesh)
    del params
    placed = all(spmd.is_dtensor(x) for x in tree_leaves(srv.params))
    srv.submit(_requests(cfg, NREQ, S0, NEW))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    launches = {n: c for n, c in LAUNCHES.items() if c}
    tokens = {str(r.rid): r.out_tokens for r in done}
    want = {str(k): v for k, v in ref["served_tokens"].items()}
    row = {"part": "serve gemma2-2b", "params_dtensors": placed,
           "tokens_equal": tokens == want, "requests": len(tokens),
           "wall_s": wall, "wall_s_unsharded": ref["wall_s"],
           "tokens_per_s": sum(map(len, tokens.values())) / wall,
           "tokens_per_s_unsharded": ref["tokens_per_s"],
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "peak_gb_unsharded": ref["peak_mem_gb"],
           "launches": launches, "launches_unsharded": ref["launches"],
           "stats": srv.stats}
    row["ok"] = (placed and row["tokens_equal"] and len(tokens) == NREQ
                 and launches == {n: c for n, c in ref["launches"].items()
                                  if c})
    del srv
    _release()
    return row


def _mesh_pilot(dev):
    """One cycle of the RE app (``MESH["re_members"]`` gemma2-2b-L4
    members, one ``lm.train`` step each, then ``re.exchange`` with
    ``device`` set) on a mesh-aware pilot of one slot; the row."""
    import numpy as np
    import torch

    from repro_torch.core import (AppManager, Kernel, PipelineSpec, Stage,
                                  TaskSpec)
    from repro_torch.dist.topology import SlotTopology
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.core.ensemble import metropolis_swap_device
    from repro_torch.plugins import lm
    from repro_torch.plugins.re_exchange import exchange_uniforms
    from repro_torch.runtime.executor import PilotRuntime

    cfg = _ensemble_cfg()
    E, n = ENSEMBLE, MESH["re_members"]
    temps = [3e-4 * 1.3 ** i for i in range(n)]
    rt = PilotRuntime(mode="real",
                      topology=SlotTopology.even(np.array([0]), 1))
    sims = []
    for i in range(n):
        k = Kernel("lm.train")
        k.arguments = {"arch": cfg.name, "device": str(dev), "steps": 1,
                       "batch": E["batch"], "seq": E["seq"],
                       "microbatches": E["microbatches"], "seed": E["seed"],
                       "member": i, "ensemble": "chip_smoke_mesh",
                       "lr": temps[i]}
        sims.append(TaskSpec(k, name=f"md{i}", metadata={"instance": i}))
    sim = Stage(sims, name="simulation")
    x = Kernel("re.exchange")
    x.arguments = {"replicas": n, "cycle": 0, "temps": temps,
                   "seed": MESH["re_seed"], "device": True}
    ex = Stage([TaskSpec(x, name="exchange")], name="exchange",
               inputs={"members": sim.future()})
    reset_launches()
    prof = AppManager(rt).run(PipelineSpec([sim, ex], name="re_mesh"))
    torch.cuda.synchronize(dev)
    launches = {k_: c for k_, c in LAUNCHES.items() if c}
    res = prof.results["tasks"]["exchange"]
    # the host replays the swap: the same rule on the same losses and the
    # uniforms the card drew
    u = exchange_uniforms(n, MESH["re_seed"], 0, dev).cpu()
    old = torch.tensor(temps, dtype=torch.float32)
    new, _ = metropolis_swap_device(
        torch.tensor(res["losses"], dtype=torch.float32), old, 0, u)
    host_acc = [(i, i + 1) for i in range(0, n - 1, 2) if new[i] != old[i]]
    host_t = list(temps)
    for i, j in host_acc:
        host_t[i], host_t[j] = host_t[j], host_t[i]
    want = _expected_launches(n, 0)
    row = {"part": "re pilot", "slots": rt.slots,
           "n_failed": prof.n_failed, "n_retries": prof.n_retries,
           "losses": res["losses"], "temps": res["temps"],
           "accepted": [list(p) for p in res["accepted"]],
           "host_replay_accepted": [list(p) for p in host_acc],
           "ttc": prof.ttc, "launches": launches,
           "launches_expected": want}
    row["ok"] = (prof.n_failed == 0 and prof.n_retries == 0
                 and all(map(math.isfinite, res["losses"]))
                 and row["accepted"] == row["host_replay_accepted"]
                 and res["temps"] == [float(t) for t in host_t]
                 and launches == want)
    for i in range(n):
        lm.STATE_STORE.pop(("chip_smoke_mesh", i), None)
    _release()
    return row


def phase_mesh(dev, refs):
    """The ``mesh`` phase; ``refs``: the rows of ``train gemma2-2b``,
    ``train qwen3-moe-30b-a3b-L4`` and ``serve gemma2-2b``.  Returns its
    launches of each kernel, by part."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    qwen = TRAIN_PHASES[3]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        _mesh_group(dev, tmp)
        try:
            mesh = make_host_mesh(MESH["shape"], MESH["axes"])
            if mesh.device_type != dev.type:
                raise AssertionError(f"mesh on {mesh.device_type}, the "
                                     f"phase on {dev}")
            rows.append(_mesh_train(dev, mesh, TRAIN_PHASES[0],
                                    refs["train gemma2-2b"],
                                    MESH["gemma_steps"]))
            rows.append(_mesh_train(dev, mesh, qwen,
                                    refs[f"train {qwen['arch']}"],
                                    MESH["qwen_steps"]))
            rows.append(_mesh_serve(dev, mesh, refs["serve gemma2-2b"]))
            rows.append(_mesh_pilot(dev))
        finally:
            dist.destroy_process_group()
    row = {"phase": "mesh", "backend": "nccl", "world": 1,
           "mesh": dict(zip(MESH["axes"], MESH["shape"])), "card": _card(),
           "parts": rows, "ok": all(r["ok"] for r in rows)}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"mesh phase failed: {row}")
    out = {}
    for r in rows:
        per = r.get("launches_per_step") or [r["launches"]]
        for name in {k for p in per for k in p}:
            out.setdefault(name, {})[f"mesh {r['part']}"] = sum(
                p.get(name, 0) for p in per)
    return out


def _release():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _phases(dev, baselines, reckonings):
    """Every phase after the build, in order; returns the main paths'
    launches of each kernel ({kernel: {path: n}}) and the kernel phases'
    cases."""
    import torch
    with torch.inference_mode():
        router = _router_sizes(dev)
        cases = {"flash_attention": phase_kernel_flash_attention(
                     dev, baselines.get("flash_attention")),
                 "linear_scan": phase_kernel_linear_scan(dev),
                 "selective_scan": phase_kernel_selective_scan(
                     dev, baselines.get("selective_scan")),
                 "gmm": phase_kernel_gmm(dev, router, baselines.get("gmm")),
                 "linear_scan_bwd": phase_kernel_linear_scan_bwd(
                     dev, baselines.get("linear_scan_bwd")),
                 "selective_scan_bwd": phase_kernel_selective_scan_bwd(
                     dev, baselines.get("selective_scan_bwd")),
                 "gmm_bwd": phase_kernel_gmm_bwd(
                     dev, router, baselines.get("gmm_bwd"))}
        _release()
    cases["flash_attention_bwd"] = phase_kernel_flash_attention_bwd(
        dev, baselines.get("flash_attention_bwd"))
    _release()
    launches = {name: {} for name in KERNELS}
    emit({"phase": "dryrun", "workers": DRYRUN_WORKERS,
          "waited_s": reckonings.wait()})
    refs = {}   # the unsharded rows the mesh phase is held against
    for spec in TRAIN_PHASES:
        row = phase_train(dev, spec)
        refs[row["phase"]] = row
        for name, n in row["launches"].items():
            if name in launches:
                launches[name][row["phase"]] = n
        phase_dryrun(row["phase"], reckonings.get(row["phase"]),
                     row["peak_mem_gb"],
                     [s_["launches"] for s_ in row["steps_run"]],
                     spec["launches"], step_ms=row["step_ms_steady"])
    for name, n in phase_launch_train(dev, reckonings).items():
        if name in launches:
            launches[name]["launch train"] = n
    for name, n in phase_ensemble(dev).items():
        if name in launches:
            launches[name]["ensemble"] = n
    for name, n in phase_federation(dev).items():
        if name in launches:
            launches[name]["federation"] = n
    for spec in (FUSED, FUSED_MOE):
        rows = []
        for name, n in phase_fused(dev, spec, rows).items():
            if name in launches:
                launches[name][f"fused {spec['arch']}"] = n
        phase_dryrun(f"fused {spec['arch']}",
                     reckonings.get(f"fused {spec['arch']}"),
                     rows[0]["peak_mem_gb"],
                     [c_["launches"] for c_ in rows[0]["fused_cycles"]],
                     rows[0]["launches_per_cycle_expected"])
    for name, n in phase_serve_ensemble(dev).items():
        if name in launches:
            launches[name]["serve_ensemble"] = n
    with torch.inference_mode():
        for arch, loop, per_prefill, per_decode in SERVE:
            row = phase_serve(dev, arch, loop, per_prefill, per_decode)
            refs[row["phase"]] = row
            for name, n in row["launches"].items():
                if n and name in launches:
                    launches[name][arch] = n
            if row["stub_inputs"]:   # build_prefill_step with them
                for name, n in row["checked_prefill_launches"].items():
                    if name in launches:
                        launches[name][f"{arch} prefill, stub inputs"] = n
            _release()
        phase_task(dev)
        phase_continuous(dev)
    for name, paths in phase_mesh(dev, refs).items():
        if name in launches:
            launches[name].update(paths)
    return launches, cases


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="NAME=PATH",
                    help="an earlier .cu of kernel NAME (flash_attention, "
                         "flash_attention_bwd, selective_scan, gmm, "
                         "linear_scan_bwd, selective_scan_bwd, gmm_bwd; "
                         "same C entry) to time beside the kernel on its "
                         "cases; repeatable")
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
    reckonings = _Reckonings(_reckon_cells())
    try:
        launches, cases = _phases(dev, baselines, reckonings)
    finally:
        reckonings.close()

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
    print(_card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

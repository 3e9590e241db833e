"""Where the train-step time goes: profile one train step of full-width
gemma2-2b (f32 master params and Adam moments, random weights from seed 0)
on the GPU, and print one JSON line.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--microbatches N]

``TRAIN`` is the shape, also that of the train phase of ``chip_smoke.py``;
``--microbatches`` (default ``TRAIN``'s) splits its batch otherwise.  The
line holds the host wall time of the step (ending in a synchronize), the
summed device time of its kernels, the device's idle share, the device
time by kernel group (``profile_serve``'s groups: flash forward and
backward, bf16 and f32 matmuls (the f32 ones are the LM head's), copies
and casts, other) and by the heaviest kernel names, from
``torch.profiler``, and the peak of allocated device memory over a warm-up
step and the profiled one.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLM
from repro_torch.launch.profile_serve import _profile
from repro_torch.train import TrainHyper, build_train_step, make_train_state

TRAIN = dict(arch="gemma2-2b", batch=4, seq=1024, microbatches=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--microbatches", type=int, default=TRAIN["microbatches"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the GPU; CUDA is missing")
    dev = torch.device("cuda")
    cfg = get_config(TRAIN["arch"]).replace(microbatches=args.microbatches)
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(cfg, TrainHyper(warmup=2, total_steps=1000))
    data = SyntheticLM(cfg, ShapeSpec("profile", "train", TRAIN["seq"],
                                      TRAIN["batch"]), device=dev)
    n = {"step": 0}

    def one_step():
        step(state, data.batch_at(n["step"]))
        n["step"] += 1
    torch.cuda.reset_peak_memory_stats(dev)
    res = _profile(one_step, 1, dev)
    print(json.dumps({"profile": "train_step", **TRAIN,
                      "microbatches": args.microbatches,
                      "device": torch.cuda.get_device_name(dev), **res,
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                      / 1e9}), flush=True)


if __name__ == "__main__":
    main()

"""Where the train-step time goes: profile one train step of a full-width
arch (f32 master params and Adam moments, random weights from seed 0) on
the GPU, and print one JSON line.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch ARCH] [--microbatches N]

``TRAIN`` is the shape, also that of the train phases of ``chip_smoke.py``;
``ARCHS`` the archs those phases train, with their microbatches:
gemma2-2b (the default), recurrentgemma-2b, falcon-mamba-7b-L24
(falcon-mamba-7b cut to 24 of its 64 layers: 7.27 B params and their Adam
moments do not fit on one card) and qwen3-moe-30b-a3b-L4 (4 of its 48
layers, in the config's 4 microbatches); ``--microbatches`` splits the
batch otherwise.  The line holds the host wall time of the step (ending in a synchronize), the
summed device time of its kernels, the device's idle share, the device
time by kernel group (``profile_serve``'s groups: the hand kernels'
forwards and backwards (gmm's among them), bf16 and f32 matmuls (the f32 ones are the LM
head's and, in recurrentgemma-2b, the RG-LRU gates'), copies and casts,
other) and by the heaviest kernel names, from
``torch.profiler``, and the peak of allocated device memory over a warm-up
step and the profiled one.
"""
from __future__ import annotations

import argparse
import json
import re

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLM
from repro_torch.launch.profile_serve import _profile
from repro_torch.train import TrainHyper, build_train_step, make_train_state

TRAIN = dict(arch="gemma2-2b", batch=4, seq=1024, microbatches=2)
ARCHS = {"gemma2-2b": 2, "recurrentgemma-2b": 2, "falcon-mamba-7b-L24": 1,
         "qwen3-moe-30b-a3b-L4": 4}


def train_config(arch: str):
    """The config of ``arch``: a registered name, or ``<base>-L<n>``, the
    full-width ``base`` config cut to its first n layers."""
    try:
        return get_config(arch)
    except KeyError:
        m = re.fullmatch(r"(.+)-L(\d+)", arch)
        if m is None:
            raise
        return get_config(m[1]).replace(name=arch, num_layers=int(m[2]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=TRAIN["arch"], choices=sorted(ARCHS))
    ap.add_argument("--microbatches", type=int, default=None,
                    help="default: the arch's in ARCHS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the GPU; CUDA is missing")
    dev = torch.device("cuda")
    mb = args.microbatches or ARCHS[args.arch]
    cfg = train_config(args.arch).replace(microbatches=mb)
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
    print(json.dumps({"profile": "train_step", **TRAIN, "arch": args.arch,
                      "microbatches": mb,
                      "device": torch.cuda.get_device_name(dev), **res,
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                      / 1e9}), flush=True)


if __name__ == "__main__":
    main()

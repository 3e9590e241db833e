"""Where the train-step time goes: profile one train step of a full-width
arch (f32 master params and Adam moments, random weights from seed 0) on
the GPU, and print one JSON line.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch ARCH] [--microbatches N] [--batch B] [--seq S]

``TRAIN`` is the shape, also that of the train phases of ``chip_smoke.py``;
``ARCHS`` the archs those phases train, with their microbatches:
gemma2-2b (the default), recurrentgemma-2b, falcon-mamba-7b-L24
(falcon-mamba-7b cut to 24 of its 64 layers: 7.27 B params and their Adam
moments do not fit on one card), qwen3-moe-30b-a3b-L4 (4 of its 48
layers, in the config's 4 microbatches), whisper-large-v3 (with its 4 x
1500 stub frames), gemma3-4b-L30, minicpm-2b, nemotron-4-15b-L4 and
internvl2-26b-L10 (with its stub vision embeddings; the last two in their
configs' 4 microbatches), each cut to the deepest depth whose dry-run
peak stays under 76 GB; ``--microbatches`` splits the batch otherwise.
``--batch`` and ``--seq`` profile another cell: ``--seq 4096 --batch 4
--microbatches 1`` is gemma2-2b's and recurrentgemma-2b's step of the
reference's train_4k cell as ``chip_smoke.py``'s ``train_4k`` phases run
it (``launch.train``: the config's one microbatch).  The
line holds the host wall time of the step (ending in a synchronize), the
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

import torch

from repro_torch.configs import resolve_config as train_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLM
from repro_torch.launch.profile_serve import _profile
from repro_torch.train import TrainHyper, build_train_step, make_train_state

TRAIN = dict(arch="gemma2-2b", batch=4, seq=1024, microbatches=2)
ARCHS = {"gemma2-2b": 2, "recurrentgemma-2b": 2, "falcon-mamba-7b-L24": 1,
         "qwen3-moe-30b-a3b-L4": 4, "whisper-large-v3": 1, "gemma3-4b-L30": 1,
         "minicpm-2b": 1, "nemotron-4-15b-L4": 4, "internvl2-26b-L10": 4}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=TRAIN["arch"], choices=sorted(ARCHS))
    ap.add_argument("--microbatches", type=int, default=None,
                    help="default: the arch's in ARCHS")
    ap.add_argument("--batch", type=int, default=TRAIN["batch"])
    ap.add_argument("--seq", type=int, default=TRAIN["seq"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the GPU; CUDA is missing")
    dev = torch.device("cuda")
    mb = args.microbatches or ARCHS[args.arch]
    cfg = train_config(args.arch).replace(microbatches=mb)
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(cfg, TrainHyper(warmup=2, total_steps=1000))
    data = SyntheticLM(cfg, ShapeSpec("profile", "train", args.seq,
                                      args.batch), device=dev)
    n = {"step": 0}

    def one_step():
        step(state, data.batch_at(n["step"]))
        n["step"] += 1
    torch.cuda.reset_peak_memory_stats(dev)
    res = _profile(one_step, 1, dev)
    print(json.dumps({"profile": "train_step", "arch": args.arch,
                      "batch": args.batch, "seq": args.seq,
                      "microbatches": mb,
                      "device": torch.cuda.get_device_name(dev), **res,
                      "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                      / 1e9}), flush=True)


if __name__ == "__main__":
    main()

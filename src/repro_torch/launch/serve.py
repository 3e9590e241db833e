"""Serving entry point: batched prefill+decode on a (reduced) arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.flags import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import BatchedServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = cfg.replace(param_dtype="float32" if args.reduced else "bfloat16")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    srv = BatchedServer(cfg, params, batch=args.batch,
                        prompt_len=args.prompt_len,
                        max_len=args.prompt_len + args.new_tokens + 1,
                        device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    srv.submit(reqs)
    t0 = time.perf_counter()
    done = srv.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    ntok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {ntok} tokens in {dt:.2f}s on "
          f"{device}; stats={srv.stats}")


if __name__ == "__main__":
    main()

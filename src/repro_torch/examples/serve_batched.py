"""Batched serving example on the port: a reduced model serving
greedy-decoded requests through the continuous-batching-lite server
(``examples/serve_batched.py``'s options and printed lines, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --requests 12 [--device cpu]
"""
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
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
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
    dt = time.perf_counter() - t0

    lat = [r.done_at - r.submitted_at for r in done]
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s incl. compile)")
    print(f"stats: {srv.stats}")
    print(f"latency p50={np.percentile(lat, 50):.3f}s "
          f"p95={np.percentile(lat, 95):.3f}s")
    print(f"request 0 tokens: {done[0].out_tokens}")


if __name__ == "__main__":
    main()

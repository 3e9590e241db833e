"""Synthetic LM batches, the same as ``repro.data.synthetic.SyntheticLM``'s.

``batch_at(step)`` draws from ``np.random.default_rng((seed, step))`` in the
JAX package's order, so its tokens, labels and segment ids are those of the
JAX batch at the same step; they come back as int32 tensors on ``device``
(``cuda`` unless the caller asks for the CPU, ``flags.resolve_device``).
``batches(start, prefetch)`` is the JAX package's double-buffered iterator:
a producer thread makes the next batches while the caller consumes one,
and stops when the generator is closed.  The JAX package's sharded
``device_put`` is not ported (one device), nor are the vision and encoder
stub inputs, which no ported arch takes (ROADMAP A8).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.flags import DeviceLike, resolve_device


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
                 batch_override: Optional[int] = None,
                 device: DeviceLike = None):
        if cfg.vision_tokens or cfg.encoder_layers:
            raise NotImplementedError(
                f"{cfg.name}: vision and encoder inputs are not ported yet")
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.B = batch_override or shape.global_batch
        self.S = shape.seq_len
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.cfg.vocab_size, (self.B, self.S + 1),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1],
               "labels": toks[:, 1:],
               "seg_ids": np.zeros((self.B, self.S), np.int32)}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in out.items()}

    def batches(self, start: int = 0, prefetch: int = 1
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Double-buffered iterator from step ``start``: generation overlaps
        consumption.  Closing the generator (or dropping it) stops the
        producer thread."""
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()

        def producer():
            step = start
            while not stop.is_set():
                batch = self.batch_at(step)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=producer, daemon=True,
                             name="SyntheticLM.batches")
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join()

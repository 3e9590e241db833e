"""Synthetic LM batches, the same as ``repro.data.synthetic.SyntheticLM``'s.

``batch_at(step)`` draws from ``np.random.default_rng((seed, step))`` in the
JAX package's order, so its tokens, labels and segment ids are those of the
JAX batch at the same step; they come back as int32 tensors on ``device``
(``cuda`` unless the caller asks for the CPU, ``flags.resolve_device``).
The frontends' stub inputs follow from the same generator, in the same
order and with the same values: ``vision_embeds`` (B, vision_tokens,
d_model) for a VLM config, float32 (a bf16 config's rounded to bf16 before
the 0.02 scale, as the reference's numpy does), then ``enc_frames`` (B,
encoder_seq, d_model) for an encoder-decoder config, in the compute dtype.
``batches(start, prefetch)`` is the JAX package's double-buffered iterator:
a producer thread makes the next batches while the caller consumes one,
and stops when the generator is closed.  The JAX package's sharded
``device_put`` is not ported (one device).
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
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.B = batch_override or shape.global_batch
        self.S = shape.seq_len
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, cfg.vocab_size, (self.B, self.S + 1),
                            dtype=np.int32)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
               (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]),
                ("seg_ids", np.zeros((self.B, self.S), np.int32)))}
        bf16 = cfg.dtype == "bfloat16"
        if cfg.vision_tokens:
            v = torch.from_numpy(rng.standard_normal(
                (self.B, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
            if bf16:
                v = v.to(torch.bfloat16).float()
            out["vision_embeds"] = v * 0.02
        if cfg.encoder_layers:
            f = torch.from_numpy(rng.standard_normal(
                (self.B, cfg.encoder_seq, cfg.d_model)) * 0.02)
            out["enc_frames"] = f.to(torch.bfloat16 if bf16
                                     else torch.float32)
        return {k: v.to(self.device) for k, v in out.items()}

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

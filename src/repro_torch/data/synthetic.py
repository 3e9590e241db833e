"""Synthetic LM batches, the same as ``repro.data.synthetic.SyntheticLM``'s.

``batch_at(step)`` draws from ``np.random.default_rng((seed, step))`` in the
JAX package's order, so its tokens, labels and segment ids are those of the
JAX batch at the same step; they come back as int32 tensors on ``device``.
The JAX package's sharded ``device_put`` and its double-buffered iterator
are not ported (one device, batches made on demand); nor are the vision and
encoder stub inputs, which no ported arch takes.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
                 batch_override: Optional[int] = None, device="cpu"):
        if cfg.vision_tokens or cfg.encoder_layers:
            raise NotImplementedError(
                f"{cfg.name}: vision and encoder inputs are not ported yet")
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.B = batch_override or shape.global_batch
        self.S = shape.seq_len
        self.device = torch.device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.cfg.vocab_size, (self.B, self.S + 1),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1],
               "labels": toks[:, 1:],
               "seg_ids": np.zeros((self.B, self.S), np.int32)}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in out.items()}

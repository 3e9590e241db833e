"""Serving substrate: prefill/decode step functions and a host-side
continuous-batching scheduler (per-step admit/evict over a live decode
wave), the port of ``repro.serve.engine``.

Under a ``mesh`` the params are DTensors laid out by
``dist.sharding.state_shardings`` and the decode cache DTensors laid out
by ``cache_shardings`` (batch over the data axes, kv heads over
``model``); token and position batches and the logits are global (every
rank the same).  A step takes the params' compute copies
(``dist.spmd.gather_params``: each ``model`` shard kept, the layers
tensor-parallel), this rank's rows and its part of the cache (its local
tensors, laid out as the layers read and write them), and runs the step
on those local tensors; the logits (every vocab column on every ``model``
rank) are gathered over the data axes for the host's sampling.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import cache_spec, spec_placements
from repro_torch.flags import resolve_device
from repro_torch.models import decode_step, forward, lm_logits


def _cache_leaf_shape(cfg: ModelConfig, path, t, B: int):
    """The whole shape of cache leaf ``t`` at ``path`` (layer index, key)
    for a batch of ``B``."""
    leaf = path[-1]
    if leaf == "pos":
        return tuple(t.shape)
    if leaf in ("k", "v", "xk", "xv"):
        return (B, t.shape[1], cfg.num_kv_heads, cfg.head_dim)
    rec = cfg.layer_kind(int(path[0])) == "rec"
    W = cfg.lru_width_ if rec else cfg.d_inner
    if leaf == "h":
        return (B, W) if rec else (B, W, cfg.ssm_state)
    return (B, cfg.ssm_conv - 1, W)


def _place_cache(cfg: ModelConfig, mesh, cache, B: int):
    """A rank's part of the cache (its rows, its ``model`` part: what the
    tensor-parallel layers make) as DTensors laid out by
    ``cache_shardings`` for a batch of ``B``; no communication.  Raises
    where a leaf is not its shard's shape."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import tree_map_with_path
    sizes = [int(n) for n in tuple(mesh.shape)]

    def one(path, t):
        shape = _cache_leaf_shape(cfg, path, t, B)
        target = spec_placements(mesh, cache_spec(cfg, mesh, path, shape))
        want = list(shape)
        for i, pl in enumerate(target):
            if isinstance(pl, Shard):
                want[pl.dim] //= sizes[i]
        if list(t.shape) != want:
            raise ValueError(f"cache leaf {path}: {tuple(t.shape)} is not "
                             f"its shard {tuple(want)} of {shape}")
        return spmd.to_dtensors(t, mesh, target)
    return tree_map_with_path(one, cache)


def build_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None,
                       impl: Optional[str] = None, *, mesh=None):
    """``impl`` goes to every kernel wrapper of the forward pass (None: the
    device decides; "ref": the plain versions).  A batch may carry the
    frontends' stub inputs, ``vision_embeds`` and ``enc_frames``.
    ``mesh``: see the module docstring."""
    def prefill_step(params, batch):
        B = batch["tokens"].shape[0]
        if mesh is not None:
            from repro_torch.dist import spmd
            params, _ = spmd.gather_params(cfg, mesh, params)
            batch = {k: spmd.local_rows(v, mesh) for k, v in batch.items()}
        out = forward(cfg, params, batch["tokens"],
                      vision_embeds=batch.get("vision_embeds"),
                      enc_frames=batch.get("enc_frames"),
                      cache_len=cache_len, impl=impl, mesh=mesh,
                      batch_kind="serve")
        logits = lm_logits(cfg, params, out["h"][:, -1:], mesh=mesh)
        cache = out["cache"]
        if mesh is not None:
            logits = spmd.gather_rows(logits, mesh, B)
            if cache is not None:
                cache = _place_cache(cfg, mesh, cache, B)
        if cache_len is None:
            return {"logits": logits}
        return {"logits": logits, "cache": cache}
    return prefill_step


def build_serve_step(cfg: ModelConfig, impl: Optional[str] = None, *,
                     mesh=None):
    """decode: one new token for the whole batch against the cache.
    ``impl`` goes to every kernel wrapper of the step, as in prefill;
    ``mesh``: see the module docstring."""
    def serve_step(params, cache, tokens, positions):
        if mesh is None:
            return decode_step(cfg, params, cache, tokens, positions,
                               impl=impl)
        from repro_torch.dist import spmd
        B = tokens.shape[0]
        params, _ = spmd.gather_params(cfg, mesh, params)
        logits, rows = decode_step(
            cfg, params, spmd.local(cache),
            spmd.local_rows(tokens, mesh), spmd.local_rows(positions, mesh),
            impl=impl, mesh=mesh)
        return (spmd.gather_rows(logits, mesh, B),
                _place_cache(cfg, mesh, rows, B))
    return serve_step


# ---------------------------------------------------------------- requests

@dataclass
class Request:
    rid: int
    prompt: Any                      # token array (S,)
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    done_at: float = 0.0
    sla: str = "throughput"          # serving SLA class (serving.sla)


def _merge_rows(old, new, mask):
    """Select ``new``'s batch rows where ``mask`` is set, ``old``'s
    elsewhere, for every tensor of a cache (nested lists and dicts, the
    batch on axis 0 of every leaf: attention k/v, and the recurrent ``h``
    and ``conv`` states of rec and mamba layers).  A DTensor leaf merges
    its local rows by the rows of ``mask`` it holds."""
    if isinstance(old, dict):
        return {k: _merge_rows(old[k], new[k], mask) for k in old}
    if isinstance(old, (list, tuple)):
        return [_merge_rows(o, n, mask) for o, n in zip(old, new)]
    if hasattr(old, "device_mesh"):          # a DTensor
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.dist import spmd
        rows = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                     else Replicate() for pl in old.placements)
        merged = _merge_rows(old.to_local(), new.to_local(),
                             spmd.local_shard(mask, old.device_mesh, rows))
        return DTensor.from_local(merged, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())
    shape = [old.shape[0]] + [1] * (old.dim() - 1)
    return torch.where(mask.reshape(shape), new, old)


class BatchedServer:
    """Host-side continuous-batching server over fixed decode slots.

    ``run()`` keeps ONE decode wave alive for the whole queue: each step it
    (1) admits queued requests into free slots — group prefill, then merge
    only the joiner rows into the live cache — (2) decodes one token for
    every occupied slot at its own per-row cache position, and (3) evicts
    each request the step it reaches its ``max_new_tokens``.  Sliding-window
    local layers keep a batch-synchronized ring cache, so configs with them
    run the synchronized wave loop instead (no mid-wave admission).

    ``device`` is where params, tokens and caches live (default ``cuda``);
    ``impl`` goes to every kernel of prefill and decode (attention, the
    scans and the MoE grouped matmul; None: the device decides; "ref": the
    plain versions).  ``clock`` stamps ``Request.submitted_at`` and
    ``done_at``.  ``mesh``: params and caches stay laid out by
    ``state_shardings`` / ``cache_shardings`` across the steps (plain
    params are placed so: each rank keeps its shard); the logits are
    gathered for sampling, so every rank decodes the same tokens.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch: int,
                 prompt_len: int, max_len: int, device=None, mesh=None,
                 impl: Optional[str] = None, clock=time.perf_counter):
        self.cfg, self.mesh = cfg, mesh
        self.device = resolve_device(device)
        if mesh is not None:
            from repro_torch.dist import spmd
            from repro_torch.dist.sharding import state_shardings
            from repro_torch.optim.adamw import tree_leaves
            if not any(spmd.is_dtensor(t) for t in tree_leaves(params)):
                params = spmd.distribute_tree(
                    params, state_shardings(cfg, mesh, params))
        self.params = params
        self.B, self.S0, self.Smax = batch, prompt_len, max_len
        self.clock = clock
        # sliding-window ring caches are batch-synchronized -> wave mode
        self.continuous = not (cfg.sliding_window and any(
            cfg.layer_kind(i) == "local" for i in range(cfg.num_layers)))
        self.prefill = build_prefill_step(cfg, cache_len=max_len,
                                          impl=impl, mesh=mesh)
        self.step = build_serve_step(cfg, impl=impl, mesh=mesh)
        self.queue: collections.deque = collections.deque()
        self.stats = {"served": 0, "decode_steps": 0, "prefills": 0,
                      "slot_steps": 0}

    def submit(self, reqs: List[Request]):
        for r in reqs:
            if self.S0 + r.max_new_tokens > self.Smax:
                raise ValueError(
                    f"request {r.rid}: prompt_len {self.S0} + "
                    f"max_new_tokens {r.max_new_tokens} exceeds cache "
                    f"length {self.Smax}")
            r.submitted_at = self.clock()
            self.queue.append(r)

    def run(self) -> List[Request]:
        with torch.inference_mode():
            return self._run_continuous() if self.continuous \
                else self._run_waves()

    def _tokens(self, prompts) -> torch.Tensor:
        rows = [torch.as_tensor(p[:self.S0], dtype=torch.int64)
                if p is not None else torch.zeros(self.S0, dtype=torch.int64)
                for p in prompts]
        return torch.stack(rows).to(self.device)

    # -------------------------------------------------- continuous batching
    def _admit(self, slots, cache, positions, last):
        """Fill free slots from the queue: one group prefill for all
        joiners, merged row-wise into the live cache."""
        joiners = []
        for i in range(self.B):
            if slots[i] is None and self.queue:
                slots[i] = self.queue.popleft()
                joiners.append(i)
        if not joiners:
            return cache
        joinset = set(joiners)
        tokens = self._tokens([slots[i].prompt if i in joinset else None
                               for i in range(self.B)])
        out = self.prefill(self.params, {"tokens": tokens})
        self.stats["prefills"] += 1
        fresh = out["cache"]
        if cache is None:
            cache = fresh
        else:
            mask = torch.tensor([i in joinset for i in range(self.B)],
                                device=self.device)
            cache = _merge_rows(cache, fresh, mask)
        first = out["logits"][:, 0].argmax(dim=-1).tolist()
        for i in joiners:
            last[i] = int(first[i])
            positions[i] = self.S0
        return cache

    def _run_continuous(self) -> List[Request]:
        done: List[Request] = []
        slots: List[Optional[Request]] = [None] * self.B
        positions = [0] * self.B     # next cache write offset per slot
        last = [0] * self.B          # last decoded token per slot (host)
        cache = None
        while self.queue or any(s is not None for s in slots):
            cache = self._admit(slots, cache, positions, last)
            logits, cache = self.step(
                self.params, cache,
                torch.tensor(last, dtype=torch.int64,
                             device=self.device)[:, None],
                torch.tensor(positions, dtype=torch.int32,
                             device=self.device))
            self.stats["decode_steps"] += 1
            nxt = logits[:, 0].argmax(dim=-1).tolist()
            for i, r in enumerate(slots):
                if r is None:
                    continue
                r.out_tokens.append(int(nxt[i]))
                last[i] = int(nxt[i])
                positions[i] += 1
                self.stats["slot_steps"] += 1
                if len(r.out_tokens) >= r.max_new_tokens:
                    r.done_at = self.clock()
                    done.append(r)
                    self.stats["served"] += 1
                    slots[i] = None      # evict: slot free next admission
        return done

    # -------------------------------------------------- wave loop
    def _run_waves(self) -> List[Request]:
        done: List[Request] = []
        while self.queue:
            wave = [self.queue.popleft()
                    for _ in range(min(self.B, len(self.queue)))]
            tokens = self._tokens([r.prompt for r in wave]
                                  + [None] * (self.B - len(wave)))
            out = self.prefill(self.params, {"tokens": tokens})
            self.stats["prefills"] += 1
            cache = out["cache"]
            last = out["logits"][:, 0].argmax(dim=-1)
            nsteps = max(r.max_new_tokens for r in wave)
            for t in range(nsteps):
                pos = torch.full((self.B,), self.S0 + t, dtype=torch.int32,
                                 device=self.device)
                logits, cache = self.step(self.params, cache,
                                          last[:, None], pos)
                last = logits[:, 0].argmax(dim=-1)
                self.stats["decode_steps"] += 1
                host = last.tolist()
                for i, r in enumerate(wave):
                    if t < r.max_new_tokens:
                        r.out_tokens.append(int(host[i]))
                        self.stats["slot_steps"] += 1
            for r in wave:
                r.done_at = self.clock()
            done.extend(wave)
            self.stats["served"] += len(wave)
        return done

"""Train state and train/eval steps, as ``repro.train.step``: remat,
gradient-accumulation microbatching, global-norm clipping, AdamW, LR
schedules.

The state is ``{"params", "opt": {"m", "v", "count"}, "step"}`` with the
port's parameter layout (``models.convert.train_state_from_numpy`` carries
a JAX state across).  A train step updates it in place and returns it:
gradients accumulate into the master params' ``.grad`` (f32 for f32
masters, the JAX package's ``zeros + g_1 + g_2 ...``), are divided by the
microbatch count, clipped, and applied by AdamW; the params require grad
only inside the step, and their ``.grad`` is dropped at its end.

Under a ``mesh`` (``build_train_step(cfg, mesh=...)``) the state is a tree
of DTensors laid out by ``dist.sharding.state_shardings`` and the batch
holds the global rows (every rank the same).  Each step takes the
parameters' compute copies (``dist.spmd.gather_params``: gathered over the
data axes, each ``model`` shard kept, on which the layers compute
tensor-parallel), takes this rank's rows of every microbatch (the
reference's microbatch, then its data shard), sums the gradients over the
data axes (a ``model`` shard's gradient is that shard's; a replicated
leaf's comes out whole on every ``model`` rank through the layers'
``copy`` / ``sum``), constrains them to the parameters' placements
(``constrain_like_params``: each rank keeps its shard), clips them by their
global norm over the mesh, and runs AdamW on the local shards of
parameters, moments and gradients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain_like_params
from repro_torch.models.transformer import _layout, forward, init_params
from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedules import make_schedule
from repro_torch.train.losses import chunked_softmax_xent

TrainState = Dict[str, Any]


@dataclass(frozen=True)
class TrainHyper:
    base_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"
    wd: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    clip: float = 1.0
    aux_weight: float = 0.01


def make_train_state(cfg: ModelConfig, gen: torch.Generator) -> TrainState:
    """Random params from ``gen`` (on its device), zero moments, step 0."""
    params = init_params(cfg, gen)
    return {"params": params,
            "opt": adamw_init(params, cfg.optstate_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


def _cast_leaf(path, p):
    if "moe" in path:
        return p
    if p.dim() >= 2 and p.numel() > 1_000_000 and p.dtype == torch.float32:
        return p.to(torch.bfloat16)
    return p


def compute_cast(cfg: ModelConfig, params):
    """Cast large matmul weights to the compute dtype once per step, as the
    JAX package does (there: on their sharded storage): leaves of 2 or more
    dims, over 1M elements and f32, not under a ``moe`` subtree.  Small and
    1-D leaves (norms, gates, A_log, dt_bias) stay in master precision.
    The cast is differentiable: gradients reach the f32 masters."""
    if cfg.dtype != "bfloat16":
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return _cast_leaf(path, tree)
    return walk(params, ())


def decay_mask(cfg: ModelConfig, params):
    """Which leaves AdamW decays: those of 2 or more dims in the JAX
    package's layout, where each layer of a scanned group is stacked into a
    ``(G, ...)`` leaf and the encoder's layers into ``(encoder_layers,
    ...)`` leaves.  So a scanned layer's norm scales (1-D here, (G, d)
    there) decay, as in the reference, and every encoder layer's norm
    scales and biases; the tail layers' and the encoder's final norm do
    not (ROADMAP C3)."""
    period, G, _ = _layout(cfg)

    def stacked(layer, extra):
        return tree_map(lambda p: p.dim() + extra >= 2, layer)
    out = {k: stacked(v, 0) for k, v in params.items()
           if k not in ("layers", "enc")}
    out["layers"] = [stacked(layer, int(i < G * period))
                     for i, layer in enumerate(params["layers"])]
    if "enc" in params:
        out["enc"] = {"layers": [stacked(layer, 1)
                                 for layer in params["enc"]["layers"]],
                      "final_norm": stacked(params["enc"]["final_norm"], 0)}
    return out


def lm_loss(cfg: ModelConfig, params, batch, impl: Optional[str] = None,
            remat: bool = False, mesh=None):
    """(mean nll, token count, aux loss) of one batch: the forward pass and
    the chunked LM-head loss, differentiable in ``params``; under ``mesh``
    the batch is this rank's rows and the mean is over every rank's."""
    out = forward(cfg, params, batch["tokens"], seg_ids=batch.get("seg_ids"),
                  vision_embeds=batch.get("vision_embeds"),
                  enc_frames=batch.get("enc_frames"), impl=impl, remat=remat,
                  mesh=mesh)
    loss, ntok = chunked_softmax_xent(cfg, params, out["h"], batch["labels"],
                                      mesh=mesh)
    return loss, ntok, out["aux"]


def _microbatches(batch, nmb: int, mesh):
    """The ``nmb`` microbatches of ``batch`` (rows split in order); under
    ``mesh``, this rank's rows of each."""
    B = batch["tokens"].shape[0]
    if B % nmb:
        raise ValueError(f"batch {B} does not split into {nmb} "
                         "microbatches")
    for i in range(nmb):
        mb = {k: v[i * B // nmb:(i + 1) * B // nmb] for k, v in batch.items()}
        if mesh is not None:
            from repro_torch.dist import spmd
            mb = {k: spmd.local_rows(v, mesh) for k, v in mb.items()}
        yield mb


def _accumulate(cfg, params, batch, hyper, impl, remat, mesh):
    """Forward and backward of every microbatch into ``params``' ``.grad``
    (the leaves require grad only here); returns (grads, loss sum, aux
    sum)."""
    leaves = list(tree_leaves(params))
    nmb = cfg.microbatches
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    aux_sum = torch.zeros_like(loss_sum)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        for mb in _microbatches(batch, nmb, mesh):
            loss, _, aux = lm_loss(cfg, compute_cast(cfg, params), mb,
                                   impl, remat, mesh)
            total = loss + hyper.aux_weight * aux
            total.backward()
            loss_sum += total.detach()
            aux_sum += aux.detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    for p in leaves:
        p.grad = None
    return grads, loss_sum, aux_sum


def build_train_step(cfg: ModelConfig, hyper: TrainHyper = TrainHyper(),
                     impl: Optional[str] = None, *, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``; ``impl`` goes to
    every kernel wrapper of the forward and backward passes (None or
    "ref"); ``mesh``: a ``DeviceMesh`` the state's DTensors lie on (see
    the module docstring)."""
    sched = make_schedule(hyper.schedule, base_lr=hyper.base_lr,
                          warmup=hyper.warmup, total_steps=hyper.total_steps)
    remat = cfg.remat != "none"       # "full" or "dots"
    nmb = cfg.microbatches

    def train_step(state: TrainState, batch) -> tuple:
        params = state["params"]
        grads, loss_sum, aux_sum = _accumulate(cfg, params, batch, hyper,
                                               impl, remat, None)
        with torch.no_grad():
            if nmb > 1:
                for g in tree_leaves(grads):
                    g.div_(nmb)
            grads, gnorm = clip_by_global_norm(grads, hyper.clip)
            lr = sched(state["step"])
            adamw_update(grads, state["opt"], params, lr=lr, b1=hyper.b1,
                         b2=hyper.b2, wd=hyper.wd,
                         decay=decay_mask(cfg, params))
        state["step"] = state["step"] + 1
        metrics = {"loss": loss_sum / nmb, "aux": aux_sum / nmb,
                   "grad_norm": gnorm, "lr": lr}
        return state, metrics

    def mesh_step(state: TrainState, batch) -> tuple:
        from repro_torch.dist import spmd
        compute, placements = spmd.gather_params(cfg, mesh, state["params"])
        grads, loss_sum, aux_sum = _accumulate(cfg, compute, batch, hyper,
                                               impl, remat, mesh)
        with torch.no_grad():
            for g in tree_leaves(grads):
                spmd.all_reduce_(g, mesh, spmd.data_dims(mesh))
            sharded = constrain_like_params(
                cfg, mesh, spmd.to_dtensors(grads, mesh, placements))
            grads = spmd.local(sharded)
            if nmb > 1:
                for g in tree_leaves(grads):
                    g.div_(nmb)
            gnorm = spmd.global_norm(list(tree_leaves(sharded)))
            grads, _ = clip_by_global_norm(grads, hyper.clip, norm=gnorm)
            params = spmd.local(state["params"])
            opt = spmd.local(state["opt"])
            step = spmd.local(state["step"])
            lr = sched(step)
            adamw_update(grads, opt, params, lr=lr, b1=hyper.b1,
                         b2=hyper.b2, wd=hyper.wd,
                         decay=decay_mask(cfg, params))
            count = state["opt"]["count"]
            state["opt"]["count"] = spmd.to_dtensors(
                opt["count"], mesh, count.placements)
            state["step"] = spmd.to_dtensors(step + 1, mesh,
                                             state["step"].placements)
        metrics = {"loss": loss_sum / nmb, "aux": aux_sum / nmb,
                   "grad_norm": gnorm, "lr": lr}
        return state, metrics

    return train_step if mesh is None else mesh_step


def build_eval_step(cfg: ModelConfig, impl: Optional[str] = None, *,
                    mesh=None):
    """``eval_step(params, batch) -> {"loss", "ntok"}``, no gradients, the
    master params as they are (no ``compute_cast``), as the JAX package;
    under ``mesh`` the params are DTensors (the step computes on their
    compute copies, as the train step does) and the batch the global
    rows."""
    @torch.no_grad()
    def eval_step(params, batch):
        if mesh is not None:
            from repro_torch.dist import spmd
            params, _ = spmd.gather_params(cfg, mesh, params)
            batch = {k: spmd.local_rows(v, mesh) for k, v in batch.items()}
        loss, ntok, _ = lm_loss(cfg, params, batch, impl, mesh=mesh)
        return {"loss": loss, "ntok": ntok}
    return eval_step

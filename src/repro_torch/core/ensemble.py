"""Fused ensemble execution: a homogeneous replica-exchange ensemble as one
program on one device (own copy of ``repro.core.ensemble``).

The paper schedules each replica as an independent task (O(N) dispatch, a
host round-trip at every exchange).  Here the members' states are stacked
on a leading axis, their train steps run through ``torch.func.vmap`` over
the port's functional ``forward``, and the exchange is computed on the
device (a Metropolis swap of the temperature vector).  Under ``vmap`` the
hand kernels' ``vmap`` rules fold the member axis into their batch (gmm's
into its expert axis: an MoE population's experts are disjoint), so one
launch serves every member (``kernels.fold_members``), and the block and
loss-chunk rematerialisation recomputes under the same ``vmap``
(``models.remat``).  Dispatch becomes one vmapped step per cycle for the
whole population.

Differences from the JAX package: the uniforms of the swap come in as a
tensor (``jax.random`` streams cannot be reproduced in torch; ``run``
draws them from its generator, ``draw_uniforms``); the state is updated in
place (the reference donates it).

With a ``mesh`` the member axis is sharded over its ``"data"`` axis (the
reference's ``P("data", ...)``; one slot = one member shard): each rank
steps its own members on their own batches, the losses are gathered for
the swap, which every rank decides alike, and the temperatures stay whole
on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.flags import DeviceLike, resolve_device
from repro_torch.models.transformer import forward, init_params
from repro_torch.optim.adamw import (
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.train.losses import chunked_softmax_xent
from repro_torch.train.step import decay_mask

AUX_WEIGHT = 0.01
CLIP = 1.0


def _member(tree, i: int):
    """Member ``i``'s view of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def _member_losses(cfg: ModelConfig, params, batch):
    """The (N,) losses of every member, cross-entropy + 0.01 aux: the
    value of the reference's ``_member_train_step`` loss under ``vmap``
    (no segment ids, remat as the config says, no compute cast)."""
    remat = cfg.remat != "none"

    def one(p, tokens, labels):
        out = forward(cfg, p, tokens, remat=remat)
        loss, _ = chunked_softmax_xent(cfg, p, out["h"], labels)
        return loss + AUX_WEIGHT * out["aux"]
    return torch.func.vmap(one)(params, batch["tokens"], batch["labels"])


def _fused_train_step(cfg: ModelConfig, members, batch, lr) -> torch.Tensor:
    """One train step of every member, in place: members' gradients from one
    backward pass of the summed losses (members share nothing), then each
    member's global-norm clip at 1.0 and AdamW at its own ``lr`` (a view of
    the (N,) temperatures) with the reference's other defaults.  Returns the
    (N,) losses that were differentiated, cross-entropy + 0.01 aux (dense
    archs have aux = 0), as the reference's ``_member_train_step``."""
    params = members["params"]
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        losses = _member_losses(cfg, params, batch)
        losses.sum().backward()
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), params)
    opt = members["opt"]
    with torch.no_grad():
        for i in range(losses.shape[0]):
            p_i = _member(params, i)
            g_i, _ = clip_by_global_norm(_member(grads, i), CLIP)
            opt_i = {"m": _member(opt["m"], i), "v": _member(opt["v"], i),
                     "count": opt["count"][i]}
            adamw_update(g_i, opt_i, p_i, lr=lr[i],
                         decay=decay_mask(cfg, p_i))
            opt["count"][i] = opt_i["count"]
        members["step"] += 1
    for p in leaves:
        p.grad = None
    return losses.detach()


def member_placements(mesh):
    """The member axis over ``"data"``, every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError(f"a fused ensemble's mesh needs a 'data' axis, "
                         f"not {names}")
    return tuple(Shard(0) if a == "data" else Replicate() for a in names)


def device_cycle(cfg: ModelConfig, steps_per_cycle: int, ens_state, batches,
                 u, mesh=None):
    """The device part of a cycle (``FusedEnsemble._build_cycle``):
    ``steps_per_cycle`` fused train steps, then the swap; updates
    ``ens_state`` in place (temperatures, cycle) and returns the last
    step's (N,) losses and the accepted pairs, on the device.  ``mesh``:
    the members are DTensors sharded over ``"data"``; ``batches``, ``u``
    and the temperatures are whole on every rank."""
    members, temps = ens_state["members"], ens_state["temps"]
    lr = temps
    if mesh is not None:
        from repro_torch.dist import spmd
        pl = member_placements(mesh)
        members = spmd.local(members)
        batches = {k: spmd.local_shard(batches[k], mesh, pl)
                   for k in ("tokens", "labels")}
        lr = spmd.local_shard(temps, mesh, pl)
    losses = None
    for s in range(steps_per_cycle):
        batch = {k: batches[k][:, s] for k in ("tokens", "labels")}
        losses = _fused_train_step(cfg, members, batch, lr)
    if mesh is not None:
        losses = spmd.gather(spmd.to_dtensors(losses, mesh, pl))
    new_temps, n_acc = metropolis_swap_device(
        losses, temps, ens_state["cycle"], u)
    ens_state["temps"] = new_temps
    ens_state["cycle"] = ens_state["cycle"] + 1
    return losses, n_acc


def metropolis_swap_device(losses, temps, cycle, u):
    """On-device even/odd Metropolis swap of the temperature vector.
    losses, temps, u: (N,), u the uniforms in (0, 1] (``draw_uniforms``);
    cycle: an int or a 0-d tensor.  Returns (new_temps, n_accepted)."""
    n = losses.shape[0]
    idx = torch.arange(n, device=losses.device)
    is_left = (idx % 2) == (cycle % 2)
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < n)
    partner = partner.clamp(0, n - 1)
    e_i, e_j = losses, losses[partner]
    t_i, t_j = temps, temps[partner]
    # d is symmetric in the pair: swapping (i, j) negates both factors, so
    # each member computes the same acceptance exponent as its partner
    d = (e_i - e_j) * (1.0 / t_i - 1.0 / t_j)
    # both members read the pair leader's (left member's) uniform draw, so
    # the accept decision is mirrored exactly across the pair
    leader = torch.where(is_left, idx, partner)
    accept = valid & (torch.log(u)[leader] < d)
    new_temps = torch.where(accept, temps[partner], temps)
    return new_temps, torch.sum(accept) // 2


def draw_uniforms(n: int, gen: torch.Generator) -> torch.Tensor:
    """(n,) float32 uniforms in [1e-12, 1) from ``gen`` on its device, as
    the reference draws ``jax.random.uniform(key, (n,), minval=1e-12)``."""
    return torch.empty(n, dtype=torch.float32, device=gen.device).uniform_(
        1e-12, 1.0, generator=gen)


class FusedEnsemble:
    """Homogeneous replica-exchange ensemble as one vmapped program
    (``device``: cuda unless the caller asks for the CPU; ``mesh``: the
    member axis sharded over its ``"data"`` axis, ``mesh=None`` one
    device)."""

    def __init__(self, cfg: ModelConfig, n_members: int, *,
                 device: DeviceLike = None, mesh=None,
                 base_temp: float = 3e-4, temp_ratio: float = 1.3):
        self.cfg = cfg
        self.n = n_members
        self.mesh = mesh
        self.device = resolve_device(device)
        self.temps0 = torch.tensor(
            [base_temp * temp_ratio ** i for i in range(n_members)],
            dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------ state
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Members made one after another from ``gen`` (on the ensemble's
        device) into stacked (N, ...) leaves; zero moments, step 0."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, ensemble on "
                             f"{self.device}")
        stacked = None
        for i in range(self.n):
            params = init_params(self.cfg, gen)
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty((self.n,) + t.shape),
                                   params)
            for dst, src in zip(tree_leaves(_member(stacked, i)),
                                tree_leaves(params)):
                dst.copy_(src)
            del params
        md = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[self.cfg.optstate_dtype]

        def zeros(t):
            return torch.zeros(t.shape, dtype=md, device=t.device)
        n_zeros = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        members = {"params": stacked,
                   "opt": {"m": tree_map(zeros, stacked),
                           "v": tree_map(zeros, stacked),
                           "count": n_zeros.clone()},
                   "step": n_zeros}
        if self.mesh is not None:
            from repro_torch.dist import spmd
            pl = member_placements(self.mesh)
            members = tree_map(lambda t: spmd.distribute(t, self.mesh, pl),
                               members)
        return {"members": members, "temps": self.temps0.clone(),
                "cycle": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    # ------------------------------------------------------------ cycle
    def _build_cycle(self, steps_per_cycle: int, shape: ShapeSpec):
        """``cycle(ens_state, batches, u) -> (ens_state, metrics)``:
        ``batches`` {"tokens", "labels"} of (N, steps, B, S) int32, ``u``
        the (N,) uniforms of the swap.  The state is updated in place; the
        metrics ``{"losses", "accepted", "temps"}`` are on the host (the
        losses of each member's last step, cross-entropy + 0.01 aux: the
        swap's energies)."""
        cfg = self.cfg

        def cycle(ens_state, batches, u):
            losses, n_acc = device_cycle(cfg, steps_per_cycle, ens_state,
                                         batches, u, self.mesh)
            return ens_state, {"losses": losses.cpu().numpy(),
                               "accepted": int(n_acc),
                               "temps": ens_state["temps"].cpu().numpy()}
        return cycle

    def run(self, gen: torch.Generator, *, cycles: int, steps_per_cycle: int,
            shape: ShapeSpec, data_seed: int = 0) -> Tuple[Any, List[dict]]:
        """Returns (final ensemble state, per-cycle metrics).  ``gen`` makes
        the members and then each cycle's uniforms."""
        from repro_torch.data import SyntheticLM
        ens = self.init(gen)
        cyc = self._build_cycle(steps_per_cycle, shape)
        data = [SyntheticLM(self.cfg, shape, seed=data_seed + i,
                            device=self.device) for i in range(self.n)]
        history = []
        step0 = 0
        for _ in range(cycles):
            batches = _stack_members(
                [_stack_steps(data[i], step0, steps_per_cycle)
                 for i in range(self.n)])
            ens, m = cyc(ens, batches, draw_uniforms(self.n, gen))
            history.append(m)
            step0 += steps_per_cycle
        return ens, history


def _stack_members(per_member: List[Dict[str, torch.Tensor]]):
    return {k: torch.stack([b[k] for b in per_member])
            for k in per_member[0]}


def _stack_steps(ds, start: int, n: int) -> Dict[str, torch.Tensor]:
    return _stack_members([ds.batch_at(start + i) for i in range(n)])


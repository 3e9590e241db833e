"""One rank of a CPU process group, for ``tests/test_torch_dist_gloo.py``.

    python tests/_dist_worker.py RANK WORLD STORE_FILE OUT_JSON [MESH ...]

Joins a ``gloo`` group of WORLD ranks through a ``FileStore``, and for
each MESH (``2x1``: data x model) runs the port's train, eval and serve
paths on that mesh beside the same computation without one, in this
process.  Writes the largest differences it saw to OUT_JSON.

The references:

* gemma2-2b (fsdp; 2 microbatches, remat): ``mesh=None`` on the whole
  batch.
* qwen3-moe-30b-a3b (tp_ep): MoE capacity is reckoned per data shard, so
  the reference runs ``mesh=None`` on each data shard alone: the loss is
  the token-weighted mean of the shards' cross-entropies plus 0.01 times
  the mean of their aux losses, and its gradient is that sum's.  Its
  batch is 4 x 8 tokens: the reference's capacity block (8 or 128 rows)
  depends on T * k // E_local, which stays under 128 both on one rank and
  on each of two model ranks here, so the expert-parallel layer and the
  reference drop the same assignments (the rule itself is held against
  the JAX package's ``_moe_local`` by ``tests/test_torch_dist.py``).
"""
from __future__ import annotations

import copy
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.dist import spmd
from repro_torch.dist.sharding import state_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import (
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.serve import BatchedServer, Request
from repro_torch.train.step import (
    TrainHyper,
    _accumulate,
    build_eval_step,
    build_train_step,
    compute_cast,
    decay_mask,
    lm_loss,
    make_train_state,
)

HYPER = TrainHyper(warmup=2, total_steps=100, base_lr=1e-3)
B = 4
SEQ = {"gemma2-2b": 32, "qwen3-moe-30b-a3b": 8}


def configs():
    gemma = reduced(get_config("gemma2-2b")).replace(microbatches=2,
                                                     remat="full")
    qwen = reduced(get_config("qwen3-moe-30b-a3b"))
    return {"gemma2-2b": gemma, "qwen3-moe-30b-a3b": qwen}


def _state(cfg):
    return make_train_state(cfg, torch.Generator().manual_seed(0))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, SEQ[cfg.name.removesuffix(
        "-reduced")]))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -2:] = -1
    return {"tokens": torch.from_numpy(tokens).int(),
            "labels": torch.from_numpy(labels).int()}


def _maxdiff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _full(tree):
    return tree_map(lambda x: x.full_tensor() if spmd.is_dtensor(x) else x,
                    tree)


def _reference(cfg, state, batch, shards: int):
    """(loss, grads, state after one step) without a mesh; MoE: each of
    ``shards`` data shards alone."""
    state = copy.deepcopy(state)
    params = state["params"]
    if not cfg.num_experts:
        grads, loss, _ = _accumulate(cfg, params, batch, HYPER, None,
                                     cfg.remat != "none", None)
        grads = tree_map(lambda g: g / cfg.microbatches, grads)
        loss = loss / cfg.microbatches
        step = build_train_step(cfg, HYPER)
        state, m = step(state, batch)
        return float(m["loss"]), grads, state
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    rows = B // shards
    parts = [lm_loss(cfg, compute_cast(cfg, params),
                     {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
             for i in range(shards)]
    ntok = sum(n for _, n, _ in parts)
    nll = sum(m * n for m, n, _ in parts) / ntok
    aux = sum(a for _, _, a in parts) / shards
    total = nll + HYPER.aux_weight * aux
    total.backward()
    grads = tree_map(lambda p: p.grad.clone(), params)
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    with torch.no_grad():
        g, _ = clip_by_global_norm(tree_map(torch.clone, grads), HYPER.clip)
        from repro_torch.optim.schedules import make_schedule
        lr = make_schedule(HYPER.schedule, base_lr=HYPER.base_lr,
                           warmup=HYPER.warmup,
                           total_steps=HYPER.total_steps)(state["step"])
        adamw_update(g, state["opt"], params, lr=lr, b1=HYPER.b1,
                     b2=HYPER.b2, wd=HYPER.wd, decay=decay_mask(cfg, params))
    state["step"] = state["step"] + 1
    return float(total.detach()), grads, state


def train_checks(cfg, mesh, shards: int) -> dict:
    state = _state(cfg)
    batch = _batch(cfg)
    loss_ref, grads_ref, after_ref = _reference(cfg, state, batch, shards)
    dstate = spmd.distribute_tree(copy.deepcopy(state),
                                  state_shardings(cfg, mesh, state))
    # the gradient as the mesh step reckons it, gathered whole
    compute, placements = spmd.gather_params(cfg, mesh, dstate["params"])
    grads, _, _ = _accumulate(cfg, compute, batch, HYPER, None,
                              cfg.remat != "none", mesh)
    with torch.no_grad():
        for g in tree_leaves(grads):
            spmd.all_reduce_(g, mesh, spmd.data_dims(mesh))
        grads = _full(spmd.to_dtensors(grads, mesh, placements))
        grads = tree_map(lambda g: g / cfg.microbatches, grads)
    step = build_train_step(cfg, HYPER, mesh=mesh)
    dstate, m = step(dstate, batch)
    ev = build_eval_step(cfg, mesh=mesh)(dstate["params"], batch)
    ev_ref = build_eval_step(cfg)(after_ref["params"], batch) \
        if not cfg.num_experts else None
    local_bytes = sum(x.to_local().numel() * x.element_size()
                      for x in tree_leaves(dstate))
    out = {"loss": float(m["loss"]), "loss_ref": loss_ref,
           "grad_err": _maxdiff(grads, grads_ref),
           "grad_scale": max(float(g.abs().max())
                             for g in tree_leaves(grads_ref)),
           "param_err": _maxdiff(_full(dstate["params"]),
                                 after_ref["params"]),
           "moment_err": _maxdiff(_full(dstate["opt"]), after_ref["opt"]),
           "step": int(_full(dstate["step"])),
           "local_state_bytes": local_bytes,
           "full_state_bytes": sum(x.numel() * x.element_size()
                                   for x in tree_leaves(state)),
           "placements": sorted({str(x.placements)
                                 for x in tree_leaves(dstate["params"])})}
    if ev_ref is not None:
        out["eval_loss"] = float(ev["loss"])
        out["eval_loss_ref"] = float(ev_ref["loss"])
    return out


def serve_checks(cfg, mesh) -> dict:
    params = _state(cfg)["params"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(5)]

    def serve(m):
        srv = BatchedServer(cfg, copy.deepcopy(params), batch=2,
                            prompt_len=8, max_len=16, device="cpu", mesh=m)
        srv.submit([Request(rid=i, prompt=p, max_new_tokens=3 + i % 3)
                    for i, p in enumerate(prompts)])
        return {r.rid: list(r.out_tokens) for r in srv.run()}
    got, want = serve(mesh), serve(None)
    return {"tokens": got, "tokens_ref": want}


def fused_checks(cfg, mesh) -> dict:
    """Two cycles of a 2-member ``FusedEnsemble``, members over "data"."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.ensemble import FusedEnsemble
    shape = ShapeSpec("f", "prefill", 16, 2)

    def run(m):
        fe = FusedEnsemble(cfg, 2, device="cpu", mesh=m)
        _, hist = fe.run(torch.Generator().manual_seed(0), cycles=2,
                         steps_per_cycle=1, shape=shape)
        return [[float(x) for x in h["losses"]] for h in hist], \
            [[float(x) for x in h["temps"]] for h in hist]
    (losses, temps), (want_l, want_t) = run(mesh), run(None)
    return {"losses": losses, "losses_ref": want_l, "temps": temps,
            "temps_ref": want_t}


def loop_checks(cfg, mesh) -> dict:
    """``launch.train.train_loop`` on the mesh and without one."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import make_hyper, train_loop
    shape = ShapeSpec("cli", "train", 32, 4)

    def run(m):
        hist = train_loop(cfg, shape, _state(cfg), steps=3,
                          hyper=make_hyper(3, 1e-3, "cosine"), device="cpu",
                          log=lambda _: None, mesh=m)
        return [h["loss"] for h in hist]
    return {"losses": run(mesh), "losses_ref": run(None)}


def checkpoint_checks(cfg, mesh, directory) -> dict:
    """A DTensor state saved (each leaf gathered whole) and restored onto
    its shardings: every rank's shards equal the state's."""
    from repro_torch.checkpoint import Checkpointer
    state = _state(cfg)
    sh = state_shardings(cfg, mesh, state)
    dstate = spmd.distribute_tree(copy.deepcopy(state), sh)
    ck = Checkpointer(directory)
    ck.save(dstate, 3)
    got, step = ck.restore(state, shardings=sh, device="cpu")
    same = all(
        spmd.is_dtensor(a) and a.placements == b.placements
        and torch.equal(a.to_local(), b.to_local())
        for a, b in zip(tree_leaves(got), tree_leaves(dstate)))
    return {"step": step, "same_shards": same}


def pilot_checks() -> dict:
    """The RE exchange on a mesh-aware pilot: one slot of every rank, the
    swap placed on the granted submesh's first rank's device."""
    from repro_torch.core import (AppManager, Kernel, PipelineSpec, Stage,
                                  TaskSpec)
    from repro_torch.dist.topology import SlotTopology
    from repro_torch.runtime.executor import PilotRuntime
    topo = SlotTopology.even(list(range(dist.get_world_size())), 1,
                             ("model",))
    rt = PilotRuntime(mode="real", topology=topo)
    xk = Kernel("re.exchange")
    temps = [1.0, 10.0, 20.0, 40.0]
    xk.arguments = {"replicas": 4, "cycle": 0, "temps": temps,
                    "losses": [10.0, 0.0, 0.0, 0.0], "device": True}
    prof = AppManager(rt).run(
        PipelineSpec([Stage([TaskSpec(xk, name="x")], name="exchange")],
                     name="re"))
    res = prof.results["tasks"]["x"]
    return {"n_failed": prof.n_failed, "temps": res["temps"],
            "accepted": [list(p) for p in res["accepted"]],
            "free_ids": sorted(rt._free_ids)}


def main(argv):
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    try:
        results["pilot"] = pilot_checks()
        for name in argv[4:]:
            shape = tuple(int(s) for s in name.split("x"))
            mesh = make_host_mesh(shape, ("data", "model"))
            for arch, cfg in configs().items():
                results[f"{name}/{arch}"] = train_checks(cfg, mesh, shape[0])
            results[f"{name}/serve"] = serve_checks(
                configs()["qwen3-moe-30b-a3b"], mesh)
            results[f"{name}/serve_gemma"] = serve_checks(
                reduced(get_config("gemma2-2b")), mesh)
            results[f"{name}/fused"] = fused_checks(
                reduced(get_config("gemma2-2b")), mesh)
            results[f"{name}/train_loop"] = loop_checks(
                reduced(get_config("gemma2-2b")), mesh)
            results[f"{name}/checkpoint"] = checkpoint_checks(
                configs()["qwen3-moe-30b-a3b"], mesh,
                f"{out}.{name}.ckpt")
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1:])

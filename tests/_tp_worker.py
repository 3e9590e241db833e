"""One rank of a CPU process group, for ``tests/test_torch_tp.py``: the
port's tensor-parallel compute over ``model`` against ``mesh=None``.

    python tests/_tp_worker.py RANK WORLD STORE_FILE OUT_JSON [MESH ...]

Joins a ``gloo`` group of WORLD ranks through a ``FileStore``, and for
each MESH (``1x2``: data x model) and each config of ``configs()`` runs, in
this process, the mesh step beside the same computation without a mesh
(``tests/_dist_worker.py``'s reference: MoE capacity is reckoned per data
shard, so the MoE reference runs each data shard alone):

* train: the loss, every gradient (each rank's shards gathered whole),
  the parameters after one AdamW step against the unsharded AdamW on
  those gradients, the moments against the reference's, the eval loss;
  and each compute copy's size: a leaf the spec splits over ``model``
  keeps its shard (1/m of its elements), every other leaf is whole;
* serve: greedy tokens of ``BatchedServer(mesh=)`` and of a prefill with
  the config's stub inputs (whisper's frames: the cross-attention cache)
  followed by decode steps, with the last logits of each.

Writes every reading to OUT_JSON.
"""
from __future__ import annotations

import copy
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from _dist_worker import (HYPER, _full, _maxdiff, _reference, adamw_step,
                          maxdiff_far)
from repro_torch.configs import get_config, reduced
from repro_torch.dist import spmd
from repro_torch.dist.sharding import state_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve import (BatchedServer, Request, build_prefill_step,
                               build_serve_step)
from repro_torch.train.step import (
    _accumulate,
    build_eval_step,
    build_train_step,
    make_train_state,
)

B = 4


def configs():
    """{name: (config, sequence length)}: every layer kind and sharding
    profile, the vocab-parallel embedding and loss (V = 256; the reduced
    configs' 257 takes the d_model split), and case (c) at model = 4
    (H = 6, KH = 2), and gemma2-2b under ``remat="dots"`` (trained
    only).  falcon-mamba-7b's 4 x 32 rows exceed its d_model
    (64), so its train step gathers ``in_proj`` and its decode steps the
    product (``layers._mamba_in``)."""
    gemma = reduced(get_config("gemma2-2b"))
    return {
        "gemma2-2b": (gemma.replace(microbatches=2, remat="full"), 32),
        "recurrentgemma-2b": (reduced(get_config("recurrentgemma-2b")), 32),
        "falcon-mamba-7b": (reduced(get_config("falcon-mamba-7b")), 32),
        "qwen3-moe-30b-a3b": (reduced(get_config("qwen3-moe-30b-a3b")), 8),
        "grok-1-314b": (reduced(get_config("grok-1-314b")), 8),
        "whisper-large-v3": (reduced(get_config("whisper-large-v3")), 16),
        "gemma2-2b-v256": (gemma.replace(name="gemma2-2b-v256",
                                         vocab_size=256), 32),
        "gemma2-2b-h6": (gemma.replace(name="gemma2-2b-h6", num_heads=6,
                                       num_kv_heads=2), 32),
        "gemma2-2b-dots": (gemma.replace(name="gemma2-2b-dots",
                                         microbatches=2, remat="dots"), 32),
    }


# configs whose serving is another config's: remat is for training only
TRAIN_ONLY = ("gemma2-2b-dots",)


def _stubs(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers:
        out["enc_frames"] = torch.from_numpy(rng.normal(
            size=(rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _batch(cfg, seq, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, seq))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -2:] = -1
    return {"tokens": torch.from_numpy(tokens).int(),
            "labels": torch.from_numpy(labels).int(),
            **_stubs(cfg, B, seed + 1)}


def _model_split(mesh, placements) -> bool:
    from torch.distributed.tensor import Shard
    md = spmd.model_dim(mesh)
    return md is not None and isinstance(placements[md], Shard)


def compute_copies(cfg, mesh, dstate, state) -> dict:
    """The compute copies' sizes against the whole leaves: a ``model``
    shard is 1/m of its leaf, every other copy the whole leaf."""
    compute, placements = spmd.gather_params(cfg, mesh, dstate["params"])
    m = int(mesh.shape[spmd.model_dim(mesh)])
    whole = {}
    from repro_torch.dist.sharding import tree_map_with_path
    tree_map_with_path(lambda p, x: whole.__setitem__(p, x.numel()),
                       state["params"])
    bad, split = [], 0
    got = {}
    tree_map_with_path(lambda p, x: got.__setitem__(p, x.numel()), compute)
    for path, n in got.items():
        sharded = m > 1 and _model_split(mesh, placements[path])
        split += sharded
        if n * (m if sharded else 1) != whole[path]:
            bad.append("/".join(path))
    return {"model_split_leaves": split, "bad_compute_copies": bad}


def train_checks(cfg, seq, mesh, shards: int) -> dict:
    state = make_train_state(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg, seq)
    loss_ref, grads_ref, after_ref = _reference(cfg, state, batch, shards)
    dstate = spmd.distribute_tree(copy.deepcopy(state),
                                  state_shardings(cfg, mesh, state))
    out = compute_copies(cfg, mesh, dstate, state)
    compute, placements = spmd.gather_params(cfg, mesh, dstate["params"])
    grads, _, _ = _accumulate(cfg, compute, batch, HYPER, None,
                              cfg.remat != "none", mesh)
    with torch.no_grad():
        for g in tree_leaves(grads):
            spmd.all_reduce_(g, mesh, spmd.data_dims(mesh))
        grads = _full(spmd.to_dtensors(grads, mesh, placements))
        grads = tree_map(lambda g: g / cfg.microbatches, grads)
    dstate, m = build_train_step(cfg, HYPER, mesh=mesh)(dstate, batch)
    out.update({
        "loss": float(m["loss"]), "loss_ref": loss_ref,
        "grad_err": _maxdiff(grads, grads_ref),
        "grad_scale": max(float(g.abs().max())
                          for g in tree_leaves(grads_ref)),
        "param_err": _maxdiff(_full(dstate["params"]),
                              adamw_step(cfg, state, grads)["params"]),
        "param_err_reference": _maxdiff(_full(dstate["params"]),
                                        after_ref["params"]),
        "param_err_far": maxdiff_far(_full(dstate["params"]),
                                     after_ref["params"], grads_ref),
        "moment_err": _maxdiff(_full(dstate["opt"]), after_ref["opt"]),
        "step": int(_full(dstate["step"]))})
    if not cfg.num_experts:
        ev = build_eval_step(cfg, mesh=mesh)(dstate["params"], batch)
        ev_ref = build_eval_step(cfg)(after_ref["params"], batch)
        out["eval_loss"] = float(ev["loss"])
        out["eval_loss_ref"] = float(ev_ref["loss"])
    return out


def _greedy(cfg, params, mesh, seq, new=3):
    """A prefill of 2 rows (with the config's stub inputs) and ``new``
    greedy decode steps from its cache: (tokens, last logits)."""
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, seq))).int(),
        **_stubs(cfg, 2, 6)}
    if mesh is not None:
        params = spmd.distribute_tree(params,
                                      state_shardings(cfg, mesh, params))
    out = build_prefill_step(cfg, cache_len=seq + new, mesh=mesh)(params,
                                                                  batch)
    step = build_serve_step(cfg, mesh=mesh)
    cache, logits = out["cache"], out["logits"]
    toks = []
    for t in range(new):
        nxt = logits[:, 0].argmax(-1)
        toks.append(nxt.tolist())
        logits, cache = step(params, cache, nxt[:, None].long(),
                             torch.full((2,), seq + t, dtype=torch.int32))
    return toks, logits[:, 0]


def serve_checks(cfg, seq, mesh) -> dict:
    params = make_train_state(cfg, torch.Generator().manual_seed(0))[
        "params"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(5)]

    def serve(m):
        srv = BatchedServer(cfg, copy.deepcopy(params), batch=2,
                            prompt_len=8, max_len=16, device="cpu", mesh=m)
        srv.submit([Request(rid=i, prompt=p, max_new_tokens=3 + i % 3)
                    for i, p in enumerate(prompts)])
        return {r.rid: list(r.out_tokens) for r in srv.run()}
    with torch.inference_mode():
        got, want = serve(mesh), serve(None)
        g_toks, g_last = _greedy(cfg, copy.deepcopy(params), mesh, seq)
        w_toks, w_last = _greedy(cfg, copy.deepcopy(params), None, seq)
    return {"tokens": got, "tokens_ref": want, "greedy": g_toks,
            "greedy_ref": w_toks,
            "logit_err": float((g_last - w_last).abs().max()),
            "logit_scale": float(w_last.abs().max())}


def main(argv):
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    try:
        for name in argv[4:]:
            shape = tuple(int(s) for s in name.split("x"))
            mesh = make_host_mesh(shape, ("data", "model"))
            for arch, (cfg, seq) in configs().items():
                results[f"{name}/{arch}/train"] = train_checks(
                    cfg, seq, mesh, shape[0])
                if arch not in TRAIN_ONLY:
                    results[f"{name}/{arch}/serve"] = serve_checks(
                        cfg, seq, mesh)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1:])

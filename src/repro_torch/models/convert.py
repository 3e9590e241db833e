"""Map parameters, train states and caches between the JAX package's layout
and the port's.

The JAX package keys every leaf by its ``/``-joined tree path (as its
checkpointer does, ``repro/checkpoint/checkpoint.py``) and stacks the layers
of each pattern period into ``(G, ...)`` leaves under ``blocks/sub_<s>/...``,
with the remainder under ``tail/block_<j>/...``.  The port keeps one dict
per layer in ``params["layers"]``: layer ``i = g * period + s`` for scanned
groups and ``i = G * period + j`` for the tail.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import _layout

Flat = Dict[str, np.ndarray]


def _to_tensor(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):    # a restored checkpoint's leaf
        return arr.to(device=device, copy=True)
    arr = np.array(arr)      # an own, writable copy: the port updates caches
    if arr.dtype.name == "bfloat16":    # numpy extension dtype of JAX arrays
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        *head, last = key.split("/")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return out


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def layers_from_numpy(flat: Flat, cfg: ModelConfig,
                      device="cpu") -> List[Dict[str, Any]]:
    """The per-layer dicts held by the ``blocks/...`` and ``tail/...``
    leaves of ``flat`` (parameters or a decode cache)."""
    period, G, _ = _layout(cfg)
    per_layer: List[Dict[str, Any]] = [{} for _ in range(cfg.num_layers)]
    for key, arr in flat.items():
        root, node, rest_key = (key.split("/", 2) + ["", ""])[:3]
        if root == "blocks":
            s = int(node.removeprefix("sub_"))
            for g in range(G):
                per_layer[g * period + s][rest_key] = _to_tensor(arr[g],
                                                                 device)
        elif root == "tail":
            j = int(node.removeprefix("block_"))
            per_layer[G * period + j][rest_key] = _to_tensor(arr, device)
    return [_nest(d) for d in per_layer]


def params_from_numpy(flat: Flat, cfg: ModelConfig, device="cpu"):
    """``{"/"-joined JAX key path: np.ndarray}`` -> the port's params."""
    top = {k: _to_tensor(v, device) for k, v in flat.items()
           if k.split("/", 1)[0] not in ("blocks", "tail")}
    params = _nest(top)
    params["layers"] = layers_from_numpy(flat, cfg, device)
    return params


def params_to_flat(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's params -> the JAX package's flat key paths (restacked),
    as host tensors in their own dtypes (what a checkpoint writes)."""
    period, G, _ = _layout(cfg)
    flat = {k: v.detach().cpu() for k, v in
            _flatten({k: v for k, v in params.items()
                      if k != "layers"}).items()}
    stacks: Dict[str, List[torch.Tensor]] = {}
    for i, layer in enumerate(params["layers"]):
        for rest, t in _flatten(layer).items():
            if i < G * period:
                stacks.setdefault(f"blocks/sub_{i % period}/{rest}",
                                  []).append(t.detach().cpu())
            else:
                flat[f"tail/block_{i - G * period}/{rest}"] = t.detach().cpu()
    for key, ts in stacks.items():
        flat[key] = torch.stack(ts)
    return flat


def train_state_from_numpy(flat: Flat, cfg: ModelConfig, device="cpu"):
    """A JAX train state's flat key paths (``params/...``, ``opt/m/...``,
    ``opt/v/...``, ``opt/count``, ``step``) -> the port's train state.
    The leaves may be numpy arrays or tensors (a restored checkpoint)."""
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    return {"params": params_from_numpy(sub("params/"), cfg, device),
            "opt": {"m": params_from_numpy(sub("opt/m/"), cfg, device),
                    "v": params_from_numpy(sub("opt/v/"), cfg, device),
                    "count": _to_tensor(flat["opt/count"], device)},
            "step": _to_tensor(flat["step"], device)}


def train_state_to_flat(state, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's train state -> the JAX package's flat key paths, as host
    tensors in their own dtypes."""
    flat: Dict[str, torch.Tensor] = {}
    for prefix, tree in (("params/", state["params"]),
                         ("opt/m/", state["opt"]["m"]),
                         ("opt/v/", state["opt"]["v"])):
        flat.update({prefix + k: v
                     for k, v in params_to_flat(tree, cfg).items()})
    flat["opt/count"] = state["opt"]["count"].detach().cpu()
    flat["step"] = state["step"].detach().cpu()
    return flat


def ensemble_state_from_numpy(flat: Flat, cfg: ModelConfig, device="cpu"):
    """A JAX ``FusedEnsemble`` state's flat key paths (``members/...``: a
    train state's leaves, each with a leading member axis; ``temps``;
    ``cycle``) -> the port's: members stacked on a leading axis of every
    leaf (``core.ensemble.FusedEnsemble``'s layout)."""
    members = {k[len("members/"):]: v for k, v in flat.items()
               if k.startswith("members/")}
    n = len(next(iter(members.values())))
    states = [train_state_from_numpy({k: v[i] for k, v in members.items()},
                                     cfg, "cpu") for i in range(n)]
    return {"members": _stack(states, device),
            "temps": _to_tensor(flat["temps"], device),
            "cycle": _to_tensor(flat["cycle"], device)}


def ensemble_state_to_flat(state, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's ensemble state -> the JAX package's flat key paths, as
    host tensors in their own dtypes (each member leaf (N, ...))."""
    members = state["members"]
    n = members["step"].shape[0]
    per = [train_state_to_flat({"params": _index(members["params"], i),
                                "opt": {"m": _index(members["opt"]["m"], i),
                                        "v": _index(members["opt"]["v"], i),
                                        "count": members["opt"]["count"][i]},
                                "step": members["step"][i]}, cfg)
           for i in range(n)]
    flat = {f"members/{k}": torch.stack([p[k] for p in per]) for k in per[0]}
    flat["temps"] = state["temps"].detach().cpu()
    flat["cycle"] = state["cycle"].detach().cpu()
    return flat


def _stack(trees, device):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees], device)
                           for i in range(len(first)))
    return torch.stack(trees).to(device)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]

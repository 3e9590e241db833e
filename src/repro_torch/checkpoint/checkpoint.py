"""Sharded checkpointing: save/restore state trees (own copy of
``repro.checkpoint.checkpoint``, in its layout).

Layout: <dir>/step_<n:010d>/shard_<host>.npz + manifest.json (``step``,
sorted ``keys``, ``shapes``, ``dtypes``).  Each host writes only its
addressable shard data (single host here; the structure is the multi-host
one).  A save is published atomically (written under ``.tmp``, then
renamed).  Async mode copies to host memory synchronously and writes in a
background thread so the train loop isn't blocked on disk; ``wait()``
joins the writers.  Retention keeps the newest ``keep`` checkpoints.

Leaves are keyed by their ``/``-joined tree paths, as the JAX package keys
them; a port train state goes through
``models.convert.train_state_to_flat`` first, so its keys are the JAX
train state's.  bfloat16 leaves are written as 2-byte data (``|V2``, what
numpy writes for the JAX package's bfloat16 arrays) with ``"bfloat16"`` in
the manifest, and restore reads the manifest's ``dtypes``, so such a leaf
from either package comes back as ``torch.bfloat16``.  Saving a step that
is already published keeps the published one and writes nothing (a
preempted save's late writer and its retry save the same step of the same
state, as the tasks of a member take turns on its lock).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.flags import resolve_device

_BF16_DISK = np.dtype("V2")


def _walk(tree, path: Tuple = ()):
    """(path, leaf) of a tree of dicts, lists and tuples; dict keys in
    sorted order, as JAX flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(state) -> Dict[str, Any]:
    return {_key(path): leaf for path, leaf in _walk(state)}


def _unflatten_into(template, arrays: Dict[str, Any], path: Tuple = ()):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, arrays, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, arrays, path + (i,))
                              for i, v in enumerate(template))
    key = _key(path)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    return arrays[key]


def _host(leaf, copy: bool) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf; ``copy``: never share
    memory with the leaf (an async save's leaves may change meanwhile)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.to("cpu", copy=True) if copy else t.cpu()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).numpy().view(_BF16_DISK),
                    "bfloat16")
        arr = t.numpy()
    else:
        arr = np.array(leaf) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")     # keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, host: int = 0):
        self.dir = directory
        self.keep = keep
        self.host = host
        self._pending: List[threading.Thread] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save
    def save(self, state, step: int, *, blocking: bool = True) -> str:
        host = {k: _host(v, copy=not blocking)
                for k, v in _flatten(state).items()}
        d = os.path.join(self.dir, f"step_{step:010d}")
        tmp = d + ".tmp"

        def write():
            if os.path.isdir(d):      # published already: that one stays
                return
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"shard_{self.host}.npz"),
                     **{k: a for k, (a, _) in host.items()})
            manifest = {
                "step": step,
                "keys": sorted(host),
                "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
                "dtypes": {k: dt for k, (_, dt) in host.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, d)           # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._pending.append(t)
        return d

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, *,
                shardings=None, device=None):
        """(state, step): ``template``'s tree filled with the checkpoint's
        leaves as tensors on ``device`` (default ``cuda``), in the dtypes
        the manifest names; ``template=None`` gives the flat
        ``{key: tensor}`` dict of every leaf."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto shardings waits for device meshes in the "
                "port (ROADMAP A9)")
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        with np.load(os.path.join(d, f"shard_{self.host}.npz")) as z:
            arrays = {k: _from_disk(z[k], dtypes[k]).to(device)
                      for k in z.files}
        if template is None:
            return arrays, step
        return _unflatten_into(template, arrays), step

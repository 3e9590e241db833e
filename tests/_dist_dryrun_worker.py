"""Rank 0 of fake process groups of 256 and 512 ranks, for
``tests/test_torch_dist_dryrun.py``.

    python tests/_dist_dryrun_worker.py bytes|cells OUT_JSON

``bytes``: for each production mesh and every registered arch, lays the params out
as ``launch.dryrun.reckon`` does (DTensors of this rank's shard shapes, on
fake tensors) and records this rank's bytes of them.  ``cells``: reckons
gemma2-2b's train_4k cell on both meshes and qwen3-moe-30b-a3b's
decode_32k on ``pod16x16`` through ``launch.dryrun.run_cell``.
"""
from __future__ import annotations

import json
import math
import sys

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config, list_configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh


def param_bytes(cfg, mesh) -> int:
    with FakeTensorMode(allow_non_fake_inputs=True):
        return dryrun._exact_bytes(dryrun._params(cfg, dryrun.FAKE_DEVICE,
                                                  mesh=mesh))


def main(part, out):
    torch.set_num_threads(1)
    res = {}
    if part == "bytes":
        for name, (shape, _) in PRODUCTION_MESHES.items():
            with dryrun.fake_world(math.prod(shape)):
                mesh = make_production_mesh(multi_pod=name == "pod2x16x16")
                for arch in list_configs():
                    res[f"{arch}/{name}"] = param_bytes(get_config(arch),
                                                        mesh)
    for arch, shape, mesh in ([] if part == "bytes" else [
            ("gemma2-2b", "train_4k", "pod16x16"),
            ("gemma2-2b", "train_4k", "pod2x16x16"),
            ("qwen3-moe-30b-a3b", "decode_32k", "pod16x16")]):
        r = dryrun.run_cell(arch, shape, mesh=mesh, save=False)
        res[f"{arch}/{shape}/{mesh}"] = {
            k: r.get(k) for k in ("status", "error", "mesh", "chips",
                                  "state_bytes_exact", "peak_bytes",
                                  "kernel_calls", "fits")}
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:])

"""The port's production-mesh dry run on fake process groups of 256 and
512 ranks (``torch.testing._internal.distributed.fake_pg``), each in a
subprocess of its own (``tests/_dist_dryrun_worker.py``,
``python -m repro_torch.launch.ensemble_dryrun``), held against the JAX
package's specs.

* Each rank's bytes of every arch's params, and of gemma2-2b's whole train
  state in the reckoned train_4k cells, equal the sum over the JAX
  package's leaves of each leaf's shard: its bytes over the product of the
  mesh axes its spec names (``repro.dist.sharding.state_shardings`` on
  ``train_state_specs``).
* The reckoned cells run the mesh steps through the hand kernels' fake
  route: gemma2-2b's train step 52 flash forward and 26 backward calls
  (remat, one microbatch per rank's rows), qwen3's decode step 144 gmm.
* ``launch.ensemble_dryrun`` prints the JAX example's lines: a 512-rank
  pilot, 2 pod slots of 256 ranks, each member on its own pod.
"""
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.train import train_state_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "MASTER_", "RANK", "WORLD_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(cmd):
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    worker = str(ROOT / "tests" / "_dist_dryrun_worker.py")
    cmds = {"bytes": [sys.executable, worker, "bytes",
                      str(tmp / "bytes.json")],
            "cells": [sys.executable, worker, "cells",
                      str(tmp / "cells.json")],
            "ensemble": [sys.executable, "-m",
                         "repro_torch.launch.ensemble_dryrun"]}
    with ThreadPoolExecutor(len(cmds)) as pool:
        outs = {k: pool.submit(_run, c) for k, c in cmds.items()}
        outs = {k: f.result() for k, f in outs.items()}
    return {"bytes": json.loads((tmp / "bytes.json").read_text()),
            "cells": json.loads((tmp / "cells.json").read_text()),
            "ensemble": outs["ensemble"]}


def _shard_bytes(cfg, mesh_name, specs) -> int:
    shape, axes = MESHES[mesh_name]
    mesh = jsh.abstract_mesh(shape, axes)
    sizes = dict(zip(axes, shape))
    sh = jsh.state_shardings(cfg, mesh, specs)
    total = 0
    for x, s in zip(jax.tree.leaves(specs), jax.tree.leaves(sh)):
        n = math.prod(sizes[a] for e in s.spec if e is not None
                      for a in (e if isinstance(e, tuple) else (e,)))
        size = math.prod(x.shape) * np.dtype(x.dtype).itemsize
        assert size % n == 0
        total += size // n
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(jax_list_configs()))
def test_rank_param_bytes_follow_the_jax_spec(runs, arch, mesh_name):
    cfg = jax_get_config(arch)
    specs = jax.eval_shape(lambda: jax_init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    assert runs["bytes"][f"{arch}/{mesh_name}"] == \
        _shard_bytes(cfg, mesh_name, specs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_reckoned_train_cell_on_a_production_mesh(runs, mesh_name):
    r = runs["cells"][f"gemma2-2b/train_4k/{mesh_name}"]
    assert r["status"] == "ok", r["error"]
    assert r["mesh"] == mesh_name
    assert r["chips"] == math.prod(MESHES[mesh_name][0])
    cfg = jax_get_config("gemma2-2b")
    assert r["state_bytes_exact"] == _shard_bytes(cfg, mesh_name,
                                                  train_state_specs(cfg))
    assert r["kernel_calls"] == {
        "flash_attention": 52, "flash_attention.wgmma": 52,
        "flash_attention_bwd": 26, "flash_attention_bwd.wgmma": 26}
    assert r["peak_bytes"] > r["state_bytes_exact"]


def test_reckoned_expert_parallel_decode_cell(runs):
    r = runs["cells"]["qwen3-moe-30b-a3b/decode_32k/pod16x16"]
    assert r["status"] == "ok", r["error"]
    assert r["kernel_calls"] == {"gmm": 144, "gmm.mma_sync": 144}


def test_ensemble_dryrun_prints_the_examples_lines(runs):
    lines = [ln for ln in runs["ensemble"].splitlines()
             if not ln.startswith("[rank")]
    assert lines[0] == ("pilot: 512 ranks, axes ('pod', 'data', 'model') "
                        "{'pod': 2, 'data': 16, 'model': 16}")
    assert lines[1] == "slots: 2 pods x 256 ranks"
    assert lines[2].startswith("member 0: pod devices [0..255] reckoned in")
    assert lines[3].startswith("member 1: pod devices [256..511] reckoned")
    for ln in lines[2:4]:
        assert "MB/rank" in ln and "GB/rank" in ln
    assert lines[4].startswith("ensemble-of-pods dry-run OK: 2 members ran "
                               "as disjoint 256-rank SPMD programs")

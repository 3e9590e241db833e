"""The port's production-mesh dry run on fake process groups of 256 and
512 ranks (``torch.testing._internal.distributed.fake_pg``), each part in
a subprocess of its own (``tests/_dist_dryrun_worker.py``,
``python -m repro_torch.launch.ensemble_dryrun``), held against the JAX
package's specs.  The parts start together; a test waits only on the part
it reads, under that part's own limit.

* Each rank's bytes of every arch's params, and of gemma2-2b's whole train
  state in the reckoned train_4k cells, equal the sum over the JAX
  package's leaves of each leaf's shard: its bytes over the product of the
  mesh axes its spec names (``repro.dist.sharding.state_shardings`` on
  ``train_state_specs``).
* The reckoned cells run the mesh steps through the hand kernels' fake
  route: gemma2-2b's train step 52 flash forward and 26 backward calls
  (remat, one microbatch per rank's rows), qwen3's decode step 144 gmm.
  The steps compute tensor-parallel over ``model``: gemma2-2b's train_4k
  fits one card on both meshes, a 1x2 mesh's rank (``--mesh 1x2``)
  peaks below the one-device step, and falcon-mamba-7b's train_4k (the
  ``in_proj`` gather over ``model``) fits one card on ``pod16x16``.
* ``launch.ensemble_dryrun`` prints the JAX example's lines: a 512-rank
  pilot, 2 pod slots of 256 ranks, each member on its own pod.
"""
import json
import math
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _procs import Started, child_env  # noqa: E402
from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.train import train_state_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_dist_dryrun_worker.py"
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# each part's limit in seconds, counted from its start: at least 3x its
# seconds inside the whole tier-1 run (6 xdist workers) on a slow host,
# where all parts run at once beside the other workers' tests (49, 57,
# 63, 84, 84, 84 and 98 s; 21-35 s each on a quiet host)
LIMITS = {"bytes": 180, "pod16x16": 240, "pod2x16x16": 240, "decode": 300,
          "two_rank": 300, "mamba": 300, "ensemble": 360}


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """Every part started at once; a test waits on the part it reads
    (``parts[name].wait()``)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    started = {}
    for name, limit in LIMITS.items():
        cmd = ([sys.executable, "-m", "repro_torch.launch.ensemble_dryrun"]
               if name == "ensemble" else
               [sys.executable, str(WORKER), name, str(tmp / f"{name}.json")])
        started[name] = Started(name, [cmd], [tmp / name], limit, cwd=ROOT,
                                env=child_env(ROOT))
    yield started
    for part in started.values():
        part.stop()


def _read(parts, name):
    """A part's JSON, once it has ended."""
    parts[name].wait()
    return json.loads(parts[name].logs[0].with_suffix(".json").read_text())


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
def test_rank_param_bytes_follow_the_jax_spec(parts, arch, mesh_name):
    cfg = jax_get_config(arch)
    specs = jax.eval_shape(lambda: jax_init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    assert _read(parts, "bytes")[f"{arch}/{mesh_name}"] == \
        _shard_bytes(cfg, mesh_name, specs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_reckoned_train_cell_on_a_production_mesh(parts, mesh_name):
    """The tensor-parallel step fits one card on both meshes: gemma2-2b's
    train_4k reckoned 129.84 GB a rank on pod16x16 while its compute
    gathered every parameter and ran replicated over ``model``."""
    r = _read(parts, mesh_name)[f"gemma2-2b/train_4k/{mesh_name}"]
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
    assert r["fits"] is True
    assert r["peak_bytes"] < 40e9


def test_reckoned_mamba_train_cell_on_pod16x16(parts):
    """falcon-mamba-7b's train_4k on one rank of pod16x16: Mamba computes
    tensor-parallel, its ``in_proj`` compute copy gathered over ``model``
    (the contiguous split gives the first half of the ranks only x's
    columns, ``layers._mamba_in``) and its gradient reduce-scattered back;
    the step fits one card and runs the scans as the one-rank step does
    (forward, remat recompute, backward: 64 layers)."""
    r = _read(parts, "mamba")["falcon-mamba-7b/train_4k/pod16x16"]
    assert r["status"] == "ok", r["error"]
    assert r["mesh"] == "pod16x16" and r["chips"] == 256
    assert r["kernel_calls"] == {"selective_scan": 128,
                                 "selective_scan_bwd": 64}
    assert r["fits"] is True
    assert r["state_bytes_exact"] < r["peak_bytes"] < 80e9


def test_reckoned_train_cell_on_a_two_rank_mesh(parts):
    """``launch.dryrun --mesh 1x2``: one rank of a (data, model) mesh of
    1 x 2 (the card's two-rank part): its state is its shards by the JAX
    specs on that mesh, its flash calls are the one-device step's (at half
    the heads), and its peak is below the one-device step's."""
    cells = _read(parts, "two_rank")
    r = cells["gemma2-2b/train_4k/1x2"]
    one = cells["gemma2-2b/train_4k/h100"]
    assert r["status"] == "ok", r["error"]
    assert one["status"] == "ok", one["error"]
    assert r["mesh"] == "1x2" and r["chips"] == 2
    cfg = jax_get_config("gemma2-2b")
    MESHES["1x2"] = ((1, 2), ("data", "model"))
    try:
        want = _shard_bytes(cfg, "1x2", train_state_specs(cfg))
    finally:
        del MESHES["1x2"]
    assert r["state_bytes_exact"] == want
    assert r["kernel_calls"] == one["kernel_calls"] == {
        "flash_attention": 52, "flash_attention.wgmma": 52,
        "flash_attention_bwd": 26, "flash_attention_bwd.wgmma": 26}
    assert r["fits"] and r["peak_bytes"] < one["peak_bytes"]


def test_reckoned_expert_parallel_decode_cell(parts):
    r = _read(parts, "decode")["qwen3-moe-30b-a3b/decode_32k/pod16x16"]
    assert r["status"] == "ok", r["error"]
    assert r["kernel_calls"] == {"gmm": 144, "gmm.mma_sync": 144}


def test_ensemble_dryrun_prints_the_examples_lines(parts):
    parts["ensemble"].wait()
    lines = [ln for ln in parts["ensemble"].stdout().splitlines()
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

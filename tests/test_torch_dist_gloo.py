"""The port's mesh paths on CPU process groups (``gloo``) of 2 and 4
ranks, each rank a subprocess of its own (``tests/_dist_worker.py``),
joined through a ``FileStore`` under ``tmp_path``, under its own timeout.

Meshes (data x model): (1, 2) and (2, 1) at world 2, (2, 2) at world 4.
On each, against the same computation without a mesh in the same
process:

* train, reduced gemma2-2b (fsdp, 2 microbatches, remat) and reduced
  qwen3-moe-30b-a3b (tp_ep: expert parallelism over ``model``): the loss
  within 1e-5, every gradient within 1e-4 of the largest, the parameters
  after one AdamW step within 1e-5 of the unsharded AdamW on the same
  gradients and of the reference's wherever its gradient is at least
  1e3 times AdamW's eps (``_dist_worker.FAR_FROM_EPS``), the moments
  within 1e-5 of the reference's, and each rank's state
  bytes its shards' (fewer than the whole where the spec shards); MoE
  capacity per data shard, so the MoE reference runs each shard alone;
* eval (gemma2-2b): the loss after the step within 1e-5;
* serve: greedy tokens of ``BatchedServer(mesh=...)`` exact, qwen3
  (continuous batching) and gemma2-2b (waves);
* ``FusedEnsemble(mesh=...)``: 2 members over "data", two cycles' losses
  and temperatures within 1e-6;
* ``launch.train.train_loop(mesh=...)``: three steps' losses within 1e-5;
* ``Checkpointer.restore(shardings=...)``: every rank's shards equal;
* a mesh-aware pilot (``PilotRuntime(topology=...)``): ``re.exchange``
  with ``device`` swaps on the granted submesh (the reference's
  ``test_exchange_kernel_swaps_on_granted_submesh``, whose topology holds
  JAX devices).

And the CPU rehearsal of ``chip_smoke.py``'s ``mesh`` phase on a one-rank
group (``tests/_mesh_phase_rehearsal.py``).
"""
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _procs import Started, child_env, rank_outputs  # noqa: E402
from _threads import _one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {2: ("1x2", "2x1"), 4: ("2x2",)}
CASES = [(w, m) for w, ms in WORLDS.items() for m in ms]


# each world's limit in seconds, counted from its start
LIMIT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds started at once; a test waits on the world it reads."""
    worlds = {}
    for w, meshes in WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"world{w}")
        cmds = [[sys.executable, str(ROOT / "tests" / "_dist_worker.py"),
                 str(r), str(w), str(tmp / "store"), str(tmp / f"out{r}.json"),
                 *meshes] for r in range(w)]
        worlds[w] = Started(f"world {w}", cmds,
                            [tmp / f"rank{r}" for r in range(w)], LIMIT,
                            cwd=ROOT, env=child_env(ROOT))
    yield worlds
    for started in worlds.values():
        started.stop()


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("world,mesh", CASES)
def test_train_step_on_a_mesh_matches_no_mesh(runs, world, mesh, arch):
    for rank, res in enumerate(rank_outputs(runs[world])):
        r = res[f"{mesh}/{arch}"]
        assert abs(r["loss"] - r["loss_ref"]) <= 1e-5 * abs(r["loss_ref"]), \
            (rank, r)
        assert r["grad_err"] <= 1e-4 * r["grad_scale"], (rank, r)
        assert r["param_err"] <= 1e-5 and r["moment_err"] <= 1e-5, (rank, r)
        assert r["param_err_far"] <= 1e-5, (rank, r)
        assert r["step"] == 1
        # fsdp shards over data and model; tp_ep only experts over model
        sharded = arch == "gemma2-2b" or mesh.endswith("x2")
        assert (r["local_state_bytes"] < r["full_state_bytes"]) == sharded, \
            (rank, r)
        if "eval_loss" in r:
            assert abs(r["eval_loss"] - r["eval_loss_ref"]) <= \
                1e-5 * abs(r["eval_loss_ref"]), (rank, r)


@pytest.mark.parametrize("server", ["serve", "serve_gemma"])
@pytest.mark.parametrize("world,mesh", CASES)
def test_served_tokens_on_a_mesh_are_exact(runs, world, mesh, server):
    for res in rank_outputs(runs[world]):
        r = res[f"{mesh}/{server}"]
        assert r["tokens"] == r["tokens_ref"]
        assert len(r["tokens"]) == 5


@pytest.mark.parametrize("world,mesh", CASES)
def test_fused_ensemble_and_train_loop_on_a_mesh(runs, world, mesh):
    for res in rank_outputs(runs[world]):
        f = res[f"{mesh}/fused"]
        for got, want in ((f["losses"], f["losses_ref"]),
                          (f["temps"], f["temps_ref"])):
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                assert max(abs(x - y) for x, y in zip(a, b)) <= 1e-6
        t = res[f"{mesh}/train_loop"]
        assert len(t["losses"]) == 3
        for a, b in zip(t["losses"], t["losses_ref"]):
            assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.parametrize("world,mesh", CASES)
def test_checkpoint_restores_onto_shardings(runs, world, mesh):
    for res in rank_outputs(runs[world]):
        assert res[f"{mesh}/checkpoint"] == {"step": 3, "same_shards": True}


@pytest.mark.parametrize("world", list(WORLDS))
def test_exchange_swaps_on_the_granted_submesh(runs, world):
    for res in rank_outputs(runs[world]):
        r = res["pilot"]
        assert r["n_failed"] == 0
        assert sorted(r["temps"]) == [1.0, 10.0, 20.0, 40.0]
        # a huge energy gap on pair (0, 1): a certain accept
        assert r["temps"][:2] == [10.0, 1.0]
        assert [0, 1] in r["accepted"]
        assert r["free_ids"] == [0]


def test_chip_smoke_mesh_phase_rehearsal(tmp_path):
    """The ``mesh`` phase's code on a one-rank gloo group and reduced
    configs: every part passes, the losses equal the unsharded rows'
    exactly (one rank reorders no sum), the served tokens too."""
    out = tmp_path / "mesh.json"
    Started("mesh phase rehearsal",
            [[sys.executable, str(ROOT / "tests" / "_mesh_phase_rehearsal.py"),
              str(out)]], [tmp_path / "mesh"], LIMIT, cwd=ROOT,
            env=child_env(ROOT)).wait()
    row = json.loads(out.read_text())["row"]
    assert row["phase"] == "mesh" and row["ok"]
    parts = {p["part"]: p for p in row["parts"]}
    assert set(parts) == {"train gemma2-2b", "train qwen3-moe-30b-a3b-L4",
                          "serve gemma2-2b", "re pilot"}
    for name in ("train gemma2-2b", "train qwen3-moe-30b-a3b-L4"):
        p = parts[name]
        assert p["state_dtensors"] and p["losses"] == p["losses_unsharded"]
    assert parts["serve gemma2-2b"]["tokens_equal"]
    assert parts["re pilot"]["n_failed"] == 0

"""Tensor-parallel compute over ``model`` on CPU process groups (``gloo``)
of 2 and 4 ranks, each rank a subprocess of its own
(``tests/_tp_worker.py``), joined through a ``FileStore`` under
``tmp_path``, under its own timeout.

Meshes (data x model): (1, 2) and (2, 1) at world 2, (2, 2) and (1, 4) at
world 4.  Configs (reduced): gemma2-2b (fsdp, 2 microbatches, remat; heads
local at model 2, case (b) at 4), recurrentgemma-2b (RG-LRU; KH = 1: case
(b)), falcon-mamba-7b (Mamba: ``in_proj``'s split of x and z),
qwen3-moe-30b-a3b (``tp_ep`` experts with attention over ``model``),
grok-1-314b (``tp``: every expert's F split), whisper-large-v3 (encoder
and cross-attention), gemma2-2b with V = 256 (the vocab-parallel
embedding, loss and logits; the reduced configs' V = 257 takes the
d_model fallback), gemma2-2b with H = 6, KH = 2 (case (c) at model 4) and
gemma2-2b under ``remat="dots"`` (the kept products are each rank's local
products before the row-parallel sums; trained, not served).

Each case is held against ``mesh=None`` in the same process: the loss
within 1e-5, every gradient within 1e-4 of the largest, the parameters
after one AdamW step within 1e-5 of the unsharded AdamW on the same
gradients and of the reference's wherever its gradient is at least 1e3
times AdamW's eps (``_dist_worker.FAR_FROM_EPS``), the moments within 1e-5 of the reference's, the eval loss
within 1e-5, greedy tokens exact in f32 (``BatchedServer`` and a prefill
with the stub inputs followed by decode steps) with the last logits
within 1e-4 of the largest; and every compute copy of a leaf the spec
splits over ``model`` is its shard: 1/m of its elements.
"""
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _procs import Started, child_env, rank_outputs  # noqa: E402
from _threads import _one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {2: ("1x2", "2x1"), 4: ("2x2", "1x4")}
CASES = [(w, m) for w, ms in WORLDS.items() for m in ms]
ARCHS = ["gemma2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
         "qwen3-moe-30b-a3b", "grok-1-314b", "whisper-large-v3",
         "gemma2-2b-v256", "gemma2-2b-h6"]
TRAIN_ARCHS = ARCHS + ["gemma2-2b-dots"]   # and the dots step


# each world's limit in seconds, counted from its start: at least 3x its
# seconds inside the whole tier-1 run (6 xdist workers) on a slow host,
# where both worlds run at once beside the other workers' tests (80 and
# 179 s; 31 and 59 s on a quiet host).  Each collective waits for its
# slowest rank, so a loaded host slows these more than the other tests.
LIMITS = {2: 300, 4: 600}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds started at once; a test waits on the world it reads."""
    worlds = {}
    for w, meshes in WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"tp{w}")
        cmds = [[sys.executable, str(ROOT / "tests" / "_tp_worker.py"),
                 str(r), str(w), str(tmp / "store"), str(tmp / f"out{r}.json"),
                 *meshes] for r in range(w)]
        worlds[w] = Started(f"world {w}", cmds,
                            [tmp / f"rank{r}" for r in range(w)], LIMITS[w],
                            cwd=ROOT, env=child_env(ROOT))
    yield worlds
    for started in worlds.values():
        started.stop()


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("world,mesh", CASES)
def test_tensor_parallel_train_step_matches_no_mesh(runs, world, mesh,
                                                    arch):
    model = int(mesh.split("x")[1])
    for rank, res in enumerate(rank_outputs(runs[world])):
        r = res[f"{mesh}/{arch}/train"]
        assert abs(r["loss"] - r["loss_ref"]) <= 1e-5 * abs(r["loss_ref"]), \
            (rank, r)
        assert r["grad_err"] <= 1e-4 * r["grad_scale"], (rank, r)
        assert r["param_err"] <= 1e-5 and r["moment_err"] <= 1e-5, (rank, r)
        assert r["param_err_far"] <= 1e-5, (rank, r)
        assert r["step"] == 1
        if "eval_loss" in r:
            assert abs(r["eval_loss"] - r["eval_loss_ref"]) <= \
                1e-5 * abs(r["eval_loss_ref"]), (rank, r)
        # no leaf is gathered over model: its compute copy is its shard
        assert r["bad_compute_copies"] == [], (rank, r)
        assert (r["model_split_leaves"] > 0) == (model > 1), (rank, r)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world,mesh", CASES)
def test_tensor_parallel_served_tokens_are_exact(runs, world, mesh, arch):
    for res in rank_outputs(runs[world]):
        r = res[f"{mesh}/{arch}/serve"]
        assert r["tokens"] == r["tokens_ref"]
        assert len(r["tokens"]) == 5
        assert r["greedy"] == r["greedy_ref"]
        assert r["logit_err"] <= 1e-4 * r["logit_scale"], r


def test_chip_smoke_mesh_tp_part_rehearsal(tmp_path):
    """The ``mesh tp`` part's rank code (``chip_smoke._tp_rank``) on two
    CPU gloo ranks and reduced configs: the train parts' losses within
    1e-5 of rank 0's unsharded run and their gradients (shards joined)
    within 1e-4, the last prefill logits within 1e-4, every served token
    the unsharded server's; each rank reports its rows."""
    out = str(tmp_path / "rank%d.json")
    Started("mesh tp rehearsal",
            [[sys.executable, str(ROOT / "tests" / "_mesh_tp_rehearsal.py"),
              str(r), str(tmp_path / "store"), out] for r in range(2)],
            [tmp_path / f"rank{r}" for r in range(2)], 240, cwd=ROOT,
            env=child_env(ROOT)).wait()
    ranks = [json.loads(Path(out % r).read_text()) for r in range(2)]
    for r, rk in enumerate(ranks):
        parts = {row["part"]: row for row in rk["rows"]}
        assert set(parts) == {"train gemma2-2b-L4",
                              "train qwen3-moe-30b-a3b-L1",
                              "serve gemma2-2b"}
        assert all(row["rank"] == r for row in rk["rows"])
        assert rk["staged"] == {}          # CPU tensors: nothing staged
        for name in ("train gemma2-2b-L4", "train qwen3-moe-30b-a3b-L1"):
            row = parts[name]
            assert row["launches_per_step"] == [{}] * len(row["losses"])
            if r == 0:
                assert max(row["loss_rel"]) <= 1e-5, row
                assert row["grad_rel_fro_total"] <= 1e-4, row
                assert len(row["grad_rel_fro"]) >= 5, row
                assert max(row["grad_rel_fro"].values()) <= 1e-4, row
        serve = parts["serve gemma2-2b"]
        assert serve["requests"] == 3
        assert serve["tokens_agree"] == serve["tokens"] == 9
        if r == 0:
            assert serve["logit_max_abs_err"] <= 1e-4, serve

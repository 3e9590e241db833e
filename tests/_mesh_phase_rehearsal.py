"""CPU rehearsal of ``chip_smoke.py``'s ``mesh`` phase, for
``tests/test_torch_dist_gloo.py``: run as a process of its own (it
initialises a one-rank ``gloo`` group where the card's phase takes NCCL).

    python tests/_mesh_phase_rehearsal.py OUT_JSON

Reduced configs stand in under the phase's names (f32, the plain kernel
versions, so every launch count reads 0 on both sides), the ``torch.cuda``
memory and sync calls are no-ops, and the unsharded rows the phase is held
against come from ``lm.train`` tasks and a ``BatchedServer`` without a
mesh, as the card's train and serve phases make them.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.configs as rc  # noqa: E402
from repro_torch.configs import reduced, register  # noqa: E402
from repro_torch.core import Kernel  # noqa: E402
from repro_torch.launch import profile_train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.plugins import lm  # noqa: E402
from repro_torch.serve import BatchedServer  # noqa: E402

_REAL_GET = rc.get_config
_REDUCED = {}


def _reduced(name):
    if name not in _REDUCED:
        base = ("qwen3-moe-30b-a3b" if name.startswith("qwen3")
                else "gemma2-2b")
        _REDUCED[name] = reduced(_REAL_GET(base)).replace(name=name)
    return _REDUCED[name]


def _stub():
    for f in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, f, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    cs._card = lambda: "cpu"
    profile_train.TRAIN.update(batch=4, seq=32)
    cs.SERVE_SHAPE.update(batch=2, prompt=8, new=3, requests=3)
    cs.ENSEMBLE.update(seq=32, batch=2)
    lm.resolve_cfg = _reduced
    rc.get_config = _reduced
    cs._ensemble_cfg = lambda: register(_reduced("gemma2-2b-L4"))
    cs._expected_launches = lambda *a: {}
    for spec in cs.TRAIN_PHASES:
        spec["launches"] = {}

    def group(dev, tmp):
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    cs._mesh_group = group


def _refs():
    refs = {}
    for spec in (cs.TRAIN_PHASES[0], cs.TRAIN_PHASES[3]):
        losses = []
        for _ in range(2):
            k = Kernel("lm.train")
            k.arguments = {"arch": spec["arch"], "device": "cpu", "steps": 1,
                           "batch": 4, "seq": 32,
                           "microbatches": spec.get("microbatches", 2),
                           "ensemble": "rehearsal", "member": 0}
            losses.append(k.execute()["loss"])
        lm.STATE_STORE.clear()
        refs[f"train {spec['arch']}"] = {"losses": losses,
                                         "steps_run": [{"ms": 0.0}],
                                         "peak_mem_gb": 0.0}
    cfg = _reduced("gemma2-2b")
    srv = BatchedServer(cfg, init_params(cfg, torch.Generator().manual_seed(
        0)), batch=2, prompt_len=8, max_len=12, device="cpu")
    srv.submit(cs._requests(cfg, 3, 8, 3))
    refs["serve gemma2-2b"] = {
        "served_tokens": {r.rid: r.out_tokens for r in srv.run()},
        "wall_s": 1.0, "tokens_per_s": 1.0, "peak_mem_gb": 0.0,
        "launches": {}}
    return refs


def main(out):
    torch.set_num_threads(1)
    _stub()
    rows = []
    real_emit = cs.emit
    cs.emit = lambda obj: (rows.append(obj), real_emit(obj))
    launches = cs.phase_mesh(torch.device("cpu"), _refs())
    with open(out, "w") as f:
        json.dump({"row": rows[-1], "launches": launches}, f)


if __name__ == "__main__":
    main(sys.argv[1])

"""CPU rehearsal of ``chip_smoke.py``'s ``mesh tp`` part, for
``tests/test_torch_tp.py``: one rank of it, run as a process of its own
(two of them make the part's gloo group).

    python tests/_mesh_tp_rehearsal.py RANK STORE_FILE OUT_PATTERN

Reduced configs stand in under the part's names (f32, the plain kernel
versions, so every launch count reads 0), ``torch.cuda``'s memory and
sync calls are no-ops, the rank's group is gloo on the CPU, and the
``serve gemma2-2b`` tokens the part compares with come from a
``BatchedServer`` without a mesh.  Writes the rank's rows to
``OUT_PATTERN % RANK``, as the card's ranks do.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.configs as rc  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
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
    for f in ("synchronize", "reset_peak_memory_stats", "empty_cache",
              "set_device"):
        setattr(torch.cuda, f, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    rc.get_config = _reduced
    cs.SERVE_SHAPE.update(batch=2, prompt=8, new=3, requests=3)
    cs.SERVE[0] = (cs.SERVE[0][0], cs.SERVE[0][1], {}, {})
    for spec in cs.MESH_TP["train"]:
        spec.update(seq=16, launches={})

    def setup(rank, store):
        dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2)
        return torch.device("cpu")
    cs._tp_setup = setup


def _served():
    cfg = _reduced("gemma2-2b")
    S = cs.SERVE_SHAPE
    srv = BatchedServer(cfg, init_params(cfg, torch.Generator().manual_seed(
        0)), batch=S["batch"], prompt_len=S["prompt"],
        max_len=S["prompt"] + S["new"] + 1, device="cpu")
    srv.submit(cs._requests(cfg, S["requests"], S["prompt"], S["new"]))
    return {str(r.rid): r.out_tokens for r in srv.run()}


def main(rank, store, out):
    torch.set_num_threads(1)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _stub()
    cs._tp_rank(int(rank), store, out, _served())


if __name__ == "__main__":
    main(*sys.argv[1:])

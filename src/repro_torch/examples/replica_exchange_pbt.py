"""Replica-exchange ensemble training (parallel tempering over learning
rates), in BOTH execution modes, on the port (``examples/
replica_exchange_pbt.py``'s options and printed lines, plus ``--device``):

  task mode  - paper-faithful: each replica is a scheduled task; exchange is
               a barrier task (RADICAL-Pilot style).
  fused mode - beyond-paper: the whole population is ONE program of
               vmapped train steps; exchange happens on the device (O(1)
               dispatch per cycle).

    PYTHONPATH=src python -m repro_torch.examples.replica_exchange_pbt \\
        [--members 4] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import (FusedEnsemble, Kernel, ReplicaExchange,
                              SingleClusterEnvironment)
from repro_torch.flags import resolve_device

SHAPE = ShapeSpec("pbt", "train", 64, 2)


class TaskModePBT(ReplicaExchange):
    def __init__(self, cycles, replicas, device):
        super().__init__(cycles, replicas)
        self.temps = [3e-4 * 1.4 ** i for i in range(replicas)]
        self.device = device

    def prepare_replica_for_md(self, r):
        k = Kernel("lm.train")
        k.arguments = {"arch": "reduced:gemma2-2b", "steps": 2,
                       "member": r.id, "ensemble": "ex_pbt",
                       "lr": self.temps[r.id], "batch": 2, "seq": 64,
                       "device": str(self.device)}
        return k

    def prepare_exchange(self, replicas):
        k = Kernel("re.exchange")
        k.arguments = {"replicas": len(replicas),
                       "cycle": replicas[0].cycle, "temps": self.temps,
                       "ensemble": "ex_pbt"}
        return k

    def apply_exchange(self, result, replicas):
        self.temps = result["temps"]
        print(f"  cycle {result['cycle']}: losses="
              f"{[round(l, 3) for l in result['losses']]} "
              f"accepted={result['accepted']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"== task mode ({args.members} members, {args.cycles} cycles) ==")
    cl = SingleClusterEnvironment(cores=args.members)
    cl.allocate()
    prof = cl.run(TaskModePBT(args.cycles, args.members, device))
    cl.deallocate()
    print(f"task-mode TTC={prof.ttc:.2f}s "
          f"dispatch-overhead={prof.t_enmd_overhead:.4f}s "
          f"({prof.n_tasks} tasks)")

    print("\n== fused SPMD mode ==")
    cfg = reduced(get_config("gemma2-2b"))
    fe = FusedEnsemble(cfg, args.members, device=device)
    t0 = time.perf_counter()
    ens, hist = fe.run(torch.Generator(device=device).manual_seed(0),
                       cycles=args.cycles, steps_per_cycle=2, shape=SHAPE)
    dt = time.perf_counter() - t0
    for c, h in enumerate(hist):
        print(f"  cycle {c}: losses="
              f"{[round(float(x), 3) for x in h['losses']]} "
              f"accepted={int(h['accepted'])}")
    print(f"fused-mode wall={dt:.2f}s (includes one-time jit compile); "
          "dispatch per cycle is a single program launch")


if __name__ == "__main__":
    main()

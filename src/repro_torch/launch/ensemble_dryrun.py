"""Ensemble-at-fleet-scale dry run: the pilot is the multi-pod mesh; each
replica-exchange member gets ONE POD as its slot (submesh), and the
member's distributed train step is reckoned for that submesh (the port's
counterpart of ``examples/ensemble_dryrun.py``).

This is the paper's core decoupling at production scale, expressed through
the PST API: the resource handler acquires 512 ranks once; a SlotTopology
carves them into pod-sized slots; the PST AppManager schedules one member
task per slot, and each task takes its 256-rank mesh from the slot ids the
scheduler granted it — ``ctx["submesh"]`` is ``PilotRuntime.submesh_for``
of the running task, so placement is decided by the pilot, not the member.

The 512 ranks are a fake process group (``launch.dryrun.fake_world``) and
this process is rank 0; each member's step is reckoned by
``launch.dryrun.reckon`` on fake tensors for one rank of its pod: the
rank's state bytes (its shards) and the step's peak, where the reference
prints XLA's ``memory_analysis``.  Pod 1's mesh does not hold rank 0, so
its member is reckoned on the mesh of the same shape and axes over ranks
0..255: every rank of a pod holds the shards of the same shapes, so the
numbers are those of each of pod 1's ranks.

    PYTHONPATH=src python -m repro_torch.launch.ensemble_dryrun
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import AppManager, Kernel, PipelineSpec, Stage, TaskSpec
from repro_torch.core.kernel_plugin import register_kernel
from repro_torch.dist.topology import SlotTopology
from repro_torch.launch.dryrun import fake_world, reckon
from repro_torch.launch.mesh import make_production_mesh, mesh_over_ranks
from repro_torch.runtime.executor import PilotRuntime

# one reckoning at a time: the fake kernel tally is process-wide
_RECKON = threading.Lock()


def _own_rank_mesh(sub):
    """``sub`` where it holds this rank, else the mesh of its shape and
    axis names over ranks 0 .. size-1 (one of whose ranks this is)."""
    if sub.get_coordinate() is not None:
        return sub
    shape = tuple(int(n) for n in tuple(sub.shape))
    return mesh_over_ranks(np.arange(int(np.prod(shape))).reshape(shape),
                           sub.mesh_dim_names, sub.device_type)


@register_kernel("dryrun.reckon_member",
                 description="reckon one RE member's train step for a rank "
                             "of its granted pod submesh")
def reckon_member(args, ctx):
    sub = ctx["submesh"]          # the pod the pilot granted this member
    cfg = get_config(args["arch"])
    shape = SHAPES[args["shape"]]
    ranks = sub.mesh.reshape(-1)
    t0 = time.time()
    with _RECKON:
        got = reckon(cfg, shape, mesh=_own_rank_mesh(sub))
    return {"member": int(args["member"]),
            "devices": (int(ranks[0]), int(ranks[-1])),
            "reckon_s": time.time() - t0,
            "state_mb_per_rank": got["state_bytes"] / 1e6,
            "peak_gb_per_rank": got["peak_bytes"] / 1e9,
            "fits": got["fits"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    with fake_world(512):
        pilot_mesh = make_production_mesh(multi_pod=True)
        sizes = dict(zip(pilot_mesh.mesh_dim_names,
                         (int(n) for n in tuple(pilot_mesh.shape))))
        print(f"pilot: {pilot_mesh.size()} ranks, axes "
              f"{tuple(pilot_mesh.mesh_dim_names)} {sizes}")
        topo = SlotTopology.from_mesh(pilot_mesh, slot_axis="pod")
        print(f"slots: {topo.n_slots} pods x {topo.devices_per_slot} ranks")
        runtime = PilotRuntime(mode="real", topology=topo)

        # one RE member per pod slot: the scheduler grants each task a slot
        # id and the kernel reckons the member's 256-rank train step against
        # runtime.submesh_for(task) (different pods -> different ranks)
        def member_kernel(i):
            k = Kernel("dryrun.reckon_member")
            k.arguments = {"arch": args.arch, "shape": args.shape,
                           "member": i}
            return k

        md = Stage([TaskSpec(member_kernel(i), name=f"member{i}",
                             metadata={"instance": i})
                    for i in range(topo.n_slots)], name="simulation")
        am = AppManager(runtime)
        prof = am.run(PipelineSpec([md], name="re_dryrun"))
        assert prof.n_failed == 0 and prof.n_canceled == 0, [
            (t.name, t.state.value, t.error)
            for t in am.session.graph.tasks.values() if t.error]

        results = [prof.results["tasks"][f"member{i}"]
                   for i in range(topo.n_slots)]
        for r in results:
            print(f"member {r['member']}: pod devices "
                  f"[{r['devices'][0]}..{r['devices'][1]}] "
                  f"reckoned in {r['reckon_s']:.0f}s; "
                  f"state {r['state_mb_per_rank']:.0f} MB/rank, "
                  f"peak {r['peak_gb_per_rank']:.2f} GB/rank")
        print(f"ensemble-of-pods dry-run OK: {prof.n_tasks} members ran as "
              "disjoint 256-rank SPMD programs under one pilot "
              f"(utilization {prof.utilization:.2f})")
    return results


if __name__ == "__main__":
    main()

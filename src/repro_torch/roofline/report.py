"""Three-term roofline report per (arch x shape x mesh) from dry-run costs
(own copy of ``repro.roofline.report``, on the H100 of
``repro_torch.launch.mesh.HW``; ``make_row`` also takes another ``hw``).

  compute term    = dot_FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_accessed_per_device / HBM_bw
  collective term = collective_wire_bytes_per_device / ICI_bw

All terms are per-device seconds for one step (the port runs on one
device: the traced step's costs are the device's, and the collective term
is 0).
MODEL_FLOPS uses the 6*N*D (train) / 2*N*D (inference) convention with
N = active params.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import HW, HardwareSpec
from repro_torch.roofline.op_costs import Costs


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (HLO flops x chips)
    roofline_frac: float         # useful-compute time / max(t_*)
    collectives: Dict[str, Dict[str, float]]
    memory_stats: Optional[Dict[str, float]] = None
    # decode cells: bytes optimality (ideal = params+cache read once)
    ideal_bytes_per_dev: Optional[float] = None
    mem_ideal_frac: Optional[float] = None

    def to_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N*D for training; 2*N*D per generated/processed token otherwise."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def make_row(cfg: ModelConfig, shape: ShapeSpec, mesh_name: str, chips: int,
             costs: Costs, memory_stats=None,
             ideal_bytes_total: Optional[float] = None,
             hw: HardwareSpec = HW) -> RooflineRow:
    t_c = costs.flops / hw.peak_flops
    t_m = costs.bytes_accessed / hw.hbm_bw
    t_x = costs.collective_wire_bytes / hw.ici_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_total = costs.flops * chips
    useful = mf / hlo_total if hlo_total else 0.0
    t_max = max(t_c, t_m, t_x)
    # "roofline fraction": how much of the step time is the *useful compute*
    # lower bound.  useful_time = MODEL_FLOPS/(chips*peak); achieved step
    # time >= t_max  =>  fraction = useful_time / t_max.
    useful_time = mf / (chips * hw.peak_flops)
    frac = useful_time / t_max if t_max else 0.0
    ideal_pd = (ideal_bytes_total / chips) if ideal_bytes_total else None
    mem_frac = (ideal_pd / costs.bytes_accessed
                if ideal_pd and costs.bytes_accessed else None)
    return RooflineRow(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_dev=costs.flops, bytes_per_dev=costs.bytes_accessed,
        coll_bytes_per_dev=costs.collective_wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops_total=mf, useful_ratio=useful,
        roofline_frac=frac,
        collectives={k: dict(v) for k, v in costs.collectives.items()},
        memory_stats=memory_stats,
        ideal_bytes_per_dev=ideal_pd, mem_ideal_frac=mem_frac)


def format_table(rows) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':10s} "
           f"{'t_comp(ms)':>10s} {'t_mem(ms)':>10s} {'t_coll(ms)':>10s} "
           f"{'bound':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:10s} "
            f"{r.t_compute*1e3:10.2f} {r.t_memory*1e3:10.2f} "
            f"{r.t_collective*1e3:10.2f} {r.bottleneck:>10s} "
            f"{r.useful_ratio:7.3f} {100*r.roofline_frac:6.1f}%")
    return "\n".join(lines)

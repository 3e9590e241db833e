"""Hardware model of the one device the port runs on (own copy of
``repro.launch.mesh``'s ``HardwareSpec``, with an H100's numbers).

``HW`` holds the NVIDIA H100 SXM data sheet's dense peaks: 989 TFLOP/s of
bf16 on the tensor cores (67 TFLOP/s of f32 on the CUDA cores), 3.35 TB/s
of HBM3, 80 GB of it, and 450 GB/s a direction over NVLink.  The roofline
report (``repro_torch.roofline``) and ``chip_smoke.py``'s kernel bounds
read it.  On one device the collective term is 0: nothing crosses NVLink.

The production meshes (a pod of many devices, and two pods) wait for
ROADMAP A9: ``make_production_mesh`` and ``make_host_mesh`` raise.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm"
    peak_flops: float = 989e12        # bf16 FLOP/s per device (dense)
    hbm_bw: float = 3.35e12           # bytes/s per device (HBM3)
    ici_bw: float = 450e9             # bytes/s per direction (NVLink)
    hbm_bytes: float = 80e9           # HBM capacity per device
    peak_flops_f32: float = 67e12     # f32 FLOP/s on the CUDA cores


HW = HardwareSpec()


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "production meshes (pod16x16, pod2x16x16) are not ported: the port "
        "runs on one device (ROADMAP A9)")


def make_host_mesh(shape=None, axes=("data", "model")):
    raise NotImplementedError(
        "device meshes are not ported: the port runs on one device "
        "(ROADMAP A9)")

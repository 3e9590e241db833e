"""Hardware model of the one device the port runs on (own copy of
``repro.launch.mesh``'s ``HardwareSpec``, with an H100's numbers).

``HW`` holds the NVIDIA H100 SXM data sheet's dense peaks: 989 TFLOP/s of
bf16 on the tensor cores (67 TFLOP/s of f32 on the CUDA cores), 3.35 TB/s
of HBM3, 80 GB of it, and 450 GB/s a direction over NVLink.  The roofline
report (``repro_torch.roofline``) and ``chip_smoke.py``'s kernel bounds
read it.  On one device the collective term is 0: nothing crosses NVLink.

Meshes are ``torch.distributed.device_mesh.DeviceMesh``es over the ranks
of the initialised default process group, with the JAX package's axis
names: ``make_production_mesh`` builds ``pod16x16`` (``("data",
"model")``, 256 ranks) or ``pod2x16x16`` (``("pod", "data", "model")``,
512 ranks), ``make_host_mesh`` any shape over the group.  Each raises,
naming the world size it needs, when the group is another size: a mesh is
never quietly shrunk.  The mesh's device type follows the group's backend:
``cuda`` under NCCL, ``cpu`` under gloo or a fake group (the dry run's).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm"
    peak_flops: float = 989e12        # bf16 FLOP/s per device (dense)
    hbm_bw: float = 3.35e12           # bytes/s per device (HBM3)
    ici_bw: float = 450e9             # bytes/s per direction (NVLink)
    hbm_bytes: float = 80e9           # HBM capacity per device
    peak_flops_f32: float = 67e12     # f32 FLOP/s on the CUDA cores


HW = HardwareSpec()


PRODUCTION_MESHES = {"pod16x16": ((16, 16), ("data", "model")),
                     "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group(backend, store=..., "
            "rank=..., world_size=...) first")
    return dist.get_world_size()


def mesh_device_type() -> str:
    """``cuda`` when the default group's backend is NCCL, else ``cpu``."""
    import torch.distributed as dist
    _world()
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_over_ranks(ranks, axes: Sequence[str],
                    device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the global ``ranks`` (an integer array of the
    mesh's shape) with axis names ``axes``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    world = _world()
    arr = np.asarray(ranks)
    if arr.dtype.kind not in "iu":
        raise TypeError(f"mesh devices must be process ranks, got "
                        f"{arr.dtype} {arr.ravel()[:2].tolist()}")
    if arr.size and (arr.min() < 0 or arr.max() >= world):
        raise ValueError(f"ranks {arr.min()}..{arr.max()} outside the "
                         f"world of {world}")
    return DeviceMesh(device_type or mesh_device_type(),
                      torch.as_tensor(arr, dtype=torch.int64),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(shape=None, axes=("data", "model"),
                   device_type: Optional[str] = None):
    """A mesh of ``shape`` (default ``(1, world)``) over every rank of the
    default group, which must hold exactly ``prod(shape)`` ranks."""
    world = _world()
    shape = (1, world) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)}")
    need = math.prod(shape)
    if need != world:
        raise ValueError(f"a {shape} mesh needs a world of {need} ranks; "
                         f"the default process group has {world}")
    return mesh_over_ranks(np.arange(need).reshape(shape), axes, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """``pod2x16x16`` with ``multi_pod``, else ``pod16x16``, over the
    default group's 512 or 256 ranks."""
    name = "pod2x16x16" if multi_pod else "pod16x16"
    shape, axes = PRODUCTION_MESHES[name]
    world, need = _world(), math.prod(shape)
    if world != need:
        raise ValueError(f"the production mesh {name} needs a world of "
                         f"{need} ranks; the default process group has "
                         f"{world}")
    return mesh_over_ranks(np.arange(need).reshape(shape), axes, device_type)

"""Mesh-slot topology: the pilot's slots as device submeshes (own copy of
``repro.dist.topology``).

The paper's pilot holds N cores and a task occupies ``slots`` of them.  At
fleet scale the pilot holds a device *mesh* and a slot is a fixed block of
devices — e.g. one pod of the 2x16x16 multi-pod mesh, so each
replica-exchange member is itself a 256-rank SPMD program.
``SlotTopology`` carves the mesh's device array into equal slots;
``PilotRuntime`` acquires and releases slot ids, and a task builds a
``torch.distributed.device_mesh.DeviceMesh`` over its slots via
:meth:`SlotTopology.submesh`.

The devices are global ranks of the default process group (any objects
serve the bookkeeping: carving, recarving and dropping slots never look at
them; only ``submesh`` needs ranks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class SlotTopology:
    """Partition of a device array into equal pilot slots.

    ``devices``: array with leading dim = number of slots; ``axis_names``:
    mesh axes of ONE slot (matching ``devices.shape[1:]``).
    """
    devices: Any
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "devices", np.asarray(self.devices))
        if self.devices.ndim - 1 != len(self.axis_names):
            raise ValueError(
                f"slot shape {self.devices.shape[1:]} does not match "
                f"axis names {self.axis_names}")

    # ------------------------------------------------------------ builders
    @classmethod
    def from_mesh(cls, mesh, slot_axis: str | None = None) -> "SlotTopology":
        """One slot per index of ``slot_axis`` (default: outermost axis).

        ``from_mesh(pod_mesh)`` on the ("pod", "data", "model") mesh yields
        2 slots of shape ("data", "model") — one pod per slot.  ``mesh`` is
        a ``DeviceMesh`` (its ranks) or anything with ``devices`` and
        ``axis_names``.
        """
        names = tuple(getattr(mesh, "mesh_dim_names", None)
                      or mesh.axis_names)
        devices = (mesh.mesh.cpu().numpy() if hasattr(mesh, "mesh")
                   else np.asarray(mesh.devices))
        slot_axis = slot_axis or names[0]
        i = names.index(slot_axis)
        dev = np.moveaxis(devices, i, 0)
        return cls(devices=dev, axis_names=names[:i] + names[i + 1:])

    @classmethod
    def even(cls, devices: Sequence[Any], n_slots: int,
             axis_names: Tuple[str, ...] = ("model",)) -> "SlotTopology":
        """Split a flat device list into ``n_slots`` equal 1-axis slots."""
        arr = np.asarray(devices)
        if n_slots <= 0 or arr.size % n_slots:
            raise ValueError(f"{arr.size} devices not divisible into "
                             f"{n_slots} slots")
        return cls(devices=arr.reshape(n_slots, arr.size // n_slots),
                   axis_names=axis_names)

    def recarve(self, n_slots: int) -> "SlotTopology":
        """Re-carve into ``n_slots`` finer slots by splitting the leading
        slot axis (e.g. 2 pods of ("data", "model") 16x16 -> 4 half-pods of
        8x16).  Grow-only: ``n_slots`` must be a multiple of the current
        slot count and the split must divide the first slot axis evenly.
        """
        cur = self.n_slots
        if n_slots == cur:
            return self
        if n_slots < cur or n_slots % cur:
            raise ValueError(f"cannot re-carve {cur} slots into {n_slots}: "
                             "grow-only, must be an integer multiple")
        factor = n_slots // cur
        if self.devices.ndim < 2 or self.devices.shape[1] % factor:
            raise ValueError(
                f"cannot split slot axis {self.axis_names[:1]} of shape "
                f"{self.devices.shape[1:]} into {factor} parts")
        shape = self.devices.shape
        dev = self.devices.reshape(cur * factor, shape[1] // factor,
                                   *shape[2:])
        return SlotTopology(devices=dev, axis_names=self.axis_names)

    def drop(self, slot_ids: Sequence[int]) -> "SlotTopology":
        """Shrink-recarve: a new topology WITHOUT the given slots (pod
        loss — the dead pod's devices leave the fleet).  Slot ids
        renumber compactly, so the runtime applies this only at a
        quiescent point (no task holds a slot id) and replica locality
        keyed on the old pod names is reset by the caller.
        """
        dead = {int(i) for i in slot_ids}
        if not dead:
            return self
        bad = [i for i in dead if i < 0 or i >= self.n_slots]
        if bad:
            raise ValueError(f"slot ids {sorted(bad)} out of range "
                             f"0..{self.n_slots - 1}")
        keep = [i for i in range(self.n_slots) if i not in dead]
        if not keep:
            raise ValueError("cannot drop every slot of the topology")
        return SlotTopology(devices=self.devices[np.asarray(keep)],
                            axis_names=self.axis_names)

    # ------------------------------------------------------------ queries
    def reachable_slot_counts(self) -> list:
        """Every slot count some chain of grow-only :meth:`recarve` calls
        can reach from here: ``n_slots * f`` for each ``f`` dividing the
        first slot axis (splitting is single-axis, so composed recarves
        reach exactly the divisors).  Sorted ascending; the static
        validator (``repro_torch.analysis``, E108/W202) uses this to decide
        whether a cores request can EVER be granted."""
        if self.devices.ndim < 2:
            return [self.n_slots]
        width = int(self.devices.shape[1])
        return sorted(self.n_slots * f for f in range(1, width + 1)
                      if width % f == 0)

    @property
    def n_slots(self) -> int:
        return int(self.devices.shape[0])

    @property
    def devices_per_slot(self) -> int:
        return int(np.prod(self.devices.shape[1:], dtype=np.int64))

    def slot_devices(self, slot_ids: Sequence[int]) -> np.ndarray:
        """(len(slot_ids), *slot_shape) device block, id-sorted."""
        ids = sorted(int(i) for i in slot_ids)
        if not ids:
            raise ValueError("empty slot id list")
        if ids[0] < 0 or ids[-1] >= self.n_slots:
            raise ValueError(f"slot ids {ids} out of range 0..{self.n_slots - 1}")
        return self.devices[np.asarray(ids)]

    def submesh(self, slot_ids: Sequence[int], device_type: str | None = None):
        """``DeviceMesh`` over the ranks of ``slot_ids``.

        One slot keeps the slot axes; several slots gain a leading "slot"
        axis (a wider data-parallel dim for multi-slot tasks).  Needs an
        initialised default process group holding those ranks;
        ``device_type`` defaults to the group's (``launch.mesh.
        mesh_device_type``).
        """
        from repro_torch.launch.mesh import mesh_over_ranks
        block = self.slot_devices(slot_ids)
        if block.shape[0] == 1:
            return mesh_over_ranks(block[0], self.axis_names, device_type)
        return mesh_over_ranks(block, ("slot",) + tuple(self.axis_names),
                               device_type)

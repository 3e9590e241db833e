"""Resource handler (paper §3.5.3): pilot-based resource acquisition (own
copy of ``repro.core.resource_handler``).

``SingleClusterEnvironment`` keeps the paper's interface (listing 3) —
resource name, cores, walltime, credentials, database — mapped to a CUDA
card: cores -> slots (tasks the pilot runs at once, each on its own
thread), database -> journal path.  ``allocate`` acquires the pilot once;
patterns then run on it with application-level scheduling (the whole point
of the pilot abstraction).  A ``cuda.`` resource (``"cuda.h100"``) checks
that CUDA is there when the pilot is allocated and records the device; the
pilot does no device work itself, since every task kernel takes its own
``device`` argument.  ``local.cpu`` stays the default.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.flags import resolve_device
from repro_torch.runtime.executor import PilotRuntime
from repro_torch.runtime.journal import Journal


@dataclass
class ResourceSpec:
    name: str = "local.cpu"
    cores: int = 4
    walltime: int = 15                 # minutes
    username: Optional[str] = None
    project: Optional[str] = None
    queue: Optional[str] = None
    # hardware model used for napkin math / sim calibration (nothing reads
    # it yet): one H100 SXM per core, NVIDIA data-sheet dense bf16 peak and
    # HBM3 capacity
    peak_flops_per_core: float = 989e12
    hbm_per_core: float = 80e9


class Pilot:
    """The resource placeholder: holds slots (and the CUDA device when the
    resource is a ``cuda.`` card) for application-level task scheduling."""

    def __init__(self, spec: ResourceSpec, runtime: PilotRuntime,
                 device=None):
        self.spec = spec
        self.runtime = runtime
        self.device = device
        self.t_allocated = time.perf_counter()
        self.active = True

    @property
    def slots(self) -> int:
        return self.runtime.slots

    def resize(self, slots: int):
        """Elastic scaling: grow/shrink the slot pool mid-run."""
        self.runtime.resize(slots)

    def walltime_remaining(self) -> float:
        return self.spec.walltime * 60 - (time.perf_counter()
                                          - self.t_allocated)


class SingleClusterEnvironment:
    """Paper listing 3 interface."""

    def __init__(self, resource: str = "local.cpu", cores: int = 4,
                 walltime: int = 15, username: Optional[str] = None,
                 project: Optional[str] = None, queue: Optional[str] = None,
                 database_url: Optional[str] = None,
                 database_name: str = "enmd",
                 mode: str = "real",
                 straggler_factor: float = 0.0,
                 max_retries: int = 2):
        self.spec = ResourceSpec(resource, cores, walltime, username,
                                 project, queue)
        self.mode = mode
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        self.journal_path = (f"{database_url}/{database_name}.jsonl"
                             if database_url else None)
        self.pilot: Optional[Pilot] = None
        self.overheads: Dict[str, float] = {"t_core": 0.0}

    # ------------------------------------------------------------ allocate
    def allocate(self) -> Pilot:
        t0 = time.perf_counter()
        device = None
        if self.spec.name.startswith("cuda."):
            device = resolve_device("cuda")     # raises without a card
        runtime = PilotRuntime(
            slots=self.spec.cores, mode=self.mode,
            journal=Journal(self.journal_path),
            max_retries=self.max_retries,
            straggler_factor=self.straggler_factor)
        self.pilot = Pilot(self.spec, runtime, device)
        self.overheads["t_core"] += time.perf_counter() - t0
        return self.pilot

    # ------------------------------------------------------------ run
    def run(self, pattern, **kw):
        if self.pilot is None or not self.pilot.active:
            raise RuntimeError("allocate() the pilot before run()")
        from repro_torch.core.execution_plugin import get_plugin
        plugin = get_plugin(pattern, self.pilot, **kw)
        profile = plugin.execute()
        profile.t_core_overhead = self.overheads["t_core"]
        return profile

    # ------------------------------------------------------------ release
    def deallocate(self):
        t0 = time.perf_counter()
        if self.pilot is not None:
            # close() also GCs unreferenced spill files (journaled refs
            # are kept — deallocate must not end restartability)
            self.pilot.runtime.close()
            self.pilot.active = False
        self.overheads["t_core"] += time.perf_counter() - t0

"""Legacy execution patterns (the paper's §3.4): Pipeline, Replica Exchange,
Simulation-Analysis Loop, plus BagOfTasks.

A pattern is a parameterized control-flow template; users subclass and fill
stage methods with Kernel plugins (paper listings 1/4/5).  Patterns compile
to PST pipelines (core/pst.py) via their execution plugin — the pattern
itself never touches execution details (paper design decision: "decouple
what to execute from how to execute").

New code should use the PST API directly (``AppManager``, ``PipelineSpec``,
``Stage``, ``TaskSpec``): it expresses everything these templates do plus
adaptive and coupled workloads they cannot (see the migration table in
repro/core/__init__.py).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core.kernel_plugin import Kernel


class ExecutionPattern:
    name = "abstract"

    def describe(self) -> Dict[str, Any]:
        return {"pattern": self.name}


# ---------------------------------------------------------------- pipeline

class Pipeline(ExecutionPattern):
    """N independent pipes x M sequential stages (paper listing 1).

    Subclasses define ``stage_1(self, instance) -> Kernel`` ... ``stage_M``.
    """
    name = "pipeline"

    def __init__(self, stages: int, instances: int):
        self.stages = stages
        self.instances = instances

    def stage_kernel(self, stage: int, instance: int) -> Kernel:
        fn = getattr(self, f"stage_{stage}", None)
        if fn is None:
            raise NotImplementedError(f"stage_{stage} not defined")
        return fn(instance)

    def describe(self):
        return {"pattern": self.name, "stages": self.stages,
                "instances": self.instances}


class BagOfTasks(Pipeline):
    """Degenerate single-stage pipeline (paper's BoT scenario)."""
    name = "bag_of_tasks"

    def __init__(self, instances: int):
        super().__init__(stages=1, instances=instances)

    def task(self, instance: int) -> Kernel:
        raise NotImplementedError

    def stage_1(self, instance: int) -> Kernel:
        return self.task(instance)


# ---------------------------------------------------------------- replica

class Replica:
    """Mutable replica context threaded through RE cycles (paper's
    ``replica.id`` / ``replica.cycle``)."""

    def __init__(self, rid: int):
        self.id = rid
        self.cycle = 0
        self.state: Dict[str, Any] = {}   # e.g. temperature, params handle


class ReplicaExchange(ExecutionPattern):
    """Cycles of (concurrent simulation phase -> exchange phase).

    Subclasses define:
      prepare_replica_for_md(self, replica) -> Kernel
      prepare_exchange(self, replicas) -> Kernel       (barrier task)
      apply_exchange(self, result, replicas) -> None   (host-side swap)
    """
    name = "replica_exchange"

    def __init__(self, cycles: int, replicas: int):
        self.cycles = cycles
        self.replicas = [Replica(i) for i in range(replicas)]

    def prepare_replica_for_md(self, replica: Replica) -> Kernel:
        raise NotImplementedError

    def prepare_exchange(self, replicas: List[Replica]) -> Kernel:
        raise NotImplementedError

    def apply_exchange(self, result: Any, replicas: List[Replica]) -> None:
        pass

    def describe(self):
        return {"pattern": self.name, "cycles": self.cycles,
                "replicas": len(self.replicas)}


# ---------------------------------------------------------------- SAL

class SimulationAnalysisLoop(ExecutionPattern):
    """pre_loop -> [N x simulation -> M x analysis] * k -> post_loop
    (paper listing 4)."""
    name = "simulation_analysis_loop"

    def __init__(self, maxiterations: int, simulation_instances: int = 1,
                 analysis_instances: int = 1):
        self.maxiterations = maxiterations
        self.simulation_instances = simulation_instances
        self.analysis_instances = analysis_instances

    def pre_loop(self) -> Optional[Kernel]:
        return None

    def simulation_stage(self, iteration: int, instance: int) -> Kernel:
        raise NotImplementedError

    def analysis_stage(self, iteration: int, instance: int) -> Kernel:
        raise NotImplementedError

    def post_loop(self) -> Optional[Kernel]:
        return None

    def should_continue(self, iteration: int, analysis_results) -> bool:
        """Convergence hook: return False to stop before maxiterations."""
        return True

    def describe(self):
        return {"pattern": self.name, "iterations": self.maxiterations,
                "simulations": self.simulation_instances,
                "analyses": self.analysis_instances}

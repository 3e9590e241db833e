"""Execution plugins (paper §3.2 component 4): compile a legacy hook-API
pattern into PST pipelines (core/pst.py) and run them on an AppManager.

One plugin per pattern.  The plugin is the ONLY component that sees both the
pattern structure and the runtime — patterns stay execution-agnostic, the
runtime stays pattern-agnostic.  Since the PST redesign the plugin no longer
drives per-cycle TaskGraphs itself: it emits *port-annotated* ``PipelineSpec``
objects — consumer stages declare their producers as StageFuture inputs
(core/flow.py), so the exchange/analysis kernels receive the member results
as ``ctx["inputs"]`` and the dependency structure is explicit in the PST
objects rather than implied by the per-pipeline barrier alone — whose
``on_done`` callbacks reproduce the pattern's control flow (apply_exchange,
should_continue, ...) adaptively, and one long-lived runtime session
executes everything.  Profiles are pinned by tests: the port edges dedupe
against the barrier deps, so task sets, dependencies and timings are
unchanged.  The paper's TTC decomposition
(TTC = T_EnMD(core+pattern+rts) + T_exec + T_data) is assembled by the
AppManager; utilization is computed once over the whole run from
accumulated busy slot-seconds (it used to be overwritten per cycle, so
RE/SAL reported only the last cycle's utilization).
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.core.patterns import (ExecutionPattern, Pipeline,
                                 ReplicaExchange, SimulationAnalysisLoop)
from repro_torch.core.pst import (AppManager, ExecutionProfile, PipelineSpec,
                            Stage, TaskSpec)
from repro_torch.core.resource_handler import Pilot

__all__ = ["ExecutionProfile", "BaseExecutionPlugin",
           "PipelineExecutionPlugin", "REExecutionPlugin",
           "SALExecutionPlugin", "get_plugin"]


class BaseExecutionPlugin:
    """Compile ``self.pattern`` to PST pipelines, then run them."""

    def __init__(self, pattern: ExecutionPattern, pilot: Pilot):
        self.pattern = pattern
        self.pilot = pilot
        self.profile = ExecutionProfile()

    def compile(self) -> List[PipelineSpec]:
        raise NotImplementedError

    def execute(self) -> ExecutionProfile:
        t0 = time.perf_counter()
        pipelines = self.compile()
        self.profile.t_pattern_overhead += time.perf_counter() - t0
        AppManager(self.pilot, profile=self.profile).run(pipelines)
        return self.profile


# ---------------------------------------------------------------- pipeline

class PipelineExecutionPlugin(BaseExecutionPlugin):
    pattern_cls = Pipeline

    def compile(self) -> List[PipelineSpec]:
        pat: Pipeline = self.pattern
        pipes = []
        # one PST pipeline per pipe instance: pipes advance independently
        # (a slow pipe never blocks another pipe's later stages)
        for p in range(pat.instances):
            stages: List[Stage] = []
            for s in range(1, pat.stages + 1):
                stages.append(Stage(
                    [TaskSpec(pat.stage_kernel(s, p),
                              name=f"pipe{p:05d}.stage{s}",
                              metadata={"instance": p})],
                    name=f"stage{s}",
                    inputs=({"prev": stages[-1].future()} if stages
                            else None)))
            pipes.append(PipelineSpec(stages, name=f"pipe{p:05d}"))
        return pipes


# ---------------------------------------------------------------- replica

class REExecutionPlugin(BaseExecutionPlugin):
    pattern_cls = ReplicaExchange

    def compile(self) -> List[PipelineSpec]:
        pat: ReplicaExchange = self.pattern
        prof = self.profile

        def cycle_stages(c: int) -> List[Stage]:
            sims = Stage(
                [TaskSpec(pat.prepare_replica_for_md(r),
                          name=f"cycle{c:04d}.md{r.id:05d}",
                          metadata={"instance": r.id, "iteration": c})
                 for r in pat.replicas],
                name="simulation")
            xname = f"cycle{c:04d}.exchange"

            def on_exchange(stage: Stage, pipe: PipelineSpec):
                xres = stage.results[xname]
                pat.apply_exchange(xres, pat.replicas)
                for r in pat.replicas:
                    r.cycle += 1
                prof.results[f"exchange_{c}"] = xres
                if c + 1 < pat.cycles:
                    # next cycle's kernels are prepared only now, AFTER the
                    # exchange was applied — the PST adaptivity hook
                    pipe.extend(cycle_stages(c + 1))

            # the exchange consumes the simulation stage through a typed
            # port: the kernel sees member results as ctx["inputs"]["members"]
            exchange = Stage(
                [TaskSpec(pat.prepare_exchange(pat.replicas), name=xname,
                          metadata={"iteration": c})],
                name="exchange", inputs={"members": sims.future()},
                on_done=on_exchange)
            return [sims, exchange]

        if pat.cycles <= 0:
            return [PipelineSpec([], name="re")]
        return [PipelineSpec(cycle_stages(0), name="re")]


# ---------------------------------------------------------------- SAL

class SALExecutionPlugin(BaseExecutionPlugin):
    pattern_cls = SimulationAnalysisLoop

    def compile(self) -> List[PipelineSpec]:
        pat: SimulationAnalysisLoop = self.pattern
        prof = self.profile

        def finale() -> List[Stage]:
            post = pat.post_loop()
            if post is None:
                return []
            return [Stage([TaskSpec(post, name="post_loop")],
                          name="post_loop")]

        def iter_stages(it: int) -> List[Stage]:
            sims = Stage(
                [TaskSpec(pat.simulation_stage(it, i),
                          name=f"iter{it:04d}.sim{i:05d}",
                          metadata={"instance": i, "iteration": it})
                 for i in range(pat.simulation_instances)],
                name="simulation")
            ana_names = [f"iter{it:04d}.ana{j:05d}"
                         for j in range(pat.analysis_instances)]

            def on_analysis(stage: Stage, pipe: PipelineSpec):
                results = [stage.results[n] for n in ana_names]
                prof.results[f"analysis_{it}"] = results
                # legacy called should_continue on EVERY iteration, the
                # last included — keep that call parity (subclasses may
                # track convergence state in it)
                cont = pat.should_continue(it, results)
                if cont and it + 1 < pat.maxiterations:
                    pipe.extend(iter_stages(it + 1))
                else:
                    pipe.extend(finale())

            analysis = Stage(
                [TaskSpec(pat.analysis_stage(it, j), name=n,
                          metadata={"instance": j, "iteration": it})
                 for j, n in enumerate(ana_names)],
                name="analysis", inputs={"sims": sims.future()},
                on_done=on_analysis)
            return [sims, analysis]

        stages: List[Stage] = []
        pre = pat.pre_loop()
        if pre is not None:
            stages.append(Stage([TaskSpec(pre, name="pre_loop")],
                                name="pre_loop"))
        if pat.maxiterations > 0:
            stages += iter_stages(0)
        else:
            stages += finale()
        return [PipelineSpec(stages, name="sal")]


_PLUGINS = [PipelineExecutionPlugin, REExecutionPlugin, SALExecutionPlugin]


def get_plugin(pattern: ExecutionPattern, pilot: Pilot,
               **kw) -> BaseExecutionPlugin:
    for cls in _PLUGINS:
        if isinstance(pattern, cls.pattern_cls):
            return cls(pattern, pilot, **kw)
    raise TypeError(f"no execution plugin for {type(pattern).__name__}; "
                    "register one by appending to _PLUGINS")

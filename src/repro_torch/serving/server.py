"""Continuous-batching decode as PST stages + its DES cost model (own copy
of ``repro.serving.server``).

``simulate_continuous`` is the virtual-clock analogue of
``repro_torch.serve.engine.BatchedServer._run_continuous``: B decode slots,
each request admitted into the earliest-free slot and evicted after its
own ``max_new_tokens`` steps.  It returns per-request first-token / finish
offsets and the wave makespan — the makespan becomes the serve task's
``sim_duration``, and the offsets let the metrics layer reconstruct
per-request latency from a single task's timestamps.  That is how a
100k-request day of traffic runs in CI as a few thousand DES tasks.

``build_serve_pipeline`` compiles one SLA class into a pipeline: one
single-task stage per traffic window, consuming that class's Channel (the
per-task FIFO port pairs window k's put with window k's take) and carrying
the class's SLA annotation so the frontier orders — and the preemptive
executor evicts — by it.

In real mode the ``serve.decode`` kernel (repro_torch/plugins/serve.py)
runs an actual ``BatchedServer`` (prefill/decode through the port's
kernels, continuous admit/evict) over the regenerated prompts.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.flow import Channel
from repro_torch.core.kernel_plugin import Kernel
from repro_torch.core.pst import PipelineSpec, Stage, TaskSpec
from repro_torch.serving.traffic import ServeRequest, TrafficModel, \
    build_traffic_pipeline, source_task_name


@dataclass(frozen=True)
class ContinuousSim:
    """Virtual-clock trace of one continuous-batch decode wave."""
    makespan_s: float
    steps: int
    prefills: int
    occupancy: float               # busy slot-steps / (slots * steps)
    first_s: Dict[int, float] = field(default_factory=dict)   # rid -> TTFT
    finish_s: Dict[int, float] = field(default_factory=dict)  # rid -> done


def simulate_continuous(reqs: List[ServeRequest], slots: int, *,
                        step_cost_s: float,
                        prefill_cost_s: float = 0.0) -> ContinuousSim:
    """Model a continuous-batching wave over ``slots`` decode slots.

    Each request takes the earliest-free slot (admission order = request
    order) and holds it for ``max_new_tokens`` steps; a slot frees the
    step its request finishes, exactly like ``BatchedServer``'s per-step
    admit/evict loop.  Admission wave w (the w-th group of ``slots``
    admissions) charges one group-prefill cost to its members' offsets.
    """
    if not reqs:
        return ContinuousSim(0.0, 0, 0, 1.0)
    free = [0] * max(int(slots), 1)       # next free step per slot
    heapq.heapify(free)
    first_s, finish_s = {}, {}
    makespan = 0
    for i, r in enumerate(reqs):
        start = heapq.heappop(free)
        end = start + max(int(r.max_new_tokens), 1)
        heapq.heappush(free, end)
        makespan = max(makespan, end)
        pre = (i // max(int(slots), 1) + 1) * prefill_cost_s
        first_s[r.rid] = (start + 1) * step_cost_s + pre
        finish_s[r.rid] = end * step_cost_s + pre
    prefills = -(-len(reqs) // max(int(slots), 1))
    busy = sum(max(int(r.max_new_tokens), 1) for r in reqs)
    return ContinuousSim(
        makespan_s=makespan * step_cost_s + prefills * prefill_cost_s,
        steps=makespan, prefills=prefills,
        occupancy=busy / (max(int(slots), 1) * makespan),
        first_s=first_s, finish_s=finish_s)


# ---------------------------------------------------------------- pipeline

def build_serve_pipeline(model: TrafficModel, sla: str, channel: Channel,
                         n_windows: int, *, decode_slots: int = 8,
                         cores: int = 1, step_cost_s: float = 0.05,
                         prefill_cost_s: float = 0.0,
                         name: Optional[str] = None,
                         source_pipeline: str = "traffic",
                         prioritize: bool = True,
                         metrics=None) -> PipelineSpec:
    """One SLA class's decode pipeline: a single-task stage per window
    with a DES duration from :func:`simulate_continuous`, consuming
    ``channel`` (FIFO: window k's put meets window k's take).  When a
    :class:`~repro_torch.serving.metrics.ServingMetrics` is given, every window
    is registered so per-request latencies can be reconstructed post-run.
    ``prioritize=False`` strips the SLA annotation (baseline mode)."""
    name = name or f"serve.{sla}"
    margs = dataclasses.asdict(model)
    stages = []
    for k in range(n_windows):
        reqs = model.requests(k, sla)
        if not reqs:
            continue
        sim = simulate_continuous(reqs, decode_slots,
                                  step_cost_s=step_cost_s,
                                  prefill_cost_s=prefill_cost_s)
        kern = Kernel("serve.decode")
        kern.arguments = {"model": margs, "window": k, "sla": sla,
                          "decode_slots": decode_slots}
        kern.cores = cores
        kern.sim_duration = sim.makespan_s
        kern.output_nbytes = (sum(r.max_new_tokens for r in reqs)
                              * model.bytes_per_token)
        task_name = f"{name}.w{k:05d}"
        stages.append(Stage(
            [TaskSpec(kern, name=task_name,
                      inputs={"batch": channel},
                      sla=sla if prioritize else None)],
            name=f"w{k:05d}"))
        if metrics is not None:
            metrics.register(
                task=task_name,
                source=source_task_name(source_pipeline, sla, k),
                sla=sla, window=k, sim=sim)
    return PipelineSpec(stages, name=name)


def build_serving_app(model: TrafficModel, n_windows: int, *,
                      decode_slots: int = 8, cores: int = 1,
                      step_cost_s: float = 0.05,
                      prefill_cost_s: float = 0.0,
                      capacity_bytes: Optional[int] = None,
                      prioritize: bool = True,
                      deadlines: Optional[Dict[str, float]] = None,
                      classes: tuple = ("latency", "throughput")):
    """Wire the full online-inference workload: per-class Channels, the
    traffic source pipeline, one serve pipeline per class, and a metrics
    collector.  Returns ``(pipelines, channels, metrics)`` — run the
    pipelines on any AppManager (DES or real), then
    ``metrics.install(am, prof)`` to land per-class latency/goodput in
    ``prof.results["serving"]``.

    ``capacity_bytes`` bounds each class Channel's unconsumed staged bytes
    (producer-side back-pressure; requires the pilot to run a
    StagingLayer, enforced by diagnostic E115).  ``deadlines`` overrides
    the per-class deadline budgets the metrics count goodput against.
    """
    from repro_torch.serving.metrics import ServingMetrics
    channels = {
        sla: Channel(f"serve.{sla}", capacity_bytes=capacity_bytes)
        for sla in classes}
    metrics = ServingMetrics(model, deadlines=deadlines)
    srcs = build_traffic_pipeline(model, n_windows, channels,
                                  prioritize=prioritize)
    serves = [build_serve_pipeline(model, sla, channels[sla], n_windows,
                                   decode_slots=decode_slots, cores=cores,
                                   step_cost_s=step_cost_s,
                                   prefill_cost_s=prefill_cost_s,
                                   prioritize=prioritize, metrics=metrics)
              for sla in classes]
    return [*srcs, *serves], channels, metrics

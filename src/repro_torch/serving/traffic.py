"""Seedable request traffic: a diurnal + bursty arrival process (own copy
of ``repro.serving.traffic``; numpy only, so both packages give the same
windows).

A :class:`TrafficModel` is a pure function of ``(seed, window index)``:
window k's request list is recomputable anywhere — the source kernel, the
DES cost model (serving/server.py), and the metrics layer
(serving/metrics.py) all regenerate the same list from the model's
parameters instead of moving 100k request payloads through the task graph.
That is what lets the O(100k)-request benchmark run as O(windows) tasks.

``build_traffic_pipeline`` compiles the model into a PST source pipeline:
one stage per window (the stage's ``sim_duration`` IS the window length,
so virtual time advances at arrival speed), one task per SLA class, each
putting its window's batch descriptor on that class's Channel.  The
declared ``output_nbytes`` is the batch's prompt-byte size, which is what
``Channel(capacity_bytes=...)`` meters for byte back-pressure.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.flow import Channel
from repro_torch.core.kernel_plugin import Kernel
from repro_torch.core.pst import PipelineSpec, Stage, TaskSpec
from repro_torch.serving.sla import CLASSES


@dataclass(frozen=True)
class ServeRequest:
    """One inference request, fully determined by (model seed, window)."""
    rid: int
    window: int
    sla: str                   # latency | throughput
    offset_s: float            # arrival offset inside its window
    prompt_tokens: int
    max_new_tokens: int


@dataclass(frozen=True)
class TrafficModel:
    """Deterministic arrival process: diurnal sinusoid + Bernoulli bursts.

    Window k's requests come from ``np.random.default_rng((seed, k))``, so
    any component can regenerate them independently; the diurnal rate is a
    raised cosine between ``base_rps`` and ``peak_rps`` over ``period_s``,
    and a burst window multiplies the rate by ``burst_mult``.
    """
    seed: int = 0
    window_s: float = 30.0
    base_rps: float = 2.0
    peak_rps: float = 8.0
    period_s: float = 3600.0
    burst_prob: float = 0.05
    burst_mult: float = 4.0
    latency_frac: float = 0.25       # share of latency-class requests
    prompt_tokens: int = 128
    latency_new_tokens: int = 16
    throughput_new_tokens: int = 96
    bytes_per_token: int = 4

    # ------------------------------------------------------------ process
    def rate(self, k: int) -> float:
        """Diurnal arrival rate (requests/s) for window k, pre-burst."""
        t = (k + 0.5) * self.window_s
        diurnal = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period_s))
        return self.base_rps + (self.peak_rps - self.base_rps) * diurnal

    def window(self, k: int) -> List[ServeRequest]:
        """Window k's full request list (deterministic in (seed, k))."""
        rng = np.random.default_rng((self.seed, k))
        rate = self.rate(k)
        if rng.random() < self.burst_prob:
            rate *= self.burst_mult
        n = int(rng.poisson(rate * self.window_s))
        offsets = np.sort(rng.uniform(0.0, self.window_s, n))
        is_lat = rng.random(n) < self.latency_frac
        reqs = []
        for i in range(n):
            sla = "latency" if is_lat[i] else "throughput"
            reqs.append(ServeRequest(
                rid=k * 1_000_000 + i, window=k, sla=sla,
                offset_s=float(offsets[i]),
                prompt_tokens=self.prompt_tokens,
                max_new_tokens=(self.latency_new_tokens if sla == "latency"
                                else self.throughput_new_tokens)))
        return reqs

    def requests(self, k: int, sla: Optional[str] = None) \
            -> List[ServeRequest]:
        reqs = self.window(k)
        if sla is None:
            return reqs
        return [r for r in reqs if r.sla == sla]

    def batch_nbytes(self, reqs: List[ServeRequest]) -> int:
        return sum(r.prompt_tokens for r in reqs) * self.bytes_per_token

    def total_requests(self, n_windows: int) -> int:
        return sum(len(self.window(k)) for k in range(n_windows))


# ---------------------------------------------------------------- pipeline

def build_traffic_pipeline(model: TrafficModel, n_windows: int,
                           channels: Dict[str, Channel], *,
                           name: str = "traffic",
                           prioritize: bool = True) -> List[PipelineSpec]:
    """Compile ``model`` into source pipelines — ONE PER SLA CLASS, each
    with one stage per window whose virtual duration is the window length
    (arrivals advance the DES clock at real-traffic speed), putting that
    window's batch descriptor on ``channels[sla]``.  Windows where a class
    has no arrivals emit no stage for it.

    The classes must be separate pipelines: stages within a pipeline are
    sequential, so a shared source pipeline would let the throughput
    class's byte back-pressure (its source parking on ``channel_space``)
    stall latency-class arrivals it has no business gating.

    ``prioritize=False`` strips the SLA annotation (every task priority 0)
    — the no-priority baseline the serving benchmark compares against.
    """
    margs = dataclasses.asdict(model)
    pipes = []
    for sla in channels:
        if sla not in CLASSES:
            raise KeyError(f"unknown SLA class {sla!r} "
                           f"(known: {sorted(CLASSES)})")
        stages = []
        for k in range(n_windows):
            reqs = model.requests(k, sla)
            if not reqs:
                continue
            kern = Kernel("serve.source")
            kern.arguments = {"model": margs, "window": k, "sla": sla}
            kern.sim_duration = model.window_s
            kern.output_nbytes = model.batch_nbytes(reqs)
            stages.append(Stage(
                [TaskSpec(kern, name=f"{name}.{sla}.w{k:05d}",
                          outputs=channels[sla],
                          sla=sla if prioritize else None)],
                name=f"w{k:05d}"))
        pipes.append(PipelineSpec(stages, name=f"{name}.{sla}"))
    return pipes


def source_task_name(name: str, sla: str, k: int) -> str:
    """Task name ``build_traffic_pipeline`` gives window k's ``sla``
    source — the arrival anchor the metrics layer reads."""
    return f"{name}.{sla}.w{k:05d}"

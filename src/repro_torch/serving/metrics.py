"""Serving metrics: per-class latency, TTFT, goodput, slot occupancy (own
copy of ``repro.serving.metrics``).

The DES run never materializes individual requests — each serve task is a
whole window's decode wave.  :class:`ServingMetrics` reconstructs the
per-request view afterwards: the traffic model regenerates window k's
arrivals, :func:`~repro_torch.serving.server.simulate_continuous`'s offsets say
when each request's first/last token landed inside the wave, and the task
graph's timestamps anchor both to the session clock (virtual in DES, wall
perf_counter in real mode).  DES arrivals follow the offered-load
schedule (open-loop), so source-side admission stalls count as latency
instead of being coordinated-omitted away; real mode anchors to the
source task's actual interval (its windows don't pace wall time).  ``install`` lands the aggregate in
``prof.results["serving"]``:

    per-class: n, p50/p99 latency, p50/p99 TTFT, tokens, deadline-met
               tokens, goodput (met tokens/s over the class's span),
               mean decode-slot occupancy, dropped windows
    overall:   tokens, goodput, throughput (all tokens/s), span
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.runtime.states import TaskState
from repro_torch.serving.server import ContinuousSim
from repro_torch.serving.sla import CLASSES
from repro_torch.serving.traffic import TrafficModel


@dataclass
class _Entry:
    task: str          # serve task name (one decode wave)
    source: str        # producing traffic task (arrival anchor)
    sla: str
    window: int
    sim: ContinuousSim


class ServingMetrics:
    """Post-run reconstruction of per-request serving metrics.

    ``deadlines`` overrides the per-class deadline budget (seconds);
    classes default to ``repro_torch.serving.sla.CLASSES``.
    """

    def __init__(self, model: TrafficModel,
                 deadlines: Optional[Dict[str, float]] = None):
        self.model = model
        self.deadlines = {name: c.deadline_s for name, c in CLASSES.items()}
        self.deadlines.update(deadlines or {})
        self.entries: List[_Entry] = []

    def register(self, *, task: str, source: str, sla: str, window: int,
                 sim: ContinuousSim):
        self.entries.append(_Entry(task, source, sla, window, sim))

    # ------------------------------------------------------------ collect
    @staticmethod
    def _times(t) -> Optional[tuple]:
        """(finish time, on-virtual-clock) for a completed task, or None.
        DES tasks carry virtual timestamps (the virtual interval is
        duration + t_data, so ``v_finished - makespan_s`` is the instant
        decoding began, after stage-in); real-mode tasks fall back to
        wall perf_counter timestamps."""
        if t is None or t.state != TaskState.DONE:
            return None
        if t.v_finished > 0.0:
            return t.v_finished, True
        return t.t_finished, False

    def collect(self, am) -> Dict[str, Any]:
        graph = am.session.graph
        per: Dict[str, Dict[str, Any]] = {}
        w_s = self.model.window_s
        # DES arrivals are anchored to the OFFERED-LOAD schedule, not to
        # the source tasks' actual finish times: a source parked on byte
        # back-pressure (or waiting for a slot) is admission delay the
        # user experiences, so it must count as latency.  Deriving each
        # arrival from its own source's finish would silently shift the
        # arrival clock along with every stall — coordinated omission —
        # and a saturated baseline would measure as fast as an idle one.
        # t0 is the earliest virtual time consistent with some source
        # having run on schedule (window k's source, unstalled, finishes
        # at t0 + (k + 1) * window_s).  Real mode keeps the source-finish
        # anchor: sources there don't pace wall time (sim_duration is
        # virtual), so no wall-clock arrival schedule exists to miss.
        resolved = []
        t0 = None
        for e in self.entries:
            serve = ServingMetrics._times(graph.tasks.get(e.task))
            src = ServingMetrics._times(graph.tasks.get(e.source))
            resolved.append((e, serve, src))
            if serve is not None and src is not None and serve[1]:
                start = src[0] - (e.window + 1) * w_s
                t0 = start if t0 is None else min(t0, start)
        for e, serve, src in resolved:
            acc = per.setdefault(e.sla, {
                "lat": [], "ttft": [], "tokens": 0, "met_tokens": 0,
                "arrivals": [], "finishes": [], "occ": [], "steps": [],
                "dropped_windows": 0})
            if serve is None or src is None:
                acc["dropped_windows"] += 1
                continue
            serve_fin, sim_clock = serve
            # wave decode start on the session clock; real mode uses the
            # modeled per-request offsets against the real task interval
            t = graph.tasks[e.task]
            decode_start = (serve_fin - e.sim.makespan_s if sim_clock
                            else t.t_started)
            deadline = self.deadlines.get(e.sla, float("inf"))
            for r in self.model.requests(e.window, e.sla):
                arrival = (t0 + e.window * w_s + r.offset_s if sim_clock
                           else src[0] - (w_s - r.offset_s))
                fin = decode_start + e.sim.finish_s[r.rid]
                lat = fin - arrival
                acc["lat"].append(lat)
                acc["ttft"].append(decode_start + e.sim.first_s[r.rid]
                                   - arrival)
                acc["tokens"] += r.max_new_tokens
                if lat <= deadline:
                    acc["met_tokens"] += r.max_new_tokens
                acc["arrivals"].append(arrival)
                acc["finishes"].append(fin)
            acc["occ"].append(e.sim.occupancy)
            acc["steps"].append(e.sim.steps)
        return self._summarize(per)

    def _summarize(self, per: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"classes": {}}
        all_arr, all_fin, all_tokens, all_met = [], [], 0, 0
        for sla, acc in sorted(per.items()):
            lat, ttft = np.asarray(acc["lat"]), np.asarray(acc["ttft"])
            span = (max(acc["finishes"]) - min(acc["arrivals"])
                    if acc["arrivals"] else 0.0)
            steps = np.asarray(acc["steps"], dtype=float)
            occ = (float(np.average(acc["occ"], weights=steps))
                   if len(steps) and steps.sum() else 0.0)
            out["classes"][sla] = {
                "n": int(lat.size),
                "p50_latency_s": float(np.percentile(lat, 50)) if lat.size
                else 0.0,
                "p99_latency_s": float(np.percentile(lat, 99)) if lat.size
                else 0.0,
                "p50_ttft_s": float(np.percentile(ttft, 50)) if ttft.size
                else 0.0,
                "p99_ttft_s": float(np.percentile(ttft, 99)) if ttft.size
                else 0.0,
                "tokens": acc["tokens"],
                "met_tokens": acc["met_tokens"],
                "goodput_tok_s": acc["met_tokens"] / span if span else 0.0,
                "occupancy": occ,
                "dropped_windows": acc["dropped_windows"],
            }
            all_arr += acc["arrivals"]
            all_fin += acc["finishes"]
            all_tokens += acc["tokens"]
            all_met += acc["met_tokens"]
        span = max(all_fin) - min(all_arr) if all_arr else 0.0
        out["overall"] = {
            "tokens": all_tokens, "met_tokens": all_met, "span_s": span,
            "goodput_tok_s": all_met / span if span else 0.0,
            "throughput_tok_s": all_tokens / span if span else 0.0,
        }
        return out

    def install(self, am, prof) -> Dict[str, Any]:
        """Collect and land the summary in ``prof.results["serving"]``."""
        summary = self.collect(am)
        prof.results["serving"] = summary
        return summary

"""repro_torch.obs: flight-recorder span tracing, metrics timelines, and TTC
overhead decomposition (own copy of ``repro.obs``).

Two complementary surfaces:

* **Live**: hand a :class:`Tracer` to ``PilotRuntime(tracer=...)`` (or a
  federation ``Fleet(tracer=...)``) — every attempt, park, preemption,
  pod event and dispatch decision becomes a span/instant on the run's
  authoritative clock, and the tracer's :class:`MetricsTimeline` samples
  frontier depth, slot occupancy, channel backlog, staging hit-rate and
  per-pilot load on clock ticks.  ``AppManager.run`` lands the timeline
  in ``prof.results["timeseries"]``.

* **Post-hoc**: any journal file replays into the same model —
  ``python -m repro_torch.obs trace|decompose|critical-path`` (see
  :mod:`repro_torch.obs.report`).  No live tracer needed.
"""
from repro_torch.obs.metrics import MetricsTimeline
from repro_torch.obs.report import (Segment, critical_path, decompose,
                              load_segments, to_chrome)
from repro_torch.obs.tracer import TASK, Tracer

__all__ = ["Tracer", "TASK", "MetricsTimeline", "Segment",
           "load_segments", "decompose", "to_chrome", "critical_path"]

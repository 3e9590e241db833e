"""Adaptive execution strategies — the paper's §5 future work ("transition
from static workload-resource mapping to adaptive mapping", Ref [41]):
time-ordered resource decisions driven by observed workload state.

``AdaptiveSlotStrategy`` watches utilization and resizes the pilot: shrink
when slots idle (freeing allocation for other pilots), grow up to a cap when
the ready backlog would overflow the current width.  It plugs in two ways:

  between runs   call ``decide``/``apply`` with per-phase profiling numbers
  live           pass ``strategy=`` to ``AppManager``: it calls ``apply``
                 at every stage completion with the session's LIVE
                 per-pipeline queue depths (``per_pipeline``) and a
                 demand-aware utilization, so the pilot re-sizes while
                 pipelines are still streaming."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.resource_handler import Pilot


@dataclass
class AdaptiveSlotStrategy:
    min_slots: int
    max_slots: int
    target_utilization: float = 0.85
    grow_factor: float = 2.0

    def decide(self, *, utilization: float, backlog: int,
               slots: int) -> int:
        """Return the slot count for the next phase."""
        if backlog > slots and utilization >= self.target_utilization:
            want = min(int(slots * self.grow_factor), self.max_slots,
                       max(backlog, slots))
        elif utilization < self.target_utilization / 2:
            want = max(self.min_slots, slots // 2)
        else:
            want = slots
        return max(self.min_slots, min(want, self.max_slots))

    def apply(self, pilot: Pilot, *, utilization: float, backlog: int,
              per_pipeline: Optional[Dict[str, int]] = None) -> int:
        """Resize ``pilot`` (any object with ``slots``/``resize``, so a bare
        PilotRuntime works too).  ``per_pipeline`` carries live per-pipeline
        queue depths when called from a running AppManager session; the
        default policy decides on the total, subclasses may weigh pipelines
        individually."""
        want = self.decide(utilization=utilization, backlog=backlog,
                           slots=pilot.slots)
        if want != pilot.slots:
            try:
                pilot.resize(want)
            except ValueError:
                # infeasible width (e.g. not a re-carvable multiple of a
                # mesh-backed pilot's slot topology): an adaptive decision
                # is advisory — hold the current width rather than kill
                # the session from inside a completion callback
                return pilot.slots
        return want

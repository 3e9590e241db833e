"""Backlog-driven fleet autoscaler (the scitq ``create_recruiter`` shape).

Where :class:`~repro_torch.runtime.strategy.AdaptiveSlotStrategy` resizes ONE
pilot, the Recruiter resizes the FLEET: it watches the ready-queue backlog
(``TaskGraph.frontier_slots()`` — total slot width waiting to run) against
active capacity, and spins whole pilots up or down within a slot budget.

Anti-thrash mechanics:

* **Hysteresis** — after any change (spawn ordered, pilot joined, pilot
  retired) the recruiter holds its decision for ``hysteresis_s``.  It
  must be at least ``spinup_s``: deciding again before the pilot you
  ordered arrives means re-reacting to the backlog you already bought
  capacity for (the validator's W205 flags that configuration).
* **Modeled spin-up** — a spawn is not instant: the pilot joins
  ``spinup_s`` after the decision (virtual clock in sim, wall clock in
  real mode), so the TTC cost of elasticity is accounted.
* **Shrink only when idle** — a pilot is retired only when the backlog
  is empty, fleet utilization is below ``shrink_idle_frac``, and that
  pilot runs nothing; its staged replicas and journal stay addressable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Recruiter:
    min_pilots: int = 1
    max_pilots: int = 4
    #: slots of each pilot the factory builds (the fleet's pilot_factory
    #: decides the real shape; this is the recruiter's planning model)
    slots_per_pilot: int = 8
    #: hard ceiling on total fleet slots (active + pending spawns)
    budget_slots: int = 32
    #: minimum seconds between fleet-size decisions
    hysteresis_s: float = 30.0
    #: seconds between ordering a pilot and it joining
    spinup_s: float = 10.0
    #: grow when backlog slots exceed this multiple of active capacity
    grow_backlog_factor: float = 2.0
    #: shrink when backlog is 0 and busy/capacity is at or below this
    shrink_idle_frac: float = 0.05
    #: decision log: {"t", "action": spawn|join|retire, ...}
    events: List[Dict] = field(default_factory=list, repr=False)
    _pending: List[float] = field(default_factory=list, repr=False)
    _last_change: float = field(default=float("-inf"), repr=False)

    def next_arrival(self) -> Optional[float]:
        return min(self._pending) if self._pending else None

    def tick(self, fleet, session, now: float):
        """One decision step, called from the session's housekeeping pass
        (``now`` is virtual in sim, wall-elapsed in real mode)."""
        due = [t for t in self._pending if t <= now]
        if due:
            self._pending = [t for t in self._pending if t > now]
            for _ in due:
                name = fleet.add_pilot()
                self.events.append({"t": now, "action": "join",
                                    "pilot": name})
                self._last_change = now
        if now - self._last_change < self.hysteresis_s:
            return
        active = fleet.active()
        total = sum(rt.slots for rt in active.values())
        backlog = session.graph.frontier_slots()
        pending_slots = len(self._pending) * self.slots_per_pilot
        if (backlog > self.grow_backlog_factor * max(total, 1)
                and fleet.pilot_factory is not None
                and len(active) + len(self._pending) < self.max_pilots
                and total + pending_slots + self.slots_per_pilot
                <= self.budget_slots):
            self._pending.append(now + self.spinup_s)
            self.events.append({"t": now, "action": "spawn",
                                "arrives": now + self.spinup_s,
                                "backlog_slots": backlog})
            self._last_change = now
            return
        if (backlog == 0 and not self._pending
                and len(active) > self.min_pilots
                and session.busy_slots
                <= self.shrink_idle_frac * max(total, 1)):
            # retire the newest idle pilot: oldest pilots hold the most
            # replicas, so they are the worst candidates to drop
            for name in reversed(list(active)):
                if session.pilot_busy(name) == 0:
                    fleet.retire_pilot(name)
                    session.on_pilot_retired(name)
                    self.events.append({"t": now, "action": "retire",
                                        "pilot": name})
                    self._last_change = now
                    return

    # ------------------------------------------------------------ summary
    def summary(self) -> Dict[str, int]:
        actions = [e["action"] for e in self.events
                   if e["action"] in ("spawn", "retire")]
        # thrash = re-buying capacity just dropped (retire -> spawn);
        # spawn -> retire is the normal end-of-campaign wind-down
        flips = sum(1 for a, b in zip(actions, actions[1:])
                    if a == "retire" and b == "spawn")
        return {"n_spawned": actions.count("spawn"),
                "n_retired": actions.count("retire"),
                "n_joined": sum(1 for e in self.events
                                if e["action"] == "join"),
                "direction_flips": flips,
                "n_pending": len(self._pending)}

"""FederatedSession: late-binding dispatch of one task stream onto N pilots.

Subclasses :class:`RuntimeSession` and overrides exactly the dispatch
hooks the base exposes (``_rt_for``, ``_occupy``, ``_can_launch_real``,
``_fault_source``, ...) so the drain loops — DES event loop, real-mode
condition-variable loop, fault scans, zombie guards, speculation plumbing —
run UNCHANGED.  What federation adds:

* **Late binding**: a task is bound to a pilot at LAUNCH time, not submit
  time.  ``_dispatch`` scores every pilot with free capacity and picks the
  one minimizing estimated completion: modeled ``t_data`` to move the
  task's staged inputs there (0 for a pilot already holding a replica,
  ``cross_gbps`` for a pilot-to-pilot fetch, ``host_gbps`` from HOST),
  tie-broken by load, with blamed pilots (retry exclusion) last.
* **Per-pilot capacity accounts** (``_busy_by``/``_free_by``) beside the
  base session's global ones — dispatch feasibility is per pilot; a
  32-slot fleet of 4 pilots cannot host a 16-wide task.
* **Per-pilot journals**: ``session_start`` is written into EVERY pilot's
  journal (tagged with the pilot name) and replay at construction merges
  every pilot's ``load_state()`` — a crashed federated run reconstructs
  the whole fleet's progress from the per-pilot files.
* **Whole-pilot death** reuses the pod-failure machinery verbatim: each
  pod of the dead pilot is abandoned/retired/replica-dropped by the
  existing kill paths (pods carry their pilot's prefix, so routing is a
  name parse), the pilot bottoms out at 0 slots and stops receiving
  dispatches, and retries late-bind onto survivors.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.federation.fleet import Fleet, _FaultUnion
from repro_torch.runtime.executor import PilotRuntime, RuntimeSession
from repro_torch.runtime.states import Task, TaskState
from repro_torch.staging.store import HOST


class FederatedSession(RuntimeSession):
    def __init__(self, fleet: Fleet, *, graph=None, on_task_done=None):
        self.fleet = fleet
        super().__init__(fleet, graph=graph, on_task_done=on_task_done)
        self._busy_by: Dict[str, int] = {}
        self._free_by: Dict[str, int] = {}
        self._started: set = set()
        self._init_done = False
        for name, rt in fleet.pilots.items():
            self._start_pilot(name, rt)
        self._init_done = True

    def _start_pilot(self, name: str, rt: PilotRuntime):
        """Open one pilot for dispatch: merge its journal's replay state
        into the session's, init its capacity accounts, and mark a new
        session segment in ITS journal (tagged — the sanitizer resets
        only this pilot's epoch state)."""
        done, results, history = rt.journal.load_state()
        self._replayed_done |= done
        self._replayed_results.update(results)
        for task, entries in history.items():
            self._replayed_history.setdefault(task, entries)
        self._busy_by[name] = 0
        self._free_by[name] = rt.slots
        if self._init_done and self.fleet.mode == "real":
            self._free["n"] += rt.slots     # joined mid-session: new capacity
        self._started.add(name)
        if self.fleet.mode == "sim":
            # per-pilot journals are time-faithful too: every record this
            # pilot writes carries the fleet session's virtual clock
            rt.journal.vclock = lambda: self.vnow
        tr = self.tracer
        if tr is not None:
            tr.metrics.gauge(f"pilot_busy:{name}",
                             lambda n=name: self.pilot_busy(n))
            if self._init_done:            # recruited mid-run, not seeded
                tr.instant("pilot", f"recruit:{name}", self._now(),
                           pilot=name, slots=rt.slots)
        rt.journal.record_event("session_start", mode=rt.mode,
                                slots=rt.slots)

    def _sync_pilots(self):
        for name, rt in self.fleet.pilots.items():
            if name not in self._started:
                self._start_pilot(name, rt)

    def on_pilot_retired(self, name: str):
        """Recruiter shrink notification: the pilot's free capacity
        leaves the global real-mode account (its per-pilot account zeroes
        so a later revival cannot double-credit)."""
        if self.fleet.mode == "real":
            self._free["n"] -= max(self._free_by.get(name, 0), 0)
        self._free_by[name] = 0
        if self.tracer is not None:
            self.tracer.instant("pilot", f"retire:{name}", self._now(),
                                pilot=name)

    def pilot_busy(self, name: str) -> int:
        if self.fleet.mode == "sim":
            return self._busy_by.get(name, 0)
        rt = self.fleet.pilots[name]
        return max(rt.slots - self._free_by.get(name, 0), 0)

    @property
    def busy_slots(self) -> int:
        if self.fleet.mode == "sim":
            return self._busy
        return sum(self.pilot_busy(n) for n in self.fleet.active())

    # ------------------------------------------------------- dispatch hooks
    def _rt_for(self, t: Task) -> PilotRuntime:
        return self.fleet.runtime_for_task(t)

    def _rt_for_pod(self, pod: str) -> PilotRuntime:
        rt = self.fleet.runtime_for_pod(pod)
        return rt if rt is not None else next(
            iter(self.fleet.pilots.values()))

    def _occupy(self, t: Task):
        self._busy += t.slots
        name = t.meta.get("pilot")
        if name in self._busy_by:
            self._busy_by[name] += t.slots

    def _vacate(self, t: Task):
        self._busy -= t.slots
        name = t.meta.get("pilot")
        if name in self._busy_by:
            self._busy_by[name] -= t.slots

    def _debit_free(self, t: Task):
        self._free["n"] -= t.slots
        name = t.meta.get("pilot")
        if name in self._free_by:
            self._free_by[name] -= t.slots

    def _credit_free(self, t: Task):
        self._free["n"] += t.slots
        name = t.meta.get("pilot")
        if name in self._free_by:
            self._free_by[name] += t.slots

    def _credit_free_n(self, rt: PilotRuntime, n: int):
        self._free["n"] += n
        name = getattr(rt, "_fleet_name", None)
        if name in self._free_by:
            self._free_by[name] += n

    def _can_launch_real(self, t: Task) -> bool:
        name = self._dispatch(t, self._free_by)
        if name is None:
            return False
        t.meta["pilot"] = name        # late binding happens HERE
        if self.tracer is not None:
            self.tracer.instant("dispatch", t.name, self._now(), pilot=name)
        return True

    def _too_wide_sim(self, t: Task) -> bool:
        active = self.fleet.active().values()
        return (all(t.slots > rt.slots for rt in active)
                if active else True)

    _too_wide_real = _too_wide_sim

    def _fault_source(self):
        injectors = [rt.faults for rt in self.fleet.pilots.values()
                     if rt.faults is not None]
        if not injectors:
            return None
        if len(injectors) == 1:
            return injectors[0]
        return _FaultUnion(injectors)

    def _housekeeping_sim(self):
        fleet = self.fleet
        self._sync_pilots()
        if fleet.recruiter is not None:
            # with an empty event heap the virtual clock only advances
            # here: jump to a pending recruit's arrival so starved tasks
            # wait for the incoming pilot instead of being canceled
            if not self._heap and not self.graph.done():
                arrival = fleet.recruiter.next_arrival()
                if arrival is not None:
                    self.vnow = max(self.vnow, arrival)
            fleet.recruiter.tick(fleet, self, self.vnow)
            self._sync_pilots()
        for rt in fleet.pilots.values():
            if rt.on_schedule is not None:
                rt.on_schedule(rt, self.graph, self.vnow)
            rt._apply_resize()
            rt._apply_topology_drop()
            # resize/compaction changed rt.slots: dispatch reads it live,
            # sim busy accounting needs no reconciliation

    def _housekeeping_real(self):
        fleet = self.fleet
        self._sync_pilots()
        if fleet.recruiter is not None:
            fleet.recruiter.tick(fleet, self,
                                 time.perf_counter() - self._t0)
            self._sync_pilots()
        for name, rt in fleet.pilots.items():
            if rt.on_schedule is not None:
                rt.on_schedule(rt, self.graph, None)
            delta = rt._apply_resize()
            if delta:
                self._credit_free_n(rt, delta)
            rt._apply_topology_drop()

    # ------------------------------------------------------------ dispatch
    def _est_t_data(self, t: Task, name: str, rt: PilotRuntime) -> float:
        """Modeled seconds to move ``t``'s staged inputs into pilot
        ``name``: 0 when a replica already lives in one of its pods
        (stage-in will link), else a pilot-to-pilot fetch at
        ``cross_gbps`` when any pod replica exists, else the host link."""
        entries = t.meta.get("staged_refs")
        if not entries or rt.staging is None:
            return 0.0
        planner = rt.staging.planner
        prefix = f"{name}:"
        total = 0.0
        for _kind, _key, ref in entries:
            locations = (planner.store.locations(ref.digest)
                         or set(ref.locations))
            pods = [loc for loc in locations if loc != HOST]
            if any(p.startswith(prefix) for p in pods):
                continue
            gbps = planner.cross_gbps if pods else planner.host_gbps
            total += planner.copy_latency_s + ref.nbytes / (gbps * 1e9)
        return total

    def _dispatch(self, t: Task, free: Dict[str, int]) -> Optional[str]:
        """Pick the pilot minimizing estimated completion for ``t`` among
        those with ``t.slots`` free NOW (late binding: the decision uses
        the replica map and load as they are at launch).  Returns None
        when no pilot currently fits — the caller requeues."""
        excluded = t.excluded_pods() if t.history else ()
        best = best_key = None
        for name, rt in self.fleet.active().items():
            if free.get(name, 0) < t.slots:
                continue
            blamed = 1 if any(p.startswith(f"{name}:")
                              for p in excluded) else 0
            load = 1.0 - free[name] / max(rt.slots, 1)
            key = (blamed, self._est_t_data(t, name, rt), load, name)
            if best_key is None or key < best_key:
                best, best_key = name, key
        return best

    # ---------------------------------------------------------- preemption
    # Per-pilot variants of the base session's preemption: capacity is a
    # per-pilot account here, so the deficit arithmetic and the victim
    # pool are scoped to one pilot, and a successful eviction binds the
    # high-priority task to the pilot it made room on.

    def _preempt_enabled(self, t: Task) -> bool:
        return t.priority > 0 and any(
            rt.preempt for rt in self.fleet.active().values())

    def _preempt_sim_for(self, t: Task) -> bool:
        for name, rt in self.fleet.active().items():
            if not rt.preempt or t.slots > rt.slots:
                continue
            need = t.slots - (rt.slots - self._busy_by.get(name, 0))
            victims = [] if need <= 0 else self._preempt_victims(
                t, need, [v for v in self._sim_running_tasks()
                          if v.meta.get("pilot") == name])
            if victims is None:
                continue
            for v in victims:
                self._preempt_sim(v)
            t.meta["pilot"] = name     # bind to the pilot we made room on
            return True
        return False

    def _preempt_real_for(self, t: Task) -> bool:
        for name, rt in self.fleet.active().items():
            if not rt.preempt or t.slots > rt.slots:
                continue
            need = t.slots - self._free_by.get(name, 0)
            victims = [] if need <= 0 else self._preempt_victims(
                t, need,
                [v for (_, epoch), (_th, v) in self._live_attempts.items()
                 if v.meta.get("launch_epoch") == epoch
                 and v.state == TaskState.RUNNING
                 and v.meta.get("pilot") == name])
            if victims is None:
                continue
            for v in victims:
                self._preempt_real(v)
            return True              # _can_launch_real re-dispatches
        return False

    def _schedule_sim(self):
        graph = self.graph
        if any(rt.preempt for rt in self.fleet.active().values()):
            # before the min-width gate: a saturated fleet is exactly
            # when a latency task needs the eviction path
            self._preempt_pass_sim()
        active = self.fleet.active()
        free = {n: rt.slots - self._busy_by.get(n, 0)
                for n, rt in active.items()}
        widest = max(free.values(), default=0)
        min_w = graph.frontier_min_width()
        if min_w is None or min_w > widest:
            return
        # bounded lookahead, as in the locality pass: pop enough ready
        # tasks to fill every free slot plus headroom, dispatch each to
        # its best pilot, hand the unplaceable back
        avail = sum(f for f in free.values() if f > 0)
        cands: List[Task] = []
        while len(cands) < avail + 16:
            t = graph.pop_ready()
            if t is None:
                break
            cands.append(t)
        for t in cands:
            name = self._dispatch(t, free)
            if name is None:
                graph.requeue(t)
                continue
            free[name] -= t.slots
            t.meta["pilot"] = name        # late binding happens HERE
            if self.tracer is not None:
                self.tracer.instant("dispatch", t.name, self.vnow,
                                    pilot=name)
            self._launch_sim(t)

    def _locality_candidates(self, avail: int) -> List[Task]:
        """Real-mode lookahead ordering across the fleet: tasks ranked by
        the CHEAPEST pilot's modeled stage-in cost (input-local anywhere
        beats copy-everywhere); per-task pilot choice still happens in
        ``_can_launch_real``."""
        graph = self.graph
        cands: List[Task] = []
        if avail <= 0:
            return cands
        min_w = graph.frontier_min_width()
        if min_w is None or min_w > avail:
            return cands
        while len(cands) < avail + 16:
            t = graph.pop_ready()
            if t is None:
                break
            cands.append(t)
        active = self.fleet.active()
        cands.sort(key=lambda c: (min(
            (self._est_t_data(c, n, rt) for n, rt in active.items()),
            default=0.0), c.tid))
        return cands

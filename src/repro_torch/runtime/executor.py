"""Pilot runtime executor: application-level scheduling of tasks onto the
pilot's slots (the RADICAL-Pilot analogue).

Two modes:
  real - tasks execute their callables on a slot thread pool (their CUDA
         work queues on the device; orchestration concurrency is real).
  sim  - discrete-event simulation: task ``duration`` advances a virtual
         clock.  Scheduler/bookkeeping overheads are still measured on the
         real clock — this is how the Fig.7-10 scaling benches reproduce the
         paper's overhead measurements at 2560 tasks without hours of
         wall-clock sleep.

Incremental scheduling: a :class:`RuntimeSession` is a long-lived scheduling
context over one pilot.  ``submit()`` injects tasks at any time — including
from an ``on_task_done`` callback fired as each task completes — and
``drain()`` runs until everything submitted is terminal.  This is what lets
the PST ``AppManager`` (repro_torch.core.pst) multiplex many pipelines over ONE
pilot session with no global barrier and no per-cycle graph teardown: a
completed exchange in ensemble A schedules A's next cycle immediately while
ensemble B is still simulating.  ``PilotRuntime.run(graph)`` is now a thin
wrapper: one session, one bulk submit, one drain.

Fault tolerance (repro_torch.runtime.faults): pod death is a NORMAL event, not an
abort.  A ``FaultInjector`` kills pods on the run clock (virtual in sim,
wall-clock elapsed in real); real mode additionally detects worker-thread
death structurally and hung tasks via heartbeat staleness.  A pod loss
fails the in-flight attempts on that pod — each recorded in
``Task.history`` with the pod it ran on (the scitq Execution-table shape) —
retires the pod's slot ids (capacity shrinks; with a device topology the
fleet shrink-recarves at the next quiescent point), drops the pod's staged
replicas, and re-grants bounded retries EXCLUDING the failing pod.  Every
launch carries an *epoch* (the attempt number); completions whose epoch no
longer matches the task's live epoch are zombies and are ignored, so an
abandoned attempt can never double-release slots or overwrite a retry.
Journal records (``pod_lost``/``worker_died``/``heartbeat_timeout``) replay
into ``Task.history`` on restart, so a run crashed mid-retry resumes with
its attempt count and pod exclusions intact.

Straggler mitigation via speculative duplicates (sim): clones route through
the SAME staging manifests as their originals, so a clone's input transfers
charge t_data exactly like the original's — the TTC decomposition stays
disjoint.  Elastic pilot resize mid-run; journal for restart (dynamically
injected tasks are journaled with a ``submitted`` record so a restarted
session can tell replayed structure from new work).

Mesh-aware slots: with a ``topology`` (``repro_torch.dist.topology.
SlotTopology``) the pilot's slots are *device submeshes* — a task
occupying ``slots`` pilot slots is granted that many slot ids
(``task.meta["slot_ids"]``) and can build its ``DeviceMesh`` via
``runtime.submesh_for(task)``.  This ties the paper's pilot-slot
abstraction to device placement: e.g. one replica-exchange member per pod
of the 2x16x16 production mesh.

Data staging: with a ``staging`` layer (repro_torch.staging.StagingLayer) tasks
carrying staged refs (``task.meta["staged_refs"]``) have their transfers
planned and executed between ``pop_ready`` and kernel launch, charged to
the task's ``t_data``; slot ids are granted locality-aware (free slots in
pods that already hold the task's input replicas first) and the scheduling
pass orders the frontier so input-local tasks run before tasks that would
have to copy.  Slot-id accounting turns on even without a device topology
(abstract ids) so locality — and pod-level fault exclusion — works on
plain pilots.
"""
from __future__ import annotations

import heapq
import statistics
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from repro_torch.runtime.faults import REVIVE, FailureDetector
from repro_torch.runtime.journal import Journal
from repro_torch.runtime.states import Task, TaskGraph, TaskState


def _staged_extra(t: Task) -> Dict[str, Any]:
    """``scheduled``-record annotation: the staged-input digests this
    attempt holds, so the sanitizer's S303 check can pair every hold
    with its eventual ``staged_release``."""
    digs = [ref.digest for _kind, _key, ref in t.meta.get("staged_refs", ())]
    return {"staged": digs} if digs else {}


@dataclass
class RuntimeProfile:
    """TTC decomposition (paper eq. 1-2)."""
    ttc: float = 0.0                   # makespan (virtual in sim mode)
    t_exec: float = 0.0                # sum of task execution times
    t_data: float = 0.0                # upload/download time
    t_rts_overhead: float = 0.0        # scheduling/dispatch (T_RP analogue)
    n_tasks: int = 0
    n_failed: int = 0
    n_canceled: int = 0
    n_retries: int = 0
    n_speculative: int = 0
    n_pod_lost: int = 0                # attempts lost to pod/worker failure
    n_preempted: int = 0               # attempts evicted for higher priority
    slot_busy: float = 0.0             # aggregate busy slot-seconds
    events: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def utilization(self) -> float:
        return self.slot_busy / max(self.ttc, 1e-12)


class PilotRuntime:
    def __init__(self, slots: Optional[int] = None, *, mode: str = "real",
                 topology=None,
                 journal: Optional[Journal] = None,
                 staging=None,
                 faults=None,
                 heartbeat_timeout: Optional[float] = None,
                 max_retries: int = 2,
                 straggler_factor: float = 0.0,
                 min_straggler_samples: int = 5,
                 sanitize: bool = False,
                 preempt: bool = False,
                 tracer=None,
                 on_schedule: Optional[Callable] = None):
        assert mode in ("real", "sim")
        if slots is None:
            if topology is None:
                raise ValueError("need slots= or topology=")
            slots = topology.n_slots
        self.slots = slots
        self.mode = mode
        self.topology = topology
        if topology is not None and slots > topology.n_slots:
            raise ValueError(f"{slots} slots > {topology.n_slots} submeshes")
        # free slot ids: tracked when the slots are device submeshes, when
        # a staging layer needs slot locality, and when a fault model needs
        # pod membership (a pod is a group of slot ids)
        self._free_ids: Optional[List[int]] = (
            list(range(topology.n_slots))[::-1] if topology is not None
            else list(range(slots))[::-1]
            if (staging is not None or faults is not None
                or heartbeat_timeout is not None)
            else None)
        # abstract ids ever minted and not retired (free + held): resize
        # must never re-mint an id a running task still holds
        self._minted: Optional[set] = \
            set(self._free_ids) if (topology is None
                                    and self._free_ids is not None) else None
        self.staging = staging
        if staging is not None:
            staging.bind_runtime(self)
        self.journal = journal or Journal(None)
        # live invariant checking (repro_torch.analysis): every record the
        # journal emits ALSO flows through the sanitizer, which raises
        # DiagnosticError at the exact record that breaks an invariant.
        # Priming digests a pre-existing journal so prior segments' puts
        # and epochs are known (else every replayed take looks unbound).
        self.sanitizer = None
        if sanitize:
            from repro_torch.analysis.sanitizer import JournalSanitizer
            self.sanitizer = JournalSanitizer(strict=True)
            self.sanitizer.prime(self.journal.path)
            self.journal.observer = self.sanitizer.observe
        self.faults = faults
        self.detector = FailureDetector(heartbeat_timeout) \
            if heartbeat_timeout is not None else None
        # pod-failure bookkeeping: retired ids stay OUT of the free pool
        # (and out of re-minting) until the pod revives or the topology
        # compacts them away at a quiescent point
        self.dead_pods: set = set()
        self._dead_ids: set = set()
        self._dead_pod_ids: Dict[str, List[int]] = {}
        self._drop_pending = False
        self.max_retries = max_retries
        # priority preemption: a ready task with priority > 0 that cannot
        # fit may evict RUNNING lower-priority idempotent tasks through
        # the abandon/requeue path (epoch-stamped — the completion of a
        # preempted attempt is an inert zombie).  Preemption is not a
        # failure: it neither blames the pod nor consumes retry budget.
        self.preempt = preempt
        # flight recorder (repro.obs.Tracer): every attempt/park/fault
        # becomes a span on the run's authoritative clock; None = untraced
        # (hook sites pay one attribute read)
        self.tracer = tracer
        self.straggler_factor = straggler_factor
        self.min_straggler_samples = min_straggler_samples
        # called as on_schedule(runtime, graph, vnow) before every
        # scheduling step (vnow None in real mode) — the hook adaptive
        # strategies use to resize() the pilot MID-run
        self.on_schedule = on_schedule
        self._resize_to: Optional[int] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ elastic
    def resize(self, slots: int):
        """Elastic pilot resize; takes effect at the next scheduling step.

        Growing past the carved submesh count re-carves the topology (e.g.
        2 pods -> 4 half-pods): validated here, applied at the first
        scheduling step where no task holds a slot id.
        """
        if self.topology is not None and slots > self.topology.n_slots:
            self.topology.recarve(slots)      # raises if not re-carvable
        with self._lock:
            self._resize_to = slots

    def _apply_resize(self) -> int:
        """Apply a pending resize; returns the capacity delta (real mode
        must credit/debit its free-slot counter by it)."""
        with self._lock:
            if self._resize_to is None:
                return 0
            if self.topology is not None \
                    and self._resize_to > self.topology.n_slots:
                # re-carve only when every live slot id is free: ids change
                # meaning, so in-flight tasks must drain first (the resize
                # stays pending and re-tries each scheduling step); retired
                # ids of a dead pod must compact away first too
                n_live = self.topology.n_slots - len(self._dead_ids)
                if self._dead_ids or len(self._free_ids) < n_live:
                    return 0
                self.topology = self.topology.recarve(self._resize_to)
                self._free_ids = list(range(self.topology.n_slots))[::-1]
            delta = self._resize_to - self.slots
            if self.topology is None and self._free_ids is not None:
                # abstract (staging-only) ids track capacity directly:
                # grow mints the lowest ids not currently outstanding
                # (NEVER an id a running task holds — that would alias two
                # tasks onto one locality domain — nor a dead pod's id),
                # shrink retires free ones (held ids return to a pool the
                # capacity gate no longer admits)
                if delta > 0:
                    new, i = [], 0
                    while len(new) < delta:
                        if i not in self._minted and i not in self._dead_ids:
                            new.append(i)
                        i += 1
                    self._minted.update(new)
                    self._free_ids[:0] = new[::-1]
                elif delta < 0:
                    drop = set(sorted(self._free_ids,
                                      reverse=True)[:-delta])
                    self._free_ids = [i for i in self._free_ids
                                     if i not in drop]
                    self._minted -= drop
            delta_out = delta
            self.slots = self._resize_to
            self._resize_to = None
            return delta_out

    # ------------------------------------------------------------ pods
    #: pod-name namespace for pilots WITHOUT a staging locality map —
    #: repro.federation sets it per pilot ("p1:") so two pilots' pod names
    #: never collide in a shared exclusion set / fault injector / journal
    _pod_prefix = ""

    def _pod_of(self, slot_id: int) -> str:
        """Locality domain of a slot id (staging's map when bound, else a
        one-slot-per-pod convention — so fault exclusion works without a
        staging layer)."""
        if self.staging is not None and self.staging.locality is not None:
            return self.staging.locality.pod_of(int(slot_id))
        return f"{self._pod_prefix}pod{int(slot_id)}"

    def _task_pod(self, t: Task) -> Optional[str]:
        ids = t.meta.get("slot_ids")
        if not ids:
            return None
        return self._pod_of(min(ids))

    def _all_live_ids(self) -> List[int]:
        if self.topology is not None:
            return [i for i in range((self.topology.n_slots))
                    if i not in self._dead_ids]
        if self._minted is not None:
            return sorted(self._minted)
        return []

    def live_pods(self) -> List[str]:
        return sorted({self._pod_of(i) for i in self._all_live_ids()})

    def _pod_ids(self, pod: str) -> List[int]:
        return [i for i in self._all_live_ids() if self._pod_of(i) == pod]

    def _retire_ids(self, ids: List[int], pod: str):
        """Take a dead pod's slot ids out of circulation."""
        self.dead_pods.add(pod)
        self._dead_pod_ids[pod] = list(ids)
        self._dead_ids.update(ids)
        if self._free_ids is not None:
            dead = set(ids)
            self._free_ids = [i for i in self._free_ids if i not in dead]
        if self._minted is not None:
            self._minted.difference_update(ids)

    def inject_pod_failure(self, pod: Optional[str] = None):
        """Kill a pod at the next scheduling step (chaos hook; creates a
        bare FaultInjector when the runtime has none)."""
        from repro_torch.runtime.faults import FaultInjector
        if self.faults is None:
            self.faults = FaultInjector()
        self.faults.kill_now(pod)

    def _apply_topology_drop(self) -> bool:
        """Shrink-recarve after pod loss: compact the device topology to
        the surviving slots.  Slot ids renumber, so this applies only at a
        quiescent point (every live id free); staged replica locations
        keyed on old pod names reset conservatively."""
        with self._lock:
            if not self._drop_pending or self.topology is None:
                return False
            n_live = self.topology.n_slots - len(self._dead_ids)
            if self._free_ids is None or len(self._free_ids) < n_live:
                return False
            self.topology = self.topology.drop(sorted(self._dead_ids))
            n = self.topology.n_slots
            self._free_ids = list(range(n))[::-1]
            self._dead_ids.clear()
            self._dead_pod_ids.clear()
            self.dead_pods.clear()
            self.slots = min(self.slots, n)
            self._drop_pending = False
            self.journal.record_event("topology_compacted", n_slots=n)
            if self.staging is not None:
                self.staging.on_topology_compacted(n)
            return True

    # ------------------------------------------------------------ submeshes
    def _acquire_slots(self, t: Task):
        """Grant ``t.slots`` slot ids (no-op without id tracking).

        Called wherever busy-count is incremented; capacity gating
        (busy <= self.slots <= live submeshes) guarantees availability.
        With a staging layer the grant is locality-aware: free ids in pods
        that already hold the task's staged input replicas come first, so
        the stage-in pass resolves to *link* instead of *copy*.  A retry
        whose history blames specific pods is granted ids AWAY from them
        (availability still wins: excluded pods are used last, not never).
        """
        if self._free_ids is None:
            return
        order: Optional[List[int]] = None
        if self.staging is not None and t.meta.get("staged_refs"):
            order = self.staging.preferred_ids(t, self._free_ids)
        excl = t.excluded_pods() if t.history else ()
        if excl:
            base = order if order is not None else sorted(self._free_ids)
            order = [i for i in base if self._pod_of(i) not in excl] \
                + [i for i in base if self._pod_of(i) in excl]
        if order is not None:
            ids = order[:t.slots]
            for i in ids:
                self._free_ids.remove(i)
            t.meta["slot_ids"] = ids
        else:
            t.meta["slot_ids"] = [self._free_ids.pop()
                                  for _ in range(t.slots)]
        t.meta.pop("slots_released", None)

    # ------------------------------------------------------------ staging
    def _stage_in_task(self, t: Task) -> float:
        """Execute the task's planned input transfers (repro_torch.staging) —
        runs between ``pop_ready`` and kernel launch.  Returns the
        seconds charged to t_data (0.0 without a staging layer)."""
        if self.staging is None or not t.meta.get("staged_refs"):
            return 0.0
        return self.staging.stage_in(t, self.mode)

    def _staging_finish(self, t: Task):
        """Terminal-state hook: release the task's staged-blob holds.
        The release is journaled (once, the finish() guard dedupes) so the
        sanitizer's S303 balance check can audit it post-hoc."""
        if self.staging is not None:
            released = self.staging.finish(t)
            if released:
                self.journal.record(t, "staged_release", digests=released)

    def _release_slots(self, t: Task):
        """Return t's slot ids exactly once (supersession may race a pop);
        ids of a dead pod stay retired instead of re-entering the pool."""
        if self._free_ids is None or "slot_ids" not in t.meta:
            return
        if t.meta.get("slots_released"):
            return
        t.meta["slots_released"] = True
        self._free_ids.extend(i for i in t.meta["slot_ids"]
                              if i not in self._dead_ids)

    def submesh_for(self, t: Task):
        """``DeviceMesh`` over the ranks of the slots granted to ``t``."""
        if self.topology is None:
            raise ValueError("runtime has no device topology")
        return self.topology.submesh(t.meta["slot_ids"])

    # ------------------------------------------------------------ sessions
    def session(self, *, on_task_done: Optional[Callable] = None
                ) -> "RuntimeSession":
        """Open a long-lived incremental scheduling session."""
        return RuntimeSession(self, on_task_done=on_task_done)

    # ------------------------------------------------------------ run
    def run(self, graph: TaskGraph) -> RuntimeProfile:
        """Closed-world execution of a prebuilt graph (one-shot session)."""
        graph.validate()
        sess = RuntimeSession(self, graph=graph)
        # journal replay from the session's (single) parse of the file
        skipped = sum(sess._replay_task(t) for t in graph.tasks.values())
        if skipped:
            sess.prof.events.append({"event": "journal_skip", "n": skipped})
        return sess.drain()

    # ------------------------------------------------------------ shutdown
    def close(self, *, keep_durable: bool = True) -> int:
        """Close the runtime: GC spill files the staging layer can prove
        unreferenced (zero-ref blobs whose digest no journal record still
        names — deleting a journaled ref's file would end restartability),
        then close the journal.  ``keep_durable=False`` drops journaled
        digests from the keep set too (a run that will never be replayed).
        Returns the number of spill files reclaimed."""
        n = 0
        if self.staging is not None:
            n = self.staging.gc_spill(self.journal,
                                      keep_durable=keep_durable)
        self.journal.close()
        return n


class RuntimeSession:
    """Incremental scheduling over one pilot: ``submit()`` then ``drain()``.

    The session owns the live TaskGraph, the virtual clock (sim mode), and
    the busy-slot accounting, all of which persist across submissions.  An
    ``on_task_done(task, session)`` callback fires from inside the drain
    loop as each non-speculative task reaches a terminal state and may call
    :meth:`submit` to inject downstream work — dynamic injection is what
    turns the per-cycle barrier of the legacy plugins into streaming,
    per-pipeline progress.  Callbacks run on the drain thread; ``submit``
    is not thread-safe against a concurrent ``drain``.
    """

    def __init__(self, runtime: PilotRuntime, *, graph: Optional[TaskGraph]
                 = None, on_task_done: Optional[Callable] = None):
        self.rt = runtime
        self.graph = graph if graph is not None else TaskGraph()
        self.prof = RuntimeProfile()
        self.on_task_done = on_task_done
        self.vnow = 0.0                      # virtual clock (sim mode)
        self._t0: Optional[float] = None     # real clock at first drain
        self._cbq: deque = deque()           # terminal tasks awaiting callback
        # sim-mode state (persists across drains: the clock never resets)
        self._busy = 0
        self._heap: List = []                # (v_finish, seq, epoch, task)
        self._seq = 0
        self._durations: Dict[str, List[float]] = {}
        self._spec_launched: Dict[str, Task] = {}
        # real-mode state
        self._cv = threading.Condition(threading.Lock())
        self._free = {"n": runtime.slots}
        # workers still inside _execute_real: a task flips to a terminal
        # state BEFORE its completion bookkeeping (callback enqueue, slot
        # release) runs under the lock, so graph.done() alone must never
        # end the drain loop
        self._inflight = 0
        # live (task name, launch epoch) -> (worker thread, task): the
        # failure scan walks this; completion pops its own entry, and a
        # completion whose entry is GONE was abandoned (pod kill / stale
        # heartbeat) — its bookkeeping already happened, so it is a zombie
        # and returns without touching the accounting
        self._live_attempts: Dict[tuple, tuple] = {}
        self._zombie_threads: set = set()
        # journal replay set, loaded once per session
        self._replayed_done, self._replayed_results, \
            self._replayed_history = runtime.journal.load_state()
        # observability (repro.obs): sim sessions make the journal
        # time-faithful — every record carries a ``vt`` field on the
        # virtual clock beside its wall ``t`` — and the frontier stamps
        # each task's ready time for the t_sched decomposition term
        self.tracer = getattr(runtime, "tracer", None)
        if runtime.mode == "sim":
            runtime.journal.vclock = lambda: self.vnow
            self.graph.clock = lambda: self.vnow
        if self.tracer is not None:
            self.tracer.clock = ("virtual" if runtime.mode == "sim"
                                 else "wall")
            self._register_gauges()
        # segment marker: epoch/attempt invariants reset here (a restart
        # legitimately re-runs tasks from attempt one), and replay parsers
        # skip it (no "task" key)
        runtime.journal.record_event("session_start", mode=runtime.mode,
                                     slots=runtime.slots)

    @property
    def busy_slots(self) -> int:
        """Slots currently occupied by running tasks (live signal for
        adaptive strategies; reads the drain thread's own accounting)."""
        if self.rt.mode == "sim":
            return self._busy
        return self.rt.slots - self._free["n"]

    # ------------------------------------------------------- observability
    def _now(self) -> float:
        """The run's authoritative clock: virtual now in sim mode, wall
        seconds since the first drain in real mode (0.0 before it)."""
        if self.rt.mode == "sim":
            return self.vnow
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def _register_gauges(self):
        """Built-in gauges over live session state, sampled by the drain
        loops on clock ticks (repro.obs.MetricsTimeline)."""
        m = self.tracer.metrics
        g = self.graph
        m.gauge("frontier_depth", lambda: len(g._in_frontier))
        m.gauge("frontier_slots", g.frontier_slots)
        m.gauge("busy_slots", lambda: self.busy_slots)
        m.gauge("capacity_slots", lambda: self.rt.slots)
        m.gauge("unfinished_tasks", lambda: len(g) - g._n_terminal)
        m.gauge("retries", lambda: self.prof.n_retries)
        m.gauge("preempted", lambda: self.prof.n_preempted)
        staging = getattr(self.rt, "staging", None)
        if staging is not None:
            m.gauge("staging_hit_rate", lambda: staging.planner.hit_rate)

    def _sched_extra(self, t: Task) -> Dict[str, Any]:
        """Observability fields on a ``scheduled`` record: granted slot
        ids (same-slot overlap checking + per-slot trace rows), width,
        owning pipeline, and — on the FIRST attempt only — the dep edges
        the critical-path walk needs (retries keep the original's)."""
        extra = _staged_extra(t)
        ids = t.meta.get("slot_ids")
        if ids:
            extra["slot_ids"] = list(ids)
        if t.slots != 1:
            extra["width"] = t.slots
        if "pipeline" in t.meta:
            extra["pipeline"] = t.meta["pipeline"]
        if t.attempts == 1 and t.deps:
            extra["deps"] = list(t.deps)
        return extra

    # ------------------------------------------------------- dispatch hooks
    # Indirection points the federation layer (repro.federation) overrides
    # to route each task/pod to its owning pilot and to keep per-pilot
    # capacity accounts.  The base session has exactly one pilot, so they
    # all collapse to self.rt / the flat counters.

    def _rt_for(self, t: Task) -> PilotRuntime:
        """Runtime owning ``t``'s current attempt."""
        return self.rt

    def _rt_for_pod(self, pod: str) -> PilotRuntime:
        """Runtime owning pod ``pod`` (federation parses the pilot prefix
        out of the pod name)."""
        return self.rt

    def _occupy(self, t: Task):
        """Charge ``t``'s width to the sim busy account at launch."""
        self._busy += t.slots

    def _vacate(self, t: Task):
        """Return ``t``'s width to the sim busy account."""
        self._busy -= t.slots

    def _can_launch_real(self, t: Task) -> bool:
        """Capacity test for one real-mode launch (federation also binds
        the task to a pilot here)."""
        return t.slots <= self._free["n"]

    def _debit_free(self, t: Task):
        self._free["n"] -= t.slots

    def _credit_free(self, t: Task):
        self._free["n"] += t.slots

    def _credit_free_n(self, rt: PilotRuntime, n: int):
        """Credit ``n`` slots of capacity belonging to ``rt`` (resize,
        pod revival, kill-abandon deltas)."""
        self._free["n"] += n

    def _too_wide_sim(self, t: Task) -> bool:
        """True when no capacity this session will EVER have can host
        ``t`` (the cancel-unsatisfiable rule's width half)."""
        return t.slots > self.rt.slots

    def _too_wide_real(self, t: Task) -> bool:
        return t.slots > self._free["n"]

    def _fault_source(self):
        """Injector consulted by the drain loops (federation: an
        aggregate over every pilot's injector)."""
        return self.rt.faults

    def _housekeeping_sim(self):
        """Per-pass sim housekeeping: strategy hook, pending resizes,
        topology compaction."""
        rt = self.rt
        if rt.on_schedule is not None:
            rt.on_schedule(rt, self.graph, self.vnow)
        rt._apply_resize()
        rt._apply_topology_drop()

    def _housekeeping_real(self):
        rt = self.rt
        if rt.on_schedule is not None:
            rt.on_schedule(rt, self.graph, None)
        self._free["n"] += rt._apply_resize()   # elastic grow/shrink
        rt._apply_topology_drop()

    # ------------------------------------------------------------ submit
    def submit(self, tasks: Union[Task, Iterable[Task]], *,
               dynamic: bool = False) -> List[Task]:
        """Add tasks to the live graph.  Deps must already be in the graph
        (earlier submission or same batch) — incremental submission is
        therefore acyclic by construction.  Tasks recorded DONE in the
        journal are replayed (skipped) and still fire their callback."""
        batch = [tasks] if isinstance(tasks, Task) else list(tasks)
        names = {t.name for t in batch}
        skipped = 0
        for t in batch:
            for d in t.deps:
                if d not in self.graph.tasks and d not in names:
                    raise ValueError(f"{t.name}: unknown dep {d}")
            self.graph.add(t)
            if dynamic:
                self.rt.journal.record(t, "submitted", dynamic=True)
            if self._replay_task(t):
                skipped += 1
                self._queue_callback(t)
        if skipped:
            self.prof.events.append({"event": "journal_skip", "n": skipped})
        return batch

    def _replay_task(self, t: Task) -> bool:
        """Mark ``t`` DONE (with its recorded result) if the journal says
        it already finished; otherwise seed its attempt history from the
        journal's failure records — a run crashed mid-retry resumes with
        its attempt count and pod exclusions, not a fresh budget.  The
        single shared replay rule."""
        if t.name in self._replayed_done and not t.state.terminal:
            t.state = TaskState.DONE
            t.result = self._replayed_results.get(t.name, t.result)
            return True
        self._seed_history(t)
        return False

    def _seed_history(self, t: Task):
        if t.state.terminal or t.attempts or t.history:
            return
        entries = self._replayed_history.get(t.name)
        if not entries:
            return
        t.attempts = max(e["attempt"] for e in entries)
        for e in entries:
            t.history.append({"attempt": e["attempt"],
                              "pod": e.get("pod"), "slot_ids": [],
                              "outcome": e["outcome"]})

    # ------------------------------------------------------------ drain
    def drain(self) -> RuntimeProfile:
        """Run until every submitted task is terminal (callbacks included:
        work they inject is drained too).  Returns the session profile,
        cumulative across drains."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if self.rt.mode == "sim":
            self._drain_sim()
            self.prof.ttc = self.vnow
        else:
            self._drain_real()
            self.prof.ttc = time.perf_counter() - self._t0
        self.prof.n_tasks = len(self.graph)
        self.prof.n_failed = sum(1 for t in self.graph.tasks.values()
                                 if t.state == TaskState.FAILED)
        self.prof.n_canceled = sum(1 for t in self.graph.tasks.values()
                                   if t.state == TaskState.CANCELED)
        return self.prof

    # ------------------------------------------------------------ staging
    def _locality_candidates(self, avail: int) -> List[Task]:
        """Bounded locality-ordered lookahead (staging pilots only): pop
        at most ``avail`` + headroom ready tasks — nothing at all when
        nothing can fit — and order input-local tasks first.  Shared by
        the sim and real drain loops; the caller launches what fits and
        hands the rest back."""
        graph, rt = self.graph, self.rt
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
        cands.sort(key=lambda c: (not rt.staging.prefers(
            c, rt._free_ids), c.tid))
        return cands

    # ------------------------------------------------------------ callbacks
    def _queue_callback(self, t: Task):
        if self.on_task_done is not None and t.speculative_of is None:
            self._cbq.append(t)

    def _flush_callbacks(self):
        while self._cbq:
            self.on_task_done(self._cbq.popleft(), self)

    # ------------------------------------------------------------ failures
    def _pick_victim(self) -> Optional[str]:
        """Deterministic kill-victim choice when the injector names none:
        the busiest live pod (most running attempts; lowest name breaks
        ties), falling back to the first live pod."""
        rt = self.rt
        counts: Dict[str, int] = {}
        if rt.mode == "sim":
            running = (t for _, _, epoch, t in self._heap
                       if t.meta.get("launch_epoch") == epoch
                       and t.state == TaskState.RUNNING)
        else:
            running = (t for _, t in self._live_attempts.values()
                       if t.state == TaskState.RUNNING)
        for t in running:
            tr = self._rt_for(t)
            p = tr._task_pod(t)
            if p is not None and p not in tr.dead_pods:
                counts[p] = counts.get(p, 0) + 1
        if counts:
            return max(sorted(counts), key=lambda p: counts[p])
        live = rt.live_pods()
        return live[0] if live else None

    def _revive_pod(self, pod: str) -> int:
        """A replacement pod joins under the dead pod's slot ids (fresh
        pod: no data replicas — staging dropped them at the kill).
        Returns the capacity gained (real mode credits its free count)."""
        rt, prof = self._rt_for_pod(pod), self.prof
        ids = rt._dead_pod_ids.pop(pod, None)
        if not ids:
            return 0
        rt.dead_pods.discard(pod)
        rt._dead_ids.difference_update(ids)
        if rt._minted is not None:
            rt._minted.update(ids)
        if rt._free_ids is not None:
            rt._free_ids.extend(sorted(ids, reverse=True))
        rt.slots += len(ids)
        if not rt._dead_ids:
            rt._drop_pending = False
        rt.journal.record_event("pod_revived", pod=pod, n_slots=len(ids))
        if self.tracer is not None:
            self.tracer.instant("pod", f"pod_revived:{pod}", self._now(),
                                pod=pod, n_slots=len(ids))
        prof.events.append({"event": "pod_revived", "pod": pod,
                            "n_slots": len(ids), "v": self.vnow})
        return len(ids)

    # ------------------------------------------------------------ sim mode
    def _overhead(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.prof.t_rts_overhead += time.perf_counter() - t0
        return out

    def _launch_sim(self, t: Task):
        self._occupy(t)
        rt = self._rt_for(t)
        rt._acquire_slots(t)
        # staged-input transfers execute here — between pop_ready and
        # launch — and extend the task's occupancy on the virtual clock
        t_data = rt._stage_in_task(t)
        t.meta["t_data_attempt"] = t_data   # this attempt's staged seconds
        t.attempts += 1
        t.error = None                 # a retry must not inherit the
        t.state = TaskState.RUNNING    # previous attempt's error
        t.t_scheduled = time.perf_counter()
        t.v_started = self.vnow
        t.meta["launch_epoch"] = t.attempts
        v_ready = t.meta.pop("v_ready", None)    # retry re-stamps afresh
        pod = rt._task_pod(t)
        journal = rt.journal
        if journal._fh is not None or journal.observer is not None:
            extra = self._sched_extra(t)
            if t_data:
                extra["t_data"] = t_data    # planned stage-in seconds
            if v_ready is not None:
                extra["v_ready"] = v_ready
            journal.record(t, "scheduled", pod=pod, **extra)
        if self.tracer is not None:
            self.tracer.task_begin(t, self.vnow, pod, t_data)
        heapq.heappush(self._heap,
                       (self.vnow + max(t.duration, 0.0) + t_data,
                        self._seq, t.attempts, t))
        self._seq += 1

    def _schedule_sim(self):
        rt, graph = self.rt, self.graph
        if rt.preempt:
            # high-priority head of line first: with the pilot saturated
            # by throughput work, the locality pass below would not even
            # pop a latency task (avail == 0)
            self._preempt_pass_sim()
        if rt.staging is not None:
            # locality-ordered pass: tasks whose staged inputs already
            # have a replica in a free pod run first (they link instead
            # of copy); head-of-line holds within the locality order
            # (stop at the first candidate that does not fit, same as
            # the seed)
            cands = self._locality_candidates(rt.slots - self._busy)
            for i, t in enumerate(cands):
                if rt.slots - self._busy >= t.slots:
                    self._launch_sim(t)
                else:
                    for c in cands[i:]:
                        graph.requeue(c)
                    break
            return
        while True:
            t = graph.pop_ready()          # incremental frontier, tid order
            if t is None:
                break
            if rt.slots - self._busy < t.slots:
                graph.requeue(t)           # same head-of-line rule as seed
                break
            self._launch_sim(t)

    def _finish_sim(self, t: Task):
        rt, graph, prof = self._rt_for(t), self.graph, self.prof
        t.record_attempt("done", pod=rt._task_pod(t))
        t.state = TaskState.DONE
        t.v_finished = self.vnow
        t.t_finished = time.perf_counter()
        prof.t_exec += t.duration
        prof.t_data += t.t_data
        prof.slot_busy += t.duration * t.slots
        self._durations.setdefault(t.stage, []).append(t.duration)
        # timing fields feed the sanitizer's S306 disjointness check: on
        # the virtual clock, the attempt's interval is EXACTLY its exec
        # time plus its staged-transfer time
        rt.journal.record(t, "finished", t_exec=max(t.duration, 0.0),
                          t_data=t.meta.get("t_data_attempt", 0.0),
                          v_started=t.v_started, v_finished=t.v_finished)
        if self.tracer is not None:
            self.tracer.task_end(t, self.vnow, "done")
        rt._staging_finish(t)
        if t.speculative_of:
            # the duplicate won: complete the straggling original
            # and kill it (freeing its slot now, if it held one — a
            # pod-lost original may be back in the frontier as NEW)
            orig = graph.tasks.get(t.speculative_of)
            if orig is not None and not orig.state.terminal:
                ort = self._rt_for(orig)
                was_running = orig.state == TaskState.RUNNING
                orig.record_attempt("superseded", pod=ort._task_pod(orig))
                orig.state = TaskState.DONE
                orig.v_finished = self.vnow
                if was_running:
                    orig.meta["slot_freed"] = True
                    self._vacate(orig)
                    ort._release_slots(orig)
                orig.meta["launch_epoch"] = None
                ort.journal.record(orig, "finished", by="speculative")
                if self.tracer is not None and was_running:
                    self.tracer.task_end(orig, self.vnow, "superseded")
                ort._staging_finish(orig)
                self._queue_callback(orig)
            self._spec_launched.pop(t.speculative_of, None)
        else:
            # original won: cancel its twin if any.  The twin's slot and
            # busy-count return at its heap pop; its journal record,
            # staged-input holds and t_data charge settle HERE — a
            # canceled clone still moved data
            twin = self._spec_launched.pop(t.name, None)
            if twin is not None and not twin.state.terminal:
                trt = self._rt_for(twin)
                twin.record_attempt("canceled", pod=trt._task_pod(twin))
                twin.state = TaskState.CANCELED
                trt.journal.record(twin, "canceled", by="original")
                if self.tracer is not None:
                    self.tracer.task_end(twin, self.vnow, "canceled")
                trt._staging_finish(twin)
                prof.t_data += twin.t_data
            self._queue_callback(t)

    def _apply_faults_sim(self):
        for kind, pod in self._fault_source().pop_due(self.vnow):
            if kind == REVIVE:
                self._revive_pod(pod)
            else:
                victim = pod if pod is not None else self._pick_victim()
                if victim is None \
                        or victim in self._rt_for_pod(victim).dead_pods:
                    continue
                self._kill_pod_sim(victim)

    def _kill_pod_sim(self, pod: str):
        rt, prof = self._rt_for_pod(pod), self.prof
        ids = rt._pod_ids(pod)
        if not ids:
            return
        idset = set(ids)
        rt._retire_ids(ids, pod)
        rt.slots = max(rt.slots - len(ids), 0)
        # slot ids are pilot-local integers, so the victim scan must also
        # match the owning runtime — id 3 on another pilot is a bystander
        victims = [t for _, _, epoch, t in self._heap
                   if t.meta.get("launch_epoch") == epoch
                   and t.state == TaskState.RUNNING
                   and self._rt_for(t) is rt
                   and idset.intersection(t.meta.get("slot_ids", ()))]
        for t in victims:
            self._abandon_sim(t, pod)
        if rt.staging is not None:
            rt.staging.on_pod_lost(pod)
        rt.journal.record_event("pod_lost", pod=pod, n_slots=len(ids),
                                v=self.vnow)
        if self.tracer is not None:
            self.tracer.instant("pod", f"pod_lost:{pod}", self.vnow,
                                pod=pod, n_slots=len(ids))
        prof.events.append({"event": "pod_lost", "pod": pod,
                            "n_slots": len(ids), "v": self.vnow})
        if rt.faults is not None and rt.faults.respawn_after is not None:
            rt.faults.schedule_revive(pod, self.vnow)
        elif rt.topology is not None:
            rt._drop_pending = True

    def _abandon_sim(self, t: Task, pod: str):
        """Fail one in-flight sim attempt on a dead pod: invalidate its
        launch epoch (the heap entry becomes a no-op), free its capacity,
        record the attempt against the pod, and retry or fail."""
        rt, prof = self._rt_for(t), self.prof
        t.meta["launch_epoch"] = None
        self._vacate(t)
        rt._release_slots(t)
        err = f"pod_lost: pod {pod} died at v={self.vnow:g}"
        t.record_attempt("pod_lost", pod=pod, error=err)
        t.error = err
        prof.n_pod_lost += 1
        rt.journal.record(t, "pod_lost", pod=pod)
        if self.tracer is not None:       # truncated span, never an overlap
            self.tracer.task_end(t, self.vnow, "pod_lost")
        if t.speculative_of is not None:
            # a clone needs no retry — the original is still running
            t.state = TaskState.CANCELED
            rt.journal.record(t, "canceled", by="pod_lost")
            rt._staging_finish(t)
            prof.t_data += t.t_data
            self._spec_launched.pop(t.speculative_of, None)
            return
        t.meta.pop("slot_ids", None)
        t.meta.pop("slots_released", None)
        if t.attempts <= rt.max_retries:
            t.state = TaskState.NEW     # re-enters the frontier; the next
            prof.n_retries += 1         # grant excludes this pod
        else:
            t.state = TaskState.FAILED
            t.v_finished = self.vnow
            rt.journal.record(t, "failed", pod=pod)
            rt._staging_finish(t)
            prof.t_data += t.t_data
            self._queue_callback(t)

    # ------------------------------------------------------- preemption
    # A ready high-priority task (serving's `latency` SLA class) that
    # cannot fit may evict running lower-priority idempotent attempts.
    # Eviction IS the abandon path: invalidate the launch epoch (the
    # in-flight completion becomes an inert zombie), free capacity,
    # record the attempt, requeue as NEW.  Unlike a pod failure it never
    # blames the pod (excluded_pods ignores "preempted") and never
    # consumes retry budget — a throughput task preempted N times still
    # has its full max_retries for real failures.

    def _preempt_enabled(self, t: Task) -> bool:
        """Gate for one preemption attempt on behalf of ready task ``t``
        (federation overrides: per-pilot capacity accounts need their own
        victim arithmetic)."""
        return self.rt.preempt and t.priority > 0

    def _preempt_victims(self, t: Task, need: int,
                         running) -> Optional[List[Task]]:
        """Pick victims freeing >= ``need`` slots for ``t``: strictly
        lower priority, idempotent, not speculation-involved.  Least
        work lost first (latest v_started).  None when the eligible pool
        cannot cover the deficit — then nothing is evicted."""
        cands = [v for v in running
                 if (v.priority < t.priority and v.idempotent
                     and v.speculative_of is None
                     and v.name not in self._spec_launched)]
        cands.sort(key=lambda v: (v.priority, -v.v_started, v.tid))
        chosen, freed = [], 0
        for v in cands:
            chosen.append(v)
            freed += v.slots
            if freed >= need:
                return chosen
        return None

    def _sim_running_tasks(self) -> List[Task]:
        return [v for _, _, epoch, v in self._heap
                if v.meta.get("launch_epoch") == epoch
                and v.state == TaskState.RUNNING]

    def _preempt_sim_for(self, t: Task) -> bool:
        """Free enough sim capacity for ``t`` by eviction; True when
        ``t`` fits afterwards (possibly without evicting anything)."""
        need = t.slots - (self.rt.slots - self._busy)
        if need <= 0:
            return True
        victims = self._preempt_victims(t, need, self._sim_running_tasks())
        if victims is None:
            return False
        for v in victims:
            self._preempt_sim(v)
        return True

    def _preempt_sim(self, v: Task):
        """Evict one running sim attempt (mirror of :meth:`_abandon_sim`
        minus the failure semantics)."""
        rt, prof = self._rt_for(v), self.prof
        v.meta["launch_epoch"] = None
        self._vacate(v)
        rt._release_slots(v)
        v.record_attempt("preempted", pod=rt._task_pod(v))
        prof.n_preempted += 1
        rt.journal.record(v, "preempted", pod=rt._task_pod(v))
        if self.tracer is not None:
            self.tracer.task_end(v, self.vnow, "preempted")
        v.meta.pop("slot_ids", None)
        v.meta.pop("slots_released", None)
        v.error = None
        v.state = TaskState.NEW        # always requeues: not a failure

    def _preempt_pass_sim(self):
        """Launch ready high-priority tasks, evicting for the ones that
        do not fit; runs before the normal scheduling pass so a latency
        task never waits behind a full pilot of throughput work."""
        graph = self.graph
        while True:
            t = graph.pop_ready()      # priority order: head is hottest
            if t is None:
                return
            if not self._preempt_enabled(t):
                graph.requeue(t)
                return
            if self._preempt_sim_for(t):
                self._launch_sim(t)
                continue
            graph.requeue(t)           # nothing evictable: wait in line
            return

    def _drain_sim(self):
        rt, graph, prof = self.rt, self.graph, self.prof
        # hoisted: one bound method, not two attribute hops per event
        _sample = (self.tracer.metrics.maybe_sample
                   if self.tracer is not None else None)
        _sampled_at = None
        while True:
            self._flush_callbacks()
            if _sample is not None and self.vnow != _sampled_at:
                _sampled_at = self.vnow
                _sample(_sampled_at)
            self._housekeeping_sim()
            self._overhead(self._schedule_sim)

            # fault events due before the next completion preempt it: a
            # pod death invalidates in-flight attempts, so their
            # completions must not be delivered first.  With an empty
            # heap, kills already due fire in place, and a pending
            # replacement pod advances the clock to its arrival (tasks
            # starved by the shrink wait for it instead of canceling).
            faults = self._fault_source()
            if faults is not None:
                nf = faults.next_time()
                if nf is not None and (
                        (self._heap and nf <= self._heap[0][0])
                        or (not self._heap
                            and (nf <= self.vnow
                                 or (faults.pending_revive()
                                     and not graph.done())))):
                    self.vnow = max(self.vnow, nf)
                    self._overhead(self._apply_faults_sim)
                    continue

            if not self._heap:
                if graph.done():
                    break
                # nothing runnable: cancel only truly unsatisfiable tasks
                # (failed/canceled upstream, or wider than the whole pilot)
                # so a narrow task queued behind a too-wide one still runs
                # on the next pass — same rule as real mode.  A pending
                # pod respawn defers the too-wide rule: capacity returns.
                reviving = faults is not None and faults.pending_revive()
                canceled = False
                for t in graph.tasks.values():
                    if t.state == TaskState.NEW and (
                            (self._too_wide_sim(t) and not reviving) or any(
                                graph.tasks[d].state.terminal
                                and graph.tasks[d].state != TaskState.DONE
                                for d in t.deps)):
                        tr = self._rt_for(t)
                        t.state = TaskState.CANCELED
                        tr.journal.record(t, "canceled")
                        tr._staging_finish(t)
                        self._queue_callback(t)
                        canceled = True
                if not canceled and not reviving:
                    # termination guard (unreachable by construction: a
                    # stuck NEW task always matches one rule above)
                    for t in graph.tasks.values():
                        if t.state == TaskState.NEW:
                            tr = self._rt_for(t)
                            t.state = TaskState.CANCELED
                            tr.journal.record(t, "canceled")
                            tr._staging_finish(t)
                            self._queue_callback(t)
                self._flush_callbacks()
                if graph.done():
                    break
                continue

            vfin, _, epoch, t = heapq.heappop(self._heap)
            if t.meta.get("launch_epoch") != epoch:
                # abandoned attempt (pod loss) or superseded original:
                # capacity and slots were settled at abandonment — the
                # entry is a zombie
                continue
            if t.state.terminal:
                # canceled twin: slot returns here; do NOT advance the
                # clock to its stale finish time
                if not t.meta.get("slot_freed"):
                    self._vacate(t)
                self._rt_for(t)._release_slots(t)
                continue
            self.vnow = max(self.vnow, vfin)
            self._vacate(t)
            self._rt_for(t)._release_slots(t)
            self._overhead(lambda: self._finish_sim(t))

            # straggler speculation: clone still-running outliers
            if rt.straggler_factor:
                self._overhead(self._speculate_sim)

    def _speculate_sim(self):
        rt, prof = self.rt, self.prof
        for vfin, sq, epoch, t in list(self._heap):
            if t.meta.get("launch_epoch") != epoch:
                continue
            rt = self._rt_for(t)
            hist = self._durations.get(t.stage, [])
            if (t.idempotent and not t.state.terminal
                    and t.speculative_of is None
                    and t.name not in self._spec_launched
                    and rt.slots - self._busy >= t.slots
                    and len(hist) >= rt.min_straggler_samples):
                med = statistics.median(hist)
                # the monitor fires when elapsed > factor * median; in DES
                # that trigger time is known, so schedule the duplicate to
                # start exactly then (if the original would still be running)
                trigger = t.v_started + rt.straggler_factor * med
                if trigger < vfin:
                    dup = Task(name=t.name + f".spec{t.attempts}",
                               duration=med, slots=t.slots, stage=t.stage,
                               instance=t.instance, iteration=t.iteration,
                               speculative_of=t.name)
                    dup.state = TaskState.RUNNING
                    dup.v_started = max(self.vnow, trigger)
                    dup.attempts = 1
                    dup.meta["launch_epoch"] = 1
                    if "pilot" in t.meta:      # clone runs on the same pilot
                        dup.meta["pilot"] = t.meta["pilot"]
                    prof.n_speculative += 1
                    self._occupy(dup)
                    # the clone reads the SAME staged inputs as the
                    # original: share the manifest (extra holds on the
                    # same blobs) so its transfers plan and charge t_data
                    # exactly like the original's
                    if rt.staging is not None:
                        rt.staging.clone_manifest(t, dup)
                    rt._acquire_slots(dup)
                    t_data = rt._stage_in_task(dup)
                    dup.meta["t_data_attempt"] = t_data
                    heapq.heappush(
                        self._heap,
                        (dup.v_started + med + t_data,
                         self._seq, dup.attempts, dup))
                    self._seq += 1
                    extra = self._sched_extra(dup)
                    if t_data:
                        extra["t_data"] = t_data
                    pod = rt._task_pod(dup)
                    rt.journal.record(dup, "scheduled", speculative=True,
                                      pod=pod, **extra)
                    if self.tracer is not None:
                        self.tracer.task_begin(dup, dup.v_started,
                                               pod=pod, t_data=t_data)
                    self._spec_launched[t.name] = dup

    # ------------------------------------------------------------ real mode
    def _check_faults_real(self):
        """Real-mode failure scan, run each pass of the drain loop: fire
        due injector events (elapsed wall clock), then detect dead worker
        threads — a thread that exited without running its completion
        bookkeeping (e.g. SystemExit through the isolation boundary) —
        and, with a detector configured, stale heartbeats."""
        now = time.perf_counter()
        elapsed = now - self._t0
        faults = self._fault_source()
        if faults is not None:
            for kind, pod in faults.pop_due(elapsed):
                if kind == REVIVE:
                    self._credit_free_n(self._rt_for_pod(pod),
                                        self._revive_pod(pod))
                else:
                    victim = pod if pod is not None else self._pick_victim()
                    if victim is not None and victim \
                            not in self._rt_for_pod(victim).dead_pods:
                        self._kill_pod_real(victim, elapsed)
        for (name, epoch), (th, t) in list(self._live_attempts.items()):
            if t.meta.get("launch_epoch") != epoch \
                    or t.state != TaskState.RUNNING:
                continue
            tr = self._rt_for(t)
            if not th.is_alive():
                self._abandon_real(t, tr._task_pod(t), "worker_died",
                                   credit_slots=True)
            elif tr.detector is not None and tr.detector.stale(t, now):
                self._abandon_real(t, tr._task_pod(t), "heartbeat_timeout",
                                   credit_slots=True)

    def _kill_pod_real(self, pod: str, elapsed: float):
        rt, prof = self._rt_for_pod(pod), self.prof
        ids = rt._pod_ids(pod)
        if not ids:
            return
        idset = set(ids)
        rt._retire_ids(ids, pod)
        abandoned_w = 0
        for (name, epoch), (th, t) in list(self._live_attempts.items()):
            if t.meta.get("launch_epoch") == epoch \
                    and self._rt_for(t) is rt \
                    and idset.intersection(t.meta.get("slot_ids", ())):
                abandoned_w += t.slots
                self._abandon_real(t, pod, "pod_lost", credit_slots=False)
        rt.slots = max(rt.slots - len(ids), 0)
        # the pod's free slots leave capacity; abandoned widths return
        # (their surviving ids re-entered the id pool at release)
        self._credit_free_n(rt, abandoned_w - len(ids))
        if rt.staging is not None:
            rt.staging.on_pod_lost(pod)
        rt.journal.record_event("pod_lost", pod=pod, n_slots=len(ids))
        if self.tracer is not None:
            self.tracer.instant("pod", f"pod_lost:{pod}", elapsed,
                                pod=pod, n_slots=len(ids))
        prof.events.append({"event": "pod_lost", "pod": pod,
                            "n_slots": len(ids), "elapsed": elapsed})
        if rt.faults is not None and rt.faults.respawn_after is not None:
            rt.faults.schedule_revive(pod, elapsed)
        elif rt.topology is not None:
            rt._drop_pending = True

    def _abandon_real(self, t: Task, pod: Optional[str], reason: str, *,
                      credit_slots: bool):
        """Fail one in-flight real attempt (pod kill, dead worker thread,
        stale heartbeat).  The worker thread cannot be stopped; popping
        the live-attempt entry turns its eventual completion into a
        zombie that skips all bookkeeping."""
        rt, prof = self._rt_for(t), self.prof
        entry = self._live_attempts.pop((t.name, t.meta.get("launch_epoch")),
                                        None)
        if entry is not None:
            self._zombie_threads.add(entry[0])
        t.meta["launch_epoch"] = None
        self._inflight -= 1
        if credit_slots:
            self._credit_free(t)
        rt._release_slots(t)
        err = f"{reason}" + (f": pod {pod}" if pod else "")
        t.record_attempt(reason, pod=pod, error=err)
        t.error = err
        prof.n_pod_lost += 1
        rt.journal.record(t, reason, pod=pod)
        if self.tracer is not None:
            self.tracer.task_end(t, self._now(), reason)
        t.meta.pop("slot_ids", None)
        t.meta.pop("slots_released", None)
        if t.attempts <= rt.max_retries:
            t.state = TaskState.NEW
            prof.n_retries += 1
        else:
            t.state = TaskState.FAILED
            rt.journal.record(t, "failed", pod=pod)
            prof.t_data += t.t_data
            rt._staging_finish(t)
            self._queue_callback(t)

    def _preempt_real_for(self, t: Task) -> bool:
        """Real-mode eviction on behalf of ready ``t`` (caller holds the
        session cv).  The victim's worker thread cannot be stopped:
        popping its live-attempt entry turns the eventual completion into
        a zombie, exactly as the failure paths do."""
        need = t.slots - self._free["n"]
        if need <= 0:
            return True
        running = [v for (_, epoch), (_th, v) in self._live_attempts.items()
                   if v.meta.get("launch_epoch") == epoch
                   and v.state == TaskState.RUNNING]
        victims = self._preempt_victims(t, need, running)
        if victims is None:
            return False
        for v in victims:
            self._preempt_real(v)
        return True

    def _preempt_real(self, v: Task):
        """Evict one running real attempt (mirror of :meth:`_abandon_real`
        minus the failure semantics)."""
        rt, prof = self._rt_for(v), self.prof
        entry = self._live_attempts.pop((v.name, v.meta.get("launch_epoch")),
                                        None)
        if entry is not None:
            self._zombie_threads.add(entry[0])
        v.meta["launch_epoch"] = None
        self._inflight -= 1
        self._credit_free(v)
        rt._release_slots(v)
        v.record_attempt("preempted", pod=rt._task_pod(v))
        prof.n_preempted += 1
        rt.journal.record(v, "preempted", pod=rt._task_pod(v))
        if self.tracer is not None:
            self.tracer.task_end(v, self._now(), "preempted")
        v.meta.pop("slot_ids", None)
        v.meta.pop("slots_released", None)
        v.error = None
        v.state = TaskState.NEW        # always requeues: not a failure

    def _execute_real(self, t: Task):
        rt, prof, cv = self._rt_for(t), self.prof, self._cv
        epoch = t.meta.get("launch_epoch")
        t.t_started = time.perf_counter()
        outcome = TaskState.DONE
        t.meta.pop("t_data_kernel", None)     # fresh window per attempt
        if rt.detector is not None:
            rt.detector.beat(t)
        res = None
        try:
            # staged-input transfers: between pop_ready and kernel launch,
            # on the worker (transfers overlap across tasks); the restamp
            # keeps t_exec and t_data disjoint in the TTC decomposition
            t.meta["t_data_attempt"] = rt._stage_in_task(t)
            t.t_started = time.perf_counter()
            if t.run is not None:
                # held locally until past the zombie check below: an
                # abandoned attempt's late return must not clobber the
                # retry's result
                res = t.run(t)
            elif t.duration:
                time.sleep(t.duration)
        except Exception as e:  # noqa: BLE001 - task isolation boundary
            t.error = f"{type(e).__name__}: {e}\n" \
                      + traceback.format_exc()[-1500:]
            outcome = (TaskState.NEW if t.attempts <= rt.max_retries
                       else TaskState.FAILED)
        t.t_finished = time.perf_counter()
        with cv:
            # the state transition happens INSIDE the lock: flipping a
            # retry to NEW any earlier lets the drain thread reschedule it
            # (and re-grant slot ids) before this attempt's bookkeeping
            # releases the old ones
            if self._live_attempts.pop((t.name, epoch), None) is None:
                # abandoned while running (pod kill / stale heartbeat):
                # the abandonment already settled slots, capacity and
                # history — this completion is a zombie
                cv.notify_all()
                return
            pod = rt._task_pod(t)
            if t.run is not None and outcome == TaskState.DONE:
                t.result = res
            self._credit_free(t)
            rt._release_slots(t)
            # in-kernel lazy derefs (ctx["staging"].get) charged to t_data
            # come OUT of the exec window — the decomposition terms must
            # not overlap
            span = max(t.t_finished - t.t_started
                       - t.meta.get("t_data_kernel", 0.0), 0.0)
            prof.t_exec += span
            prof.slot_busy += span * t.slots
            t.record_attempt("done" if outcome == TaskState.DONE
                             else "failed", pod=pod, error=t.error)
            t.state = outcome
            if outcome == TaskState.NEW:
                prof.n_retries += 1
                t.meta.pop("slot_ids", None)
                t.meta.pop("slots_released", None)
            # wall/t_exec/t_data_kernel feed the sanitizer's S306 check:
            # in-kernel deref seconds must come OUT of the exec window
            rt.journal.record(
                t, "finished" if t.state == TaskState.DONE else "failed",
                pod=pod, t_exec=span,
                t_data=t.meta.get("t_data_attempt", 0.0),
                t_data_kernel=t.meta.get("t_data_kernel", 0.0),
                wall=max(t.t_finished - t.t_started, 0.0))
            if self.tracer is not None:
                self.tracer.task_end(
                    t, self._now(),
                    "done" if t.state == TaskState.DONE else "failed")
            if t.state.terminal:
                # cumulative across attempts, charged once at the end
                prof.t_data += t.t_data
                rt._staging_finish(t)
                self._queue_callback(t)
            self._inflight -= 1
            cv.notify_all()

    def _drain_real(self):
        # thread-per-task: slot gating already bounds concurrency, and a
        # fixed pool would cap an elastic grow mid-run
        workers: List[threading.Thread] = []
        try:
            self._drain_real_loop(workers)
        finally:
            # join even when a user on_done callback raised, so no worker
            # is left mutating the profile/journal after drain() returns.
            # Abandoned (zombie) threads may be stuck in a hung kernel:
            # they get a bounded join — their completion path is inert
            # (the live-attempt pop already failed), so leaking the
            # daemon thread is safe
            for th in workers:
                if th in self._zombie_threads:
                    th.join(timeout=0.2)
                else:
                    th.join()

    def _launch_real(self, t: Task, workers: List[threading.Thread]):
        """Start one real-mode attempt (capacity already reserved via
        :meth:`_can_launch_real`)."""
        rt, graph = self._rt_for(t), self.graph
        self._debit_free(t)
        rt._acquire_slots(t)
        t.meta["dep_results"] = {
            d: graph.tasks[d].result for d in t.deps}
        t.attempts += 1
        t.error = None         # no stale error into a retry
        t.state = TaskState.RUNNING
        t.t_scheduled = time.perf_counter()
        t.meta["launch_epoch"] = t.attempts
        pod = rt._task_pod(t)
        rt.journal.record(t, "scheduled", pod=pod, **self._sched_extra(t))
        if self.tracer is not None:
            self.tracer.task_begin(t, self._now(), pod=pod)
        self._inflight += 1
        th = threading.Thread(target=self._execute_real,
                              args=(t,), daemon=True)
        self._live_attempts[(t.name, t.attempts)] = (th, t)
        workers.append(th)
        th.start()

    def _drain_real_loop(self, workers: List[threading.Thread]):
        rt, graph, prof = self.rt, self.graph, self.prof
        cv = self._cv
        _sample = (self.tracer.metrics.maybe_sample
                   if self.tracer is not None else None)
        with cv:
            while True:
                self._flush_callbacks()
                if _sample is not None:
                    _sample(self._now())
                self._housekeeping_real()
                self._check_faults_real()
                t0 = time.perf_counter()
                # pop from the incremental frontier, re-checking capacity
                # per task; too-wide tasks are skipped (narrower ones behind
                # them may fit) and requeued after the pass.  The min-width
                # check ends the pass as soon as NOTHING left can fit —
                # without it a nearly-full pilot would drain the whole
                # frontier into `skipped` on every wakeup (O(n) per event)
                scheduled, skipped = [], []
                cands = None
                if rt.staging is not None:
                    # locality-ordered pass: input-local tasks claim free
                    # pods before tasks that would have to copy (too-wide
                    # candidates are skipped, as in the default pass)
                    cands = self._locality_candidates(self._free["n"])
                    cands.reverse()        # consumed via pop() below
                while True:
                    if cands is not None:
                        t = cands.pop() if cands else None
                    else:
                        min_w = graph.frontier_min_width()
                        if min_w is None or min_w > self._free["n"]:
                            t = None
                        else:
                            t = graph.pop_ready()
                    if t is None and getattr(rt, "preempt", False):
                        # the width/locality early-exit must not hide a
                        # ready high-priority task wider than the free
                        # slots — that is exactly the case eviction
                        # (PilotRuntime(preempt=True)) exists for
                        t = graph.pop_ready()
                        if t is not None and not self._preempt_enabled(t):
                            graph.requeue(t)
                            t = None
                    if t is None:
                        break
                    if not self._can_launch_real(t):
                        if self._preempt_enabled(t) \
                                and self._preempt_real_for(t) \
                                and self._can_launch_real(t):
                            scheduled.append(t)
                            self._launch_real(t, workers)
                            continue
                        skipped.append(t)
                        continue
                    scheduled.append(t)
                    self._launch_real(t, workers)
                for t in skipped:
                    graph.requeue(t)
                prof.t_rts_overhead += time.perf_counter() - t0
                quiescent = not self._inflight and not self._cbq
                if graph.done() and quiescent:
                    break
                if not scheduled and quiescent:
                    # nothing runnable: cancel unsatisfiable tasks — failed
                    # upstream deps, or wider than the whole idle pilot
                    # (nothing in flight, so free == capacity: such a task
                    # can never start and would spin this loop forever).
                    # A pending pod respawn defers the too-wide rule:
                    # the capacity is coming back.
                    faults = self._fault_source()
                    reviving = (faults is not None
                                and faults.pending_revive())
                    for t in graph.tasks.values():
                        if t.state != TaskState.NEW:
                            continue
                        if (self._too_wide_real(t) and not reviving) \
                                or any(
                                graph.tasks[d].state.terminal
                                and graph.tasks[d].state != TaskState.DONE
                                for d in t.deps):
                            tr = self._rt_for(t)
                            t.state = TaskState.CANCELED
                            tr.journal.record(t, "canceled")
                            tr._staging_finish(t)
                            self._queue_callback(t)
                    if graph.done() and not self._cbq:
                        break
                    # retried tasks (back to NEW) reschedule next pass
                if not self._cbq:
                    cv.wait(timeout=0.05)

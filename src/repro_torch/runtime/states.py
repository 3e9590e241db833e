"""Task model: states, tasks, task graphs (the IR all patterns compile to).

The TaskGraph maintains its ready frontier *incrementally*: every task keeps
a count of unmet (not-DONE) dependencies and the graph keeps a min-heap of
ready task names keyed by (-priority, tid): higher-priority tasks (e.g. the
serving ``latency`` SLA class) pop before lower ones, FIFO within a
priority level.  State transitions are observed through the
``Task.state`` descriptor, so any ``t.state = ...`` write — scheduler,
journal replay, speculative supersession — updates the frontier in O(log f)
(f = frontier size) instead of the per-event full scan the seed used, which
made a long session O(n²) in completion events.  ``ready()`` survives as a
snapshot API; schedulers should use ``pop_ready()``/``requeue()``.
"""
from __future__ import annotations

import enum
import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class TaskState(str, enum.Enum):
    NEW = "NEW"
    SCHEDULED = "SCHEDULED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"

    @property
    def terminal(self) -> bool:
        return self in (TaskState.DONE, TaskState.FAILED, TaskState.CANCELED)


_tid_counter = itertools.count()


@dataclass
class Task:
    """One executable unit (the paper's task, produced from a kernel plugin).

    ``duration``: simulated execution seconds (DES mode); ``run``: callable
    executed in real mode.  ``slots``: resource width (paper's "cores").
    """
    name: str
    run: Optional[Callable[["Task"], Any]] = None
    duration: float = 0.0
    slots: int = 1
    deps: List[str] = field(default_factory=list)
    stage: str = ""
    instance: int = 0
    iteration: int = 0
    idempotent: bool = True       # eligible for speculative re-execution
    # frontier ordering: higher pops first; ties break on tid (FIFO).
    # Serving SLA classes map onto this (latency > throughput), and the
    # executor may preempt a running lower-priority task for a ready
    # higher-priority one (see PilotRuntime(preempt=True)).
    priority: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    tid: str = field(default_factory=lambda: f"t{next(_tid_counter):06d}")
    state: TaskState = TaskState.NEW
    attempts: int = 0
    # execution history: one JSON-able record per finished attempt
    # ({"attempt", "pod", "slot_ids", "outcome", "error"}) — the scitq
    # Execution-table analogue.  Drives bounded retries that EXCLUDE the
    # failing pod from the re-grant, and survives restarts via the journal.
    history: List[Dict[str, Any]] = field(default_factory=list)
    # seconds spent moving this task's data (staged-ref transfers executed
    # between pop_ready and launch, plus in-kernel lazy derefs) — the
    # per-task slice of the paper's t_data term
    t_data: float = 0.0
    result: Any = None
    error: Optional[str] = None
    # timestamps (real clock for overheads; virtual clock for sim TTC)
    t_created: float = field(default_factory=time.perf_counter)
    t_scheduled: float = 0.0
    t_started: float = 0.0
    t_finished: float = 0.0
    v_started: float = 0.0
    v_finished: float = 0.0
    speculative_of: Optional[str] = None

    # ------------------------------------------------------------ attempts
    def record_attempt(self, outcome: str, *, pod: Optional[str] = None,
                       error: Optional[str] = None) -> Dict[str, Any]:
        """Append one attempt record to :attr:`history` (outcome in
        done|failed|pod_lost|worker_died|heartbeat_timeout|superseded|
        canceled|preempted)."""
        rec = {"attempt": self.attempts, "pod": pod,
               "slot_ids": list(self.meta.get("slot_ids", ())),
               "outcome": outcome}
        if error:
            rec["error"] = error
        self.history.append(rec)
        return rec

    def excluded_pods(self) -> set:
        """Pods a retry must avoid: every pod a FAILED attempt ran on
        (the retry-remembering model — availability still wins: the
        scheduler falls back to an excluded pod when nothing else is
        free)."""
        from repro_torch.runtime.faults import FAILED_OUTCOMES
        return {h["pod"] for h in self.history
                if h.get("pod") and h["outcome"] in FAILED_OUTCOMES}

    def beat(self):
        """Heartbeat hook for long-running kernels (real mode): refreshes
        the liveness timestamp the failure detector checks."""
        self.meta["heartbeat"] = time.perf_counter()


def _task_state_get(self: Task) -> TaskState:
    return self.__dict__["_state"]


def _task_state_set(self: Task, new: TaskState):
    old = self.__dict__.get("_state")
    self.__dict__["_state"] = new
    graph = self.__dict__.get("_graph")
    if graph is not None and old is not new:
        graph._on_state(self, old, new)


# ``state`` stays a dataclass field (default/repr/eq all intact) but reads
# and writes go through a property attached after class creation: once a
# task is add()ed to a TaskGraph, EVERY state write notifies the graph so
# the frontier and terminal count stay incremental — no call-site refactor,
# no way to bypass the bookkeeping.
Task.state = property(_task_state_get, _task_state_set)


@dataclass
class TaskGraph:
    tasks: Dict[str, Task] = field(default_factory=dict)

    def __post_init__(self):
        self._unmet: Dict[str, int] = {}       # name -> deps not yet DONE
        self._waiters: Dict[str, List[str]] = {}   # dep name -> dependents
        self._in_frontier: set = set()
        self._heap: List = []    # (-priority, tid, name), lazily pruned
        self._width_counts: Dict[int, int] = {}    # slots -> frontier count
        self._n_terminal = 0
        # optional zero-arg run clock (a sim RuntimeSession sets it to its
        # virtual now): frontier entry stamps task.meta["v_ready"], the
        # ready-timestamp the t_sched term of the TTC decomposition needs
        self.clock: Optional[Callable[[], float]] = None
        for t in list(self.tasks.values()):    # pre-populated dict support
            self._index(t)

    def add(self, task: Task) -> Task:
        if task.name in self.tasks:
            raise ValueError(f"duplicate task {task.name}")
        self.tasks[task.name] = task
        self._index(task)
        return task

    def _index(self, task: Task):
        task.__dict__["_graph"] = self
        unmet = 0
        for d in task.deps:
            dep = self.tasks.get(d)
            if dep is None or dep.state != TaskState.DONE:
                unmet += 1
                self._waiters.setdefault(d, []).append(task.name)
        self._unmet[task.name] = unmet
        if task.state == TaskState.NEW:
            if unmet == 0:
                self._frontier_add(task)
        elif task.state.terminal:
            self._n_terminal += 1
            if task.state == TaskState.DONE:
                self._satisfy_waiters(task)

    def __len__(self):
        return len(self.tasks)

    # ------------------------------------------------------------ frontier
    def _frontier_add(self, task: Task):
        if task.name not in self._in_frontier:
            self._in_frontier.add(task.name)
            heapq.heappush(self._heap,
                           (-task.priority, task.tid, task.name))
            w = task.slots
            self._width_counts[w] = self._width_counts.get(w, 0) + 1
            if self.clock is not None:
                # setdefault: a pop_ready/requeue round-trip keeps the
                # ORIGINAL ready time; a retry (launch popped the key)
                # stamps afresh
                task.meta.setdefault("v_ready", self.clock())

    def _frontier_discard(self, task: Task):
        if task.name in self._in_frontier:
            self._in_frontier.discard(task.name)
            w = task.slots
            left = self._width_counts.get(w, 0) - 1
            if left:
                self._width_counts[w] = left
            else:
                self._width_counts.pop(w, None)

    def frontier_min_width(self) -> Optional[int]:
        """Narrowest slot width in the frontier (None when empty).  Lets a
        scheduler skip a pass outright when nothing can fit the free
        capacity, instead of scanning wide tasks (#widths is tiny)."""
        return min(self._width_counts) if self._width_counts else None

    def frontier_slots(self) -> int:
        """Total slot width queued in the frontier (O(#distinct widths)) —
        the backlog signal backlog-driven recruiting keys on."""
        return sum(w * c for w, c in self._width_counts.items())

    def _satisfy_waiters(self, task: Task):
        for wname in self._waiters.pop(task.name, ()):
            left = self._unmet.get(wname)
            if left is None:
                continue
            self._unmet[wname] = left - 1
            w = self.tasks.get(wname)
            if left == 1 and w is not None and w.state == TaskState.NEW:
                self._frontier_add(w)

    def _on_state(self, task: Task, old: Optional[TaskState],
                  new: TaskState):
        """Observer for every in-graph ``task.state`` write."""
        was_terminal = old is not None and old.terminal
        if new.terminal and not was_terminal:
            self._n_terminal += 1
        elif was_terminal and not new.terminal:
            self._n_terminal -= 1
        if new == TaskState.NEW:               # retry re-enters the frontier
            if self._unmet.get(task.name, 0) == 0:
                self._frontier_add(task)
        else:
            self._frontier_discard(task)
        if new == TaskState.DONE and old != TaskState.DONE:
            self._satisfy_waiters(task)

    def pop_ready(self) -> Optional[Task]:
        """Highest-priority ready task (ties: lowest tid), removed from the
        frontier (the caller either schedules it or gives it back via
        :meth:`requeue`)."""
        while self._heap:
            name = self._heap[0][2]
            if name not in self._in_frontier:   # stale entry: lazily prune
                heapq.heappop(self._heap)
                continue
            heapq.heappop(self._heap)
            t = self.tasks[name]
            self._frontier_discard(t)
            return t
        return None

    def requeue(self, task: Task):
        """Return a popped-but-unscheduled task to the frontier."""
        if task.state == TaskState.NEW and \
                self._unmet.get(task.name, 0) == 0:
            self._frontier_add(task)

    def validate(self):
        for t in self.tasks.values():
            for d in t.deps:
                if d not in self.tasks:
                    raise ValueError(f"{t.name}: unknown dep {d}")
        # cycle check (Kahn)
        indeg = {n: len(t.deps) for n, t in self.tasks.items()}
        out: Dict[str, List[str]] = {n: [] for n in self.tasks}
        for n, t in self.tasks.items():
            for d in t.deps:
                out[d].append(n)
        q = [n for n, k in indeg.items() if k == 0]
        seen = 0
        while q:
            n = q.pop()
            seen += 1
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    q.append(m)
        if seen != len(self.tasks):
            raise ValueError("task graph has a cycle")

    def ready(self) -> List[Task]:
        """Snapshot of the frontier in pop order — priority desc, then tid
        (O(f log f), f = frontier size — NOT O(n); kept for
        inspection/back-compat)."""
        return sorted((self.tasks[n] for n in self._in_frontier),
                      key=lambda t: (-t.priority, t.tid))

    def done(self) -> bool:
        return self._n_terminal == len(self.tasks)

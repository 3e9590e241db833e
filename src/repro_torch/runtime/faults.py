"""Failure model for the pilot runtime: pod death as a NORMAL event.

The paper's pilot decouples workload from resource management; production
fleets lose pods constantly, and the follow-on EnTK work ("Harnessing the
Power of Many") makes ensemble-layer fault tolerance a first-class
requirement.  scitq's ``Execution``/``WorkerPing`` design is the exemplar
shape: every attempt is a remembered row carrying the worker it ran on, a
ping monitor declares silent workers offline, and retries are re-placed
AWAY from the worker that failed.  This module is that shape for our slots:

  FaultInjector     deterministic pod-kill schedule (chaos testing).  Time
                    is "seconds since run start" — the VIRTUAL clock in DES
                    mode, wall-clock elapsed in real mode — so the same
                    injector drives both.  Kills either name a pod or leave
                    the victim to the scheduler (which picks the busiest
                    live pod, deterministically).  ``respawn_after``
                    models a replacement pod joining the fleet: the dead
                    pod's slot ids return, with NO data replicas (a fresh
                    pod remembers nothing).

  FailureDetector   heartbeat bookkeeping for real mode.  Worker-thread
                    death (the thread exits without running its completion
                    bookkeeping — e.g. a ``SystemExit`` escaping the task
                    isolation boundary) is detected structurally by the
                    drain loop; the detector adds the *hung* case: a task
                    whose heartbeat goes stale past ``heartbeat_timeout``
                    is declared lost even though its thread is alive, and
                    its eventual completion is ignored (launch epochs).

The executor turns a pod death into: fail the in-flight attempts on that
pod (recorded in ``Task.history`` with the pod), retire the pod's slot
ids (capacity shrinks; with a device topology the shrink re-carves at the
next quiescent point), drop the pod's staged-data replicas, and re-grant
retries EXCLUDING the failing pod.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import List, Optional, Sequence, Tuple

KILL = "kill"
REVIVE = "revive"

# attempt outcomes that mark the pod as failing for retry exclusion
FAILED_OUTCOMES = ("failed", "pod_lost", "worker_died", "heartbeat_timeout")


class FaultInjector:
    """Deterministic schedule of pod failures (and respawns).

    ``kill_every``: periodic kills starting at ``first_kill`` (defaults to
    one period in).  ``kill_at``: explicit ``(time, pod)`` pairs (pod may
    be None — the scheduler picks the victim).  ``max_kills`` bounds the
    periodic stream.  ``respawn_after``: seconds after each kill at which
    a replacement pod (same slot ids, no replicas) joins the fleet.
    """

    def __init__(self, *, kill_every: Optional[float] = None,
                 first_kill: Optional[float] = None,
                 kill_at: Sequence[Tuple[float, Optional[str]]] = (),
                 pods: Optional[Sequence[str]] = None,
                 max_kills: Optional[int] = None,
                 respawn_after: Optional[float] = None):
        if kill_every is not None and kill_every <= 0:
            raise ValueError("kill_every must be positive")
        self.kill_every = kill_every
        self.respawn_after = respawn_after
        self.max_kills = max_kills
        self._pods = list(pods) if pods else []
        self._pod_i = 0
        self._seq = itertools.count()
        # (time, seq, kind, pod) — seq breaks ties deterministically
        self._events: List[Tuple[float, int, str, Optional[str]]] = []
        for t, pod in kill_at:
            heapq.heappush(self._events,
                           (float(t), next(self._seq), KILL, pod))
        self._next_periodic = (first_kill if first_kill is not None
                               else kill_every)
        self.n_kills = 0          # kills actually fired (periodic + explicit)

    # ------------------------------------------------------------ schedule
    def kill_now(self, pod: Optional[str] = None):
        """Inject an immediate kill (fires at the next scheduling step)."""
        heapq.heappush(self._events, (0.0, next(self._seq), KILL, pod))

    def schedule_revive(self, pod: str, now: float):
        if self.respawn_after is not None:
            heapq.heappush(self._events,
                           (now + self.respawn_after, next(self._seq),
                            REVIVE, pod))

    # ------------------------------------------------------------ queries
    def _periodic_live(self) -> bool:
        return (self.kill_every is not None
                and (self.max_kills is None
                     or self.n_kills < self.max_kills))

    def next_time(self) -> Optional[float]:
        """Earliest pending event time (None when nothing is scheduled)."""
        times = []
        if self._events:
            times.append(self._events[0][0])
        if self._periodic_live():
            times.append(self._next_periodic)
        return min(times) if times else None

    def pending_revive(self) -> bool:
        """True when a replacement pod is scheduled to join (the scheduler
        must keep waiting rather than cancel capacity-starved tasks)."""
        return any(kind == REVIVE for _, _, kind, _ in self._events)

    # ------------------------------------------------------------ firing
    def _next_pod_hint(self) -> Optional[str]:
        if not self._pods:
            return None
        pod = self._pods[self._pod_i % len(self._pods)]
        self._pod_i += 1
        return pod

    def pop_due(self, now: float) -> List[Tuple[str, Optional[str]]]:
        """Events due at or before ``now``, in time order, consuming them.
        Returns ``(kind, pod)`` pairs; a kill's pod may be None (caller
        picks the victim)."""
        out: List[Tuple[str, Optional[str]]] = []
        while True:
            t_ev = self._events[0][0] if self._events else None
            t_per = (self._next_periodic if self._periodic_live()
                     else None)
            if t_per is not None and (t_ev is None or t_per <= t_ev):
                if t_per > now:
                    break
                self._next_periodic = t_per + self.kill_every
                self.n_kills += 1
                out.append((KILL, self._next_pod_hint()))
                continue
            if t_ev is None or t_ev > now:
                break
            _, _, kind, pod = heapq.heappop(self._events)
            if kind == KILL:
                self.n_kills += 1
            out.append((kind, pod))
        return out


class FailureDetector:
    """Heartbeat staleness policy (real mode).

    Workers beat at attempt start (and kernels may beat via
    ``Task.beat()`` during long executions); ``stale`` declares an
    attempt lost when its last beat is older than ``heartbeat_timeout``.
    ``None`` disables staleness checks — worker-thread *death* is always
    detected regardless (it needs no timeout)."""

    def __init__(self, heartbeat_timeout: Optional[float] = None):
        self.heartbeat_timeout = heartbeat_timeout

    def beat(self, task, now: Optional[float] = None):
        task.meta["heartbeat"] = (now if now is not None
                                  else time.perf_counter())

    def stale(self, task, now: float) -> bool:
        if self.heartbeat_timeout is None:
            return False
        last = task.meta.get("heartbeat") or task.t_started
        return (now - last) > self.heartbeat_timeout

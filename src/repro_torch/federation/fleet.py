"""Fleet: N heterogeneous pilots behind one runtime-shaped facade.

A :class:`Fleet` owns an ordered set of named :class:`PilotRuntime`\\ s —
different slot counts, different meshes, each with its OWN journal — and
duck-types the exact surface ``AppManager`` (repro_torch.core.pst) and
``RuntimeSession`` speak: ``mode``, ``slots``, ``journal``, ``staging``,
``topology``, ``session()``, ``live_pods()``, ``max_retries``, ``close()``.
Existing PST applications run federated by constructing their manager with
a Fleet instead of a PilotRuntime — no API change.

Namespacing invariant: every pilot's pods are prefixed with its name
(``p1:pod0``), either through its staging ``LocalityMap(prefix=...)`` or
through ``PilotRuntime._pod_prefix``.  Replica locations, retry
exclusions, fault injection and journal records all key on pod names, so
the prefix is the ONLY plumbing federation needs — everything downstream
already treats pods as opaque strings.

Staged pilots must share one :class:`ObjectStore`/:class:`TransferPlanner`
(enforced at construction): that is what makes a pilot-to-pilot blob fetch
a planner ``copy`` at ``cross_gbps`` instead of a round-trip through the
manager, and what lets the dispatcher see where every replica lives.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, Iterable, List, Optional, Union

from repro_torch.runtime.executor import PilotRuntime, RuntimeProfile
from repro_torch.runtime.journal import Journal, journal_from_env
from repro_torch.runtime.states import TaskGraph
from repro_torch.staging.transfer import LocalityMap, pilot_of


class FleetStagingView:
    """AppManager-facing staging facade over the pilots' layers.

    Task-scoped calls (``location_for``, ``resolve``) route through the
    task's OWN pilot's layer — its locality map carries that pilot's pod
    prefix, so a task dispatched to p2 stages to ``p2:pod*``.  Everything
    else (store, planner, thresholds, manifests, channel-put staging)
    delegates to the first staged pilot's layer, which is safe because
    all layers share one store and one planner.
    """

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet

    @property
    def _primary(self):
        for rt in self._fleet.pilots.values():
            if rt.staging is not None:
                return rt.staging
        raise AttributeError("no pilot in this fleet has a staging layer")

    def _layer_for(self, task):
        rt = self._fleet.runtime_for_task(task)
        return rt.staging if rt.staging is not None else self._primary

    def location_for(self, task):
        return self._layer_for(task).location_for(task)

    def resolve(self, task, ref):
        return self._layer_for(task).resolve(task, ref)

    def __getattr__(self, attr):
        return getattr(self._primary, attr)


class _FaultUnion:
    """Aggregate injector view over every pilot's FaultInjector — the
    drain loops consult ONE fault source; per-pod handling still routes
    to the owning pilot via the pod-name prefix."""

    def __init__(self, injectors):
        self._injectors = list(injectors)

    def next_time(self) -> Optional[float]:
        times = [t for inj in self._injectors
                 if (t := inj.next_time()) is not None]
        return min(times) if times else None

    def pending_revive(self) -> bool:
        return any(inj.pending_revive() for inj in self._injectors)

    def pop_due(self, now: float) -> List[tuple]:
        due: List[tuple] = []
        for inj in self._injectors:
            due.extend(inj.pop_due(now))
        return due


class _DigestUnion:
    """Journal shim for spill GC: the keep set of a federated run is the
    union of every journal's referenced digests (a blob journaled by p1
    may be the restart input of a task that will re-dispatch to p2)."""

    def __init__(self, journals: Iterable[Journal]):
        self._journals = list(journals)

    def load_digests(self) -> set:
        digests: set = set()
        for j in self._journals:
            digests |= j.load_digests()
        return digests


class Fleet:
    """N named pilots + one fleet journal + (optionally) a Recruiter.

    ``pilots`` is a name->PilotRuntime dict (or an iterable, auto-named
    ``p1..pN``).  All pilots must share one mode; staged pilots must share
    one ObjectStore.  ``pilot_factory(name) -> PilotRuntime`` lets the
    recruiter spin up replacements/additions mid-run.
    """

    def __init__(self, pilots: Union[Dict[str, PilotRuntime],
                                     Iterable[PilotRuntime]], *,
                 journal: Optional[Journal] = None,
                 recruiter=None,
                 tracer=None,
                 pilot_factory: Optional[Callable[[str], PilotRuntime]]
                 = None):
        if not isinstance(pilots, dict):
            pilots = {f"p{i + 1}": rt for i, rt in enumerate(pilots)}
        if not pilots:
            raise ValueError("a fleet needs at least one pilot")
        modes = {rt.mode for rt in pilots.values()}
        if len(modes) != 1:
            raise ValueError(f"pilots mix modes {sorted(modes)}: a fleet "
                             "runs all-sim or all-real")
        self.mode = modes.pop()
        self.journal = journal if journal is not None else Journal(None)
        self.recruiter = recruiter
        # flight recorder (repro_torch.obs.Tracer) shared by the whole fleet:
        # dispatch decisions, recruit/retire and every pilot's attempt
        # spans land in ONE trace
        self.tracer = tracer
        self.pilot_factory = pilot_factory
        self.pilots: Dict[str, PilotRuntime] = {}
        self.retired: set = set()
        self._by_prefix: Dict[str, PilotRuntime] = {}
        self._next_auto = len(pilots)
        for name, rt in pilots.items():
            self._admit(name, rt)
        stores = {id(rt.staging.store) for rt in self.pilots.values()
                  if rt.staging is not None}
        if len(stores) > 1:
            raise ValueError(
                "staged pilots must share one ObjectStore (and planner): "
                "pilot-to-pilot blob fetch and the dispatcher's replica "
                "view both need a single content-addressed namespace — "
                "build pilots via repro_torch.federation.make_pilot/build_fleet")
        self._staging_view = FleetStagingView(self) if stores else None

    # ------------------------------------------------------------ membership
    def _admit(self, name: str, rt: PilotRuntime):
        if name in self.pilots:
            raise ValueError(f"pilot name {name!r} already in the fleet")
        prefix = f"{name}:"
        if rt.staging is not None and rt.staging.locality is not None:
            loc = rt.staging.locality
            if loc.prefix != prefix:
                if loc.prefix:
                    raise ValueError(
                        f"pilot {name!r} locality prefix {loc.prefix!r} "
                        f"does not match its fleet name ({prefix!r})")
                rt.staging.locality = replace(loc, prefix=prefix)
                rt.staging.planner.locality = rt.staging.locality
        else:
            rt._pod_prefix = prefix
        rt._fleet_name = name
        if rt.journal.tag is None:
            rt.journal.tag = name
        self.pilots[name] = rt
        self._by_prefix[prefix] = rt

    def add_pilot(self, name: Optional[str] = None,
                  rt: Optional[PilotRuntime] = None) -> str:
        """Admit one more pilot (recruiter path: built by the factory).
        Returns its name; a live FederatedSession picks it up at its next
        housekeeping pass."""
        if name is None:
            self._next_auto += 1
            name = f"p{self._next_auto}"
            while name in self.pilots:
                self._next_auto += 1
                name = f"p{self._next_auto}"
        if rt is None:
            if self.pilot_factory is None:
                raise ValueError("no pilot_factory to build the new pilot")
            rt = self.pilot_factory(name)
        if rt.mode != self.mode:
            raise ValueError(f"pilot {name!r} mode {rt.mode!r} != fleet "
                             f"mode {self.mode!r}")
        self._admit(name, rt)
        self.journal.record_event("pilot_joined", pilot=name,
                                  slots=rt.slots)
        return name

    def retire_pilot(self, name: str):
        """Take a pilot out of dispatch (recruiter shrink).  The pilot
        object stays in ``pilots`` — its journal, staged replicas and any
        straggling bookkeeping remain addressable."""
        if name not in self.pilots:
            raise ValueError(f"unknown pilot {name!r}")
        self.retired.add(name)
        self.journal.record_event("pilot_retired", pilot=name)

    def active(self) -> Dict[str, PilotRuntime]:
        """Dispatchable pilots, in admission order."""
        return {n: rt for n, rt in self.pilots.items()
                if n not in self.retired}

    def runtime_for_task(self, task) -> PilotRuntime:
        """The pilot a task is (or was last) bound to; falls back to the
        first pilot for never-dispatched tasks (replayed/canceled ones)."""
        rt = self.pilots.get(task.meta.get("pilot"))
        if rt is not None:
            return rt
        return next(iter(self.pilots.values()))

    def runtime_for_pod(self, pod: str) -> Optional[PilotRuntime]:
        return self._by_prefix.get(pilot_of(pod))

    # ------------------------------------------------------------ facade
    @property
    def slots(self) -> int:
        """Aggregate active capacity (AppManager's utilization and the
        recruiter's budget both read this).  A single task can NOT span
        pilots — per-task width is bounded by one pilot's slots."""
        return sum(rt.slots for rt in self.active().values())

    @property
    def staging(self):
        return self._staging_view

    @property
    def topology(self):
        """Non-None only when every active pilot carries a device
        topology (AppManager gates ``ctx["submesh"]`` on this); the
        per-task mesh comes from the task's own pilot."""
        topos = [rt.topology for rt in self.active().values()]
        if topos and all(tp is not None for tp in topos):
            return topos[0]
        return None

    def submesh_for(self, task):
        return self.runtime_for_task(task).submesh_for(task)

    @property
    def max_retries(self) -> int:
        return max(rt.max_retries for rt in self.pilots.values())

    @property
    def straggler_factor(self) -> float:
        """Speculation stays per-pilot for now: a cross-pilot duplicate
        would need fleet-wide duration histories and a second staging
        manifest — a documented extension point, disabled federated."""
        return 0.0

    @property
    def dead_pods(self) -> set:
        dead: set = set()
        for rt in self.pilots.values():
            dead |= rt.dead_pods
        return dead

    def live_pods(self) -> List[str]:
        pods: set = set()
        for name, rt in self.active().items():
            pods.update(rt.live_pods())
        return sorted(pods)

    def resize(self, slots: int):
        raise ValueError(
            "a Fleet is resized by recruiting/retiring pilots (see "
            "repro_torch.federation.Recruiter), not by resize(); resize "
            "individual pilots via fleet.pilots[name].resize()")

    # ------------------------------------------------------------ chaos
    def inject_pod_failure(self, pod: str):
        """Kill one (prefixed) pod at the next scheduling step."""
        rt = self.runtime_for_pod(pod)
        if rt is None:
            raise ValueError(f"pod {pod!r} matches no pilot prefix")
        rt.inject_pod_failure(pod)

    def inject_pilot_failure(self, name: str):
        """Whole-pilot death: every live pod of the pilot dies.  In-flight
        attempts are abandoned, its staged replicas are dropped, retries
        re-dispatch to surviving pilots, and the recruiter (if any) sees
        the lost capacity as backlog pressure and may replace it."""
        rt = self.pilots[name]
        for pod in rt.live_pods():
            rt.inject_pod_failure(pod)

    # ------------------------------------------------------------ sessions
    def session(self, *, on_task_done: Optional[Callable] = None):
        from repro_torch.federation.session import FederatedSession
        return FederatedSession(self, on_task_done=on_task_done)

    def run(self, graph: TaskGraph) -> RuntimeProfile:
        """Closed-world federated execution of a prebuilt graph (parity
        with ``PilotRuntime.run``)."""
        from repro_torch.federation.session import FederatedSession
        graph.validate()
        sess = FederatedSession(self, graph=graph)
        skipped = sum(sess._replay_task(t) for t in graph.tasks.values())
        if skipped:
            sess.prof.events.append({"event": "journal_skip", "n": skipped})
        return sess.drain()

    # ------------------------------------------------------------ shutdown
    def close(self, *, keep_durable: bool = True) -> int:
        """Close every pilot journal plus the fleet journal; GC spill
        files against the UNION of all journals' digests — any journal
        still naming a blob keeps its spill file restartable."""
        n = 0
        layer = self._staging_view._primary if self._staging_view else None
        if layer is not None:
            union = _DigestUnion([rt.journal for rt in self.pilots.values()]
                                 + [self.journal])
            n = layer.gc_spill(union, keep_durable=keep_durable)
        for rt in self.pilots.values():
            rt.journal.close()
        self.journal.close()
        return n

    # ------------------------------------------------------------ summary
    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "n_pilots": len(self.pilots),
            "n_active": len(self.active()),
            "n_retired": len(self.retired),
            "slots": self.slots,
            "pilot_slots": {n: rt.slots for n, rt in self.pilots.items()},
        }
        if self.recruiter is not None:
            out["recruiter"] = self.recruiter.summary()
        return out


# ------------------------------------------------------------ constructors
def make_pilot(name: str, *, slots: int, mode: str = "sim",
               store=None, planner=None, slots_per_pod: int = 1,
               threshold_bytes: int = 1 << 10,
               journal: Optional[Journal] = None,
               topology=None, faults=None, max_retries: int = 2,
               **kwargs) -> PilotRuntime:
    """One fleet-ready pilot: when a shared ``store``/``planner`` is
    given, the pilot gets its own StagingLayer with a ``{name}:``-prefixed
    locality over them."""
    staging = None
    if store is not None:
        from repro_torch.staging import StagingLayer
        staging = StagingLayer(
            store=store, planner=planner,
            locality=LocalityMap(n_slots=slots, slots_per_pod=slots_per_pod,
                                 prefix=f"{name}:"),
            threshold_bytes=threshold_bytes)
    return PilotRuntime(slots=slots, mode=mode, staging=staging,
                        journal=journal, topology=topology, faults=faults,
                        max_retries=max_retries, **kwargs)


def build_fleet(n_pilots: int, *, slots: int = 8, mode: str = "sim",
                slots_per_pod: int = 1, staging: bool = True,
                threshold_bytes: int = 1 << 10,
                byte_budget: int = 1 << 40,
                spill_dir: Optional[str] = None,
                journal_base: Optional[str] = None,
                recruiter=None, max_retries: int = 2,
                **pilot_kwargs) -> Fleet:
    """Homogeneous starter fleet: ``n_pilots`` pilots of ``slots`` slots
    over ONE shared ObjectStore/TransferPlanner, per-pilot journals named
    ``{journal_base}-{name}`` (tagged with the pilot name — crash replay
    reconstructs the whole fleet from the files), and a ``pilot_factory``
    wired so a Recruiter can grow the fleet with identical pilots."""
    store = planner = None
    if staging:
        from repro_torch.staging import ObjectStore, TransferPlanner
        store = ObjectStore(byte_budget=byte_budget, spill_dir=spill_dir)
        planner = TransferPlanner(store)

    def factory(name: str) -> PilotRuntime:
        journal = (journal_from_env(f"{journal_base}-{name}", tag=name)
                   if journal_base else None)
        return make_pilot(name, slots=slots, mode=mode, store=store,
                          planner=planner, slots_per_pod=slots_per_pod,
                          threshold_bytes=threshold_bytes, journal=journal,
                          max_retries=max_retries, **pilot_kwargs)

    pilots = {f"p{i + 1}": factory(f"p{i + 1}") for i in range(n_pilots)}
    fleet_journal = (journal_from_env(f"{journal_base}-fleet")
                     if journal_base else None)
    return Fleet(pilots, journal=fleet_journal, recruiter=recruiter,
                 pilot_factory=factory)

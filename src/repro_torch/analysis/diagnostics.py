"""Structured diagnostics for the static linter and journal sanitizer.

Every check in :mod:`repro_torch.analysis` emits :class:`Diagnostic` records with
a stable code.  ``E###`` codes are errors (the spec cannot run correctly),
``W###`` are warnings (the spec runs but something is probably not what the
author meant), ``S###`` are journal-invariant violations found by the
sanitizer.  The full registry:

Static validator — errors
  E101  port-type-mismatch: a producer's declared ``output_dtype`` is not
        acceptable for the typed ``Channel`` it feeds.
  E102  channel-no-producer: a consumed channel has no producing stage in
        any submitted pipeline and no pre-seeded puts.
  E103  future-unknown-stage: a ``StageFuture`` references a pipeline/stage
        that is not part of this run and was never previously submitted.
  E104  ensemble-cycle: pipelines wait on each other in a cycle — the
        DAG-of-ensembles has no topological order.
  E105  channel-starved: a stage blocks on a channel whose producers have
        all run; the puts that exist can never satisfy the takes needed.
  E106  capacity-deadlock: a bounded-capacity channel wedges its producer
        while every consumer that could drain it is itself blocked.
  E107  unknown-kernel: a ``TaskSpec`` names a kernel no plugin registered.
  E108  slots-unsatisfiable: a task wants more cores than any reachable
        ``SlotTopology.recarve`` (respecting sharding divisibility) grants.
  E109  staging-overflow: a declared ``output_nbytes`` exceeds the staging
        store's ``byte_budget`` with no spill directory configured.
  E110  duplicate-channel: two distinct ``Channel`` objects share a name.
  E111  duplicate-pipeline: two pipelines (or a pipeline and an already-run
        one on the same ``AppManager``) share a name.
  E112  duplicate-task: two explicit ``TaskSpec.name``s collide.
  E113  invalid-ports: a stage/task ``inputs``/``outputs`` declaration is
        structurally malformed.

Static validator — federation (runtime is a repro.federation.Fleet)
  E114  fleet-slots-unsatisfiable: a task wants more cores than any pilot
        the fleet can EVER field — wider than every active pilot's
        reachable width and wider than anything the recruiter's slot
        budget could spin up.
  E115  invalid-sla: a ``TaskSpec.sla`` names no known serving SLA class,
        or a ``Channel(capacity_bytes=...)`` runs on a pilot with no
        staging layer (puts carry no byte sizes, so the byte bound could
        never engage).

Static validator — warnings
  W201  channel-unconsumed: a fifo channel is produced but never consumed.
  W202  task-wider-than-pilot: a task needs a recarve (grow) before any
        slot can host it — feasible, but startup will stall until granted.
  W203  retries-exceed-pods: ``max_retries`` exceeds what pod-exclusion
        preferences can honor — late retries reuse previously-blamed pods.
  W204  spill-guaranteed: a declared put must exceed ``byte_budget`` and
        will always hit the spill path.
  W205  recruiter-thrash: the recruiter's hysteresis window is shorter
        than its pilot spin-up time, so it can re-decide before the pilot
        it just ordered arrives — fleet size can oscillate.
  W206  latency-starvation-risk: latency-class tasks are declared but no
        task in the app has a lower effective priority — nothing is
        preemptable, so under saturation the latency class queues exactly
        like everything else.

Journal sanitizer
  S301  epoch-regression: ``scheduled`` launch epochs not strictly
        increasing for a task within one session segment.
  S302  zombie-clobber: a result was assigned by an attempt whose epoch had
        been nulled (abandoned) — the PR-6 zombie guard failed.
  S303  release-imbalance: a staged ref was released more than once, or a
        terminal task with staged inputs never released them.
  S304  flow-binding: a ``channel_take`` names a put that does not exist
        (yet), or a fifo put was consumed by two distinct consumers.
  S305  attempt-gap: per-task attempt history skips a number within one
        session segment — an attempt left no record.
  S306  time-overlap: ``t_exec``/``t_data`` accounting is not disjoint —
        their sum exceeds the wall interval of the attempt.

``python -m repro.analysis codes`` prints this table.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

#: code -> (slug, one-line description); the single source of truth used by
#: the CLI, ROADMAP, and tests (every code must have a triggering fixture).
CODES = {
    "E101": ("port-type-mismatch",
             "producer output dtype incompatible with typed channel"),
    "E102": ("channel-no-producer",
             "consumed channel has no producer and no pre-seeded puts"),
    "E103": ("future-unknown-stage",
             "StageFuture references a stage in no known pipeline"),
    "E104": ("ensemble-cycle",
             "pipelines wait on each other in a cycle"),
    "E105": ("channel-starved",
             "all producers run; remaining takes can never be satisfied"),
    "E106": ("capacity-deadlock",
             "bounded channel wedges producer with no live consumer"),
    "E107": ("unknown-kernel",
             "TaskSpec kernel name matches no registered plugin"),
    "E108": ("slots-unsatisfiable",
             "cores request exceeds every reachable recarve slot width"),
    "E109": ("staging-overflow",
             "declared output_nbytes exceeds byte_budget with no spill_dir"),
    "E110": ("duplicate-channel",
             "two distinct Channel objects share one name"),
    "E111": ("duplicate-pipeline",
             "pipeline name already used in this AppManager"),
    "E112": ("duplicate-task",
             "two explicit TaskSpec names collide"),
    "E113": ("invalid-ports",
             "malformed inputs/outputs declaration"),
    "E114": ("fleet-slots-unsatisfiable",
             "cores request exceeds every pilot the fleet can ever field"),
    "E115": ("invalid-sla",
             "unknown SLA class, or capacity_bytes without a staging layer"),
    "W201": ("channel-unconsumed",
             "fifo channel produced but never consumed"),
    "W202": ("task-wider-than-pilot",
             "task needs a grow-recarve before any slot fits it"),
    "W203": ("retries-exceed-pods",
             "max_retries exceeds distinct pods; exclusions will repeat"),
    "W204": ("spill-guaranteed",
             "declared put exceeds byte_budget; always spills"),
    "W205": ("recruiter-thrash",
             "hysteresis shorter than pilot spin-up; size can oscillate"),
    "W206": ("latency-starvation-risk",
             "latency class declared but nothing lower-priority to preempt"),
    "S301": ("epoch-regression",
             "scheduled launch epochs not strictly increasing"),
    "S302": ("zombie-clobber",
             "result assigned by an abandoned (nulled-epoch) attempt"),
    "S303": ("release-imbalance",
             "staged refs not released exactly once per terminal task"),
    "S304": ("flow-binding",
             "take references a missing put, or fifo put double-consumed"),
    "S305": ("attempt-gap",
             "attempt history skips a number within a session segment"),
    "S306": ("time-overlap",
             "t_exec + t_data exceeds the attempt's wall interval"),
}


@dataclass
class Diagnostic:
    """One finding: a stable code plus enough location to act on it."""
    code: str
    message: str
    pipeline: Optional[str] = None
    stage: Optional[int] = None
    task: Optional[str] = None
    channel: Optional[str] = None

    @property
    def severity(self) -> str:
        return {"E": "error", "W": "warning", "S": "violation"}[self.code[0]]

    @property
    def slug(self) -> str:
        return CODES.get(self.code, ("?", "?"))[0]

    def __str__(self) -> str:
        loc = []
        if self.pipeline is not None:
            loc.append(f"pipeline={self.pipeline}")
        if self.stage is not None:
            loc.append(f"stage={self.stage}")
        if self.task is not None:
            loc.append(f"task={self.task}")
        if self.channel is not None:
            loc.append(f"channel={self.channel}")
        where = f" [{' '.join(loc)}]" if loc else ""
        return f"{self.code} {self.slug}{where}: {self.message}"


class DiagnosticError(RuntimeError):
    """Raised by ``validate='error'`` / strict sanitizing; carries the
    structured findings so callers need not re-parse the message."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__("\n".join(str(d) for d in self.diagnostics))


@dataclass
class Report:
    """Ordered collection of diagnostics from one validator/sanitizer run."""
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, code: str, message: str, **loc) -> Diagnostic:
        assert code in CODES, f"unregistered diagnostic code {code}"
        d = Diagnostic(code, message, **loc)
        self.diagnostics.append(d)
        return d

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code[0] in "ES"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code[0] == "W"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def format(self) -> str:
        if not self.diagnostics:
            return "no findings"
        return "\n".join(str(d) for d in self.diagnostics)

    def raise_if_errors(self):
        if self.errors:
            raise DiagnosticError(self.errors)
        return self

    def extend(self, other: "Report"):
        self.diagnostics.extend(other.diagnostics)
        return self

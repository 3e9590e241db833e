"""Journal invariant sanitizer: happens-before checking over run records.

The runtime's deepest invariants (PR 6's launch epochs, staging refcount
balance, flow replay bindings, the TTC decomposition's t_exec/t_data
disjointness) all leave a trace in the journal.  :class:`JournalSanitizer`
replays that trace and checks every invariant **incrementally** — each
``observe(rec)`` call digests one record — so the same checker runs

* post-hoc over any journal file: ``sanitize_file(path)`` (the CLI
  ``python -m repro.analysis sanitize`` and the CI gate over the smoke-run
  journals), and
* live inside a running pilot: ``PilotRuntime(sanitize=True)`` attaches
  ``observe`` as the journal's observer and raises
  :class:`~repro_torch.analysis.diagnostics.DiagnosticError` at the exact record
  that breaks an invariant (strict mode).

Session segments: a crash-restart legitimately re-runs tasks from attempt
one, so per-task epoch state resets at every ``session_start`` record
(written by each ``RuntimeSession``).  Channel traffic, by contrast,
survives restarts by design (replayed puts/takes), so the flow-binding
state is global across segments.

Pilot scoping: federated runs stamp every record with a ``pilot`` tag
(Journal.tag) and a FederatedSession writes a ``session_start`` into EACH
pilot's journal.  A *tagged* session_start therefore resets only that
pilot's task segments — otherwise one pilot's restart would wipe the
epoch state of every other pilot sharing the observer (or a merged
journal) and zombie clobbers would go unseen.  Untagged session_start
records keep the old reset-everything behavior.

Checked invariants (codes in ``diagnostics.CODES``):

  S301  epoch monotonicity: ``scheduled`` records for one task carry
        strictly increasing attempt epochs within a segment.
  S302  zombie clobber: a ``finished``/DONE record (not a speculative
        supersession) must not reuse an epoch that an abandonment record
        (pod_lost/worker_died/heartbeat_timeout/canceled/preempted)
        already nulled.
  S303  staged-ref release balance: at most one ``staged_release`` per
        task per segment, and a task whose ``scheduled`` record listed
        staged inputs must release them by its terminal record.
  S304  flow bindings: every ``channel_take`` names a put that exists,
        and a fifo put is consumed by at most one distinct consumer.
  S305  attempt contiguity: epochs within a segment never skip a number
        (every attempt leaves a record).
  S306  time disjointness: sim — ``v_finished - v_started`` equals
        ``t_exec + t_data`` to 1e-6; real — ``t_exec + t_data_kernel``
        never exceeds the attempt's wall interval (1 ms tolerance).
        When records carry the virtual-clock stamp ``vt`` (PR 10) the
        check extends to SLOTS: two attempts holding the same
        (pilot, slot_id) must not have overlapping [scheduled.vt,
        close.vt] windows — the slot timeline the TTC decomposition
        partitions must be single-occupancy.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.diagnostics import DiagnosticError, Report

_ABANDON_EVENTS = ("pod_lost", "worker_died", "heartbeat_timeout",
                   "canceled", "preempted")
_SIM_TOL = 1e-6
_REAL_TOL = 1e-3


class _TaskSeg:
    """Per-task state within one session segment."""
    __slots__ = ("last_epoch", "abandoned", "staged", "releases",
                 "terminal", "pilot", "held")

    def __init__(self):
        self.last_epoch: Optional[int] = None
        self.abandoned: Set[int] = set()
        self.staged: List[str] = []       # digests on the last scheduled
        self.releases = 0
        self.terminal = False
        self.pilot: Optional[str] = None  # owning pilot (tagged journals)
        self.held: List[Tuple[Optional[str], int]] = []  # open attempt's slots


class JournalSanitizer:
    """Incremental happens-before checker over journal records.

    ``strict=True`` raises :class:`DiagnosticError` at the first
    violation (the live ``PilotRuntime(sanitize=True)`` mode); otherwise
    violations accumulate in :attr:`report` (the post-hoc mode).
    """

    def __init__(self, *, strict: bool = False):
        self.strict = strict
        self.report = Report()
        self.n_records = 0
        self._tasks: Dict[str, _TaskSeg] = {}
        self._segment = 0
        # flow state is global (channel replay crosses restarts)
        self._puts: Set[Tuple[str, str]] = set()
        self._chan_mode: Dict[str, str] = {}
        self._fifo_consumer: Dict[Tuple[str, str], str] = {}
        # slot occupancy on the vt clock: (pilot, slot_id) -> holder /
        # latest release time.  Only fed by records carrying ``vt``.
        self._slot_open: Dict[Tuple[Optional[str], int], str] = {}
        self._slot_free_at: Dict[Tuple[Optional[str], int], float] = {}

    # ------------------------------------------------------------ plumbing
    def _seg(self, task: str) -> _TaskSeg:
        seg = self._tasks.get(task)
        if seg is None:
            seg = self._tasks[task] = _TaskSeg()
        return seg

    def _violation(self, code: str, message: str, **loc):
        d = self.report.add(code, message, **loc)
        if self.strict:
            raise DiagnosticError([d])

    def prime(self, path: Optional[str]):
        """Digest an existing journal file to seed state (puts, epochs)
        WITHOUT reporting or raising on its historical content — a live
        sanitizer attached to an appended journal must know about prior
        segments' puts or every replayed take would look unbound."""
        if not path or not os.path.exists(path):
            return
        strict, self.strict = self.strict, False
        try:
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue          # torn crash line
                    self.observe(rec)
        finally:
            self.strict = strict
            self.report = Report()        # historical findings discarded

    # ------------------------------------------------------------ observe
    def observe(self, rec: dict):
        """Digest one journal record (the Journal.observer hook)."""
        self.n_records += 1
        ev = rec.get("event")
        if ev == "session_start":
            self._segment += 1
            tag = rec.get("pilot")
            if tag is None:
                self._tasks = {}           # single-runtime journal: reset all
            else:
                # a pilot's restart resets ONLY that pilot's task segments;
                # other pilots' epoch state must not bleed away
                self._tasks = {k: s for k, s in self._tasks.items()
                               if s.pilot != tag}
            if tag is None:
                self._slot_open = {}
                self._slot_free_at = {}
            else:
                self._slot_open = {k: v for k, v in self._slot_open.items()
                                   if k[0] != tag}
                self._slot_free_at = {
                    k: v for k, v in self._slot_free_at.items()
                    if k[0] != tag}
            return
        if ev == "channel_put":
            self._on_put(rec)
            return
        if ev == "channel_take":
            self._on_take(rec)
            return
        task = rec.get("task")
        if task is None:
            return                         # run-level event (pod_lost, ...)
        if ev == "scheduled":
            self._on_scheduled(task, rec)
            self._slot_acquire(task, rec)
        elif ev == "staged_release":
            self._on_release(task, rec)
        elif ev in _ABANDON_EVENTS:
            seg = self._seg(task)
            seg.abandoned.add(int(rec.get("attempts", 0)))
            self._slot_release(task, rec)
        elif ev == "finished":
            self._on_finished(task, rec)
            self._slot_release(task, rec)
        elif ev == "failed":
            if rec.get("state") == "FAILED":
                self._on_terminal(task)
            self._slot_release(task, rec)

    # ------------------------------------------------------------ checks
    def _on_scheduled(self, task: str, rec: dict):
        seg = self._seg(task)
        if rec.get("pilot") is not None:
            seg.pilot = rec["pilot"]      # task (re)binds to this pilot
        epoch = int(rec.get("attempts", 0))
        if seg.last_epoch is not None:
            if epoch <= seg.last_epoch:
                self._violation(
                    "S301",
                    f"scheduled epoch {epoch} after epoch "
                    f"{seg.last_epoch} in the same segment", task=task)
            elif epoch > seg.last_epoch + 1:
                self._violation(
                    "S305",
                    f"attempt history jumps {seg.last_epoch} -> {epoch}: "
                    "an attempt left no record", task=task)
        seg.last_epoch = max(epoch, seg.last_epoch or 0)
        staged = rec.get("staged")
        if staged:
            seg.staged = list(staged)

    def _on_finished(self, task: str, rec: dict):
        if rec.get("by") is not None:
            return            # supersession record: epoch legally nulled
        if rec.get("state") != "DONE":
            return
        seg = self._seg(task)
        epoch = int(rec.get("attempts", 0))
        if epoch in seg.abandoned:
            self._violation(
                "S302",
                f"result assigned by abandoned attempt {epoch} (its "
                "epoch was nulled): the zombie guard failed", task=task)
        self._check_times(task, rec)
        self._on_terminal(task)

    def _check_times(self, task: str, rec: dict):
        t_exec = rec.get("t_exec")
        if t_exec is None:
            return            # pre-analysis journal: no timing fields
        if "v_started" in rec and "v_finished" in rec:
            span = float(rec["v_finished"]) - float(rec["v_started"])
            total = float(t_exec) + float(rec.get("t_data", 0.0))
            if abs(span - total) > _SIM_TOL:
                self._violation(
                    "S306",
                    f"virtual interval {span:g} != t_exec + t_data "
                    f"= {total:g}: the TTC decomposition is not "
                    "disjoint", task=task)
        elif "wall" in rec:
            overlap = (float(t_exec) + float(rec.get("t_data_kernel", 0.0))
                       - float(rec["wall"]))
            if overlap > _REAL_TOL:
                self._violation(
                    "S306",
                    f"t_exec + t_data_kernel exceeds the wall interval "
                    f"by {overlap:g}s: exec and data windows overlap",
                    task=task)

    def _slot_acquire(self, task: str, rec: dict):
        """Slot single-occupancy on the vt clock (records without ``vt``
        or ``slot_ids`` — real mode, pre-PR-10 journals — are skipped)."""
        vt = rec.get("vt")
        slot_ids = rec.get("slot_ids")
        if vt is None or not slot_ids:
            return
        seg = self._seg(task)
        pilot = rec.get("pilot")
        for sid in slot_ids:
            key = (pilot, int(sid))
            holder = self._slot_open.get(key)
            if holder is not None and holder != task:
                self._violation(
                    "S306",
                    f"slot {key[1]} scheduled to {task!r} at vt={vt:g} "
                    f"while still held by {holder!r}: slot occupancy "
                    "overlaps", task=task)
            elif float(vt) < self._slot_free_at.get(key,
                                                    float("-inf")) - _SIM_TOL:
                self._violation(
                    "S306",
                    f"slot {key[1]} scheduled to {task!r} at vt={vt:g} "
                    f"before its previous attempt released it at "
                    f"vt={self._slot_free_at[key]:g}", task=task)
            self._slot_open[key] = task
        seg.held = [(pilot, int(s)) for s in slot_ids]

    def _slot_release(self, task: str, rec: dict):
        vt = rec.get("vt")
        seg = self._tasks.get(task)
        if vt is None or seg is None or not seg.held:
            return
        for key in seg.held:
            if self._slot_open.get(key) == task:
                del self._slot_open[key]
            prev = self._slot_free_at.get(key, float("-inf"))
            self._slot_free_at[key] = max(prev, float(vt))
        seg.held = []

    def _on_release(self, task: str, rec: dict):
        seg = self._seg(task)
        seg.releases += 1
        if seg.releases > 1:
            self._violation(
                "S303",
                f"staged refs released {seg.releases} times "
                "(must be exactly once)", task=task)

    def _on_terminal(self, task: str):
        # release-balance closure is checked in finalize(): the runtime
        # journals the terminal record BEFORE the release record, so a
        # missing release is only decidable once the whole file is read
        self._seg(task).terminal = True

    def _on_put(self, rec: dict):
        ch, pk = rec.get("channel"), rec.get("producer")
        if ch is None or pk is None:
            return
        self._puts.add((ch, pk))
        mode = rec.get("mode")
        if mode:
            self._chan_mode[ch] = mode

    def _on_take(self, rec: dict):
        ch, pk = rec.get("channel"), rec.get("producer")
        consumer = rec.get("consumer")
        if ch is None or pk is None:
            return
        if (ch, pk) not in self._puts:
            self._violation(
                "S304",
                f"take by {consumer!r} references put {pk!r} on channel "
                f"{ch!r} which does not exist (yet)", channel=ch)
            return
        if consumer is None or self._chan_mode.get(ch) != "fifo":
            return            # broadcast / unknown mode: fan-out is legal
        prev = self._fifo_consumer.setdefault((ch, pk), consumer)
        if prev != consumer:
            self._violation(
                "S304",
                f"fifo put {pk!r} on channel {ch!r} consumed by both "
                f"{prev!r} and {consumer!r}", channel=ch)

    # ------------------------------------------------------------ results
    def finalize(self) -> Report:
        """Post-hoc closing checks (release balance needs to know the run
        ended); returns the report.  Live mode never calls this — a live
        run cannot know a task will not release later."""
        for task, seg in self._tasks.items():
            if seg.terminal and seg.staged and seg.releases == 0:
                self._violation(
                    "S303",
                    f"task reached a terminal state holding "
                    f"{len(seg.staged)} staged refs it never released",
                    task=task)
        return self.report


def sanitize_file(path: str) -> Report:
    """Check every invariant over one journal file; returns the Report
    (empty when the journal is clean).  Torn trailing lines — the normal
    crash artifact — are skipped, exactly as the replay parsers do."""
    san = JournalSanitizer(strict=False)
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                san.observe(rec)
    return san.finalize()

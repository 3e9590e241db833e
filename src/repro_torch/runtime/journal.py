"""Persistent task-state journal (the MongoDB analogue, per DESIGN.md §2).

Append-only JSONL of task transitions.  On restart, ``replay`` marks DONE
tasks so the executor skips re-running them — this is the checkpoint/restart
path for pattern state (model state itself is checkpointed at the kernel
level by ``repro_torch.checkpoint``: the ``lm.checkpoint`` task).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from repro_torch.runtime.states import TaskGraph, TaskState

# names currently claimed by OPEN journal_from_env journals in this
# process: a second runtime asking for the same name gets a "-2" suffix
# instead of interleaving records into the first one's file.  close()
# releases the claim, so sequential runs (and crash-replay reopens) keep
# the original name.
_claimed_names: set = set()
_claim_lock = threading.Lock()


def journal_from_env(name: str, tag: Optional[str] = None) -> "Journal":
    """Journal writing ``$REPRO_JOURNAL_DIR/<name>.jsonl``, or a no-op
    journal when the env var is unset — lets smoke runs opt into journal
    capture (CI sanitizes the captured files) without new CLI flags.

    When several runtimes live in one process (a federated fleet, or two
    benchmarks back to back) and ask for the same ``name`` while the first
    journal is still open, later callers get a distinct ``<name>-<k>``
    suffix — two pilots never write the same file.  ``tag`` stamps every
    record with a ``pilot`` field (see :class:`Journal`)."""
    base = os.environ.get("REPRO_JOURNAL_DIR")
    if not base:
        return Journal(None, tag=tag)
    with _claim_lock:
        unique, k = name, 1
        while unique in _claimed_names:
            k += 1
            unique = f"{name}-{k}"
        _claimed_names.add(unique)
    j = Journal(os.path.join(base, f"{unique}.jsonl"), tag=tag)
    j._claimed_name = unique
    return j


class Journal:
    #: optional callable(rec: dict) invoked for every record written —
    #: the live-sanitizer hook (analysis.JournalSanitizer.observe).  Also
    #: fires when ``path`` is None, so in-memory runs can be checked.
    observer = None
    #: optional zero-arg callable returning the authoritative run clock.
    #: A sim-mode RuntimeSession sets it to ``lambda: session.vnow`` so
    #: EVERY record (task, run-level, flow) carries a ``vt`` field beside
    #: the wall ``t`` — sim journals are time-faithful on the clock the
    #: DES actually ran on, which is what repro.obs decomposes over.
    vclock = None
    #: name claimed in _claimed_names (journal_from_env only)
    _claimed_name: Optional[str] = None

    def __init__(self, path: Optional[str], *, tag: Optional[str] = None):
        self.path = path
        #: when set (the fleet sets it to the pilot name), every record
        #: carries ``"pilot": tag`` — the sanitizer scopes session_start
        #: resets per pilot, and merged-journal tooling can de-interleave.
        self.tag = tag
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
            # a crash can leave a torn final line with no newline; terminate
            # it so records appended after restart parse on their own lines
            # (the torn fragment itself is skipped by the replay parsers)
            if self._fh.tell():
                with open(path, "rb") as probe:
                    probe.seek(-1, os.SEEK_END)
                    if probe.read(1) != b"\n":
                        self._fh.write("\n")

    def _emit(self, rec: dict):
        if self.tag is not None:
            rec.setdefault("pilot", self.tag)
        if self.vclock is not None:
            rec.setdefault("vt", self.vclock())
        if self._fh is not None:
            self._fh.write(json.dumps(rec, default=str) + "\n")
        if self.observer is not None:
            self.observer(rec)

    def record(self, task, event: str, **extra):
        if self._fh is None and self.observer is None:
            return
        rec = {"t": time.time(), "task": task.name, "event": event,
               "state": task.state.value, "attempts": task.attempts}
        if task.error:
            rec["error"] = task.error
        if event == "finished" and task.result is not None:
            try:                 # persist results a restart can replay —
                json.dumps(task.result)   # callbacks (apply_exchange,
                rec["result"] = task.result   # should_continue) need them
            except (TypeError, ValueError):
                pass             # non-JSON results replay as None
        rec.update(extra)
        self._emit(rec)
        return rec

    def record_event(self, event: str, **extra):
        """Run-level (taskless) record: session_start, pod_lost,
        pod_revived, topology compaction.  Replay parsers that key on
        ``task`` skip these."""
        if self._fh is None and self.observer is None:
            return
        rec = {"t": time.time(), "event": event, **extra}
        self._emit(rec)

    def record_flow(self, event: str, channel: str, producer: str,
                    value=None, consumer: Optional[str] = None,
                    digest: Optional[str] = None,
                    nbytes: Optional[int] = None,
                    mode: Optional[str] = None):
        """Persist a data-flow event (core.flow): ``channel_put`` carries
        the put value (when JSON-serializable), ``channel_take`` the
        consumer->producer binding.  Replay uses these so coupled pipelines
        see identical inputs after a restart.

        Staged puts (repro_torch.staging) journal their ref *encoded* as the
        value AND carry ``digest``/``nbytes`` explicitly, so a coupled
        restart re-binds consumers to the content-addressed blob (spill
        file) without re-staging the payload."""
        if self._fh is None and self.observer is None:
            return
        rec = {"t": time.time(), "event": event, "channel": channel,
               "producer": producer}
        if consumer is not None:
            rec["consumer"] = consumer
        if mode is not None:
            rec["mode"] = mode
        if digest is not None:
            rec["digest"] = digest
            if nbytes is not None:
                rec["nbytes"] = int(nbytes)
        if event == "channel_put":
            try:
                # only values that survive the JSON round-trip UNCHANGED
                # are authoritative on replay (a tuple would come back as
                # a list — different type than the original run delivered);
                # lossy payloads are omitted and the restart recomputes
                # them from replayed task results
                if json.loads(json.dumps(value)) == value:
                    rec["value"] = value
            except (TypeError, ValueError):
                pass
        self._emit(rec)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._claimed_name is not None:
            with _claim_lock:
                _claimed_names.discard(self._claimed_name)
            self._claimed_name = None

    # -------------------------------------------------------------- replay
    # attempt-terminating events whose records seed Task.history on restart
    # ("preempted" is an eviction, not a failure — it still counts an
    # attempt, so a restart resumes with the right epoch numbering, but
    # faults.FAILED_OUTCOMES excludes it: no pod blame)
    _ATTEMPT_EVENTS = ("failed", "pod_lost", "worker_died",
                       "heartbeat_timeout", "preempted")

    def load_state(self):
        """Parse the journal once: ``(done, results, history)``.

        ``done``/``results`` replay finished tasks (as before).
        ``history`` maps task name -> list of failed-attempt records
        ``{"attempt", "pod", "outcome"}`` for tasks NOT done — the
        retry-remembering set: a run that crashed mid-retry restarts with
        its attempt count and failing-pod exclusions intact instead of a
        fresh retry budget."""
        done: set = set()
        results: Dict[str, object] = {}
        history: Dict[str, list] = {}
        if not self.path or not os.path.exists(self.path):
            return done, results, history
        with open(self.path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write at crash: ignore
                ev = rec.get("event")
                if ev == "finished" and rec.get("state") == "DONE":
                    done.add(rec["task"])
                    if "result" in rec:
                        results[rec["task"]] = rec["result"]
                elif ev in self._ATTEMPT_EVENTS and "task" in rec:
                    history.setdefault(rec["task"], []).append(
                        {"attempt": int(rec.get("attempts", 1)),
                         "pod": rec.get("pod"), "outcome": ev})
        # dedupe per (attempt): terminal failure writes both a
        # reason record and a "failed" record for the same attempt
        for name, entries in history.items():
            seen, uniq = set(), []
            for h in entries:
                if h["attempt"] not in seen:
                    seen.add(h["attempt"])
                    uniq.append(h)
            history[name] = uniq
        return done, results, history

    def load_done(self):
        """(set of DONE task names, name->result) — see :meth:`load_state`."""
        done, results, _ = self.load_state()
        return done, results

    def load_digests(self) -> set:
        """Every staged-blob digest any journal record references — the
        KEEP set for spill-file GC: deleting a referenced blob's spill
        file would end the restartability of journaled refs."""
        digests: set = set()
        if not self.path or not os.path.exists(self.path):
            return digests
        with open(self.path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                d = rec.get("digest")
                if d:
                    digests.add(d)
        return digests

    def load_flow(self):
        """Parse data-flow records: ``(puts, takes)`` where puts maps
        ``(channel, producer_key) -> value`` and takes maps
        ``(channel, consumer_key) -> producer_key`` (last record wins)."""
        puts: Dict[tuple, object] = {}
        takes: Dict[tuple, str] = {}
        if not self.path or not os.path.exists(self.path):
            return puts, takes
        with open(self.path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write at crash: ignore
                ev = rec.get("event")
                if ev == "channel_put":
                    # records without "value" (non-JSON payload) carry no
                    # authoritative value: the restart recomputes the put
                    # from replayed stage results instead
                    if "value" in rec:
                        puts[(rec["channel"], rec["producer"])] = \
                            rec["value"]
                elif ev == "channel_take":
                    takes[(rec["channel"], rec["consumer"])] = \
                        rec["producer"]
        return puts, takes

    def replay(self, graph: TaskGraph) -> int:
        """Mark tasks recorded DONE as done; returns #skipped."""
        done, results = self.load_done()
        n = 0
        for name in done:
            t = graph.tasks.get(name)
            if t is not None and not t.state.terminal:
                t.state = TaskState.DONE
                t.result = results.get(name, t.result)
                n += 1
        return n

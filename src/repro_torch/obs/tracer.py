"""Flight-recorder span tracing for the pilot runtime.

A :class:`Tracer` is handed to ``PilotRuntime(tracer=...)`` (or set as
``Fleet.tracer``) and the executor/AppManager/federation hook points call
``task_begin``/``task_end``/``begin``/``end``/``instant`` on it — every
call site guards with ``if tracer is not None``, so an untraced run pays a
single attribute read per hook.  Spans are begin/end pairs keyed to
(pod, slot, pipeline, task, attempt) on the run's authoritative clock:
the virtual clock in sim mode, wall seconds since drain start in real
mode.  A truncated attempt (preemption, pod loss, supersession) ENDS its
span at the truncation time with that outcome — spans never overlap on a
slot, which is what keeps the TTC decomposition (repro_torch.obs.report)
disjoint.

The task-attempt path is the hot one (a 100k-task sim opens and closes
100k spans inside the DES loop), so it records raw tuples and defers
EVERYTHING derivable — dict materialization (the :attr:`spans` read),
outcome counters and span/data/exec histograms (:meth:`_fold`) — to read
time.  The per-attempt cost inside the DES loop is two dict ops and one
tuple append.  The generic ``begin``/``end`` path (parks, transfers)
stays dict-based; it fires orders of magnitude less often.

The tracer owns a :class:`~repro_torch.obs.metrics.MetricsTimeline` — per-attempt
spans fold into histograms (``t_data_attempt``/``t_exec_attempt`` are
recorded for attempts that staged data; for the rest ``attempt_span`` IS
the exec histogram) and ``attempts_<outcome>`` counters, and the drain
loops sample the registered gauges on clock ticks.  Read the timeline
through :meth:`timeseries` (it folds first); ``metrics.series()`` alone
misses attempts recorded since the last fold.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsTimeline

#: span category for task attempts (other cats: "park", "transfer", ...)
TASK = "task"

#: interned ``attempts_<outcome>`` counter names (hot-path cache)
_COUNTER_KEY: Dict[str, str] = {}


class Tracer:
    def __init__(self, *, metrics: Optional[MetricsTimeline] = None):
        self.metrics = metrics if metrics is not None else MetricsTimeline()
        #: "virtual" | "wall" — stamped by the session at first use
        self.clock: Optional[str] = None
        self.events: List[Dict[str, Any]] = []    # instants (pod loss, ...)
        self._open: Dict[Tuple, Any] = {}
        # task spans: raw (task, attempt, t0, t1, outcome, extras) tuples,
        # materialized to dicts lazily by the .spans property
        self._raw: List[Tuple] = []
        self._span_cache: List[Dict[str, Any]] = []
        self._closed: List[Dict[str, Any]] = []   # generic (non-task) spans
        self._folded = 0          # prefix of _raw already in the metrics

    # ------------------------------------------------------------ generic
    def begin(self, key: Tuple, cat: str, name: str, now: float, **args):
        """Open a span under ``key`` (re-begin on an open key replaces the
        stale span — defensively; the runtime never does)."""
        span = {"cat": cat, "name": name, "t0": float(now), "t1": None,
                "outcome": None}
        if args:
            span.update(args)
        self._open[key] = span

    def end(self, key: Tuple, now: float, outcome: str = "done", **args):
        """Close the span under ``key`` (no-op when the key is unknown —
        e.g. a supersession record for a task that never launched)."""
        span = self._open.pop(key, None)
        if span is None:
            return None
        span["t1"] = float(now)
        span["outcome"] = outcome
        if args:
            span.update(args)
        self._closed.append(span)
        return span

    def instant(self, cat: str, name: str, now: float, **args):
        ev = {"cat": cat, "name": name, "t": float(now)}
        if args:
            ev.update(args)
        self.events.append(ev)

    # ------------------------------------------------------------ tasks
    def task_begin(self, t, now: float, pod: Optional[str] = None,
                   t_data: float = 0.0):
        """Open a task-attempt span (hot path: no dict until the span is
        read back; ``extras`` only materializes for annotated tasks)."""
        extras = None
        meta = t.meta
        if pod is not None:
            extras = {"pod": pod}
        if t_data:
            extras = extras or {}
            extras["t_data"] = t_data
        if t.slots != 1:
            extras = extras or {}
            extras["width"] = t.slots
        if meta:
            pilot = meta.get("pilot")
            pipeline = meta.get("pipeline")
            ids = meta.get("slot_ids")
            if pilot is not None or pipeline is not None or ids:
                extras = extras or {}
                if pilot is not None:
                    extras["pilot"] = pilot
                if pipeline is not None:
                    extras["pipeline"] = pipeline
                if ids:
                    extras["slots"] = list(ids)
        self._open[(t.name, t.attempts)] = (now, extras)

    def task_end(self, t, now: float, outcome: str):
        opened = self._open.pop((t.name, t.attempts), None)
        if opened is None:
            return None
        self._raw.append(
            (t.name, t.attempts, opened[0], now, outcome, opened[1]))
        return True

    def _fold(self):
        """Fold raw attempt records into the metrics registry (counters
        and histograms) — deferred off the DES hot path; idempotent over
        the already-folded prefix."""
        raw = self._raw
        if self._folded == len(raw):
            return
        m = self.metrics
        h_span = m.hist("attempt_span")
        h_data = m.hist("t_data_attempt")
        h_exec = m.hist("t_exec_attempt")
        cnt = m.counters
        for rec in raw[self._folded:]:
            _name, _attempt, t0, t1, outcome, extras = rec
            key = _COUNTER_KEY.get(outcome)
            if key is None:
                key = _COUNTER_KEY[outcome] = "attempts_" + outcome
            cnt[key] = cnt.get(key, 0.0) + 1.0
            dur = t1 - t0
            h_span.add(dur)
            if extras is not None and outcome == "done":
                t_data = extras.get("t_data")
                if t_data:
                    h_data.add(t_data)
                    h_exec.add(dur - t_data if dur > t_data else 0.0)
        self._folded = len(raw)

    def timeseries(self) -> dict:
        """The metrics timeline with all recorded attempts folded in —
        this is what lands in ``prof.results["timeseries"]``."""
        self._fold()
        return self.metrics.series()

    # ------------------------------------------------------------ results
    @staticmethod
    def _materialize(raw: Tuple) -> Dict[str, Any]:
        name, attempt, t0, t1, outcome, extras = raw
        span = {"cat": TASK, "task": name, "attempt": attempt,
                "t0": t0, "t1": t1, "outcome": outcome}
        if extras:
            span.update(extras)
        return span

    @property
    def spans(self) -> List[Dict[str, Any]]:
        """All closed spans as dicts, end order: task-attempt spans
        (materialized from the raw hot-path records) then generic spans
        (parks, transfers)."""
        if len(self._span_cache) != len(self._raw) + len(self._closed):
            self._span_cache = [self._materialize(r) for r in self._raw]
            self._span_cache.extend(self._closed)
        return self._span_cache

    def unpaired(self) -> List[Dict[str, Any]]:
        """Spans still open (a clean run ends with none; pipelines parked
        at drain end legitimately remain — the caller filters by cat)."""
        out = []
        for key, val in self._open.items():
            if isinstance(val, dict):
                out.append(val)
            else:
                t0, extras = val
                span = {"cat": TASK, "task": key[0], "attempt": key[1],
                        "t0": t0, "t1": None, "outcome": None}
                if extras:
                    span.update(extras)
                out.append(span)
        return out

    def summary(self) -> dict:
        self._fold()
        return {"n_spans": len(self._raw) + len(self._closed),
                "n_events": len(self.events),
                "n_open": len(self._open), "clock": self.clock}

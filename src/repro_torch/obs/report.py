"""TTC decomposition, Chrome-trace export, and critical-path analysis
over journal files (own copy of ``repro.obs.report``).

The journal (repro_torch.runtime.journal) already records every attempt's
lifecycle — ``scheduled`` opens an attempt, ``finished``/``failed``/
``pod_lost``/``preempted``/``canceled`` close it — and those
records are time-faithful (``vt`` = virtual clock in sim, wall ``t``
otherwise) and slot-attributed (``slot_ids``, ``width``, ``pipeline``,
``deps``, ``v_ready``).  This module re-derives the run's full timeline
from that trace alone: no live Tracer needed, any journal from any past
run decomposes.

The decomposition identity, per slot row::

    w1 - w0  =  t_exec + t_data + t_sched + t_block + t_idle

is EXACT by construction (the five classes partition the slot's window;
``residual`` reports the floating-point leftover and the CLI gates it at
1e-6).  Gap classification uses global step functions swept over the
whole segment:

* some task is ready-but-not-running        -> ``t_sched``  (scheduler /
  packing delay: work existed, the slot sat empty)
* tasks pending on deps, or a pipeline
  parked on an unsatisfiable input          -> ``t_block``
* neither                                   -> ``t_idle``   (tail / drain)

Truncated attempts (preemption, pod loss, supersession, cancelation) end
their span at the truncation record — never an overlap — and their exec
seconds are additionally tallied as ``t_exec_lost`` (wasted work the
retry must redo).
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Any, Dict, List, Optional, Tuple

_CLOSERS = {
    "pod_lost": "pod_lost",
    "worker_died": "worker_died",
    "heartbeat_timeout": "heartbeat_timeout",
    "preempted": "preempted",
    "canceled": "canceled",
}
#: outcomes whose exec seconds count as lost work
_LOST = ("pod_lost", "worker_died", "heartbeat_timeout", "preempted",
         "canceled", "superseded", "failed", "open")
#: Perfetto/Chrome reserved color names per piece kind / outcome
_COLORS = {
    "exec": "thread_state_running",
    "data": "thread_state_iowait",
    "sched": "thread_state_runnable",
    "block": "bad",
    "idle": "thread_state_sleeping",
    "preempted": "terrible",
    "pod_lost": "terrible",
    "worker_died": "terrible",
    "heartbeat_timeout": "terrible",
    "failed": "terrible",
    "canceled": "grey",
    "superseded": "yellow",
    "open": "grey",
}


class Segment:
    """One session segment of one journal: paired attempt spans, park
    intervals, instants, and the dep/readiness metadata the decomposition
    and critical-path walks consume."""

    def __init__(self, index: int = 0):
        self.index = index
        self.clock: str = "wall"            # "vt" once a vt record shows up
        self.spans: List[Dict[str, Any]] = []
        self.instants: List[Dict[str, Any]] = []
        self.parks: List[Dict[str, Any]] = []
        self.deps: Dict[str, List[str]] = {}
        self.ready_at: Dict[Tuple[str, int], float] = {}
        self.terminal_at: Dict[str, float] = {}
        #: dynamic tasks only (``submitted`` records); static tasks are
        #: pending from the segment's start
        self.submitted_at: Dict[str, float] = {}
        self.w0 = math.inf
        self.w1 = -math.inf
        self.n_records = 0
        self._open: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._park_open: Dict[str, Dict[str, Any]] = {}
        self._wall_base: Optional[float] = None

    # ------------------------------------------------------------ time
    def _time(self, rec: dict) -> Optional[float]:
        vt = rec.get("vt")
        if vt is not None:
            self.clock = "vt"
            return float(vt)
        if self.clock == "vt":
            return None                  # stray wall record in a vt segment
        t = rec.get("t")
        if t is None:
            return None
        if self._wall_base is None:
            self._wall_base = float(t)
        return float(t) - self._wall_base

    def _touch(self, t: Optional[float]):
        if t is not None:
            self.w0 = min(self.w0, t)
            self.w1 = max(self.w1, t)

    # ------------------------------------------------------------ ingest
    def observe(self, rec: dict):
        self.n_records += 1
        t = self._time(rec)
        self._touch(t)
        ev = rec.get("event")
        task = rec.get("task")
        if task is None:
            if ev == "pipeline_parked":
                self._park(rec, t)
            elif ev == "pipeline_woken":
                self._wake(rec, t)
            elif ev in ("pod_lost", "pod_revived", "topology_compacted") \
                    and t is not None:
                self.instants.append({"name": ev, "t": t,
                                      "pod": rec.get("pod"),
                                      "n_slots": rec.get("n_slots")})
            return
        if t is None:
            return
        att = int(rec.get("attempts", 1))
        if ev == "submitted":
            self.submitted_at.setdefault(task, t)
        elif ev == "scheduled":
            self._on_scheduled(task, att, t, rec)
        elif ev == "finished":
            if rec.get("by") is not None:
                self._close(task, att, t, "superseded")
            elif rec.get("state") == "DONE":
                sp = self._close(task, att,
                                 float(rec.get("v_finished", t)), "done")
                if sp is not None:
                    if "v_started" in rec:
                        sp["t0"] = float(rec["v_started"])
                    sp["t_data"] = float(rec.get("t_data", 0.0))
                self.terminal_at[task] = t
        elif ev == "failed":
            self._close(task, att, t, "failed")
            if rec.get("state") == "FAILED":
                self.terminal_at[task] = t
        elif ev in _CLOSERS:
            self._close(task, att, t, _CLOSERS[ev])
            if rec.get("state") == "CANCELED":
                self.terminal_at[task] = t

    def _on_scheduled(self, task: str, att: int, t: float, rec: dict):
        sp = {"task": task, "attempt": att, "t0": t, "t1": None,
              "outcome": None, "pod": rec.get("pod"),
              "pilot": rec.get("pilot"), "pipeline": rec.get("pipeline"),
              "slot_ids": rec.get("slot_ids"),
              "width": int(rec.get("width", 1)),
              "t_data": float(rec.get("t_data", 0.0))}
        self._open[(task, att)] = sp
        if rec.get("deps"):
            self.deps[task] = list(rec["deps"])
        ready = rec.get("v_ready")
        if ready is not None:
            self.ready_at[(task, att)] = float(ready)

    def _close(self, task: str, att: int, t: float, outcome: str):
        sp = self._open.pop((task, att), None)
        if sp is None:
            return None                   # duplicate closer (failed after
        sp["t1"] = max(t, sp["t0"])       # pod_lost) — first close wins
        sp["outcome"] = outcome
        self.spans.append(sp)
        return sp

    def _park(self, rec: dict, t: Optional[float]):
        if t is None:
            return
        pk = {"pipeline": rec.get("pipeline"), "on": rec.get("on"),
              "t0": t, "t1": None}
        self._park_open[rec.get("pipeline")] = pk
        self.parks.append(pk)

    def _wake(self, rec: dict, t: Optional[float]):
        pk = self._park_open.pop(rec.get("pipeline"), None)
        if pk is not None and t is not None:
            pk["t1"] = max(t, pk["t0"])

    # ------------------------------------------------------------ close
    def finish(self):
        """Seal the segment: spans/parks still open truncate at ``w1``
        (crash artifact, or a pipeline parked forever)."""
        if not math.isfinite(self.w0):
            self.w0, self.w1 = 0.0, 0.0
        self.n_open = len(self._open)
        for sp in self._open.values():
            sp["t1"] = max(self.w1, sp["t0"])
            sp["outcome"] = "open"
            self.spans.append(sp)
        self._open = {}
        for pk in self._park_open.values():
            pk["t1"] = max(self.w1, pk["t0"])
        self._park_open = {}
        self.spans.sort(key=lambda s: (s["t0"], s["task"], s["attempt"]))
        return self


def load_segments(path: str) -> List[Segment]:
    """Parse one journal file into its session segments (``session_start``
    bounds a segment; a crash-restart journal yields several — the FINAL
    one is the run that completed).  Torn trailing lines are skipped,
    exactly as the replay parsers do."""
    segments: List[Segment] = [Segment(0)]
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("event") == "session_start":
                if segments[-1].n_records:
                    segments.append(Segment(len(segments)))
                seg = segments[-1]
                seg.observe(rec)
                continue
            segments[-1].observe(rec)
    return [seg.finish() for seg in segments]


def segment_from_tracer(tracer) -> Segment:
    """Build a Segment from a live :class:`~repro_torch.obs.tracer.Tracer` —
    the no-journal path for Chrome export (``prof`` in hand, no file)."""
    seg = Segment(0)
    seg.clock = "vt" if tracer.clock == "virtual" else "wall"
    for sp in tracer.spans:
        if sp["cat"] == "task":
            rec = {"task": sp["task"], "attempt": sp["attempt"],
                   "t0": sp["t0"], "t1": sp["t1"],
                   "outcome": sp["outcome"], "pod": sp.get("pod"),
                   "pilot": sp.get("pilot"),
                   "pipeline": sp.get("pipeline"),
                   "slot_ids": sp.get("slots"),
                   "width": sp.get("width", 1),
                   "t_data": sp.get("t_data", 0.0)}
            seg.spans.append(rec)
            if rec["outcome"] in ("done", "failed"):
                seg.terminal_at[rec["task"]] = rec["t1"]
        elif sp["cat"] == "park":
            seg.parks.append({"pipeline": sp.get("pipeline"),
                              "on": sp.get("on"),
                              "t0": sp["t0"], "t1": sp["t1"]})
        seg.w0 = min(seg.w0, sp["t0"])
        seg.w1 = max(seg.w1, sp["t1"])
    for ev in tracer.events:
        seg.instants.append({"name": ev["name"], "t": ev["t"],
                             "pod": ev.get("pod"),
                             "n_slots": ev.get("n_slots")})
        seg.w0 = min(seg.w0, ev["t"])
        seg.w1 = max(seg.w1, ev["t"])
    seg.n_records = len(seg.spans) + len(seg.instants)
    return seg.finish()


# ---------------------------------------------------------------- classify
def _classified_intervals(seg: Segment):
    """Sweep the segment's global step functions into a list of
    ``(a, b, cls)`` elementary intervals with cls in sched|block|idle."""
    deltas: Dict[float, List[int]] = {}

    def add(t0: float, t1: float, idx: int):
        if t1 <= t0:
            return
        deltas.setdefault(t0, [0, 0, 0, 0])[idx] += 1
        deltas.setdefault(t1, [0, 0, 0, 0])[idx] -= 1

    by_attempt = {(s["task"], s["attempt"]): s for s in seg.spans}
    for key, ready in seg.ready_at.items():
        sp = by_attempt.get(key)
        if sp is not None:
            add(ready, sp["t0"], 0)                       # ready, unlaunched
    tasks = ({s["task"] for s in seg.spans}
             | set(seg.terminal_at) | set(seg.submitted_at))
    for task in tasks:                                    # pending
        add(seg.submitted_at.get(task, seg.w0),
            seg.terminal_at.get(task, seg.w1), 1)
    for sp in seg.spans:
        add(sp["t0"], sp["t1"], 2)                        # running
    for pk in seg.parks:
        add(pk["t0"], pk["t1"] if pk["t1"] is not None else seg.w1, 3)

    times = sorted(deltas)
    out: List[Tuple[float, float, str]] = []
    ready = pending = running = parked = 0
    for i, tt in enumerate(times):
        d = deltas[tt]
        ready += d[0]
        pending += d[1]
        running += d[2]
        parked += d[3]
        if i + 1 < len(times):
            if ready > 0:
                cls = "sched"
            elif pending - running - ready > 0 or parked > 0:
                cls = "block"
            else:
                cls = "idle"
            out.append((tt, times[i + 1], cls))
    return out


def _gap_pieces(classes, starts, g0: float, g1: float):
    """Split gap [g0, g1) by the classified intervals (idle when the gap
    outruns the classified range — e.g. [w0, first event))."""
    pieces: List[Tuple[float, float, str]] = []
    if g1 - g0 <= 0:
        return pieces
    i = max(bisect.bisect_right(starts, g0) - 1, 0)
    cur = g0
    while cur < g1 and i < len(classes):
        a, b, cls = classes[i]
        if b <= cur:
            i += 1
            continue
        if a >= g1:
            break
        lo, hi = max(a, cur), min(b, g1)
        if lo > cur:
            pieces.append((cur, lo, "idle"))
        if hi > lo:
            pieces.append((lo, hi, cls))
        cur = hi
        i += 1
    if cur < g1:
        pieces.append((cur, g1, "idle"))
    # merge adjacent same-class pieces
    merged: List[List] = []
    for p in pieces:
        if merged and merged[-1][2] == p[2] and \
                abs(merged[-1][1] - p[0]) < 1e-12:
            merged[-1][1] = p[1]
        else:
            merged.append(list(p))
    return [tuple(p) for p in merged]


# ---------------------------------------------------------------- lanes
def _slot_rows(seg: Segment) -> Dict[Tuple, List[dict]]:
    """Group spans into slot rows: by granted ``slot_ids`` when the
    journal carries them, else deterministic greedy lane packing per
    pilot (a width-w span occupies w lanes — slot-seconds semantics)."""
    rows: Dict[Tuple, List[dict]] = {}
    lanes: Dict[Optional[str], List[float]] = {}   # pilot -> lane free_at
    for sp in seg.spans:                           # already (t0, task)-sorted
        ids = sp.get("slot_ids")
        if ids:
            for sid in ids:
                rows.setdefault((sp.get("pilot"), f"slot{sid:04d}"),
                                []).append(sp)
            continue
        pool = lanes.setdefault(sp.get("pilot"), [])
        grant = [i for i, free in enumerate(pool)
                 if free <= sp["t0"] + 1e-9][:sp["width"]]
        while len(grant) < sp["width"]:
            pool.append(-math.inf)
            grant.append(len(pool) - 1)
        for i in grant:
            pool[i] = sp["t1"]
            rows.setdefault((sp.get("pilot"), f"lane{i:04d}"),
                            []).append(sp)
    return rows


# ---------------------------------------------------------------- decompose
def decompose(seg: Segment) -> dict:
    """Exact TTC decomposition of one segment: per slot row,
    ``t_exec + t_data + t_sched + t_block + t_idle == w1 - w0``
    (``residual`` is the float leftover; the CLI gates it at 1e-6)."""
    w0, w1 = seg.w0, seg.w1
    classes = _classified_intervals(seg)
    starts = [c[0] for c in classes]
    slots: Dict[str, dict] = {}
    for (pilot, lane), spans in sorted(
            _slot_rows(seg).items(),
            key=lambda kv: (kv[0][0] or "", kv[0][1])):
        label = f"{pilot}:{lane}" if pilot else lane
        comp = {"t_exec": 0.0, "t_data": 0.0, "t_sched": 0.0,
                "t_block": 0.0, "t_idle": 0.0, "t_exec_lost": 0.0,
                "n_attempts": 0, "n_preempted": 0, "n_pod_lost": 0,
                "residual": 0.0, "pieces": []}
        cursor = w0
        for sp in spans:
            t0, t1 = max(sp["t0"], cursor), max(sp["t1"], cursor)
            for a, b, cls in _gap_pieces(classes, starts, cursor, t0):
                comp[f"t_{cls}"] += b - a
                comp["pieces"].append({"t0": a, "t1": b, "kind": cls})
            span = t1 - t0
            data = min(max(sp.get("t_data", 0.0), 0.0), span)
            ex = span - data
            comp["t_data"] += data
            comp["t_exec"] += ex
            comp["n_attempts"] += 1
            out = sp["outcome"]
            if out == "preempted":
                comp["n_preempted"] += 1
            elif out in ("pod_lost", "worker_died", "heartbeat_timeout"):
                comp["n_pod_lost"] += 1
            if out in _LOST:
                comp["t_exec_lost"] += ex
            if data > 0:
                comp["pieces"].append(
                    {"t0": t0, "t1": t0 + data, "kind": "data",
                     "task": sp["task"], "attempt": sp["attempt"]})
            if ex > 0 or data == 0:
                comp["pieces"].append(
                    {"t0": t0 + data, "t1": t1, "kind": "exec",
                     "task": sp["task"], "attempt": sp["attempt"],
                     "outcome": out})
            cursor = max(cursor, t1)
        for a, b, cls in _gap_pieces(classes, starts, cursor, w1):
            comp[f"t_{cls}"] += b - a
            comp["pieces"].append({"t0": a, "t1": b, "kind": cls})
        total = (comp["t_exec"] + comp["t_data"] + comp["t_sched"]
                 + comp["t_block"] + comp["t_idle"])
        comp["residual"] = abs((w1 - w0) - total)
        slots[label] = comp
    totals = {k: sum(c[k] for c in slots.values())
              for k in ("t_exec", "t_data", "t_sched", "t_block",
                        "t_idle", "t_exec_lost", "n_attempts",
                        "n_preempted", "n_pod_lost")}
    return {"window": [w0, w1], "clock": seg.clock,
            "n_open": getattr(seg, "n_open", 0),
            "residual_max": max(
                (c["residual"] for c in slots.values()), default=0.0),
            "slots": slots, "totals": totals}


# ---------------------------------------------------------------- chrome
def to_chrome(named_segments: List[Tuple[str, Segment]]) -> str:
    """Render segments as a Chrome/Perfetto ``trace_event`` JSON string
    (load via chrome://tracing or ui.perfetto.dev).  One process per
    segment, one thread row per slot, X slices per exec/data/gap piece,
    instants for pod events.  Output is byte-deterministic: events are
    fully sorted and serialized with sorted keys."""
    events: List[dict] = []
    for pid, (name, seg) in enumerate(named_segments):
        dec = decompose(seg)
        w0 = dec["window"][0]
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})
        for tid, (label, comp) in enumerate(sorted(dec["slots"].items()),
                                            start=1):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": label}})
            for p in comp["pieces"]:
                out = p.get("outcome")
                color = _COLORS[out] if out in _COLORS and out != "done" \
                    else _COLORS[p["kind"]]
                args = {k: p[k] for k in ("task", "attempt", "outcome")
                        if p.get(k) is not None}
                nm = p.get("task", p["kind"])
                events.append({"ph": "X", "pid": pid, "tid": tid,
                               "name": nm, "cat": p["kind"],
                               "cname": color,
                               "ts": round((p["t0"] - w0) * 1e6, 3),
                               "dur": round((p["t1"] - p["t0"]) * 1e6, 3),
                               "args": args})
        for inst in seg.instants:
            events.append({"ph": "i", "pid": pid, "tid": 0, "s": "p",
                           "name": inst["name"], "cat": "pod",
                           "ts": round((inst["t"] - w0) * 1e6, 3),
                           "args": {k: inst[k] for k in ("pod", "n_slots")
                                    if inst.get(k) is not None}})
    events.sort(key=lambda e: (e["pid"], e["tid"], e.get("ts", -1.0),
                               e["ph"], e["name"]))
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------- critpath
def critical_path(seg: Segment, k: int = 3) -> List[dict]:
    """Top-k critical chains through the segment's span/dep DAG.

    Walk back from the k latest-finishing tasks, at each step following
    the dependency that finished LAST; every link reports its slack —
    the gap between the dep's finish and this task's start (scheduling /
    staging / queueing delay the chain absorbed).  A chain of zero-slack
    links is the classic critical path."""
    done = {}
    for sp in seg.spans:
        if sp["outcome"] == "done":
            done[sp["task"]] = sp
    ends = sorted(done.values(),
                  key=lambda s: (-s["t1"], s["task"]))[:max(k, 0)]
    chains, seen = [], set()
    for end in ends:
        links, cur = [], end
        while True:
            deps = [done[d] for d in seg.deps.get(cur["task"], ())
                    if d in done]
            link = {"task": cur["task"], "t0": cur["t0"], "t1": cur["t1"],
                    "span": cur["t1"] - cur["t0"]}
            if not deps:
                links.append(link)
                break
            dep = max(deps, key=lambda s: (s["t1"], s["task"]))
            link["dep"] = dep["task"]
            link["slack"] = max(cur["t0"] - dep["t1"], 0.0)
            links.append(link)
            cur = dep
        links.reverse()
        key = tuple(ln["task"] for ln in links)
        if key in seen:
            continue
        seen.add(key)
        chains.append({"ttc": end["t1"], "n_links": len(links),
                       "total_slack": sum(ln.get("slack", 0.0)
                                          for ln in links),
                       "links": links})
    return chains

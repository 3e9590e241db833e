"""Static pre-flight validator for PST applications.

``validate_app(pipelines)`` runs every check that is decidable from the
declared `PipelineSpec`/`Stage`/`TaskSpec` objects, their `core.flow` port
graph, and (when a runtime is provided) the pilot's topology, sharding
contract, staging budget, and retry policy — BEFORE any task launches.
Findings come back as a :class:`repro_torch.analysis.diagnostics.Report` of
stable-coded diagnostics (the registry lives in ``diagnostics.CODES``; the
ROADMAP "Analysis & correctness tooling" section documents each code).

Two layers:

1.  A structural pass over the declarations (port well-formedness, kernel
    resolution, name collisions, dtype compatibility, slot feasibility,
    staging budgets).
2.  An *abstract executor*: a deterministic re-implementation of the
    ``AppManager``'s submission rules (channel availability, broadcast
    cursors, capacity back-pressure, future parking) that advances every
    pipeline to a fixpoint counting puts/takes only — no tasks, no pilot.
    Pipelines stuck at the fixpoint are classified into starvation (E105),
    capacity deadlock (E106), or wait-for cycles (E104) by root-causing
    the blocked-pipeline graph: secondary blockages (a pipeline starved
    only because its producer is stuck) are suppressed so one defect
    yields one diagnostic.

Adaptive ``on_done`` extensions are invisible statically; the validator
analyzes the declared stages, which is exactly the fail-early contract:
anything a callback appends later is validated by the runtime checks when
it is submitted.

Usage::

    report = validate_app(pipes, runtime=rt)
    report.raise_if_errors()          # or inspect report.diagnostics

``AppManager.run(..., validate="error"|"warn"|"off")`` wires this in, and
``python -m repro.analysis lint module:factory`` runs it from the CLI.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Report
from repro_torch.core import flow
from repro_torch.core.flow import Channel, StageFuture
from repro_torch.core.kernel_plugin import Kernel, kernel_names, kernel_registered

# ------------------------------------------------------------ small helpers


def _kernel_of(spec) -> Optional[Kernel]:
    """The spec's Kernel when already bound; None for (unresolved) names."""
    k = getattr(spec, "kernel", None)
    return k if isinstance(k, Kernel) else None


def _spec_sources(obj) -> Tuple[Dict[str, Any], Optional[str]]:
    """normalize_sources with the failure folded into the return value."""
    try:
        return flow.normalize_sources(obj.inputs), None
    except (TypeError, ValueError) as e:
        return {}, str(e)


def _spec_outputs(obj) -> Tuple[List[Channel], Optional[str]]:
    try:
        return flow.normalize_outputs(obj.outputs), None
    except (TypeError, ValueError) as e:
        return [], str(e)


class _AbstractChannel:
    """Counting model of one Channel: enough state to decide every
    availability / back-pressure question the AppManager's blocker asks —
    including the byte-denominated bound (``capacity_bytes``), mirrored
    with per-put byte sizes — pre-seeded from the live object so a second
    ``run()`` on one manager validates against traffic the first run left
    behind."""

    def __init__(self, ch: Channel):
        self.name = ch.name
        self.mode = ch.mode
        self.capacity = ch.capacity
        self.capacity_bytes = ch.capacity_bytes
        self.n_puts = len(ch.puts)
        self.n_taken = len(ch._taken)
        self.cursors: Dict[str, int] = dict(ch._cursors)
        # per-put declared sizes (abstract fifo consumes in order, so the
        # running byte totals stay exact against the declared traffic)
        self.put_bytes: List[int] = [
            ch._byte_prefix[i + 1] - ch._byte_prefix[i]
            for i in range(self.n_puts)]
        self.bytes_taken = ch._bytes_taken

    def available_fifo(self) -> int:
        return self.n_puts - self.n_taken

    def available_broadcast(self, stream: str) -> int:
        return self.n_puts - self.cursors.get(stream, 0)

    def n_unconsumed(self) -> int:
        if self.mode == "broadcast":
            low = min(self.cursors.values()) if self.cursors else 0
            return self.n_puts - low
        return self.n_puts - self.n_taken

    def n_unconsumed_bytes(self) -> int:
        total = sum(self.put_bytes)
        if self.mode == "broadcast":
            low = min(self.cursors.values()) if self.cursors else 0
            return total - sum(self.put_bytes[:low])
        return total - self.bytes_taken


class _AbstractRun:
    """Execution-time state of one pipeline under abstract execution."""

    def __init__(self, spec, name: str):
        self.spec = spec
        self.name = name
        self.idx = -1
        self.done = False
        self.invalid = False      # E113/E102-poisoned: excluded from exec
        self.blocker = None       # ("channel"|"channel_space"|"future", key)


# ------------------------------------------------------------ entry point


def validate_app(pipelines, *, runtime=None,
                 channels: Optional[Dict[str, Channel]] = None,
                 existing_pipelines: Iterable[str] = ()) -> Report:
    """Validate PST pipelines; returns a Report (never raises).

    ``runtime`` (a PilotRuntime, optional) enables the environment-aware
    checks: slot feasibility against the topology + sharding contract
    (E108/W202), staging byte budgets (E109/W204, real mode), and the
    retry/pod-exclusion interaction (W203).  ``channels`` and
    ``existing_pipelines`` carry an AppManager's state from prior runs so
    repeated ``run()`` calls validate against it (E110/E111 and channel
    pre-seeding).
    """
    report = Report()
    pipes = list(pipelines) if not hasattr(pipelines, "stages") \
        else [pipelines]
    runs: List[_AbstractRun] = []
    names_used = set(existing_pipelines)
    for p in pipes:
        name = p.name or f"p{len(runs) + len(set(existing_pipelines)):04d}"
        if name in names_used:
            report.add("E111", f"pipeline name {name!r} already used",
                       pipeline=name)
        names_used.add(name)
        runs.append(_AbstractRun(p, name))

    seen_channels: Dict[str, Channel] = dict(channels or {})
    stage_owner: Dict[int, Tuple[_AbstractRun, int]] = {}
    for r in runs:
        for si, stage in enumerate(r.spec.stages):
            stage_owner[id(stage)] = (r, si)

    _structural_pass(report, runs, seen_channels, runtime)
    _flow_pass(report, runs, seen_channels, stage_owner)
    return report


# ------------------------------------------------------------ layer 1


def _structural_pass(report: Report, runs, seen_channels, runtime):
    task_names: Dict[str, str] = {}       # explicit name -> "pipeline/stage"
    for r in runs:
        for si, stage in enumerate(r.spec.stages):
            _check_stage(report, r, si, stage, seen_channels, runtime,
                         task_names)
    _check_channel_bytes(report, seen_channels, runtime)
    _check_sla_priorities(report, runs)
    _check_retry_policy(report, runtime)
    _check_recruiter(report, runtime)


def _check_stage(report, r, si, stage, seen_channels, runtime, task_names):
    loc = {"pipeline": r.name, "stage": si}
    srcs, err = _spec_sources(stage)
    if err:
        report.add("E113", f"stage inputs: {err}", **loc)
        r.invalid = True
    outs, err = _spec_outputs(stage)
    if err:
        report.add("E113", f"stage outputs: {err}", **loc)
        r.invalid = True
    for port, src in srcs.items():
        if not isinstance(src, (Channel, StageFuture)):
            report.add("E113",
                       f"input port {port!r}: expected Channel or "
                       f"StageFuture, got {type(src).__name__}", **loc)
            r.invalid = True
        elif isinstance(src, Channel):
            _check_channel(report, src, seen_channels, loc)
    for ch in outs:
        _check_channel(report, ch, seen_channels, loc)

    for j, spec in enumerate(stage.tasks):
        tloc = dict(loc)
        tloc["task"] = spec.name or f"#{j}"
        k = getattr(spec, "kernel", None)
        if isinstance(k, str) and not kernel_registered(k):
            report.add("E107",
                       f"kernel {k!r} matches no registered plugin "
                       f"(available: {', '.join(kernel_names())})", **tloc)
        sla = getattr(spec, "sla", None)
        if sla is not None:
            from repro_torch.serving.sla import CLASSES
            if sla not in CLASSES:
                report.add("E115",
                           f"unknown SLA class {sla!r} "
                           f"(known: {', '.join(sorted(CLASSES))})", **tloc)
        if spec.name:
            prev = task_names.get(spec.name)
            here = f"{r.name}/stage{si}"
            if prev is not None:
                report.add("E112",
                           f"task name {spec.name!r} already used at "
                           f"{prev}", **tloc)
            task_names[spec.name] = here
        tsrcs, err = _spec_sources(spec)
        if err:
            report.add("E113", f"task inputs: {err}", **tloc)
            r.invalid = True
        touts, err = _spec_outputs(spec)
        if err:
            report.add("E113", f"task outputs: {err}", **tloc)
            r.invalid = True
        for port, src in tsrcs.items():
            if not isinstance(src, (Channel, StageFuture)):
                report.add("E113",
                           f"input port {port!r}: expected Channel or "
                           f"StageFuture, got {type(src).__name__}", **tloc)
                r.invalid = True
            elif isinstance(src, Channel):
                _check_channel(report, src, seen_channels, tloc)
        for ch in touts:
            _check_channel(report, ch, seen_channels, tloc)
            _check_put_dtype(report, _kernel_of(spec), ch, tloc,
                             task_level=True)
        kernel = _kernel_of(spec)
        # stage-level outputs carry {task: result} dicts: every member's
        # declared result type must satisfy the channel
        for ch in outs:
            _check_put_dtype(report, kernel, ch, tloc, task_level=False)
        _check_placement(report, kernel, runtime, tloc)
        _check_staging(report, kernel, runtime, tloc)


def _check_channel(report, ch: Channel, seen: Dict[str, Channel], loc):
    cur = seen.get(ch.name)
    if cur is None:
        seen[ch.name] = ch
    elif cur is not ch:
        if not any(d.code == "E110" and d.channel == ch.name
                   for d in report.diagnostics):
            report.add("E110",
                       f"two distinct Channel objects named {ch.name!r} "
                       "in one application", channel=ch.name, **{
                           k: v for k, v in loc.items() if k != "channel"})


def _check_put_dtype(report, kernel: Optional[Kernel], ch: Channel, loc,
                     *, task_level: bool):
    if kernel is None or ch.dtype is None or kernel.output_dtype is None:
        return
    if not issubclass(kernel.output_dtype, ch.dtype):
        kind = "task-level" if task_level else "stage-level"
        report.add("E101",
                   f"kernel {kernel.name!r} declares output_dtype="
                   f"{kernel.output_dtype.__name__} but {kind} output "
                   f"channel {ch.name!r} expects {ch.dtype.__name__}",
                   channel=ch.name, **loc)


def _recarve_counts(topo):
    """The slot counts a device topology can recarve to: the JAX package
    asks its sharding rules (``repro.dist.sharding``), which wait for
    ROADMAP A9 in the port."""
    raise NotImplementedError("device topologies (slot submeshes) are not "
                              "ported yet: ROADMAP A9")


def _pilot_reachable_width(rt) -> int:
    """Widest slot count one pilot can ever field: its current slots, or
    the best grow-recarve its device topology admits."""
    topo = getattr(rt, "topology", None)
    if topo is None:
        return rt.slots
    return max(_recarve_counts(topo))


def _check_fleet_placement(report, kernel, fleet, cores, loc):
    """E114/W202 for a federated runtime: a task must fit inside ONE
    pilot (the fleet's summed slots are not co-schedulable), so the bound
    is the widest pilot any future of this fleet can field — active
    pilots at their reachable recarve widths, plus whatever the recruiter
    could still spin up within its slot budget."""
    retired = getattr(fleet, "retired", set())
    current = reachable = 0
    for name, rt in fleet.pilots.items():
        if name in retired:
            continue
        current = max(current, rt.slots)
        reachable = max(reachable, _pilot_reachable_width(rt))
    rec = getattr(fleet, "recruiter", None)
    if rec is not None and getattr(fleet, "pilot_factory", None) is not None \
            and rec.slots_per_pilot <= rec.budget_slots:
        reachable = max(reachable, int(rec.slots_per_pilot))
    if cores <= current:
        return
    if cores > reachable:
        report.add("E114",
                   f"kernel {kernel.name!r} wants {cores} slots but no "
                   f"pilot this fleet can ever field goes past {reachable} "
                   f"(widest active pilot: {current}; "
                   + (f"recruiter pilots: {rec.slots_per_pilot} slots"
                      if rec is not None else "no recruiter")
                   + "): the fleet slot budget is unsatisfiable", **loc)
    else:
        report.add("W202",
                   f"kernel {kernel.name!r} wants {cores} slots; no active "
                   f"pilot fields that width yet (widest: {current}) — the "
                   "task waits for a recarve or a recruited pilot", **loc)


def _check_placement(report, kernel: Optional[Kernel], runtime, loc):
    """E108/W202: can the pilot EVER grant this task's slot width?
    Federated runtimes route to the per-pilot rule (E114/W202) first —
    ``runtime.slots`` on a Fleet is the SUM over pilots, which a single
    task can never co-schedule."""
    if kernel is None or runtime is None:
        return
    cores = int(kernel.cores or 1)
    if getattr(runtime, "pilots", None) is not None:
        _check_fleet_placement(report, kernel, runtime, cores, loc)
        return
    if cores <= runtime.slots:
        return
    topo = getattr(runtime, "topology", None)
    if topo is None:
        # abstract pilots resize freely; a wide task just waits for a grow
        report.add("W202",
                   f"kernel {kernel.name!r} wants {cores} slots but the "
                   f"pilot has {runtime.slots}; it will wait for a "
                   "resize", **loc)
        return
    reachable = _recarve_counts(topo)
    best = max(reachable)
    if cores > best:
        report.add("E108",
                   f"kernel {kernel.name!r} wants {cores} slots but no "
                   f"recarve reaches past {best} "
                   f"(reachable slot counts: {reachable}; grow splits the "
                   f"leading slot axis {topo.axis_names[:1]})", **loc)
    else:
        report.add("W202",
                   f"kernel {kernel.name!r} wants {cores} slots; the "
                   f"pilot must recarve {runtime.slots} -> >= {cores} "
                   "before it can start", **loc)


def _check_staging(report, kernel: Optional[Kernel], runtime, loc):
    """E109/W204: declared puts vs the staging byte budget.  Real mode
    only — DES stages *virtual* blobs that never occupy memory, so a sim
    run with large declared nbytes is fine by construction."""
    if kernel is None or runtime is None or not kernel.output_nbytes:
        return
    staging = getattr(runtime, "staging", None)
    if staging is None or runtime.mode != "real":
        return
    nbytes = int(kernel.output_nbytes)
    store = staging.store
    if nbytes < staging.threshold_bytes or nbytes <= store.byte_budget:
        return
    if store.spill_dir is None:
        report.add("E109",
                   f"kernel {kernel.name!r} declares output_nbytes="
                   f"{nbytes} > byte_budget={store.byte_budget} with no "
                   "spill_dir: the put cannot be held or spilled", **loc)
    else:
        report.add("W204",
                   f"kernel {kernel.name!r} declares output_nbytes="
                   f"{nbytes} > byte_budget={store.byte_budget}: every "
                   "put will go through the spill path", **loc)


def _check_channel_bytes(report, seen_channels, runtime):
    """E115: a ``capacity_bytes`` bound only engages when a staging layer
    supplies byte sizes for puts — without one, every put meters 0 bytes
    and the declared bound silently never parks anybody."""
    if runtime is None:
        return
    if getattr(runtime, "staging", None) is not None:
        return
    pilots = getattr(runtime, "pilots", None)
    if pilots and any(getattr(rt, "staging", None) is not None
                      for rt in pilots.values()):
        return            # some pilot of the fleet meters bytes
    for name in sorted(seen_channels):
        ch = seen_channels[name]
        if getattr(ch, "capacity_bytes", None) is not None:
            report.add("E115",
                       f"channel {name!r} declares capacity_bytes="
                       f"{ch.capacity_bytes} but the pilot has no staging "
                       "layer: puts carry no byte sizes, so the bound can "
                       "never engage", channel=name)


def _check_sla_priorities(report, runs):
    """W206: a preempting SLA class (latency) with nothing below it.  If
    no task in the whole app has a lower effective priority, there is
    nothing to evict — under saturation the latency class queues exactly
    like everything else and its deadline budget is fiction."""
    from repro_torch.serving.sla import CLASSES

    def effective(spec) -> int:
        if getattr(spec, "priority", None) is not None:
            return int(spec.priority)
        c = CLASSES.get(getattr(spec, "sla", None) or "")
        return c.priority if c is not None else 0

    preempting = []                        # (priority, loc) of latency specs
    priorities = []
    for r in runs:
        for si, stage in enumerate(r.spec.stages):
            for spec in stage.tasks:
                p = effective(spec)
                priorities.append(p)
                c = CLASSES.get(getattr(spec, "sla", None) or "")
                if c is not None and c.preempts:
                    preempting.append(
                        (p, {"pipeline": r.name, "stage": si,
                             "task": spec.name or None}))
    if not preempting:
        return
    floor = min(p for p, _ in preempting)
    if all(p >= floor for p in priorities):
        _, loc = min(preempting, key=lambda e: e[0])
        report.add("W206",
                   f"latency-class tasks (priority {floor}) have no "
                   "lower-priority task anywhere in the app: nothing is "
                   "preemptable, so under saturation the latency class "
                   "queues like everything else", **loc)


def _check_retry_policy(report, runtime):
    """W203: more retries than distinct pods means the pod-exclusion
    preference must repeat a previously-blamed pod on late attempts."""
    if runtime is None:
        return
    try:
        pods = runtime.live_pods()
    except Exception:
        return
    if not pods:
        return            # no slot-id tracking: no pod exclusion either
    budget = int(runtime.max_retries) + 1
    if budget > len(pods):
        report.add("W203",
                   f"max_retries={runtime.max_retries} allows {budget} "
                   f"attempts but only {len(pods)} pods exist: attempts "
                   f"beyond {len(pods)} re-use previously-blamed pods")


def _check_recruiter(report, runtime):
    """W205: a recruiter that re-decides faster than its pilots arrive
    sees the backlog it already ordered capacity for and orders again —
    the classic autoscaler thrash.  Hysteresis must cover spin-up."""
    rec = getattr(runtime, "recruiter", None)
    if rec is None:
        return
    if rec.hysteresis_s < rec.spinup_s:
        report.add("W205",
                   f"recruiter hysteresis_s={rec.hysteresis_s:g} is "
                   f"shorter than spinup_s={rec.spinup_s:g}: the fleet "
                   "can re-decide before the pilot it just ordered "
                   "arrives — size oscillation is likely")


# ------------------------------------------------------------ layer 2


def _flow_pass(report, runs, seen_channels, stage_owner):
    """Abstract execution to a fixpoint + root-cause classification."""
    chans: Dict[str, _AbstractChannel] = {
        name: _AbstractChannel(ch) for name, ch in seen_channels.items()}

    # --- static producer/consumer maps over ALL declared stages
    producers: Dict[str, List[Tuple[_AbstractRun, int]]] = {}
    consumers: Dict[str, List[Tuple[_AbstractRun, int]]] = {}
    for r in runs:
        if r.invalid:
            continue
        for si, stage in enumerate(r.spec.stages):
            for ch in _all_outputs(stage):
                producers.setdefault(ch.name, []).append((r, si))
            for _ck, _stream, _port, src, _j in _bindings(stage, r, si):
                if isinstance(src, Channel):
                    consumers.setdefault(src.name, []).append((r, si))
                elif isinstance(src, StageFuture):
                    if id(src.stage) not in stage_owner \
                            and not src.submitted:
                        sname = getattr(src.stage, "name", "?")
                        report.add(
                            "E103",
                            f"StageFuture references stage {sname!r} "
                            "which is in no submitted pipeline",
                            pipeline=r.name, stage=si)
                        r.invalid = True

    no_producer = set()
    for cname, users in consumers.items():
        ach = chans.get(cname)
        preseeded = ach is not None and ach.n_puts > 0
        if cname not in producers and not preseeded:
            r, si = users[0]
            no_producer.add(cname)
            report.add("E102",
                       f"channel {cname!r} is consumed but nothing "
                       "produces to it and it holds no prior puts",
                       channel=cname, pipeline=r.name, stage=si)
    for cname in producers:
        ach = chans.get(cname)
        if ach is not None and ach.mode == "broadcast":
            continue
        if cname not in consumers:
            r, si = producers[cname][0]
            report.add("W201",
                       f"fifo channel {cname!r} is produced but never "
                       "consumed", channel=cname, pipeline=r.name,
                       stage=si)

    # --- run the abstract machine to a fixpoint
    live = [r for r in runs if not r.invalid]
    progress = True
    while progress:
        progress = False
        for r in live:
            if r.done:
                continue
            if _advance(r, chans, stage_owner):
                progress = True

    blocked = [r for r in live if not r.done]
    if not blocked:
        return
    _classify_blocked(report, blocked, chans, stage_owner, producers,
                      consumers, no_producer)


def _all_outputs(stage) -> List[Channel]:
    outs, err = _spec_outputs(stage)
    if err:
        return []
    for spec in stage.tasks:
        touts, terr = _spec_outputs(spec)
        if not terr:
            outs.extend(touts)
    return outs


def _stage_emissions(stage) -> Tuple[Dict[str, int], Dict[str, int],
                                     List[Tuple[Channel, int]]]:
    """What this stage will put, mirrored from the AppManager: per-channel
    put counts, per-channel declared byte totals, and the individual puts
    in emission order (a stage-level output is ONE {task: result} put
    carrying every member's declared bytes; a task-level output is one put
    per spec carrying that kernel's bytes)."""
    emits: Dict[str, int] = {}
    emit_bytes: Dict[str, int] = {}
    puts: List[Tuple[Channel, int]] = []
    stage_outs, err = _spec_outputs(stage)
    stage_nbytes = sum(
        int(getattr(_kernel_of(s), "output_nbytes", 0) or 0)
        for s in stage.tasks if _kernel_of(s) is not None)
    for ch in (stage_outs if not err else []):
        emits[ch.name] = emits.get(ch.name, 0) + 1
        emit_bytes[ch.name] = emit_bytes.get(ch.name, 0) + stage_nbytes
        puts.append((ch, stage_nbytes))
    for spec in stage.tasks:
        touts, terr = _spec_outputs(spec)
        k = _kernel_of(spec)
        kb = int(getattr(k, "output_nbytes", 0) or 0) if k is not None \
            else 0
        for ch in (touts if not terr else []):
            emits[ch.name] = emits.get(ch.name, 0) + 1
            emit_bytes[ch.name] = emit_bytes.get(ch.name, 0) + kb
            puts.append((ch, kb))
    return emits, emit_bytes, puts


def _bindings(stage, r, si):
    """Mirror of AppManager._iter_bindings over abstract runs."""
    srcs, err = _spec_sources(stage)
    if not err:
        for port, src in srcs.items():
            yield (f"{r.name}:{si:04d}:{port}", f"{r.name}:{port}",
                   port, src, None)
    for j, spec in enumerate(stage.tasks):
        tsrcs, terr = _spec_sources(spec)
        if terr:
            continue
        for port, src in tsrcs.items():
            yield (f"{r.name}:{si:04d}:{j:05d}:{port}",
                   f"{r.name}:{j:05d}:{port}", port, src, j)


def _blocker(r, stage, si, chans, stage_owner):
    """Abstract mirror of AppManager._input_blocker: the first
    unsatisfiable input or full output channel, else None."""
    fresh: Dict[str, int] = {}
    own_takes: Dict[str, int] = {}
    for ck, stream, _port, src, _j in _bindings(stage, r, si):
        if isinstance(src, Channel):
            ach = chans.setdefault(src.name, _AbstractChannel(src))
            if ach.mode == "broadcast":
                ach.cursors.setdefault(stream, 0)
            own_takes[src.name] = own_takes.get(src.name, 0) + 1
            if ach.mode == "broadcast":
                if ach.available_broadcast(stream) < 1:
                    return ("channel", src.name)
            else:
                fresh[src.name] = fresh.get(src.name, 0) + 1
        elif isinstance(src, StageFuture):
            owner = stage_owner.get(id(src.stage))
            if src.submitted:
                continue
            if owner is None:
                return ("future", id(src.stage))
            pr, psi = owner
            if pr.idx < psi:        # producer stage not yet submitted
                return ("future", id(src.stage))
    for cname, n in fresh.items():
        if chans[cname].available_fifo() < n:
            return ("channel", cname)
    emits, emit_bytes, _puts = _stage_emissions(stage)
    for ch in _all_outputs(stage):
        chans.setdefault(ch.name, _AbstractChannel(ch))
    for cname, n_emit in emits.items():
        ach = chans[cname]
        if ach.capacity is not None:
            backlog = ach.n_unconsumed() - own_takes.get(cname, 0)
            if backlog > 0 and backlog + n_emit > ach.capacity:
                return ("channel_space", cname)
        if ach.capacity_bytes is not None:
            # own-take byte credit: the fifo puts this stage itself will
            # consume drain before its emission lands (broadcast takes
            # free no bytes — other streams may still need them)
            credit = 0
            if ach.mode != "broadcast":
                lo = ach.n_taken
                hi = min(lo + own_takes.get(cname, 0), len(ach.put_bytes))
                credit = sum(ach.put_bytes[lo:hi])
            backlog_b = ach.n_unconsumed_bytes() - credit
            if backlog_b > 0 and \
                    backlog_b + emit_bytes[cname] > ach.capacity_bytes:
                return ("channel_space", cname)
    return None


def _advance(r, chans, stage_owner) -> bool:
    """Advance one pipeline as far as it can go; True if any stage ran."""
    ran = False
    while True:
        nxt = r.idx + 1
        if nxt >= len(r.spec.stages):
            r.done = True
            r.blocker = None
            return ran
        stage = r.spec.stages[nxt]
        b = _blocker(r, stage, nxt, chans, stage_owner)
        if b is not None:
            r.blocker = b
            return ran
        # run it: consume takes (retiring their bytes), emit puts
        for ck, stream, _port, src, _j in _bindings(stage, r, nxt):
            if isinstance(src, Channel):
                ach = chans[src.name]
                if ach.mode == "broadcast":
                    cur = ach.cursors.get(stream, 0)
                    ach.cursors[stream] = cur + 1
                else:
                    if ach.n_taken < len(ach.put_bytes):
                        ach.bytes_taken += ach.put_bytes[ach.n_taken]
                    ach.n_taken += 1
        for ch, nbytes in _stage_emissions(stage)[2]:
            ach = chans.setdefault(ch.name, _AbstractChannel(ch))
            ach.n_puts += 1
            ach.put_bytes.append(nbytes)
        r.idx = nxt
        r.blocker = None
        ran = True


def _classify_blocked(report, blocked, chans, stage_owner, producers,
                      consumers, no_producer):
    """Root-cause the fixpoint: who is stuck on a resource nobody can
    ever provide (E105/E106), who is in a genuine wait-for cycle
    (E104/E106)?  Pipelines blocked only downstream of a root cause are
    suppressed."""
    # helpers: the pipelines that could still unblock r
    def candidates(r):
        kind, key = r.blocker
        out = []
        if kind == "channel":
            for (pr, psi) in producers.get(key, []):
                if not pr.done and pr.idx < psi and pr is not r:
                    out.append(pr)
        elif kind == "channel_space":
            for (pr, psi) in consumers.get(key, []):
                if not pr.done and pr.idx < psi and pr is not r:
                    out.append(pr)
        elif kind == "future":
            owner = stage_owner.get(key)
            if owner is not None and not owner[0].done \
                    and owner[0] is not r:
                out.append(owner[0])
        return out

    cand = {r.name: candidates(r) for r in blocked}
    roots = [r for r in blocked if not cand[r.name]]
    for r in roots:
        kind, key = r.blocker
        si = r.idx + 1
        if kind == "channel":
            if key in no_producer:
                continue          # E102 already names the defect
            report.add("E105",
                       f"stage waits on channel {key!r} but every "
                       "producer has already run: the remaining takes "
                       "can never be satisfied", channel=key,
                       pipeline=r.name, stage=si)
        elif kind == "channel_space":
            report.add("E106",
                       f"bounded channel {key!r} is full and no "
                       "remaining stage consumes it: the producer is "
                       "wedged forever", channel=key, pipeline=r.name,
                       stage=si)
        else:
            sname = getattr(
                stage_owner.get(key, (None, None))[0], "name", "?")
            report.add("E103",
                       f"stage waits on a StageFuture whose producer "
                       f"({sname}) can never be submitted",
                       pipeline=r.name, stage=si)

    # cycles among the remaining blocked pipelines (every non-root has at
    # least one candidate, all of which are blocked, so any residue not
    # explained by a root must contain a cycle)
    root_names = {r.name for r in roots}
    index = {r.name: r for r in blocked}
    sccs = _sccs({r.name: [c.name for c in cand[r.name]]
                  for r in blocked if r.name not in root_names})
    reported = set()
    for comp in sccs:
        if len(comp) == 1:
            n = comp[0]
            if n not in [c.name for c in cand[n]]:
                continue              # not even a self-loop: secondary
        names = sorted(comp)
        key = tuple(names)
        if key in reported:
            continue
        reported.add(key)
        kinds = {index[n].blocker[0] for n in comp}
        chan_names = sorted({index[n].blocker[1] for n in comp
                             if index[n].blocker[0] != "future"})
        via = f" via channels {chan_names}" if chan_names else ""
        if "channel_space" in kinds:
            report.add("E106",
                       f"capacity deadlock: pipelines {names} block each "
                       f"other{via}; at least one is parked on "
                       "channel_space that only the others could free",
                       pipeline=names[0])
        else:
            report.add("E104",
                       f"pipelines {names} wait on each other in a "
                       f"cycle{via}: the DAG-of-ensembles has no "
                       "topological order", pipeline=names[0])


def _sccs(graph: Dict[str, List[str]]) -> List[List[str]]:
    """Tarjan SCCs of {node: [successors]}; successors outside the graph
    are ignored (they are roots, classified separately)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Dict[str, bool] = {}
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on[v] = True
        for w in graph.get(v, ()):
            if w not in graph:
                continue
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif on.get(w):
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on[w] = False
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for v in list(graph):
        if v not in index:
            strong(v)
    return out

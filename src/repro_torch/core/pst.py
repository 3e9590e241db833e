"""Composable Pipeline-Stage-Task (PST) workflow API with data-flow ports
(own copy of ``repro.core.pst``).

The seed mirrored the 2016 toolkit's subclass-hook pattern API
(``stage_1..stage_M`` via getattr, ``prepare_*`` overrides).  The second
generation toolkit ("Harnessing the Power of Many", arXiv:1710.08491)
replaced those hardcoded patterns with composable *data objects* because the
hook API structurally cannot express adaptive or coupled ensembles.  This
module is that redesign:

  TaskSpec      one executable unit: a bound Kernel + placement metadata
                (+ optional per-task data-flow ports).
  Stage         a set of concurrent TaskSpecs + an ``on_done`` adaptivity
                callback that may append stages or mutate the downstream
                pipeline when the stage completes, + declared ``inputs`` /
                ``outputs`` ports (core/flow.py) for cross-pipeline edges.
  PipelineSpec  an ordered list of Stages; stage k+1 starts when stage k
                finishes (a per-pipeline barrier — never a global one).
  AppManager    executes many pipelines concurrently over ONE long-lived
                PilotRuntime session (runtime/executor.RuntimeSession) with
                dynamic task injection, resolving every cross-pipeline port
                edge into task dependencies on the shared session — a true
                DAG-of-ensembles, not just shared-session concurrency.

Quickstart::

    sim = Stage([TaskSpec(k) for k in member_kernels], name="sim")
    def adapt(stage, pipe):
        if needs_more_sampling(stage.results):
            pipe.add_stage(make_refinement_stage(stage.results))
    ana = Stage([TaskSpec(ana_kernel)], name="analysis", on_done=adapt)
    profile = AppManager(pilot).run([PipelineSpec([sim, ana], name="e0"),
                                     PipelineSpec([...], name="e1")])

Coupling (see core/flow.py for the full producer -> analysis -> feedback
example): a Stage in pipeline B consumes a Stage in pipeline A either via a
``Channel`` (``outputs=[ch]`` / ``inputs={"traj": ch}``: FIFO stream, one
put per producing stage completion) or a ``StageFuture``
(``inputs={"traj": stage_a.future()}``: direct task dependencies).  The
consumer starts the moment its producer stage is done — while pipeline A's
later stages are still running.  A pipeline whose next stage's inputs are
not yet satisfiable parks and is woken by the producing event; pipelines
still parked when the session drains are reported ``blocked``.

The legacy patterns (Pipeline, BagOfTasks, ReplicaExchange,
SimulationAnalysisLoop) still work: their execution plugins are now thin
compilers from the hook API to port-annotated PST (core/execution_plugin.py).

Placement: tasks land on the pilot's abstract slots; each task kernel
places its own work (the port's ``lm.*`` kernels take a ``device``
argument).  ``ctx["submesh"]``, the device submesh of the slots granted to
a task, needs a runtime built with a device topology, which the port does
not have yet (ROADMAP A9; ``PilotRuntime(topology=...)`` raises).

Federation: ``AppManager`` also accepts a
:class:`repro_torch.federation.Fleet` as its runtime — the same application then late-binds every task across N
pilots (different slot counts/meshes, per-pilot journals, optional
backlog-driven recruiting) with no declaration change; the per-pilot
dispatch counts land in ``profile.results["federation"]``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

from repro_torch.core import flow
from repro_torch.core.flow import Channel, StageFuture
from repro_torch.core.kernel_plugin import Kernel
from repro_torch.runtime.states import Task, TaskState
from repro_torch.staging.ports import TaskStagingView, decode_refs, encode_refs
from repro_torch.staging.store import StagedRef

_MISSING = object()


@dataclass
class ExecutionProfile:
    """Paper eq. (1)-(2): TTC = T_exec + T_data + T_EnMD(core+pattern+rts)."""
    ttc: float = 0.0
    t_exec: float = 0.0
    t_data: float = 0.0
    t_core_overhead: float = 0.0
    t_pattern_overhead: float = 0.0
    t_rts_overhead: float = 0.0
    n_tasks: int = 0
    n_failed: int = 0
    n_canceled: int = 0
    n_retries: int = 0
    n_speculative: int = 0
    n_pod_lost: int = 0     # attempts lost to pod/worker failure
    n_preempted: int = 0    # attempts evicted for higher-priority work
    # busy slot-seconds accumulate here so utilization can be computed over
    # the WHOLE run at the end (not overwritten per cycle — that bug made
    # RE/SAL report only the last cycle's utilization)
    slot_busy: float = 0.0
    utilization: float = 0.0
    per_stage: Dict[str, Dict[str, float]] = field(default_factory=dict)
    results: Dict[str, Any] = field(default_factory=dict)

    @property
    def t_enmd_overhead(self) -> float:
        return (self.t_core_overhead + self.t_pattern_overhead
                + self.t_rts_overhead)

    def summary(self) -> Dict[str, float]:
        return {"ttc": self.ttc, "t_exec": self.t_exec,
                "t_data": self.t_data,
                "t_core_overhead": self.t_core_overhead,
                "t_pattern_overhead": self.t_pattern_overhead,
                "t_rts_overhead": self.t_rts_overhead,
                "n_tasks": self.n_tasks, "n_failed": self.n_failed,
                "utilization": self.utilization}


# ------------------------------------------------------------------ objects

@dataclass
class TaskSpec:
    """Kernel + slots + metadata (+ ports): what to run, how wide, labels.

    ``kernel`` is a :class:`Kernel` or a plugin name string; a string is
    resolved at submit time and an unknown name is rejected with
    diagnostic E107 (carrying the pipeline/stage/task location) before
    any task of the stage launches.

    ``name`` (optional) becomes the runtime task name verbatim — callers
    providing names are responsible for global uniqueness; unnamed specs get
    ``<pipeline>.<stage_idx>.<stage>.<index>`` (unique even when adaptive
    extension reuses a stage name).  Slot width comes from ``kernel.cores``.
    ``metadata`` keys ``instance`` and ``iteration`` land on the Task record
    (profiling labels); everything else rides along in ``task.meta``.

    ``inputs``/``outputs`` are per-TASK ports: an input Channel takes one
    put for this task alone; an output Channel receives this task's bare
    result the moment the task finishes (finer-grained streaming than the
    stage-level ports, which move ``{task: result}`` dicts per stage).

    ``stage_in``/``stage_out`` are data-staging declarations (values or
    callables / result-consuming callables).  They default to the kernel's
    legacy ``upload_input_data``/``download_output_data`` fields — the
    compile path from the 2016 staging directives — and are acted on only
    when the pilot runs with a ``repro_torch.staging.StagingLayer``: inputs are
    content-address-staged ONCE (N members sharing a blob link it), moved
    to each task's pod between ``pop_ready`` and launch, and delivered as
    ``ctx["staged_inputs"]``; every move is charged to ``t_data``.
    Without staging the kernel handles its own lists, exactly as before.

    ``sla`` names a serving SLA class (``latency`` | ``throughput``, see
    repro/serving/sla.py); an unknown name is rejected with diagnostic
    E115.  The class supplies the frontier ``priority`` (overridable
    explicitly) and a default ``deadline`` budget in seconds; both land on
    the Task (``task.priority`` / ``task.meta["deadline"]``) so the
    scheduler orders — and, with ``PilotRuntime(preempt=True)``, preempts —
    by them.
    """
    kernel: Union[Kernel, str]
    name: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)
    inputs: Any = None
    outputs: Any = None
    stage_in: Any = None
    stage_out: Any = None
    sla: Optional[str] = None
    priority: Optional[int] = None
    deadline: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.kernel, str):
            # named-kernel spec: resolved to a Kernel (and the staging
            # defaults below applied) at submit time, where an unknown
            # name is rejected with diagnostic E107
            return
        if self.stage_in is None:
            self.stage_in = self.kernel.upload_input_data
        if self.stage_out is None:
            self.stage_out = self.kernel.download_output_data


class Stage:
    """A set of concurrent tasks; completes when all of them are terminal.

    ``on_done(stage, pipeline)`` fires once at completion (only if no task
    failed) and may mutate the downstream graph: append stages via
    ``pipeline.add_stage`` / ``pipeline.extend`` or return an iterable of
    new stages.  ``stage.results`` maps task name -> result.

    ``inputs`` declares data-flow sources (``{port: Channel|StageFuture}``,
    or a list — see core/flow.py); kernels receive the bound values as
    ``ctx["inputs"][port]``.  ``outputs`` lists Channels that receive this
    stage's ``{task: result}`` dict when the stage completes.  A Stage is
    executed at most once by one AppManager (adaptive loops build a fresh
    Stage per cycle).
    """

    def __init__(self, tasks: Iterable[Union[TaskSpec, Kernel]] = (), *,
                 name: str = "",
                 inputs: Any = None, outputs: Any = None,
                 stage_in: Any = None, stage_out: Any = None,
                 on_done: Optional[Callable[["Stage", "PipelineSpec"],
                                            Any]] = None):
        self.name = name
        self.tasks: List[TaskSpec] = [
            t if isinstance(t, TaskSpec) else TaskSpec(t) for t in tasks]
        self.inputs = inputs
        self.outputs = outputs
        # stage-level staging declarations: shared by EVERY task of the
        # stage (one content-addressed blob, N links); out-callables run
        # once with the stage's {task: result} dict
        self.stage_in = list(stage_in) if stage_in else []
        self.stage_out = list(stage_out) if stage_out else []
        self.on_done = on_done
        self.results: Dict[str, Any] = {}
        self.n_failed = 0
        # set by the AppManager when the stage is submitted
        self.task_names: Optional[List[str]] = None
        self.bound_inputs: Dict[str, Any] = {}   # channel ports, concrete
        self._future_ports: List = []            # (port, StageFuture), lazy
        self._port_deps: List[str] = []          # producer task names

    def add(self, task: Union[TaskSpec, Kernel]) -> TaskSpec:
        spec = task if isinstance(task, TaskSpec) else TaskSpec(task)
        self.tasks.append(spec)
        return spec

    def future(self, port: str = "") -> StageFuture:
        """Cross-pipeline handle to this stage's eventual results."""
        return StageFuture(self, port)

    def __repr__(self):
        return f"Stage({self.name!r}, {len(self.tasks)} tasks)"


class PipelineSpec:
    """Ordered stages executed with a per-pipeline barrier between them.

    The stage list may grow while the pipeline runs (adaptivity): appending
    from an ``on_done`` callback extends this pipeline without touching any
    other pipeline running on the same AppManager.
    """

    def __init__(self, stages: Iterable[Stage] = (), *, name: str = ""):
        self.name = name
        self.stages: List[Stage] = list(stages)

    def add_stage(self, stage: Stage) -> Stage:
        self.stages.append(stage)
        return stage

    def extend(self, stages: Iterable[Stage]):
        self.stages.extend(stages)

    def __repr__(self):
        return f"PipelineSpec({self.name!r}, {len(self.stages)} stages)"


# ------------------------------------------------------------------ manager

class _PipelineRun:
    """Execution-time state of one pipeline on an AppManager."""

    def __init__(self, spec: PipelineSpec, name: str):
        self.spec = spec
        self.name = name
        self.idx = -1                 # index of the currently running stage
        # pending | running | waiting | done | failed | blocked
        self.state = "pending"
        self.waiting_on: Optional[str] = None
        self.pending: set = set()     # outstanding task names, current stage
        self.stage_task_names: List[List[str]] = []


class AppManager:
    """Run many PST pipelines concurrently over one pilot session.

    Accepts a ``Pilot`` (core.resource_handler) or a bare ``PilotRuntime``.
    All pipelines share the runtime's slots; each advances independently —
    stage k+1 of pipeline A is injected into the live session the moment
    stage k completes, regardless of what B is doing (no global barrier, no
    per-cycle graph teardown).  Port declarations (core/flow.py) couple
    pipelines into a DAG-of-ensembles resolved on the same session.

    ``strategy`` (runtime/strategy.AdaptiveSlotStrategy) is applied at every
    stage completion with the LIVE per-pipeline queue depths, so the pilot
    elastically grows into a backlog and shrinks when pipelines idle —
    within one session, not just between runs.
    """

    def __init__(self, pilot, *, profile: Optional[ExecutionProfile] = None,
                 strategy=None):
        if hasattr(pilot, "runtime"):
            self.pilot = pilot
            self.runtime = pilot.runtime
        else:
            self.pilot = None
            self.runtime = pilot
        self.profile = profile if profile is not None else ExecutionProfile()
        self.strategy = strategy
        # the pilot's staging layer (repro_torch.staging), when configured:
        # large channel puts become StagedRefs, dereferenced back into
        # ctx["inputs"] between pop_ready and kernel launch
        self.staging = getattr(self.runtime, "staging", None)
        self._kernels: Dict[str, Kernel] = {}
        self._task_index: Dict[str, _PipelineRun] = {}
        self._stage_of: Dict[str, Stage] = {}
        self._spec_of: Dict[str, TaskSpec] = {}
        self._task_bound: Dict[str, Dict[str, Any]] = {}
        self._task_futures: Dict[str, List] = {}
        self.session = None            # live RuntimeSession while running
        self.pipeline_runs: Dict[str, _PipelineRun] = {}
        # data-flow state: registered channels, parked pipelines, and the
        # journal's replayed puts/takes (restart determinism; loaded
        # lazily on first port use so port-free workloads never pay a
        # second journal parse on top of the session's load_done)
        self.channels: Dict[str, Channel] = {}
        self._parked: Dict[Any, List[_PipelineRun]] = {}
        self._replayed_puts: Optional[Dict] = None
        self._replayed_takes: Optional[Dict] = None
        # wakes raised while a stage is mid-submission are DEFERRED until
        # the outermost submission completes: a wake delivered between two
        # of a stage's counted takes could reentrantly submit another
        # consumer that steals the puts this stage's blocker check already
        # counted (-> LookupError mid-bind)
        self._advance_depth = 0
        self._pending_wakes: List[Any] = []

    # ------------------------------------------------------------ build
    def _make_run(self, kernel: Kernel, stage: Stage):
        if self.runtime.mode != "real":
            return None

        def run(task: Task, _k=kernel, _stage=stage):
            ctx = {"pilot": self.pilot, "runtime": self.runtime,
                   "task": task,
                   "dep_results": task.meta.get("dep_results", {}),
                   "inputs": self._bound_inputs_for(task, _stage)}
            if self.runtime.topology is not None \
                    and task.meta.get("slot_ids"):
                ctx["submesh"] = self.runtime.submesh_for(task)
            if self.staging is not None:
                ctx["staging_managed"] = True
                ctx["staging"] = TaskStagingView(self.staging, task)
                # always present under management, as the unmanaged
                # kernel path guarantees (kernels index it unconditionally)
                ctx["staged_inputs"] = task.meta.get("staged_in_values",
                                                     [])
            return _k.execute(ctx)

        return run

    def _resolve_ref(self, task: Task, value: Any) -> Any:
        """Top-level staged refs bound to a port dereference to the value
        the stage-in pass landed at this task's pod; refs NESTED inside a
        payload stay lazy (a consumer reading only scalar fields never
        pays for the bulk ones — it derefs via ``ctx["staging"]``)."""
        if self.staging is not None and isinstance(value, StagedRef):
            return self.staging.resolve(task, value)
        return value

    def _bound_inputs_for(self, task: Task, stage: Stage) -> Dict[str, Any]:
        """Concrete port values for one task: channel takes were bound at
        submission (staged refs dereference here, after the executor's
        stage-in pass moved them pod-local); StageFuture ports resolve now
        (their producer tasks are dependencies, so the results are
        complete by execution time)."""
        inputs = {p: self._resolve_ref(task, v)
                  for p, v in stage.bound_inputs.items()}
        for port, fut in stage._future_ports:
            inputs[port] = dict(fut.stage.results)
        for p, v in self._task_bound.get(task.name, {}).items():
            inputs[p] = self._resolve_ref(task, v)
        for port, fut in self._task_futures.get(task.name, ()):
            inputs[port] = dict(fut.stage.results)
        return inputs

    def _build_task(self, spec: TaskSpec, pr: _PipelineRun, stage: Stage,
                    stage_idx: int, j: int, deps: List[str]) -> Task:
        k = spec.kernel
        stage_label = stage.name or f"stage{stage_idx}"
        # stage_idx keeps auto-names unique when a stage NAME repeats
        # across appended cycles (the adaptive extension pattern)
        name = spec.name or f"{pr.name}.{stage_idx:04d}.{stage_label}.{j:05d}"
        port_deps = self._bind_task_ports(spec, pr, name, stage_idx, j)
        all_deps = list(dict.fromkeys(
            [*deps, *stage._port_deps, *port_deps]))
        # deferred import: repro_torch.serving sits above core in the layering
        from repro_torch.serving.sla import resolve_sla
        priority, deadline = resolve_sla(spec)
        t = Task(name=name, run=self._make_run(k, stage),
                 duration=(k.sim_duration or 0.0), slots=k.cores,
                 deps=all_deps, stage=stage_label,
                 instance=int(spec.metadata.get("instance", j)),
                 iteration=int(spec.metadata.get("iteration", 0)),
                 idempotent=k.idempotent, priority=priority)
        t.meta["pipeline"] = pr.name
        if spec.sla is not None:
            t.meta["sla"] = spec.sla
        if deadline is not None:
            t.meta["deadline"] = deadline
        extra = {kk: v for kk, v in spec.metadata.items()
                 if kk not in ("instance", "iteration")}
        if extra:
            t.meta["spec"] = extra
        if self.staging is not None:
            self._build_staging_manifest(t, spec, stage)
        self._kernels[name] = k
        self._task_index[name] = pr
        self._stage_of[name] = stage
        self._spec_of[name] = spec
        return t

    # ------------------------------------------------------------ ports
    def _ensure_flow_loaded(self):
        if self._replayed_puts is None:
            self._replayed_puts, self._replayed_takes = \
                self.runtime.journal.load_flow()

    def _register_channel(self, ch: Channel):
        self._ensure_flow_loaded()
        cur = self.channels.get(ch.name)
        if cur is None:
            if ch.capacity_bytes is not None and self.staging is None:
                # byte budgets meter *staged* payload bytes; without a
                # staging layer no put carries a size and the budget would
                # silently never park anyone
                from repro_torch.analysis.diagnostics import (Diagnostic,
                                                        DiagnosticError)
                raise DiagnosticError([Diagnostic(
                    "E115",
                    f"channel {ch.name!r} declares capacity_bytes="
                    f"{ch.capacity_bytes} but the pilot has no staging "
                    "layer (PilotRuntime(staging=StagingLayer(...))) — "
                    "puts carry no byte sizes to meter")])
            self.channels[ch.name] = ch
            # reserve journaled put->consumer bindings so a replayed take
            # always re-binds to ITS producer, never a FIFO steal
            for (cname, ck), pk in self._replayed_takes.items():
                if cname == ch.name:
                    ch._reserved[pk] = ck
            tr = getattr(self.runtime, "tracer", None)
            if tr is not None:
                tr.metrics.gauge(f"channel_backlog:{ch.name}",
                                 ch.n_unconsumed)
                tr.metrics.gauge(f"channel_backlog_bytes:{ch.name}",
                                 ch.n_unconsumed_bytes)
        elif cur is not ch:
            raise ValueError(
                f"two different Channel objects named {ch.name!r} on one "
                "AppManager")

    def _iter_bindings(self, stage: Stage, pr: _PipelineRun, idx: int):
        """Yield (consumer_key, stream, port, source, task_j) for every
        declared input of the stage and its task specs.  The *stream* id
        omits the stage index: a pipeline's successive bindings of one
        port form one broadcast cursor."""
        for port, src in flow.normalize_sources(stage.inputs).items():
            yield (f"{pr.name}:{idx:04d}:{port}",
                   f"{pr.name}:{port}", port, src, None)
        for j, spec in enumerate(stage.tasks):
            for port, src in flow.normalize_sources(spec.inputs).items():
                yield (f"{pr.name}:{idx:04d}:{j:05d}:{port}",
                       f"{pr.name}:{j:05d}:{port}", port, src, j)

    def _input_blocker(self, stage: Stage, pr: _PipelineRun, idx: int):
        """First unsatisfiable input — or full output channel
        (back-pressure) — as ``(parking_key, description)``; None when the
        stage can submit right now."""
        fresh: Dict[str, int] = {}
        own_takes: Dict[str, int] = {}    # this stage's own consumption
        for ck, stream, port, src, _j in self._iter_bindings(stage, pr,
                                                             idx):
            if isinstance(src, Channel):
                self._register_channel(src)
                src.touch(stream)
                own_takes[src.name] = own_takes.get(src.name, 0) + 1
                pk = self._replayed_takes.get((src.name, ck))
                if pk is not None:
                    i = src._index.get(pk)
                    if i is None or (src.mode != "broadcast"
                                     and i in src._taken):
                        return (("channel", src.name),
                                f"channel:{src.name}")
                elif src.mode == "broadcast":
                    if src.n_available(ck, stream) < 1:
                        return (("channel", src.name),
                                f"channel:{src.name}")
                else:
                    fresh[src.name] = fresh.get(src.name, 0) + 1
            elif isinstance(src, StageFuture):
                if not src.submitted:
                    return (("future", id(src.stage)),
                            f"stage:{getattr(src.stage, 'name', '?')}")
            else:
                raise TypeError(f"input port {port!r}: expected Channel or "
                                f"StageFuture, got {type(src).__name__}")
        for cname, n in fresh.items():
            if self.channels[cname].n_available("") < n:
                return (("channel", cname), f"channel:{cname}")
        # back-pressure: park the producer when admitting this stage would
        # leave the channel above `capacity` unconsumed puts — or above
        # `capacity_bytes` unconsumed payload bytes — counting what the
        # stage itself will emit (a stage of N task-level outputs bursts
        # N puts between blocker checks; emitted bytes come from the
        # kernels' declared output_nbytes, resolved before this runs).
        # Two carve-outs keep progress: the stage's OWN takes from that
        # channel are credited (a feedback stage consuming and producing
        # one bounded channel must not deadlock on itself), and a fully
        # drained channel always admits one stage even when its burst
        # alone exceeds the limit.
        emits: Dict[str, int] = {}
        emit_bytes: Dict[str, int] = {}
        stage_nbytes = sum(int(getattr(s.kernel, "output_nbytes", 0) or 0)
                           for s in stage.tasks)
        for ch in flow.normalize_outputs(stage.outputs):
            self._register_channel(ch)
            emits[ch.name] = emits.get(ch.name, 0) + 1
            emit_bytes[ch.name] = emit_bytes.get(ch.name, 0) + stage_nbytes
        for s in stage.tasks:
            for ch in flow.normalize_outputs(s.outputs):
                self._register_channel(ch)
                emits[ch.name] = emits.get(ch.name, 0) + 1
                emit_bytes[ch.name] = emit_bytes.get(ch.name, 0) + \
                    int(getattr(s.kernel, "output_nbytes", 0) or 0)
        for name, n_emit in emits.items():
            ch = self.channels[name]
            if ch.capacity is not None:
                backlog = ch.n_unconsumed() - own_takes.get(name, 0)
                if backlog > 0 and backlog + n_emit > ch.capacity:
                    return (("channel_space", name),
                            f"channel_space:{name}")
            if ch.capacity_bytes is not None:
                credit = self._own_take_byte_credit(
                    ch, own_takes.get(name, 0))
                backlog_b = ch.n_unconsumed_bytes() - credit
                if backlog_b > 0 and \
                        backlog_b + emit_bytes[name] > ch.capacity_bytes:
                    return (("channel_space", name),
                            f"channel_space:{name}")
        return None

    @staticmethod
    def _own_take_byte_credit(ch: Channel, n_takes: int) -> int:
        """Bytes of the puts this stage's own takes are about to retire
        (fifo binds the oldest candidates) — credited against the byte
        backlog so a self-feeding stage cannot park on its own input."""
        if n_takes <= 0 or ch.mode == "broadcast":
            return 0
        credit = 0
        for idx in ch._fifo_candidates(""):
            credit += ch._byte_prefix[idx + 1] - ch._byte_prefix[idx]
            n_takes -= 1
            if n_takes == 0:
                break
        return credit

    def _take(self, ch: Channel, ck: str, stream: Optional[str] = None,
              n_consumers: int = 1) -> Any:
        pk = self._replayed_takes.get((ch.name, ck))
        producer, value = ch.take(ck, pk, stream)
        is_ref = isinstance(value, StagedRef)
        self.runtime.journal.record_flow(
            "channel_take", ch.name, producer, consumer=ck,
            digest=value.digest if is_ref else None)
        if self.staging is not None and is_ref:
            self.staging.on_take(value, n_consumers=n_consumers,
                                 broadcast=ch.mode == "broadcast")
        # a take frees channel space: wake producers parked on capacity
        self._wake(("channel_space", ch.name))
        return value

    def _bind_stage_inputs(self, stage: Stage, pr: _PipelineRun, idx: int):
        stage.bound_inputs = {}
        stage._future_ports = []
        stage._port_deps = []
        for port, src in flow.normalize_sources(stage.inputs).items():
            if isinstance(src, Channel):
                ck = f"{pr.name}:{idx:04d}:{port}"
                stage.bound_inputs[port] = self._take(
                    src, ck, f"{pr.name}:{port}",
                    n_consumers=len(stage.tasks))
            else:
                stage._future_ports.append((port, src))
                stage._port_deps.extend(src.stage.task_names)

    def _bind_task_ports(self, spec: TaskSpec, pr: _PipelineRun, name: str,
                         idx: int, j: int) -> List[str]:
        port_deps: List[str] = []
        for port, src in flow.normalize_sources(spec.inputs).items():
            if isinstance(src, Channel):
                ck = f"{pr.name}:{idx:04d}:{j:05d}:{port}"
                self._task_bound.setdefault(name, {})[port] = \
                    self._take(src, ck, f"{pr.name}:{j:05d}:{port}")
            else:
                self._task_futures.setdefault(name, []).append((port, src))
                port_deps.extend(src.stage.task_names)
        return port_deps

    # ------------------------------------------------------------ staging
    def _build_staging_manifest(self, t: Task, spec: TaskSpec,
                                stage: Stage):
        """Collect the task's staged refs (bound channel payloads +
        stage_in declarations) into ``task.meta["staged_refs"]`` — the
        executor's stage-in pass transfers them to the task's granted pod
        between ``pop_ready`` and kernel launch."""
        for port, v in stage.bound_inputs.items():
            if isinstance(v, StagedRef):
                self.staging.manifest_input(t, port, v)
        for port, v in self._task_bound.get(t.name, {}).items():
            if isinstance(v, StagedRef):
                self.staging.manifest_input(t, port, v)
        for item in [*stage.stage_in, *(spec.stage_in or ())]:
            self.staging.acquire_stage_in(t, item)

    def _producer_hints(self, task_names):
        """(locations, declared nbytes) of a completed producer stage —
        where its members ran (each member's piece is replicated there)
        and, for DES mode, how big the combined payload is declared."""
        if self.staging is None:
            return [], 0
        locs: List[str] = []
        nbytes = 0
        for nm in task_names or ():
            task = self.session.graph.tasks.get(nm) if self.session else \
                None
            if task is not None:
                loc = self.staging.location_for(task)
                if loc not in locs:
                    locs.append(loc)
            k = self._kernels.get(nm)
            if k is not None and k.output_nbytes:
                nbytes += int(k.output_nbytes)
        return locs, nbytes

    def _run_stage_out(self, outs, payload):
        """Invoke stage_out callables (the legacy download_output_data
        path under staging management), charged to t_data.  Real mode
        only — DES tasks execute nothing, so there is no result to stage
        out (and a callable would crash on the None placeholder)."""
        if self.runtime.mode != "real":
            return
        callables = [d for d in (outs or ()) if callable(d)]
        if not callables:
            return
        t0 = time.perf_counter()
        for d in callables:
            d(payload)
        self.profile.t_data += time.perf_counter() - t0

    def _put(self, ch: Channel, pk: str, fresh_value, *,
             task_level: bool = False, nbytes_hint: int = 0,
             locations=()):
        """The one put-with-replay protocol: journaled values override the
        freshly computed one, the put is recorded, waiters wake.  With a
        staging layer, large fresh payloads are staged and the REF is what
        travels (journaled with its digest, so restarts replay refs
        without re-staging); in DES mode a declared ``nbytes_hint`` stages
        a virtual ref so t_data is modeled without payloads."""
        self._register_channel(ch)
        if ch.has_put(pk):
            return
        value = self._replayed_puts.get((ch.name, pk), _MISSING)
        replayed = value is not _MISSING
        if not replayed:
            value = fresh_value
        elif self.staging is not None:
            value = decode_refs(value)
        check = self.runtime.mode == "real"
        if self.staging is not None and not replayed:
            if check and not isinstance(value, StagedRef):
                ch.check(value, task_level=task_level)   # pre-staging
                check = False
                value = self.staging.stage_payload(value, list(locations))
            elif self.runtime.mode == "sim" and nbytes_hint:
                ref = self.staging.stage_virtual(
                    f"{ch.name}:{pk}", nbytes_hint, list(locations))
                if ref is not None:
                    value = ref
        is_ref = isinstance(value, StagedRef)
        ch.put(pk, value, task_level=task_level,
               check=check and not is_ref,
               nbytes=value.nbytes if is_ref else int(nbytes_hint or 0))
        # a journaled ref is only replayable when its payload outlives the
        # process: a write-through spill file (real mode) or virtual-ref
        # metadata (sim).  Otherwise journal the payload itself, so a
        # restart replays by value (and re-stages fresh)
        ref_durable = is_ref and (
            self.runtime.mode == "sim"
            or self.staging.store.spill_dir is not None)
        if is_ref and not ref_durable:
            journal_value = fresh_value
        elif self.staging is not None:
            journal_value = encode_refs(value)
        else:
            journal_value = value
        self.runtime.journal.record_flow(
            "channel_put", ch.name, pk, value=journal_value,
            digest=value.digest if is_ref else None,
            nbytes=value.nbytes if is_ref else None,
            mode=ch.mode)
        self._wake(("channel", ch.name))

    def _emit_outputs(self, stage: Stage, pr: _PipelineRun, idx: int):
        """Stage completed: put its {task: result} dict on every declared
        output channel."""
        outs = flow.normalize_outputs(stage.outputs)
        if self.staging is not None and stage.stage_out and any(
                self.session.graph.tasks[nm].attempts
                for nm in stage.task_names or ()):
            # skipped when the whole stage replayed from the journal:
            # its downloads ran before the restart
            self._run_stage_out(stage.stage_out, dict(stage.results))
        if not outs:
            return
        locations, nbytes = self._producer_hints(stage.task_names)
        for ch in outs:
            self._put(ch, f"{pr.name}:{idx:04d}", dict(stage.results),
                      nbytes_hint=nbytes, locations=locations)

    def _emit_task_outputs(self, task: Task, spec: TaskSpec):
        outs = flow.normalize_outputs(spec.outputs)
        if not outs:
            return
        locations, nbytes = self._producer_hints([task.name])
        for ch in outs:
            self._put(ch, task.name, task.result, task_level=True,
                      nbytes_hint=nbytes, locations=locations)

    def _wake(self, key):
        """Re-attempt submission of pipelines parked on ``key`` (they
        re-park on their next unsatisfied input, if any).  Only "waiting"
        pipelines wake: a pipeline marked "blocked" belongs to a drained
        session whose task graph is gone — resubmitting its stages into a
        later run's fresh session would reference dead dependency names.

        Wakes raised while another pipeline is mid-submission queue up and
        drain when the outermost submission returns (see ``_advance_depth``
        above)."""
        self._pending_wakes.append(key)
        if self._advance_depth == 0:
            self._drain_wakes()

    def _drain_wakes(self):
        while self._pending_wakes:
            key = self._pending_wakes.pop(0)
            for pr in self._parked.pop(key, []):
                if pr.state == "waiting":
                    self._submit_next_stage(pr, dynamic=True)

    # ------------------------------------------------------------ advance
    def _resolve_kernels(self, stage: Stage, pr: _PipelineRun, idx: int):
        """Resolve named-kernel specs (``TaskSpec(kernel="...")``) to
        Kernel instances, applying the staging defaults the dataclass
        deferred; an unknown name raises E107 with its full pipeline/
        stage/task location — at submit time, before any task of the
        stage (or of a stage parked behind it) launches."""
        from repro_torch.core.kernel_plugin import kernel_registered
        from repro_torch.serving.sla import CLASSES
        for j, spec in enumerate(stage.tasks):
            if spec.sla is not None and spec.sla not in CLASSES:
                from repro_torch.analysis.diagnostics import (Diagnostic,
                                                        DiagnosticError)
                raise DiagnosticError([Diagnostic(
                    "E115",
                    f"unknown SLA class {spec.sla!r} (known: "
                    f"{', '.join(sorted(CLASSES))})",
                    pipeline=pr.name, stage=idx,
                    task=spec.name or f"{stage.name or idx}[{j}]")])
            if not isinstance(spec.kernel, str):
                continue
            kname = spec.kernel
            if not kernel_registered(kname):
                from repro_torch.analysis.diagnostics import (Diagnostic,
                                                        DiagnosticError)
                raise DiagnosticError([Diagnostic(
                    "E107",
                    f"kernel {kname!r} matches no registered plugin "
                    "(kernel_names() lists the registry)",
                    pipeline=pr.name, stage=idx,
                    task=spec.name or f"{stage.name or idx}[{j}]")])
            spec.kernel = Kernel(kname)
            if spec.stage_in is None:
                spec.stage_in = spec.kernel.upload_input_data
            if spec.stage_out is None:
                spec.stage_out = spec.kernel.download_output_data

    def _submit_next_stage(self, pr: _PipelineRun, *, dynamic: bool):
        self._advance_depth += 1
        try:
            self._submit_next_stage_inner(pr, dynamic=dynamic)
        finally:
            self._advance_depth -= 1
        if self._advance_depth == 0:
            self._drain_wakes()

    def _submit_next_stage_inner(self, pr: _PipelineRun, *, dynamic: bool):
        """Submit pr's next stage; parks the pipeline when its inputs are
        not yet satisfiable; skips through empty (control-only) stages,
        firing their on_done inline."""
        while True:
            nxt = pr.idx + 1
            if nxt >= len(pr.spec.stages):
                pr.state = "done"
                return
            stage = pr.spec.stages[nxt]
            self._resolve_kernels(stage, pr, nxt)
            if self.staging is None and (stage.stage_in or stage.stage_out):
                # stage-level declarations have no kernel-side fallback
                # (unlike TaskSpec's, which default FROM the kernel's own
                # upload/download lists) — ignoring them silently would
                # drop declared inputs
                raise ValueError(
                    f"stage {stage.name!r} declares stage_in/stage_out "
                    "but the pilot has no staging layer "
                    "(PilotRuntime(staging=StagingLayer(...)))")
            blocker = self._input_blocker(stage, pr, nxt)
            if blocker is not None:
                key, desc = blocker
                pr.state = "waiting"
                pr.waiting_on = desc
                self._parked.setdefault(key, []).append(pr)
                self._note_park(pr, desc)
                return
            pr.idx = nxt
            pr.state = "running"
            pr.waiting_on = None
            self._note_unpark(pr)
            self._bind_stage_inputs(stage, pr, nxt)
            deps = pr.stage_task_names[-1] if pr.stage_task_names else []
            tasks = [self._build_task(spec, pr, stage, nxt, j, deps)
                     for j, spec in enumerate(stage.tasks)]
            stage.task_names = [t.name for t in tasks]
            if tasks:
                pr.pending = set(stage.task_names)
                pr.stage_task_names.append(list(stage.task_names))
                self.session.submit(tasks, dynamic=dynamic)
                # consumers waiting on this stage's submission (futures)
                self._wake(("future", id(stage)))
                return
            # empty stage: pure control point — emit, fire on_done, continue
            self._wake(("future", id(stage)))
            self._emit_outputs(stage, pr, nxt)
            self._fire_on_done(stage, pr)

    def _note_park(self, pr: _PipelineRun, desc: str):
        """Journal + trace a pipeline parking on an unsatisfiable input
        (span opens; :meth:`_note_unpark` closes it at the advance).  A
        pipeline still parked at drain end keeps an open span — the
        truncated-span convention, same as a preempted attempt."""
        pr._was_parked = True
        now = self.session._now() if self.session is not None else 0.0
        self.runtime.journal.record_event(
            "pipeline_parked", pipeline=pr.name, on=desc)
        tr = getattr(self.runtime, "tracer", None)
        if tr is not None:
            tr.begin(("park", pr.name), "park", pr.name, now,
                     pipeline=pr.name, on=desc)
            tr.metrics.inc("pipeline_parks")

    def _note_unpark(self, pr: _PipelineRun):
        if not getattr(pr, "_was_parked", False):
            return
        pr._was_parked = False
        now = self.session._now() if self.session is not None else 0.0
        self.runtime.journal.record_event("pipeline_woken",
                                          pipeline=pr.name)
        tr = getattr(self.runtime, "tracer", None)
        if tr is not None:
            tr.end(("park", pr.name), now, "woken")

    def _fire_on_done(self, stage: Stage, pr: _PipelineRun):
        if stage.on_done is None:
            return
        t0 = time.perf_counter()
        appended = stage.on_done(stage, pr.spec)
        if appended:
            pr.spec.extend(appended)
        self.profile.t_pattern_overhead += time.perf_counter() - t0

    def _on_task(self, task: Task, session):
        pr = self._task_index.get(task.name)
        if pr is None:
            return
        stage = self._stage_of[task.name]
        prof = self.profile
        if task.attempts:                 # executed (possibly failed): its
            k = self._kernels[task.name]  # staging/exec time is real cost
            prof.t_data += k.timings["data_in"] + k.timings["data_out"]
        st = prof.per_stage.setdefault(task.stage, {"n": 0, "t_exec": 0.0})
        st["n"] += 1
        st["t_exec"] += (task.duration if self.runtime.mode == "sim"
                         else max(task.t_finished - task.t_started
                                  - task.meta.get("t_data_kernel", 0.0),
                                  0.0))
        if task.t_data:
            st["t_data"] = st.get("t_data", 0.0) + task.t_data
        if task.state == TaskState.DONE:
            stage.results[task.name] = task.result
            prof.results.setdefault("tasks", {})[task.name] = task.result
            spec = self._spec_of[task.name]
            if self.staging is not None and task.attempts:
                # the kernel skipped its own download phase (staging
                # manages data movement): run the declarations here —
                # but NOT for journal-replayed tasks (attempts == 0),
                # whose downloads ran before the restart
                self._run_stage_out(spec.stage_out, task.result)
            self._emit_task_outputs(task, spec)
        else:
            stage.n_failed += 1
        pr.pending.discard(task.name)
        if pr.pending:
            return
        # stage complete
        if stage.n_failed:
            pr.state = "failed"
            return
        self._emit_outputs(stage, pr, pr.idx)    # puts before adaptivity
        self._fire_on_done(stage, pr)
        self._submit_next_stage(pr, dynamic=True)
        if self.strategy is not None:
            self._apply_strategy()

    # ------------------------------------------------------------ adaptive
    def _apply_strategy(self):
        """Feed the adaptive strategy from LIVE per-pipeline queue depth
        (submitted-but-not-started tasks), within the running session."""
        graph = self.session.graph
        backlogs = {
            p.name: sum(1 for nm in p.pending
                        if graph.tasks[nm].state == TaskState.NEW)
            for p in self.pipeline_runs.values()
            if p.state in ("running", "waiting")}
        backlog = sum(backlogs.values())
        slots = max(self.runtime.slots, 1)
        # demand-aware utilization: busy slots plus the queued work that
        # could fill them now (instantaneous busy alone reads 0 at a stage
        # boundary and would always vote shrink)
        utilization = min(1.0, (self.session.busy_slots + backlog) / slots)
        self.strategy.apply(self.pilot or self.runtime,
                            utilization=utilization, backlog=backlog,
                            per_pipeline=backlogs)

    # ------------------------------------------------------------ faults
    def _failure_counts(self, pr) -> Dict[str, int]:
        """Per-pipeline fault accounting read back from ``Task.history``:
        which ensemble members failed, how often they retried, and how
        many attempts a pod/worker death cost them."""
        tasks = self.session.graph.tasks
        n_failed = n_retries = n_pod_lost = 0
        for names in pr.stage_task_names:
            for nm in names:
                t = tasks.get(nm)
                if t is None:
                    continue
                if t.state == TaskState.FAILED:
                    n_failed += 1
                n_retries += max(t.attempts - 1, 0)
                n_pod_lost += sum(
                    1 for h in t.history
                    if h["outcome"] in ("pod_lost", "worker_died",
                                        "heartbeat_timeout"))
        return {"n_failed": n_failed, "n_retries": n_retries,
                "n_pod_lost": n_pod_lost}

    # ------------------------------------------------------------ run
    def run(self, pipelines: Union[PipelineSpec, Iterable[PipelineSpec]],
            *, validate: str = "warn") -> ExecutionProfile:
        """Execute the pipelines to completion; returns the aggregate
        profile (cumulative if a profile was passed in).

        ``validate`` gates the pre-flight linter (repro_torch.analysis) run over
        the declared specs BEFORE any task launches: ``"error"`` raises
        :class:`~repro_torch.analysis.diagnostics.DiagnosticError` on any E-code
        finding (nothing is submitted), ``"warn"`` (default) prints a
        one-line summary to stderr and proceeds, ``"off"`` skips the pass.
        The full report lands in ``profile.results["diagnostics"]``."""
        if validate not in ("error", "warn", "off"):
            raise ValueError(f"validate={validate!r}: "
                             "expected 'error', 'warn' or 'off'")
        pipes = ([pipelines] if isinstance(pipelines, PipelineSpec)
                 else list(pipelines))
        prof = self.profile
        if validate != "off":
            from repro_torch.analysis.validate import validate_app
            report = validate_app(
                pipes, runtime=self.runtime, channels=dict(self.channels),
                existing_pipelines=list(self.pipeline_runs))
            prof.results["diagnostics"] = [str(d) for d in
                                           report.diagnostics]
            if validate == "error":
                report.raise_if_errors()
            elif not report.ok:
                import sys
                print(f"repro_torch.analysis: {len(report.errors)} error(s), "
                      f"{len(report.warnings)} warning(s) in submitted "
                      "pipelines (validate='warn'; see "
                      "profile.results['diagnostics'])", file=sys.stderr)
        t0 = time.perf_counter()
        runs = []
        for p in pipes:
            name = p.name or f"p{len(self.pipeline_runs):04d}"
            if name in self.pipeline_runs:
                raise ValueError(f"duplicate pipeline name {name!r}")
            pr = _PipelineRun(p, name)
            self.pipeline_runs[name] = pr
            runs.append(pr)
        prof.t_pattern_overhead += time.perf_counter() - t0

        self.session = self.runtime.session(on_task_done=self._on_task)
        for pr in runs:
            self._submit_next_stage(pr, dynamic=False)
        rp = self.session.drain()

        # pipelines still parked when the session drained can never wake
        for pr in self.pipeline_runs.values():
            if pr.state == "waiting":
                pr.state = "blocked"

        prof.ttc += rp.ttc
        prof.t_exec += rp.t_exec
        prof.t_data += rp.t_data          # staged-ref transfer seconds
        prof.t_rts_overhead += rp.t_rts_overhead
        prof.n_tasks += rp.n_tasks
        prof.n_failed += rp.n_failed
        prof.n_canceled += rp.n_canceled
        prof.n_retries += rp.n_retries
        prof.n_speculative += rp.n_speculative
        prof.n_pod_lost += rp.n_pod_lost
        prof.n_preempted += rp.n_preempted
        prof.slot_busy += rp.slot_busy
        # utilization over the WHOLE session: busy slot-seconds / available
        # slot-seconds (accumulated, then computed once — not per cycle)
        prof.utilization = prof.slot_busy / (
            max(prof.ttc, 1e-12) * max(self.runtime.slots, 1))
        prof.results["pipelines"] = {
            pr.name: {"state": pr.state,
                      "n_stages": len(pr.spec.stages),
                      "n_tasks": sum(len(ns) for ns in pr.stage_task_names),
                      **self._failure_counts(pr),
                      **({"waiting_on": pr.waiting_on}
                         if pr.state == "blocked" else {})}
            for pr in self.pipeline_runs.values()}
        if self.staging is not None:
            prof.results["staging"] = self.staging.summary()
        if getattr(self.runtime, "pilots", None) is not None:
            # federated runtime (repro_torch.federation.Fleet): fleet shape,
            # recruiter activity, and where the dispatcher sent the work
            dispatch: Dict[str, int] = {}
            for t in self.session.graph.tasks.values():
                p = t.meta.get("pilot")
                if p is not None:
                    dispatch[p] = dispatch.get(p, 0) + 1
            prof.results["federation"] = {**self.runtime.summary(),
                                          "dispatch": dispatch}
        tr = getattr(self.runtime, "tracer", None)
        if tr is not None:
            prof.results["timeseries"] = tr.timeseries()
            prof.results["trace"] = tr.summary()
        return prof

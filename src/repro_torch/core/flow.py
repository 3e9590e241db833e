"""Typed data-flow ports: cross-pipeline coupling for PST workflows.

The PST API (core/pst.py) runs many pipelines over one pilot session, but
until this module a stage could only consume results from *its own*
pipeline's previous stage.  Ports turn that shared-session concurrency into
a true DAG-of-ensembles: a ``Stage`` (or ``TaskSpec``) declares ``inputs``
and ``outputs``, and the ``AppManager`` resolves every cross-pipeline edge
into task dependencies on the shared ``RuntimeSession`` — a consumer stage
in pipeline B starts the moment the producing stage in pipeline A is done,
while A's later stages are still running.

Two edge primitives:

  StageFuture   a handle to ONE specific stage's eventual results
                (``stage.future()``).  The consumer's tasks gain direct
                dependencies on the producer's tasks, so the consumer is
                submitted as soon as the producer stage is, and starts the
                instant the producer's last task finishes.
  Channel       a named, ordered stream decoupling producers from
                consumers.  Every completion of a producing stage ``put``s
                its results; each consumer binding ``take``s the oldest
                untaken put (FIFO work-queue).  Repeating producers (one
                put per cycle) feed repeating consumers without either side
                naming the other's stages.

Producer ensemble -> shared analysis ensemble -> feedback stage::

    from repro_torch.core import AppManager, PipelineSpec, Stage, TaskSpec
    from repro_torch.core.flow import Channel

    traj = Channel("trajectories", dtype=dict)   # typed: puts are checked
    weights = Channel("weights")

    # ensemble of simulators: each cycle's stage streams into `traj`
    prod = PipelineSpec(
        [Stage([TaskSpec(md_kernel(m)) for m in range(members)],
               name=f"cycle{c}", outputs=[traj])
         for c in range(cycles)], name="producer")

    # shared analysis ensemble: each round consumes ONE trajectory put —
    # round 0 starts while the producer is still on cycle 1
    ana = PipelineSpec(
        [Stage([TaskSpec(ana_kernel())], name=f"round{c}",
               inputs={"traj": traj}, outputs=[weights])
         for c in range(cycles)], name="analysis")

    # feedback: re-weights sampling from the analysis stream
    fb = PipelineSpec(
        [Stage([TaskSpec(fb_kernel())], name=f"fb{c}",
               inputs={"weights": weights}) for c in range(cycles)],
        name="feedback")

    AppManager(pilot).run([prod, ana, fb])

A consumer kernel receives its bound ports as ``ctx["inputs"]`` — for the
analysis kernel above, ``ctx["inputs"]["traj"]`` is the producing stage's
``{task_name: result}`` dict.  A pipeline whose next stage's inputs are not
yet satisfiable parks ("waiting") and is woken when the producer stage is
submitted (futures) or a put arrives (channels); pipelines still parked
when the session drains are reported ``blocked``.

Restart determinism: the journal records every ``channel_put`` (value) and
``channel_take`` (consumer -> producer binding).  On replay, puts reuse the
journaled value and takes re-bind to the journaled producer — consumer
stages see byte-identical inputs and no completed task re-executes (see
runtime/journal.py ``load_flow``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Port:
    """A named, optionally typed attachment point for data flow."""
    name: str
    dtype: Optional[type] = None


class TypedPortError(TypeError):
    """A put violated the channel's declared payload type."""


class Channel:
    """Named, ordered stream of stage/task outputs shared across pipelines.

    Producers are stages (put value = the stage's ``{task: result}`` dict)
    or single tasks (put value = the task's result).  ``dtype``, when set,
    is enforced per task result at put time.  A Channel belongs to one
    AppManager run topology; names must be unique within it.

    Consumption modes:

      fifo (default)  work-queue: each consumer binding takes the oldest
                      untaken put exactly once — N consumers SPLIT the
                      stream.
      broadcast       each consumer *stream* (one pipeline's successive
                      bindings of the port) keeps its own cursor over
                      EVERY put — N analysis ensembles each see every
                      trajectory.  Staged refs (repro_torch.staging) make the
                      fan-out cheap: one blob, N takes.

    ``capacity`` declares back-pressure: the AppManager parks a producer
    pipeline whose next stage would put onto a channel already holding
    ``capacity`` unconsumed puts, and wakes it on the next take (default
    None: unbounded, the historical behavior).

    ``capacity_bytes`` is the byte-denominated variant: each put carries a
    payload size (the AppManager passes the staged-ref ``nbytes``, or the
    producing kernels' declared ``output_nbytes`` in DES mode) and a
    producer parks while the channel's *unconsumed* bytes plus its next
    emission would exceed the budget.  This is what bounds staged-blob
    memory for streaming workloads (serving traffic windows) where put
    COUNT says nothing about footprint.  Both limits may be set; either
    parks the producer.
    """

    def __init__(self, name: str, dtype: Optional[type] = None, *,
                 capacity: Optional[int] = None,
                 capacity_bytes: Optional[int] = None, mode: str = "fifo"):
        if not name:
            raise ValueError("channel needs a non-empty name")
        if mode not in ("fifo", "broadcast"):
            raise ValueError(f"channel mode must be fifo|broadcast, "
                             f"got {mode!r}")
        if capacity is not None and capacity < 1:
            raise ValueError("channel capacity must be >= 1")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError("channel capacity_bytes must be >= 1")
        self.name = name
        self.dtype = dtype
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.mode = mode
        self.puts: List[Tuple[str, Any]] = []   # (producer_key, value)
        self._index: Dict[str, int] = {}        # producer_key -> put index
        self._taken: set = set()                # consumed put indices (fifo)
        self._scan_from = 0                     # first possibly-untaken idx
        # puts pre-bound to a consumer by journal replay (producer_key ->
        # consumer_key): invisible to fresh FIFO takes
        self._reserved: Dict[str, str] = {}
        # broadcast: consumer stream -> index of its next unread put
        self._cursors: Dict[str, int] = {}
        # byte accounting: per-put payload sizes as a prefix-sum (O(1)
        # unconsumed-bytes queries), bytes retired by fifo takes, and the
        # high-water mark the serving bench asserts against the budget
        self._byte_prefix: List[int] = [0]      # prefix[i] = bytes of puts[:i]
        self._bytes_taken = 0
        self.peak_unconsumed_bytes = 0

    @property
    def port(self) -> Port:
        return Port(self.name, self.dtype)

    def check(self, value: Any, *, task_level: bool = False):
        """Type-check a put payload.  Stage-level puts are ``{task:
        result}`` dicts (each result checked); task-level puts are one bare
        result (checked as-is — it may itself be a dict)."""
        if self.dtype is None:
            return
        if not task_level and not isinstance(value, dict):
            raise TypedPortError(
                f"channel {self.name!r}: stage-level puts must be "
                f"{{task: result}} dicts, got {type(value).__name__}")
        results = [value] if task_level else value.values()
        for r in results:
            if not isinstance(r, self.dtype):
                raise TypedPortError(
                    f"channel {self.name!r} expects {self.dtype.__name__} "
                    f"results, got {type(r).__name__}")

    def put(self, producer_key: str, value: Any, *,
            task_level: bool = False, check: bool = True,
            nbytes: int = 0) -> int:
        """``check=False`` skips the dtype check — the AppManager passes it
        in DES (sim) mode, where tasks run nothing and every result is
        None, so a typed channel would reject the placeholder payloads.
        ``nbytes`` is the payload size charged against ``capacity_bytes``
        (0 = untracked put)."""
        if producer_key in self._index:
            raise ValueError(f"channel {self.name!r}: duplicate put from "
                             f"{producer_key!r}")
        if check:
            self.check(value, task_level=task_level)
        self._index[producer_key] = len(self.puts)
        self.puts.append((producer_key, value))
        self._byte_prefix.append(self._byte_prefix[-1] + max(int(nbytes), 0))
        self.peak_unconsumed_bytes = max(self.peak_unconsumed_bytes,
                                         self.n_unconsumed_bytes())
        return self._index[producer_key]

    def has_put(self, producer_key: str) -> bool:
        return producer_key in self._index

    def _fifo_candidates(self, consumer_key: str):
        # amortized O(new puts): the cursor skips the fully-consumed prefix
        # (reserved-but-untaken replay puts can pin it, bounded by replay)
        while self._scan_from < len(self.puts) \
                and self._scan_from in self._taken:
            self._scan_from += 1
        for i in range(self._scan_from, len(self.puts)):
            if i in self._taken:
                continue
            if self._reserved.get(self.puts[i][0],
                                  consumer_key) != consumer_key:
                continue                        # held for a replayed taker
            yield i

    def n_available(self, consumer_key: str,
                    stream: Optional[str] = None) -> int:
        """Puts a fresh (non-replayed) take by ``consumer_key`` could bind.
        Broadcast channels count from the consumer stream's own cursor."""
        if self.mode == "broadcast":
            return len(self.puts) - self._cursors.get(
                stream or consumer_key, 0)
        return sum(1 for _ in self._fifo_candidates(consumer_key))

    def touch(self, stream: str):
        """Register a broadcast consumer stream (cursor at 0) so
        back-pressure counts it before its first take."""
        if self.mode == "broadcast":
            self._cursors.setdefault(stream, 0)

    def n_unconsumed(self) -> int:
        """Puts nobody has consumed yet — the back-pressure signal.
        Broadcast counts from the SLOWEST registered stream's cursor."""
        if self.mode == "broadcast":
            return len(self.puts) - (min(self._cursors.values())
                                     if self._cursors else 0)
        return len(self.puts) - len(self._taken)

    def n_unconsumed_bytes(self) -> int:
        """Payload bytes nobody has consumed yet — the byte-denominated
        back-pressure signal ``capacity_bytes`` parks producers on.
        Broadcast counts from the SLOWEST registered stream's cursor (a
        put's bytes are retained until every stream is past it)."""
        if self.mode == "broadcast":
            lo = min(self._cursors.values()) if self._cursors else 0
            return self._byte_prefix[-1] - self._byte_prefix[lo]
        return self._byte_prefix[-1] - self._bytes_taken

    def take(self, consumer_key: str, producer_key: Optional[str] = None,
             stream: Optional[str] = None) -> Tuple[str, Any]:
        """Consume one put: the journaled producer when replaying, else the
        oldest untaken put (fifo) / the stream's cursor (broadcast).
        Returns ``(producer_key, value)``."""
        if self.mode == "broadcast":
            s = stream or consumer_key
            if producer_key is not None:
                idx = self._index.get(producer_key)
                if idx is None:
                    raise LookupError(
                        f"channel {self.name!r}: put from {producer_key!r} "
                        "not available for replayed take")
            else:
                idx = self._cursors.get(s, 0)
                if idx >= len(self.puts):
                    raise LookupError(
                        f"channel {self.name!r}: no put available")
            self._cursors[s] = max(self._cursors.get(s, 0), idx + 1)
            return self.puts[idx]
        if producer_key is not None:
            idx = self._index.get(producer_key)
            if idx is None or idx in self._taken:
                raise LookupError(
                    f"channel {self.name!r}: put from {producer_key!r} "
                    "not available for replayed take")
        else:
            idx = next(self._fifo_candidates(consumer_key), None)
            if idx is None:
                raise LookupError(f"channel {self.name!r}: no put available")
        self._taken.add(idx)
        self._bytes_taken += \
            self._byte_prefix[idx + 1] - self._byte_prefix[idx]
        return self.puts[idx]

    def __repr__(self):
        consumed = (f"{len(self._cursors)} streams"
                    if self.mode == "broadcast"
                    else f"{len(self._taken)} taken")
        return f"Channel({self.name!r}, {len(self.puts)} puts, {consumed})"


class StageFuture:
    """Handle to one Stage's eventual results — a cross-pipeline edge.

    Created via ``Stage.future()``.  The consuming stage's tasks depend
    directly on the producer stage's tasks; at execution time the bound
    port resolves to the producer's ``{task: result}`` dict.
    """

    def __init__(self, stage, port: str = ""):
        self.stage = stage
        self.port = port or (getattr(stage, "name", "") or "stage")

    @property
    def submitted(self) -> bool:
        return getattr(self.stage, "task_names", None) is not None

    def __repr__(self):
        return f"StageFuture({self.stage!r})"


def normalize_sources(sources) -> Dict[str, Any]:
    """Normalize an ``inputs`` declaration to ``{port_name: source}``.

    Accepts None, a single Channel/StageFuture, an iterable of them (port
    name defaults to the channel name / producer stage name), or a dict.
    """
    if sources is None:
        return {}
    if isinstance(sources, dict):
        return dict(sources)
    if isinstance(sources, (Channel, StageFuture)):
        sources = [sources]
    out: Dict[str, Any] = {}
    for src in sources:
        port = src.name if isinstance(src, Channel) else src.port
        if port in out:
            raise ValueError(f"duplicate input port {port!r}")
        out[port] = src
    return out


def normalize_outputs(outputs) -> List[Channel]:
    """Normalize an ``outputs`` declaration to a list of Channels."""
    if outputs is None:
        return []
    if isinstance(outputs, Channel):
        return [outputs]
    chans = list(outputs)
    for ch in chans:
        if not isinstance(ch, Channel):
            raise TypeError(f"outputs must be Channels, got {type(ch)}")
    return chans

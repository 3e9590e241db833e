"""Port integration: staged refs through channels, tasks, and the journal.

``core/flow.py`` Channels move stage results by value; at fleet scale a
trajectory-sized payload copied through every put is invisible to profiles
and unbounded in memory.  The :class:`StagingLayer` here turns large puts
into :class:`StagedRef` handles (one content-addressed blob, N cheap takes)
and transparently dereferences them back into ``ctx["inputs"]`` between
``pop_ready`` and kernel launch — charging every move to ``t_data``.

Wiring (who calls what):

  AppManager (core/pst.py)
    - ``stage_payload``/``stage_virtual`` on channel put (real/DES mode)
    - ``on_take`` when a consumer binding takes a staged put
    - ``manifest_input``/``acquire_stage_in`` at task build: records the
      task's staged refs in ``task.meta["staged_refs"]``
    - ``resolve`` in the task closure: refs -> values (from the stage-in
      pass below)
  PilotRuntime / RuntimeSession (runtime/executor.py)
    - ``stage_in(task, mode)`` between ``pop_ready`` and kernel launch:
      plans + executes every transfer to the task's granted pod
    - ``preferred_ids``/``prefers`` for locality-aware slot grant and
      frontier ordering
    - ``finish(task)`` at terminal state: releases the task's holds
  Journal (runtime/journal.py)
    - ``encode_refs``/``decode_refs``: refs survive the JSONL round-trip,
      so a coupled restart replays refs WITHOUT re-staging payloads

Only top-level port payloads are dereferenced automatically; a
``StagedRef`` *nested inside* a result dict stays lazy — a consumer that
only reads scalar fields (e.g. ``re.exchange`` reading member losses)
never pays for the bulk field (see ``iter_refs``/kernel ``ctx["staging"]``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.staging.store import HOST, ObjectStore, StagedRef
from repro_torch.staging.transfer import LocalityMap, TransferPlanner

REF_KEY = "__staged_ref__"


# ---------------------------------------------------------------- encoding

def encode_refs(value: Any) -> Any:
    """JSON-encodable form: StagedRefs become marker dicts (recursing into
    dicts/lists); everything else passes through."""
    if isinstance(value, StagedRef):
        return {REF_KEY: [value.digest, value.nbytes,
                          list(value.locations)]}
    if isinstance(value, dict):
        return {k: encode_refs(v) for k, v in value.items()}
    if isinstance(value, list):
        return [encode_refs(v) for v in value]
    return value


def decode_refs(value: Any) -> Any:
    """Inverse of :func:`encode_refs` (applied to journal-replayed puts)."""
    if isinstance(value, dict):
        if set(value) == {REF_KEY}:
            d, n, locs = value[REF_KEY]
            return StagedRef(str(d), int(n), tuple(locs))
        return {k: decode_refs(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_refs(v) for v in value]
    return value


def iter_refs(value: Any) -> Iterator[StagedRef]:
    """Yield every StagedRef nested anywhere in ``value``."""
    if isinstance(value, StagedRef):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from iter_refs(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from iter_refs(v)


def payload_nbytes(value: Any) -> int:
    from repro_torch.staging.store import encode
    return len(encode(value))


# ---------------------------------------------------------------- the layer

class StagingLayer:
    """One staging policy bound to one PilotRuntime.

    ``threshold_bytes``: channel puts at or above it are staged (smaller
    payloads keep the pass-by-value fast path).  ``locality`` defaults to
    one pod per pilot slot when the runtime binds; ``prefer_local=False``
    disables locality-aware placement/ordering (the benchmark's "copy
    everywhere" baseline) while keeping accounting.
    """

    def __init__(self, *, store: Optional[ObjectStore] = None,
                 planner: Optional[TransferPlanner] = None,
                 locality: Optional[LocalityMap] = None,
                 threshold_bytes: int = 4096,
                 byte_budget: int = 256 << 20,
                 spill_dir: Optional[str] = None,
                 prefer_local: bool = True,
                 copy_gbps: float = 25.0, disk_gbps: float = 2.0):
        self.store = store if store is not None else \
            ObjectStore(byte_budget=byte_budget, spill_dir=spill_dir)
        self.locality = locality
        self.planner = planner if planner is not None else \
            TransferPlanner(self.store, locality,
                            copy_gbps=copy_gbps, disk_gbps=disk_gbps)
        if self.planner.locality is None:
            self.planner.locality = locality
        self.threshold_bytes = int(threshold_bytes)
        self.prefer_local = prefer_local
        self._lock = threading.RLock()

    # ------------------------------------------------------------ binding
    def bind_runtime(self, runtime):
        """Called by PilotRuntime.__init__: default the locality map to
        the pilot's slot count (one pod per slot) when none was given."""
        if self.locality is None:
            n = runtime.topology.n_slots if runtime.topology is not None \
                else runtime.slots
            self.locality = LocalityMap(n_slots=max(n, 1))
        if self.planner.locality is None:
            self.planner.locality = self.locality

    def location_for(self, task) -> str:
        if self.locality is None:
            return HOST
        return self.locality.location_for(task.meta.get("slot_ids"))

    # ------------------------------------------------------------ puts
    def stage_payload(self, value: Any, locations: List[str]):
        """Stage a channel put when it crosses the threshold; returns the
        StagedRef, or the value itself when it is small (or already a
        ref).  Stage-level puts register a replica at EVERY producing
        member's pod — each member's piece lives there."""
        if isinstance(value, StagedRef) or value is None:
            return value
        from repro_torch.staging.store import encode
        data = encode(value)                 # encoded ONCE: measures AND
        if len(data) < self.threshold_bytes:     # feeds the put below
            return value
        with self._lock:
            ref = self.store.put(value, location=(locations or [HOST])[0],
                                 data=data)
            for loc in (locations or [])[1:]:
                self.store.add_location(ref.digest, loc)
            locs = self.store.locations(ref.digest)
            return StagedRef(ref.digest, ref.nbytes, tuple(sorted(locs)))

    def stage_virtual(self, key: str, nbytes: int,
                      locations: List[str]) -> Optional[StagedRef]:
        """DES-mode put: a bookkeeping ref of declared size (no payload
        moves in sim).  Returns None when no size was declared."""
        if nbytes < max(self.threshold_bytes, 1):
            return None
        with self._lock:
            ref = self.store.put_virtual(key, nbytes,
                                         location=(locations or [HOST])[0])
            for loc in (locations or [])[1:]:
                self.store.add_location(ref.digest, loc)
            locs = self.store.locations(ref.digest)
            return StagedRef(ref.digest, ref.nbytes, tuple(sorted(locs)))

    # ------------------------------------------------------------ takes
    def on_take(self, ref: StagedRef, *, n_consumers: int,
                broadcast: bool):
        """Adjust holds when a consumer binding takes a staged put.

        FIFO: the channel's put hold transfers to the taker, so the blob
        dies when the LAST consumer task releases (retain n-1 extra).
        Broadcast: the channel keeps its hold (any future stream may still
        take); each consumer task gets its own hold (retain n).
        """
        with self._lock:
            extra = n_consumers if broadcast else n_consumers - 1
            if extra > 0:
                self.store.retain(ref, extra)
            elif extra < 0:                # 0-task (control) stage on FIFO
                self.store.release(ref)

    # ------------------------------------------------------------ manifests
    def manifest_input(self, task, port: str, ref: StagedRef):
        """Record that ``task`` needs ``ref`` dereferenced onto ``port``
        before launch (the executor's stage-in pass reads this)."""
        task.meta.setdefault("staged_refs", []).append(("input", port, ref))

    def acquire_stage_in(self, task, item: Any) -> StagedRef:
        """Stage one ``stage_in`` declaration for ``task``: put-or-retain
        by content, so N member tasks declaring the same input share ONE
        blob and each holds a reference."""
        value = item() if callable(item) else item
        with self._lock:
            ref = self.store.put(value, location=HOST)
        idx = sum(1 for e in task.meta.get("staged_refs", ())
                  if e[0] == "staged_in")
        task.meta.setdefault("staged_refs", []).append(
            ("staged_in", idx, ref))
        return ref

    def clone_manifest(self, orig, clone):
        """Route a speculative twin through the SAME staging manifests as
        its original: the clone holds its own reference on every ref (so
        either twin's terminal release is balanced) and its stage-in pass
        plans/executes — and charges to the clone's ``t_data`` — the same
        transfers, to the CLONE's granted pod."""
        entries = orig.meta.get("staged_refs") or []
        if not entries:
            return
        with self._lock:
            for _kind, _key, ref in entries:
                self.store.retain(ref)
        clone.meta["staged_refs"] = list(entries)

    # ------------------------------------------------------------ failures
    def on_pod_lost(self, pod: str):
        """The pod's memory is gone: invalidate its replicas.  Blobs keep
        serving from other replicas / host / spill — the next consumer in
        that pod copies instead of linking."""
        with self._lock:
            self.store.drop_location(pod)

    def on_topology_compacted(self, n_slots: int):
        """Shrink-recarve renumbered the slot ids: pod-keyed replica
        bookkeeping is stale wholesale (conservative reset — consumers
        fall back to host/spill copies), and the locality map re-keys to
        the new slot count."""
        with self._lock:
            self.store.drop_pod_locations()
            if self.locality is not None:
                # keep the pilot's pod-name prefix: a federated pilot that
                # compacts must not fall back into the shared unprefixed
                # namespace (its pods would alias another pilot's)
                self.locality = LocalityMap(
                    n_slots=max(n_slots, 1),
                    slots_per_pod=self.locality.slots_per_pod,
                    prefix=self.locality.prefix)
                self.planner.locality = self.locality

    # ------------------------------------------------------------ gc
    def gc_spill(self, journal=None, *, keep_durable: bool = True) -> int:
        """Session-close disk reclaim: delete zero-ref spill files the
        journal never references.  ``keep_durable=False`` drops the
        journal keep-set too (zero-ref files go regardless of journaled
        refs — ends restartability).  Returns files deleted."""
        referenced = (journal.load_digests()
                      if keep_durable and journal is not None
                      else frozenset())
        return self.store.gc_spill(referenced)

    # ------------------------------------------------------------ stage-in
    def stage_in(self, task, mode: str) -> float:
        """Execute every planned transfer for ``task`` to its granted pod.

        Runs between ``pop_ready`` and kernel launch (DES: on the drain
        loop before the finish-event push; real: on the worker thread
        before the kernel).  Returns the seconds charged to ``t_data`` —
        modeled cost in sim, measured wall time in real mode.  Dereferenced
        values land in ``task.meta["staged_values"]`` (by digest) and
        ``task.meta["staged_in_values"]`` (declaration order).
        """
        entries = task.meta.get("staged_refs")
        if not entries:
            return 0.0
        dst = self.location_for(task)
        t0 = time.perf_counter()
        modeled = 0.0
        values: Dict[str, Any] = task.meta.setdefault("staged_values", {})
        in_values: List[Any] = []
        transfers = []
        # plan under the lock (replica reads must be consistent); EXECUTE
        # outside it — worker threads copying different blobs must overlap
        # (the store and planner stats lock themselves)
        with self._lock:
            if mode == "sim":
                # a journal-replayed virtual ref has no live blob in the
                # restarted store; re-register it from the ref's own
                # metadata (virtual blobs carry no payload — only nbytes
                # and replica locations matter)
                for _kind, _key, ref in entries:
                    if not self.store.has(ref.digest):
                        self.store.register_virtual(ref)
            plans = [(kind, ref, self.planner.plan(ref, dst))
                     for kind, _key, ref in entries]
        for kind, ref, spec in plans:
            value = self.planner.execute(spec)
            modeled += spec.cost_s
            values[ref.digest] = value
            if kind == "staged_in":
                in_values.append(value)
            transfers.append({"digest": ref.digest[:10],
                              "nbytes": ref.nbytes, "mode": spec.mode,
                              "src": spec.src, "dst": spec.dst,
                              "cost_s": round(spec.cost_s, 6)})
        if in_values:
            task.meta["staged_in_values"] = in_values
        task.meta["transfers"] = \
            task.meta.get("transfers", []) + transfers
        t_data = (time.perf_counter() - t0) if mode == "real" else modeled
        task.t_data += t_data
        return t_data

    def resolve(self, task, value: Any) -> Any:
        """Top-level ref -> its staged-in value (nested refs stay lazy)."""
        if isinstance(value, StagedRef):
            staged = task.meta.get("staged_values", {})
            if value.digest in staged:
                return staged[value.digest]
            return self.store.get(value, location=self.location_for(task))
        return value

    def finish(self, task):
        """Terminal-state hook: drop the task's holds exactly once (a
        retried task keeps its refs until its FINAL attempt ends), and
        drop the decoded payloads pinned on the task — otherwise every
        consumer task would keep its inputs resident for the whole run,
        defeating the byte budget.  Returns the released digests (empty
        when this call was a no-op) so the executor can journal the
        release — the sanitizer's S303 balance check audits it."""
        entries = task.meta.get("staged_refs")
        if not entries or task.meta.get("staging_released"):
            return []
        task.meta["staging_released"] = True
        task.meta.pop("staged_values", None)
        task.meta.pop("staged_in_values", None)
        with self._lock:
            for _kind, _key, ref in entries:
                self.store.release(ref)
        return [ref.digest for _kind, _key, ref in entries]

    # ------------------------------------------------------------ placement
    def _ref_pods(self, task) -> set:
        pods = set()
        for _kind, _key, ref in task.meta.get("staged_refs", ()):
            pods |= self.store.locations(ref.digest) or set(ref.locations)
        return pods

    def preferred_ids(self, task, free_ids: List[int]) -> List[int]:
        """Order free slot ids so ids in pods that already hold the task's
        input replicas come first (locality-aware placement)."""
        if not self.prefer_local or self.locality is None \
                or not task.meta.get("staged_refs"):
            return list(free_ids)
        pods = self._ref_pods(task)
        if not pods:
            return list(free_ids)
        return sorted(free_ids,
                      key=lambda s: (self.locality.pod_of(s) not in pods, s))

    def prefers(self, task, free_ids: Optional[List[int]]) -> bool:
        """True when some free slot sits in a pod that already holds this
        task's inputs — the frontier scheduler runs such tasks first."""
        if not self.prefer_local or self.locality is None or not free_ids:
            return False
        pods = self._ref_pods(task)
        return bool(pods) and any(
            self.locality.pod_of(s) in pods for s in free_ids)

    # ------------------------------------------------------------ summary
    def summary(self) -> Dict[str, Any]:
        return {"store": dict(self.store.stats),
                "mem_bytes": self.store.mem_bytes,
                "peak_mem_bytes": self.store.peak_mem_bytes,
                "transfers": self.planner.summary()}


class TaskStagingView:
    """Per-task facade kernels see as ``ctx["staging"]``: explicit staging
    of bulk outputs (``put``) and lazy dereference of nested refs
    (``get``), with the work charged to THIS task's ``t_data``."""

    def __init__(self, layer: StagingLayer, task):
        self._layer = layer
        self._task = task

    def put(self, value: Any) -> StagedRef:
        """Stage a bulk output; embed the returned ref in the result in
        place of the payload (consumers deref lazily via ``get``)."""
        loc = self._layer.location_for(self._task)
        with self._layer._lock:
            ref = self._layer.store.put(value, location=loc)
        return ref

    def get(self, ref: StagedRef) -> Any:
        t0 = time.perf_counter()
        dst = self._layer.location_for(self._task)
        with self._layer._lock:
            spec = self._layer.planner.plan(ref, dst)
        value = self._layer.planner.execute(spec)
        dt = time.perf_counter() - t0
        self._task.t_data += dt
        # this deref ran INSIDE the kernel's wall-clock window; record it
        # so the executor can subtract it from t_exec (t_exec and t_data
        # must stay disjoint in the TTC decomposition)
        meta = self._task.meta
        meta["t_data_kernel"] = meta.get("t_data_kernel", 0.0) + dt
        return value

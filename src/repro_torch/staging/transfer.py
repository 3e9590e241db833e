"""Locality-aware transfer planning: link / copy / materialize + t_data.

"Harnessing the Power of Many" shows staging policy (link vs copy vs remote
transfer) dominating ensemble TTC at scale; the RADICAL-Pilot
characterization papers make locality of task data a first-class scheduler
input.  This module is that policy layer:

  LocalityMap        maps pilot slot ids onto locality domains ("pods"):
                     two slots in the same pod share fast memory/interconnect
                     (e.g. one pod of the 2x16x16 production mesh), so a
                     blob resident in the pod is *linked*, not copied.
  TransferPlanner    resolves one ``StagedRef`` + destination to the
                     cheapest available mode and its modeled cost:

                       link          replica already in the consumer's pod —
                                     share the decoded object, ~zero cost
                       copy          in-memory replica in another pod —
                                     decode a fresh object, nbytes/copy_bw
                       materialize   only a spilled blob exists — read the
                                     spill file, nbytes/disk_bw

Copy bandwidth is **tiered**: pod↔pod inside one pilot rides the fast
interconnect (``copy_gbps``), pilot↔pilot crosses the inter-pilot fabric
(``cross_gbps``), and anything touching HOST pays the slow host link
(``host_gbps``).  Source selection prefers a same-pilot pod replica, then
a cross-pilot pod replica (pilot-to-pilot fetch — the blob never routes
through the manager), and falls back to HOST last.  Pilot membership is
encoded in the pod name itself: a federated ``LocalityMap`` carries a
``prefix`` (e.g. ``"p1:"``) so its pods are ``p1:pod0, p1:pod1, ...`` —
fleet-unique names that replica sets, retry exclusion, and this tiering
all key on without extra plumbing.

The modeled cost charges ``t_data`` in DES (sim) mode; in real mode the
executed transfer is measured on the wall clock (link returns the shared
object, copy genuinely re-decodes, materialize genuinely reads disk), so
real profiles stay honest.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from repro_torch.staging.store import HOST, ObjectStore, StagedRef

MODES = ("link", "copy", "materialize")


def pilot_of(location: str) -> str:
    """Pilot prefix of a pod location: ``"p1:pod3" -> "p1:"``, an
    unprefixed ``"pod3" -> ""`` (single-pilot runs), ``HOST -> "host"``
    (its own tier — never equal to any pod's pilot)."""
    return location.partition("pod")[0]


@dataclass(frozen=True)
class LocalityMap:
    """Slot id -> locality domain ("pod").

    ``slots_per_pod`` groups consecutive slot ids: the pod2x16x16 mesh
    carved one-slot-per-pod uses ``slots_per_pod=1`` (each slot IS a pod);
    a single pod16x16 carved into k submesh slots uses ``slots_per_pod=k``
    (every slot shares the pod).  Data staged outside any slot lives at
    ``HOST``.

    ``prefix`` namespaces the pod names (``prefix="p1:"`` -> ``p1:pod0``)
    so several pilots' pods coexist in one shared ObjectStore / journal /
    exclusion set without collision — repro.federation sets it per pilot.
    """
    n_slots: int
    slots_per_pod: int = 1
    prefix: str = ""

    def __post_init__(self):
        if self.n_slots <= 0 or self.slots_per_pod <= 0:
            raise ValueError("n_slots and slots_per_pod must be positive")

    @classmethod
    def from_topology(cls, topology, slots_per_pod: int = 1,
                      prefix: str = "") -> "LocalityMap":
        """Locality over a dist.topology.SlotTopology's slot ids."""
        return cls(n_slots=topology.n_slots, slots_per_pod=slots_per_pod,
                   prefix=prefix)

    @property
    def n_pods(self) -> int:
        return (self.n_slots + self.slots_per_pod - 1) // self.slots_per_pod

    def pod_of(self, slot_id: int) -> str:
        return f"{self.prefix}pod{int(slot_id) // self.slots_per_pod}"

    def location_for(self, slot_ids: Optional[Sequence[int]]) -> str:
        """A task's locality domain: the pod of its first granted slot
        (multi-slot tasks are granted locality-packed ids), HOST if the
        task holds no slot ids (no topology / not yet granted)."""
        if not slot_ids:
            return HOST
        return self.pod_of(min(slot_ids))

    def pods_of(self, slot_ids: Sequence[int]) -> set:
        return {self.pod_of(s) for s in slot_ids}


@dataclass(frozen=True)
class TransferSpec:
    """One planned move of one blob to one destination pod."""
    digest: str
    nbytes: int
    mode: str                  # link | copy | materialize
    src: str                   # source location (pod id or HOST/"disk")
    dst: str
    cost_s: float              # modeled seconds (DES charge)


class TransferPlanner:
    """Resolve consumer bindings to the cheapest transfer mode.

    Bandwidths are modeled (GB/s) for DES cost accounting; latencies are
    the fixed per-transfer floors.  ``stats`` accumulates decisions —
    ``hit_rate`` (links over all transfers) is the locality headline the
    staging benchmark reports.
    """

    def __init__(self, store: ObjectStore, locality: Optional[LocalityMap]
                 = None, *, copy_gbps: float = 25.0, disk_gbps: float = 2.0,
                 host_gbps: float = 8.0, cross_gbps: float = 12.5,
                 link_latency_s: float = 0.0, copy_latency_s: float = 1e-4):
        self.store = store
        self.locality = locality
        self.copy_gbps = copy_gbps          # pod<->pod, same pilot
        self.disk_gbps = disk_gbps          # spill materialization
        self.host_gbps = host_gbps          # anything touching HOST
        self.cross_gbps = cross_gbps        # pod<->pod across pilots
        self.link_latency_s = link_latency_s
        self.copy_latency_s = copy_latency_s
        self.stats: Dict[str, float] = {
            "link": 0, "copy": 0, "materialize": 0, "cross_pilot": 0,
            "bytes_linked": 0, "bytes_copied": 0, "bytes_materialized": 0,
            "bytes_cross_pilot": 0, "t_data_modeled": 0.0}
        self._lock = threading.Lock()      # stats only; store self-locks

    # ------------------------------------------------------------ planning
    def _copy_gbps_for(self, src: str, dst: str) -> float:
        """Bandwidth tier for a copy: host link when either end is HOST,
        inter-pilot fabric across pilots, pod interconnect inside one."""
        if src == HOST or dst == HOST:
            return self.host_gbps
        if pilot_of(src) != pilot_of(dst):
            return self.cross_gbps
        return self.copy_gbps

    def _pick_source(self, known: set, dst: str) -> str:
        """Copy source for ``dst``: same-pilot pod replica first, then a
        cross-pilot pod replica (direct pilot-to-pilot fetch), HOST last —
        pod replicas always beat the slow host link when both exist."""
        pods = sorted(loc for loc in known if loc != HOST)
        if dst != HOST:
            same = [p for p in pods if pilot_of(p) == pilot_of(dst)]
            if same:
                return same[0]
        return pods[0] if pods else HOST

    def plan(self, ref: StagedRef, dst: str) -> TransferSpec:
        """Cheapest mode for ``ref`` at ``dst``: link when a replica is
        already in the destination pod, copy from an in-memory replica in
        another pod (tiered bandwidth — see :meth:`_pick_source`),
        materialize when only the spilled blob survives."""
        d, n = ref.digest, ref.nbytes
        live = self.store.locations(d)
        known = live or set(ref.locations)
        if self.store.in_memory(d):
            if dst in known:
                return TransferSpec(d, n, "link", dst, dst,
                                    self.link_latency_s)
            src = self._pick_source(known, dst)
            gbps = self._copy_gbps_for(src, dst)
            return TransferSpec(d, n, "copy", src, dst,
                                self.copy_latency_s + n / (gbps * 1e9))
        if self.store.spilled(d):
            return TransferSpec(d, n, "materialize", "disk", dst,
                                self.copy_latency_s
                                + n / (self.disk_gbps * 1e9))
        raise KeyError(f"blob {d[:10]}… is neither resident nor spilled")

    # ------------------------------------------------------------ execute
    def execute(self, spec: TransferSpec):
        """Perform the planned move; returns the payload value (None for
        virtual blobs).  The destination gains a replica, so the NEXT
        consumer in that pod links.  Real work matches the mode: link
        shares the decoded object, copy decodes fresh bytes, materialize
        reads the spill file first."""
        value = self.store.get(spec.digest, location=spec.dst,
                               fresh=spec.mode != "link")
        key = {"link": "bytes_linked", "copy": "bytes_copied",
               "materialize": "bytes_materialized"}[spec.mode]
        cross = (spec.mode == "copy" and spec.src != HOST
                 and spec.dst != HOST
                 and pilot_of(spec.src) != pilot_of(spec.dst))
        with self._lock:
            self.stats[spec.mode] += 1
            self.stats[key] += spec.nbytes
            self.stats["t_data_modeled"] += spec.cost_s
            if cross:
                self.stats["cross_pilot"] += 1
                self.stats["bytes_cross_pilot"] += spec.nbytes
        return value

    # ------------------------------------------------------------ summary
    @property
    def n_transfers(self) -> int:
        return int(self.stats["link"] + self.stats["copy"]
                   + self.stats["materialize"])

    @property
    def hit_rate(self) -> float:
        """Fraction of transfers that were pod-local links."""
        n = self.n_transfers
        return self.stats["link"] / n if n else 0.0

    def summary(self) -> Dict[str, float]:
        return {**{k: self.stats[k] for k in
                   ("link", "copy", "materialize", "cross_pilot",
                    "bytes_copied", "bytes_materialized",
                    "bytes_cross_pilot", "t_data_modeled")},
                "n_transfers": self.n_transfers,
                "locality_hit_rate": round(self.hit_rate, 4)}

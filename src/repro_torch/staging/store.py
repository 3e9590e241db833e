"""Content-addressed object store: hash-keyed blobs with replica tracking.

The EnTK paper's Kernel abstraction carries explicit staging directives
(``upload_input_data``/``copy_input_data``/``link_input_data``/
``download_output_data``); this store is the substrate those directives
resolve against at fleet scale.  Every staged payload is canonically
encoded, hashed, and kept exactly once (N ensemble members declaring the
same input blob share one entry — the paper's *link* semantics), with:

  replica tracking   per-location (pod / slot-submesh id) replica sets, the
                     input the transfer planner (transfer.py) uses to pick
                     link vs copy vs materialize
  ref-counting       every consumer holds a reference; the blob (and its
                     spill file) is dropped when the last consumer releases
  spill-to-disk      past ``byte_budget`` the least-recently-used blobs drop
                     their in-memory bytes; content-addressed spill files
                     are written through at put time, so a restarted run
                     can re-materialize journaled refs WITHOUT re-staging
  virtual blobs      DES (sim) mode stages bookkeeping-only refs with a
                     declared ``nbytes`` and no payload, so t_data and
                     locality are modeled at scale without moving bytes

A :class:`StagedRef` is the value that travels through channels and the
journal in place of the payload: ``(digest, nbytes, locations)`` — small,
JSON-encodable (ports.py), and resolvable from any location.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set, Tuple

HOST = "host"          # location of data staged outside any pilot slot


@dataclass(frozen=True)
class StagedRef:
    """Content-addressed handle to a staged payload.

    ``locations`` is the replica set snapshot at creation time (the store
    tracks the live set); it is what survives a journal round-trip, so a
    restarted planner still knows where the blob once lived even before
    the spill file is re-registered.
    """
    digest: str
    nbytes: int
    locations: Tuple[str, ...] = ()

    def __repr__(self):
        return (f"StagedRef({self.digest[:10]}…, {self.nbytes}B, "
                f"@{list(self.locations)})")


@dataclass
class _Blob:
    nbytes: int
    data: Optional[bytes] = None       # None once spilled (or virtual)
    value: Any = None                  # decoded cache: the "link" fast path
    has_value: bool = False
    virtual: bool = False
    spilled: bool = False
    refcount: int = 0
    locations: Set[str] = field(default_factory=set)


def encode(value: Any) -> bytes:
    """Canonical encoding: sorted-key JSON when the value survives the
    round trip UNCHANGED (digest stable across dict insertion orders and
    processes), pickle otherwise.  The round-trip check matters for
    correctness, not just fidelity: without it, ``{1: "a"}`` and
    ``{"1": "a"}`` would collide on one digest, and tuples would decode
    as lists on the copy/materialize path while same-pod links returned
    the original object."""
    try:
        data = json.dumps(value, sort_keys=True, separators=(",", ":"))
        if json.loads(data) == value:
            return b"J" + data.encode()
    except (TypeError, ValueError):
        pass
    return b"P" + pickle.dumps(value, protocol=4)


def decode(data: bytes) -> Any:
    if data[:1] == b"J":
        return json.loads(data[1:].decode())
    return pickle.loads(data[1:])


def digest_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ObjectStore:
    """Hash-keyed blob store with ref-counts, replicas, and disk spill.

    ``byte_budget`` bounds the *in-memory* payload bytes; past it the
    least-recently-used blobs spill (their bytes drop from memory — the
    write-through spill file under ``spill_dir`` already holds them).
    Without a ``spill_dir`` the budget is advisory (nothing can be dropped
    safely); ``stats["over_budget"]`` counts the violations instead.
    """

    def __init__(self, byte_budget: int = 256 << 20,
                 spill_dir: Optional[str] = None):
        self.byte_budget = int(byte_budget)
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._blobs: "OrderedDict[str, _Blob]" = OrderedDict()  # LRU order
        self._mem_bytes = 0            # running: bytes resident in memory
        self._lock = threading.RLock()
        self.stats: Dict[str, int] = {
            "puts": 0, "dedup_hits": 0, "bytes_put": 0, "spills": 0,
            "materializations": 0, "releases": 0, "evictions": 0,
            "over_budget": 0}
        self.peak_mem_bytes = 0

    # ------------------------------------------------------------ queries
    @property
    def mem_bytes(self) -> int:
        """Bytes resident in memory — a running counter (puts happen per
        channel put; an O(blobs) scan here would make staging O(n²))."""
        return self._mem_bytes

    def __len__(self):
        return len(self._blobs)

    def has(self, digest: str) -> bool:
        """Known in memory, as a virtual blob, or as a spill file."""
        with self._lock:
            if digest in self._blobs:
                return True
        return self._spill_path_exists(digest)

    def in_memory(self, digest: str) -> bool:
        with self._lock:
            b = self._blobs.get(digest)
            return b is not None and not b.spilled

    def spilled(self, digest: str) -> bool:
        with self._lock:
            b = self._blobs.get(digest)
            if b is not None:
                return b.spilled
        return self._spill_path_exists(digest)

    def locations(self, digest: str) -> Set[str]:
        with self._lock:
            b = self._blobs.get(digest)
            return set(b.locations) if b is not None else set()

    def refcount(self, digest: str) -> int:
        with self._lock:
            b = self._blobs.get(digest)
            return b.refcount if b is not None else 0

    # ------------------------------------------------------------ put
    def put(self, value: Any, location: Optional[str] = None, *,
            data: Optional[bytes] = None) -> StagedRef:
        """Stage a payload; returns a ref the caller holds (refcount +1).

        Content-addressed: a second put of equal content lands on the same
        blob (``dedup_hits``) — this is what makes N members sharing one
        input pay for it once.  ``data`` passes pre-encoded bytes so a
        caller that already measured the payload does not encode twice.
        """
        if data is None:
            data = encode(value)
        d = digest_of(data)
        with self._lock:
            b = self._blobs.get(d)
            if b is None:
                b = _Blob(nbytes=len(data), data=data, value=value,
                          has_value=True)
                self._blobs[d] = b
                self._mem_bytes += len(data)
                self.stats["puts"] += 1
                self.stats["bytes_put"] += len(data)
                self._write_through(d, data)
                self._enforce_budget()
            else:
                self._blobs.move_to_end(d)
                self.stats["dedup_hits"] += 1
                if not b.has_value:
                    b.value, b.has_value = value, True
            b.refcount += 1
            if location:
                b.locations.add(location)
            self.peak_mem_bytes = max(self.peak_mem_bytes, self.mem_bytes)
            return StagedRef(d, b.nbytes, tuple(sorted(b.locations)))

    def put_virtual(self, key: str, nbytes: int,
                    location: Optional[str] = None) -> StagedRef:
        """Stage a payload-free blob of declared size (DES mode): the
        digest derives from ``key`` so replay is deterministic."""
        d = digest_of(b"V" + key.encode())
        with self._lock:
            b = self._blobs.get(d)
            if b is None:
                b = _Blob(nbytes=int(nbytes), virtual=True)
                self._blobs[d] = b
                self.stats["puts"] += 1
                self.stats["bytes_put"] += int(nbytes)
            else:
                self.stats["dedup_hits"] += 1
            b.refcount += 1
            if location:
                b.locations.add(location)
            return StagedRef(d, b.nbytes, tuple(sorted(b.locations)))

    def add_location(self, digest: str, location: str):
        """Record a new replica (a completed transfer landed the blob
        there); unknown digests are re-registered from their spill file."""
        with self._lock:
            b = self._register_if_spilled(digest)
            if b is not None and location:
                b.locations.add(location)

    def drop_location(self, location: str):
        """Invalidate every replica at ``location`` (the pod died: its
        memory is gone).  Blobs whose ONLY replica lived there survive —
        the in-memory bytes / spill file / other replicas still serve
        consumers, just never as a link into the dead pod."""
        with self._lock:
            for b in self._blobs.values():
                b.locations.discard(location)

    def drop_pod_locations(self):
        """Invalidate every non-HOST replica (topology compaction: slot
        ids — and therefore pod names — renumbered, so pod-keyed replica
        bookkeeping is stale wholesale)."""
        with self._lock:
            for b in self._blobs.values():
                b.locations.intersection_update({HOST})

    def register_virtual(self, ref: StagedRef):
        """Re-register a journal-replayed virtual ref (DES restart): the
        blob never had a payload, so its nbytes and replica locations
        reconstruct it completely."""
        with self._lock:
            if ref.digest not in self._blobs:
                self._blobs[ref.digest] = _Blob(
                    nbytes=ref.nbytes, virtual=True,
                    locations=set(ref.locations))

    # ------------------------------------------------------------ get
    def get(self, ref_or_digest, location: Optional[str] = None,
            *, fresh: bool = False) -> Any:
        """Resolve a blob to its value.

        ``fresh=False`` returns the shared decoded object (the *link* path
        — zero work; consumers must treat staged inputs as read-only).
        ``fresh=True`` decodes a new object from bytes (the *copy* path).
        Spilled blobs re-load from disk (*materialize*) first.  Virtual
        blobs resolve to None.
        """
        d = ref_or_digest.digest if isinstance(ref_or_digest, StagedRef) \
            else ref_or_digest
        with self._lock:
            b = self._register_if_spilled(d)
            if b is None:
                raise KeyError(f"unknown blob {d[:10]}…")
            if b.virtual:
                if location:
                    b.locations.add(location)
                return None
            data = b.data
            if data is None:                       # spilled: materialize
                data = self._read_spill(d)
                b.data, b.spilled = data, False
                self._mem_bytes += b.nbytes
                self._blobs.move_to_end(d)
                self.stats["materializations"] += 1
                self._enforce_budget()
            if location:
                b.locations.add(location)
            if not fresh and b.has_value:
                self._blobs.move_to_end(d)     # link = a use: keep hot
                return b.value                 # blobs off the spill list
        # decode OUTSIDE the lock: concurrent worker threads copying
        # different blobs must not serialize on each other's deserialize
        value = decode(data)
        with self._lock:
            b = self._blobs.get(d)
            if b is not None and not b.has_value:
                b.value, b.has_value = value, True
        return value

    # ------------------------------------------------------------ refcount
    def retain(self, ref_or_digest, n: int = 1):
        d = ref_or_digest.digest if isinstance(ref_or_digest, StagedRef) \
            else ref_or_digest
        with self._lock:
            b = self._blobs.get(d)
            if b is not None:
                b.refcount += n

    def release(self, ref_or_digest, n: int = 1):
        """Drop ``n`` holds; at zero the blob leaves memory.  The
        content-addressed spill file is NOT deleted — it is the durable
        cache a journal replay re-materializes from after a crash (use
        :meth:`clear_spill` to reclaim disk).  Unknown digests (e.g. a
        post-restart consumer releasing a ref whose holds died with the
        previous process) are a no-op."""
        d = ref_or_digest.digest if isinstance(ref_or_digest, StagedRef) \
            else ref_or_digest
        with self._lock:
            b = self._blobs.get(d)
            if b is None:
                return
            b.refcount -= n
            self.stats["releases"] += 1
            if b.refcount <= 0:
                if not b.virtual and b.data is not None:
                    self._mem_bytes -= b.nbytes
                del self._blobs[d]
                self.stats["evictions"] += 1

    def clear_spill(self):
        """Explicit disk reclaim: delete every spill file (ends the
        restartability of journaled refs)."""
        if not self.spill_dir:
            return
        with self._lock:
            for fn in os.listdir(self.spill_dir):
                if fn.endswith(".blob"):
                    os.unlink(os.path.join(self.spill_dir, fn))

    def gc_spill(self, referenced=frozenset()) -> int:
        """Reclaim spill files that nothing can ever need again: zero-ref
        (no live consumer holds the blob) AND not in ``referenced`` (the
        digests the journal names — deleting those would break replay of
        journaled refs).  Returns the number of files deleted.  Live
        blobs whose bytes exist only on disk keep their files."""
        if not self.spill_dir:
            return 0
        n = 0
        with self._lock:
            for fn in os.listdir(self.spill_dir):
                if not fn.endswith(".blob"):
                    continue
                digest = fn[:-len(".blob")]
                if digest in referenced:
                    continue
                b = self._blobs.get(digest)
                if b is not None and b.refcount > 0:
                    continue
                os.unlink(os.path.join(self.spill_dir, fn))
                self.stats["spill_gcs"] = self.stats.get("spill_gcs", 0) + 1
                n += 1
        return n

    # ------------------------------------------------------------ spill
    def spill(self, digest: str) -> bool:
        """Explicitly drop a blob's bytes from memory (keeps the spill
        file / virtual bookkeeping).  Returns True if it spilled."""
        with self._lock:
            b = self._blobs.get(digest)
            if b is None or b.spilled:
                return False
            if b.virtual:
                b.spilled = True
                self.stats["spills"] += 1
                return True
            if not self._spill_path_exists(digest):
                return False               # nowhere durable to put it
            b.data, b.value, b.has_value = None, None, False
            b.spilled = True
            self._mem_bytes -= b.nbytes
            self.stats["spills"] += 1
            return True

    def _enforce_budget(self):
        if self.mem_bytes <= self.byte_budget:
            return
        if not self.spill_dir:
            self.stats["over_budget"] += 1
            return
        for d in list(self._blobs):        # LRU first
            if self.mem_bytes <= self.byte_budget:
                break
            b = self._blobs[d]
            if not b.virtual and not b.spilled:
                self.spill(d)

    # ------------------------------------------------------------ disk
    def _spill_path(self, digest: str) -> Optional[str]:
        return os.path.join(self.spill_dir, f"{digest}.blob") \
            if self.spill_dir else None

    def _spill_path_exists(self, digest: str) -> bool:
        p = self._spill_path(digest)
        return p is not None and os.path.exists(p)

    def _write_through(self, digest: str, data: bytes):
        p = self._spill_path(digest)
        if p and not os.path.exists(p):
            tmp = p + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, p)             # atomic: no torn spill files

    def _read_spill(self, digest: str) -> bytes:
        with open(self._spill_path(digest), "rb") as f:
            return f.read()

    def _register_if_spilled(self, digest: str) -> Optional[_Blob]:
        """A digest known only as a spill file (journal replay after a
        restart) gets a live entry so replicas/refcounts work again."""
        b = self._blobs.get(digest)
        if b is None and self._spill_path_exists(digest):
            nbytes = os.path.getsize(self._spill_path(digest))
            b = _Blob(nbytes=nbytes, data=None, spilled=True)
            self._blobs[digest] = b
        return b

    def __repr__(self):
        return (f"ObjectStore({len(self._blobs)} blobs, "
                f"{self.mem_bytes}B in memory, budget {self.byte_budget}B)")

"""Metrics timelines: counter/gauge/histogram registry sampled on clock
ticks (virtual in sim, wall-elapsed in real mode).

The registry is pull-based: a subsystem registers a *gauge* as a zero-arg
closure over its live state (frontier depth, busy slots, channel backlog
bytes, staging hit-rate, per-pilot load) and the drain loop calls
:meth:`maybe_sample` once per clock advance.  Sampling is adaptively
decimated — when the timeline exceeds ``max_samples`` points every other
sample is dropped and the minimum sampling interval doubles — so a 100k-task
DES run keeps a bounded, evenly thinned timeline instead of one point per
event (this is what keeps the frontier-bench tracing overhead inside its
10% gate).

Counters are monotonic scalars (`inc`), histograms are streaming summaries
(n/sum/min/max + power-of-two buckets) — neither is per-tick, so both stay
O(1) in memory.  ``series()`` renders everything JSON-able; the AppManager
lands it in ``prof.results["timeseries"]``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

_frexp = math.frexp


class Histogram:
    """Streaming summary: n/sum/min/max + log2 buckets, O(1) per update.
    ``hist(name)`` hands the object out so hot paths (the tracer's
    per-attempt updates) skip the registry lookup."""

    __slots__ = ("n", "sum", "min", "max", "buckets")

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def add(self, v: float):
        self.n += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        b = 0 if v <= 0 else _frexp(v)[1]           # log2 bucket exponent
        bk = self.buckets
        bk[b] = bk.get(b, 0) + 1


class MetricsTimeline:
    def __init__(self, *, max_samples: int = 2048,
                 min_interval: float = 0.0):
        self._gauges: Dict[str, Callable[[], float]] = {}
        self.counters: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self.t: List[float] = []
        self.samples: Dict[str, List[Optional[float]]] = {}
        self.max_samples = max(int(max_samples), 8)
        self._interval = float(min_interval)
        # effective gap: never re-sample a clock that has not advanced
        # (the DES drain calls maybe_sample once per event; many events
        # share one virtual tick)
        self._min_gap = max(self._interval, 1e-12)
        self._last_t: Optional[float] = None

    # ------------------------------------------------------------ registry
    def gauge(self, name: str, fn: Callable[[], float]):
        """Register (or replace) a pull gauge.  A gauge registered mid-run
        backfills None for the ticks it missed, so every series stays
        aligned with ``t``."""
        self._gauges[name] = fn
        self.samples.setdefault(name, [None] * len(self.t))

    def inc(self, name: str, value: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def hist(self, name: str) -> Histogram:
        """The named :class:`Histogram`, created on first use."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def observe(self, name: str, value: float):
        """Streaming histogram update (O(1); no per-sample storage)."""
        self.hist(name).add(float(value))

    # ------------------------------------------------------------ sampling
    def maybe_sample(self, now: float):
        """Sample every registered gauge unless the adaptive minimum
        interval since the last sample has not elapsed."""
        last = self._last_t
        if last is not None and now - last < self._min_gap:
            return
        self.sample(now)

    def sample(self, now: float):
        self._last_t = now
        self.t.append(now)
        for name, fn in self._gauges.items():
            try:
                v = fn()
            except Exception:      # noqa: BLE001 - a dying gauge must not
                v = None           # take the run down
            self.samples[name].append(v)
        if len(self.t) > self.max_samples:
            self._decimate()

    def _decimate(self):
        """Drop every other sample and double the minimum interval: the
        timeline stays bounded and evenly thinned however long the run."""
        self.t = self.t[::2]
        for name in self.samples:
            self.samples[name] = self.samples[name][::2]
        span = (self.t[-1] - self.t[0]) if len(self.t) > 1 else 0.0
        floor = span / self.max_samples if span > 0 else 1e-9
        self._interval = max(self._interval * 2, floor)
        self._min_gap = max(self._interval, 1e-12)

    # ------------------------------------------------------------ output
    def series(self) -> dict:
        """JSON-able snapshot: aligned gauge timelines, final counter
        values, histogram summaries."""
        hists = {}
        for name, h in self._hists.items():
            hists[name] = {
                "n": h.n, "sum": h.sum, "min": h.min, "max": h.max,
                "buckets": {str(k): v for k, v in h.buckets.items()},
                "mean": h.sum / h.n if h.n else 0.0}
        return {"t": list(self.t),
                "gauges": {k: list(v) for k, v in self.samples.items()},
                "counters": dict(self.counters),
                "histograms": hists,
                "n_samples": len(self.t)}

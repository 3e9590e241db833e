"""SLA classes: the serving subsystem's contract with the frontier.

Online inference splits into two service classes (the pilot papers'
latency-sensitive vs throughput work sharing one allocation):

  latency      interactive traffic.  High frontier priority — its tasks
               pop before anything else — and, on a pilot with
               ``preempt=True``, may evict running throughput-class tasks
               through the requeue/abandon path.  Tight deadline budget.
  throughput   bulk/batch traffic (and co-tenant training).  Baseline
               priority, generous deadline; the preemption victim pool.

A ``TaskSpec(sla="latency")`` inherits the class priority and deadline;
both can be overridden per spec (``priority=``, ``deadline=``).  Unknown
class names are rejected at submit time with diagnostic E115.

This module is a leaf (no repro_torch.core imports): core/pst.py resolves specs
through it without a layering cycle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class SLAClass:
    """One service class: frontier priority + default deadline budget."""
    name: str
    priority: int
    deadline_s: float      # default latency budget (arrival -> last token)
    preempts: bool         # may evict lower-priority RUNNING tasks


LATENCY = SLAClass("latency", priority=10, deadline_s=2.0, preempts=True)
THROUGHPUT = SLAClass("throughput", priority=0, deadline_s=600.0,
                      preempts=False)

CLASSES: Dict[str, SLAClass] = {c.name: c for c in (LATENCY, THROUGHPUT)}


def sla_class(name: str) -> SLAClass:
    """Look up a class; raises ``KeyError`` listing the known names."""
    try:
        return CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown SLA class {name!r} "
                       f"(known: {', '.join(sorted(CLASSES))})") from None


def resolve_sla(spec) -> Tuple[int, Optional[float]]:
    """(priority, deadline) for a TaskSpec-like object: explicit fields
    win, else the SLA class defaults, else (0, None).  Unknown class names
    resolve as if unset — submit-time validation (E115) rejects them
    before any task is built."""
    cls = CLASSES.get(spec.sla) if spec.sla is not None else None
    priority = spec.priority if spec.priority is not None else \
        (cls.priority if cls is not None else 0)
    deadline = spec.deadline if spec.deadline is not None else \
        (cls.deadline_s if cls is not None else None)
    return int(priority), deadline

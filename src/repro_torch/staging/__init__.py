"""repro_torch.staging — content-addressed data staging with locality-aware
transfers and t_data accounting.

The paper decomposes TTC into execution, overhead, and data movement
(``t_data``); its Kernel abstraction carries explicit staging directives.
This package models that subsystem at fleet scale:

  store.py      content-addressed ObjectStore (hash-keyed blobs,
                ref-counted, spill-to-disk past a byte budget) with
                per-pod replica tracking; ``StagedRef`` handles
  transfer.py   ``LocalityMap`` + ``TransferPlanner``: link when producer
                and consumer share a pod, copy across pods, materialize
                from spilled blobs — each charged to ``t_data``
  ports.py      ``StagingLayer``: Channel puts of large values become
                staged refs, transparently dereferenced into
                ``ctx["inputs"]`` between ``pop_ready`` and kernel launch;
                journaled refs replay without re-staging

Enable it per pilot::

    from repro_torch.staging import LocalityMap, StagingLayer
    rt = PilotRuntime(slots=8, mode="real",
                      staging=StagingLayer(
                          locality=LocalityMap(8, slots_per_pod=4),
                          spill_dir="/tmp/blobs", threshold_bytes=1 << 12))
"""
from repro_torch.staging.ports import (  # noqa: F401
    StagingLayer,
    TaskStagingView,
    decode_refs,
    encode_refs,
    iter_refs,
    payload_nbytes,
)
from repro_torch.staging.store import HOST, ObjectStore, StagedRef  # noqa: F401
from repro_torch.staging.transfer import (  # noqa: F401
    LocalityMap,
    TransferPlanner,
    TransferSpec,
)

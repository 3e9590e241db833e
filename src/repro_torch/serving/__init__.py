"""Online inference as a first-class ensemble workload (own copy of
``repro.serving``).

The serving subsystem compiles a seedable traffic process into PST
pipelines: traffic windows become source tasks whose DES duration is the
window length, each window's requests decode as one continuous-batching
wave (``repro_torch.serve.engine.BatchedServer`` in real mode, the
``simulate_continuous`` cost model in DES), SLA classes map onto frontier
priorities (``PilotRuntime(preempt=True)`` evicts throughput work for
latency work), and ``Channel(capacity_bytes=...)`` back-pressures bursty
producers by staged bytes.
"""
from repro_torch.serving.metrics import ServingMetrics          # noqa: F401
from repro_torch.serving.server import (                        # noqa: F401
    ContinuousSim,
    build_serve_pipeline,
    build_serving_app,
    simulate_continuous,
)
from repro_torch.serving.sla import CLASSES, SLAClass, sla_class  # noqa: F401
from repro_torch.serving.traffic import (                       # noqa: F401
    ServeRequest,
    TrafficModel,
    build_traffic_pipeline,
)

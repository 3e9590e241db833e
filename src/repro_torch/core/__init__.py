"""Ensemble toolkit public API (own copy of ``repro.core``: the same names).
``FusedEnsemble`` runs a homogeneous replica-exchange population as one
vmapped program on one device (``core/ensemble.py``).

Two API generations live here:

**PST (current)** — composable Pipeline-Stage-Task data objects (the
second-generation EnTK model, arXiv:1710.08491), executed by an AppManager
over one long-lived pilot session with dynamic task injection::

    from repro_torch.core import AppManager, PipelineSpec, Stage, TaskSpec

    sim = Stage([TaskSpec(k) for k in kernels], name="sim")
    ana = Stage([TaskSpec(ak)], name="analysis", on_done=adapt)  # may append
    AppManager(pilot).run([PipelineSpec([sim, ana], name="e0"), ...])

Many pipelines run concurrently with NO global barrier: ensemble A's next
cycle is injected the moment A's exchange completes, while B still
simulates.  ``on_done`` callbacks make workloads adaptive (append stages,
extend loops, branch on results) — shapes the 2016 hook API could not
express.

Typed data-flow ports (``repro_torch.core.flow``) couple pipelines into a
DAG-of-ensembles: a stage declares ``outputs=[Channel("traj")]`` and a
stage in ANOTHER pipeline consumes it via ``inputs={"traj": ch}`` (or
pins one producer with ``inputs={"x": stage.future()}``); the consumer
starts the moment its producer stage completes, while the producer
pipeline keeps running.  Kernels see bound ports as ``ctx["inputs"]``.

**Legacy hooks (still supported)** — the 2016 paper's subclass API
(paper listings 1/4/5).  The patterns now *compile to PST* (see
core/execution_plugin.py); behavior and profiles are unchanged.

Migration table (old hook -> PST equivalent):

====================================  =====================================
legacy hook API                       PST equivalent
====================================  =====================================
``Pipeline.stage_k(self, i)``         one ``PipelineSpec`` per instance i,
                                      one single-task ``Stage`` per k
``BagOfTasks.task(self, i)``          single ``Stage`` of N ``TaskSpec``s
``RE.prepare_replica_for_md(r)``      "simulation" ``Stage`` (task per
                                      replica) of cycle c
``RE.prepare_exchange(replicas)``     "exchange" ``Stage``; its ``on_done``
``RE.apply_exchange(result, rs)``     applies the swap and *appends* cycle
                                      c+1's stages (adaptive extension)
``SAL.simulation_stage(it, i)``       "simulation" ``Stage`` of iteration it
``SAL.analysis_stage(it, j)``         "analysis" ``Stage``; ``on_done``
``SAL.should_continue(it, res)``      decides whether to append iteration
                                      it+1 or the ``post_loop`` stage
``SingleClusterEnvironment.run(p)``   ``AppManager(pilot).run(pipelines)``
====================================  =====================================
"""
from repro_torch.core.ensemble import FusedEnsemble  # noqa: F401
from repro_torch.core.execution_plugin import (  # noqa: F401
    BaseExecutionPlugin,
    get_plugin,
)
from repro_torch.core.flow import (  # noqa: F401
    Channel,
    Port,
    StageFuture,
    TypedPortError,
)
from repro_torch.core.kernel_plugin import Kernel, kernel_names, register_kernel  # noqa: F401
from repro_torch.core.patterns import (  # noqa: F401
    BagOfTasks,
    ExecutionPattern,
    Pipeline,
    Replica,
    ReplicaExchange,
    SimulationAnalysisLoop,
)
from repro_torch.core.pst import (  # noqa: F401
    AppManager,
    ExecutionProfile,
    PipelineSpec,
    Stage,
    TaskSpec,
)
from repro_torch.core.resource_handler import (  # noqa: F401
    Pilot,
    ResourceSpec,
    SingleClusterEnvironment,
)

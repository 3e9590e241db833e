"""repro_torch.federation — multi-pilot fleet with late-binding dispatch and a
backlog-driven recruiter (own copy of ``repro.federation``).

The EnTK papers scale one pilot; production campaigns run MANY — different
allocations, different meshes, joining and leaving mid-campaign.  This
package federates the runtime without changing the programming model: a
:class:`Fleet` owns N heterogeneous :class:`~repro_torch.runtime.executor
.PilotRuntime`\\ s (own slot counts, own topologies, own journals) and
duck-types the single-pilot surface ``AppManager`` speaks, so the same
PST application runs federated by swapping the runtime object::

    from repro_torch.federation import Fleet, Recruiter, build_fleet

    fleet = build_fleet(2, slots=8, slots_per_pod=2, mode="sim",
                        journal_base="myrun",
                        recruiter=Recruiter(max_pilots=4, spinup_s=5.0,
                                            hysteresis_s=10.0))
    mgr = AppManager(fleet)        # unchanged PST app from here on
    profile = mgr.run(pipelines)
    fleet.close()

The moving parts:

  fleet.py      ``Fleet`` facade + ``FleetStagingView`` (task-routed
                staging over ONE shared ObjectStore/TransferPlanner) +
                ``make_pilot``/``build_fleet`` constructors.  Pod names
                carry their pilot's prefix (``p1:pod0``) — replica
                locations, retry exclusions, fault routing and journal
                records all key on that, so federation needs no other
                plumbing.
  session.py    ``FederatedSession``: overrides the base session's
                dispatch hooks.  Every ready task LATE-BINDS at launch to
                the pilot minimizing estimated completion — modeled
                ``t_data`` from where its staged inputs actually live
                (link > pilot-to-pilot fetch at ``cross_gbps`` > host
                link), load as tiebreak, blamed pilots last.
  recruiter.py  ``Recruiter``: watches ``TaskGraph.frontier_slots()``
                backlog vs active capacity and spins pilots up/down
                against a slot budget, with hysteresis >= spin-up so the
                fleet converges instead of oscillating (W205 checks the
                configuration statically; E114 catches tasks wider than
                any pilot the fleet could ever field).

Failure model: a whole-pilot death is N pod deaths (the pod-failure machinery) —
in-flight attempts abandoned, the pilot's staged replicas dropped from
the shared store, retries re-dispatched to surviving pilots, and the
recruiter sees the lost capacity as backlog pressure and may replace it.
Each pilot journals its own records (tagged with its name), so crash
replay reconstructs the whole fleet's progress — done tasks stay done,
attempt counts and pod exclusions survive, whichever pilot they happened
on.

Extension points (deliberately out of scope here): cross-pilot
speculative duplicates (``Fleet.straggler_factor`` pins speculation off),
per-pilot pricing in the dispatch score, and recruiting heterogeneous
pilot shapes per backlog width distribution.
"""
from repro_torch.federation.fleet import (  # noqa: F401
    Fleet,
    FleetStagingView,
    build_fleet,
    make_pilot,
)
from repro_torch.federation.recruiter import Recruiter  # noqa: F401
from repro_torch.federation.session import FederatedSession  # noqa: F401

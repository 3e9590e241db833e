"""The port's Ensemble Toolkit front end (``repro_torch.core``,
``repro_torch.runtime``, ``repro_torch.staging``, ``repro_torch.analysis``)
held against the JAX package's (``repro.core`` ...) on the CPU, with no
model: each scenario runs through both packages, as the cases of one
parametrised test, and gives the same counts, results, virtual times and
journal order wherever the discrete-event mode makes them exact.
"""
import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

from _port_examples import example_module

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")


def _pkg(name):
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")
    return SimpleNamespace(
        name=name, core=mod("core"), executor=mod("runtime.executor"),
        journal=mod("runtime.journal"), faults=mod("runtime.faults"),
        states=mod("runtime.states"), staging=mod("staging"),
        analysis=mod("analysis"), diagnostics=mod("analysis.diagnostics"))


def _noop(m, dur=0.0, nbytes=None):
    k = m.core.Kernel("synthetic.noop")
    k.sim_duration = dur
    k.output_nbytes = nbytes
    return k


def _echo(m, value=None):
    k = m.core.Kernel("synthetic.echo")
    k.arguments = {"value": value}
    return k


def _journal_order(path):
    """(task, event) of every task record, in the order written."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "task" in rec:
                out.append((rec["task"], rec["event"]))
    return out


def _profile(prof, times=True):
    out = {"n_tasks": prof.n_tasks, "n_failed": prof.n_failed,
           "n_retries": prof.n_retries, "n_canceled": prof.n_canceled}
    if times:
        out["ttc"] = prof.ttc
        out["per_stage"] = prof.per_stage
    return out


# ------------------------------------------------------------ scenarios
# Each takes the package namespace and a scratch directory and returns
# what must agree between the two packages; its own assertions hold the
# scenario's meaning on either package.

def sc_charcount(m, tmp):
    """The paper's five-step flow (``tests/test_system.py:12``), real
    threads: mkfile -> ccount over 16 pipes."""
    core = m.core

    class CharCount(core.Pipeline):
        def stage_1(self, i):
            k = core.Kernel("misc.mkfile")
            k.arguments = {"bytes": 1 << 14, "seed": i}
            return k

        def stage_2(self, i):
            return core.Kernel("misc.ccount")

    cluster = core.SingleClusterEnvironment(resource="local.cpu", cores=8,
                                            walltime=5)
    cluster.allocate()
    prof = cluster.run(CharCount(stages=2, instances=16))
    cluster.deallocate()
    assert prof.n_failed == 0 and prof.n_tasks == 32
    assert prof.t_enmd_overhead > 0
    counts = {k: v for k, v in prof.results["tasks"].items()
              if k.endswith("stage2")}
    assert all(c["total"] == 1 << 14 for c in counts.values())
    return {**_profile(prof, times=False), "counts": counts}


def _sim_cluster(m, tmp, cores):
    return m.core.SingleClusterEnvironment(
        cores=cores, mode="sim", database_url=str(tmp), database_name="j")


def _run_sim(m, tmp, pattern, cores):
    cl = _sim_cluster(m, tmp, cores)
    cl.allocate()
    prof = cl.run(pattern)
    cl.deallocate()
    return {**_profile(prof), "journal": _journal_order(cl.journal_path),
            "utilization": prof.utilization}


def sc_pipeline_sim(m, tmp):
    """Pipeline of synthetic kernels in the DES: 3 pipes x 3 stages whose
    durations differ per pipe."""
    core = m.core

    class P(core.Pipeline):
        def stage_1(self, i):
            return _noop(m, 1.0 + i)

        def stage_2(self, i):
            return _noop(m, 2.0)

        def stage_3(self, i):
            return _noop(m, 0.5 * (3 - i))

    out = _run_sim(m, tmp, P(stages=3, instances=3), cores=2)
    assert out["n_tasks"] == 9 and out["n_failed"] == 0
    return out


def sc_bag_sim(m, tmp):
    """BagOfTasks in the DES: 10 tasks on 4 slots."""
    core = m.core

    class Bag(core.BagOfTasks):
        def task(self, i):
            return _noop(m, 1.0 + (i % 3))

    out = _run_sim(m, tmp, Bag(instances=10), cores=4)
    assert out["n_tasks"] == 10
    return out


def sc_re_sim(m, tmp):
    """ReplicaExchange in the DES: 4 members, 3 cycles, an exchange whose
    on_done appends the next cycle."""
    core = m.core
    applied = []

    class RE(core.ReplicaExchange):
        def prepare_replica_for_md(self, r):
            return _noop(m, 2.0 + r.id)

        def prepare_exchange(self, replicas):
            return _noop(m, 0.25)

        def apply_exchange(self, result, replicas):
            applied.append(replicas[0].cycle)

    out = _run_sim(m, tmp, RE(cycles=3, replicas=4), cores=4)
    assert out["n_tasks"] == 15 and applied == [0, 1, 2]
    return {**out, "applied": applied}


def sc_sal_sim(m, tmp):
    """SimulationAnalysisLoop in the DES that stops on its own rule after
    3 of 5 iterations, with a pre- and post-loop."""
    core = m.core

    class SAL(core.SimulationAnalysisLoop):
        def pre_loop(self):
            return _noop(m, 0.5)

        def simulation_stage(self, it, i):
            return _noop(m, 1.0 + i)

        def analysis_stage(self, it, j):
            return _noop(m, 0.5)

        def post_loop(self):
            return _noop(m, 0.25)

        def should_continue(self, it, results):
            return it < 2

    out = _run_sim(m, tmp, SAL(maxiterations=5, simulation_instances=3,
                               analysis_instances=2), cores=3)
    assert out["n_tasks"] == 2 + 3 * 5
    return out


def sc_adaptive_pst(m, tmp):
    """``examples/pst_adaptive.py``: two RE ensembles and an adaptive
    sampler over one DES session, each exchange's ``on_done`` appending
    the next cycle; the fast ensemble streams 6 cycles inside the slow
    one's first."""
    core = m.core
    log = []

    def re_ensemble(name, members, cycles, sim_dur, x_dur):
        def cycle_stages(c):
            sims = core.Stage([core.TaskSpec(_noop(m, sim_dur),
                                             name=f"{name}.c{c}.md{i}")
                               for i in range(members)], name="simulation")

            def on_exchange(stage, pipe):
                log.append((name, c))
                if c + 1 < cycles:
                    pipe.extend(cycle_stages(c + 1))
            return [sims, core.Stage(
                [core.TaskSpec(_noop(m, x_dur), name=f"{name}.c{c}.x")],
                name="exchange", on_done=on_exchange)]
        return core.PipelineSpec(cycle_stages(0), name=name)

    def sampler(name, max_rounds=6):
        def round_stages(r):
            sim = core.Stage([core.TaskSpec(_noop(m, 2.0),
                                            name=f"{name}.r{r}.sim{i}")
                              for i in range(4)], name="simulation")

            def on_analysis(stage, pipe):
                converged = 0.5 ** r < 0.1
                log.append((name, r, converged))
                if not converged and r + 1 < max_rounds:
                    pipe.extend(round_stages(r + 1))
            return [sim, core.Stage(
                [core.TaskSpec(_noop(m, 0.5), name=f"{name}.r{r}.ana")],
                name="analysis", on_done=on_analysis)]
        return core.PipelineSpec(round_stages(0), name=name)

    rt = m.executor.PilotRuntime(
        slots=8, mode="sim", journal=m.journal.Journal(str(tmp / "j.jsonl")))
    prof = core.AppManager(rt).run([
        re_ensemble("fast_re", 2, 6, 1.0, 0.1),
        re_ensemble("slow_re", 2, 2, 20.0, 0.5), sampler("adaptive")])
    assert log.index(("fast_re", 5)) < log.index(("slow_re", 0))
    return {**_profile(prof), "log": log,
            "journal": _journal_order(tmp / "j.jsonl"),
            "pipelines": prof.results["pipelines"]}


def sc_channel(m, tmp):
    """A cross-pipeline ``Channel``: analysis round 0 starts the moment
    the producer's cycle 0 completes, long before the producer drains."""
    core = m.core
    traj = core.Channel("traj")
    prod = core.PipelineSpec(
        [core.Stage([core.TaskSpec(_noop(m, 4.0), name=f"prod.c{c}.m{i}")
                     for i in range(2)], name=f"cycle{c}", outputs=[traj])
         for c in range(3)], name="producer")
    ana = core.PipelineSpec(
        [core.Stage([core.TaskSpec(_noop(m, 1.0), name=f"ana.r{c}")],
                    name=f"round{c}", inputs={"traj": traj})
         for c in range(3)], name="analysis")
    am = core.AppManager(m.executor.PilotRuntime(slots=4, mode="sim"))
    prof = am.run([prod, ana])
    g = am.session.graph
    starts = {n: g.tasks[n].v_started for n in sorted(g.tasks)}
    assert starts["ana.r0"] == 4.0
    assert len(traj.puts) == 3 and len(traj._taken) == 3
    return {**_profile(prof), "starts": starts,
            "pipelines": prof.results["pipelines"]}


def sc_staged(m, tmp):
    """A staged run: a large Channel put becomes a content-addressed ref,
    dereferenced into the consumer's inputs and charged to its t_data."""
    core, st = m.core, m.staging
    lay = st.StagingLayer(locality=st.LocalityMap(4, slots_per_pod=2),
                          threshold_bytes=64)
    rt = m.executor.PilotRuntime(slots=4, mode="real", staging=lay)
    ch = core.Channel("data")
    big = {"payload": list(range(200))}
    prod = core.PipelineSpec([core.Stage(
        [core.TaskSpec(_echo(m, big), name="p0")], name="s",
        outputs=[ch])], name="P")
    cons = core.PipelineSpec([core.Stage(
        [core.TaskSpec(_echo(m, "c"), name="c0")], name="a",
        inputs={"d": ch})], name="C")
    am = core.AppManager(rt)
    prof = am.run([prod, cons])
    assert isinstance(ch.puts[0][1], st.StagedRef)
    assert am.session.graph.tasks["c0"].t_data > 0.0
    summ = prof.results["staging"]
    assert len(lay.store) == 0
    return {**_profile(prof, times=False),
            "inputs": prof.results["tasks"]["c0"]["inputs"],
            "n_transfers": summ["transfers"]["n_transfers"],
            "store_puts": lay.store.stats["puts"]}


def sc_fail_retries(m, tmp):
    """``synthetic.fail`` retried under a ``FaultInjector`` in real mode
    (each fails its first attempt), then a DES bag whose pod 2 is killed
    at t=5: the victim is retried off the dead pod."""
    core = m.core
    fails = [core.TaskSpec(_fail(m, 1), name=f"f{i}") for i in range(3)]
    rt = m.executor.PilotRuntime(slots=4, mode="real", max_retries=2,
                                 faults=m.faults.FaultInjector())
    prof = core.AppManager(rt).run(
        [core.PipelineSpec([core.Stage(fails, name="s")], name="p")])
    assert prof.n_failed == 0 and prof.n_retries == 3
    real = {**_profile(prof, times=False), "results": prof.results["tasks"]}

    g = m.states.TaskGraph()
    for i in range(8):
        g.add(m.states.Task(name=f"t{i}", duration=10.0, stage="w"))
    rt = m.executor.PilotRuntime(
        slots=8, mode="sim", max_retries=2,
        faults=m.faults.FaultInjector(kill_at=[(5.0, "pod2")]))
    sim = rt.run(g)
    assert sim.n_pod_lost == 1 and sim.ttc == 20.0 and rt.slots == 7
    history = {n: [(h["attempt"], h["outcome"], h["pod"]) for h in t.history]
               for n, t in g.tasks.items() if t.history}
    return {"real": real, "sim": {
        "ttc": sim.ttc, "n_retries": sim.n_retries,
        "n_pod_lost": sim.n_pod_lost, "free": sorted(rt._free_ids),
        "history": history}}


def _fail(m, times):
    k = m.core.Kernel("synthetic.fail")
    k.arguments = {"fail_times": times}
    return k


def sc_journal_restart(m, tmp):
    """A journal restart: a DES pipeline app run twice on one journal; the
    second run replays every task as done and runs none."""
    core = m.core

    def app():
        return [core.PipelineSpec(
            [core.Stage([core.TaskSpec(_noop(m, 1.0 + i), name=f"s{s}.{i}")
                         for i in range(3)], name=f"s{s}")
             for s in range(2)], name="p")]

    path = str(tmp / "j.jsonl")
    first = core.AppManager(m.executor.PilotRuntime(
        slots=2, mode="sim", journal=m.journal.Journal(path))).run(app())
    n_first = len(_journal_order(path))
    rt = m.executor.PilotRuntime(slots=2, mode="sim",
                                 journal=m.journal.Journal(path))
    am = core.AppManager(rt)
    second = am.run(app())
    assert first.ttc > 0 and second.ttc == 0.0
    assert all(t.state == m.states.TaskState.DONE
               for t in am.session.graph.tasks.values())
    return {"first": _profile(first), "second": _profile(second),
            "journal": _journal_order(path), "n_first": n_first}


def sc_diagnostics(m, tmp):
    """E107 (a kernel name no plugin registered) and E115 (an unknown SLA
    class), from the linter and at submit time."""
    core, diag = m.core, m.diagnostics
    bad = core.PipelineSpec([core.Stage([core.TaskSpec("no.such.kernel")],
                                        name="s0")], name="p")
    rep = m.analysis.validate_app([bad])
    d = next(d for d in rep.diagnostics if d.code == "E107")
    out = {"E107": (rep.codes(), d.pipeline, d.stage)}
    ok = core.PipelineSpec([core.Stage([core.TaskSpec("synthetic.noop")],
                                       name="s0")], name="p")
    assert "E107" not in m.analysis.validate_app([ok]).codes()
    sla = core.PipelineSpec([core.Stage(
        [core.TaskSpec(_noop(m), sla="gold")], name="s0")], name="p")
    rep = m.analysis.validate_app([sla])
    out["E115"] = rep.codes()
    raised = []
    for app in (sla, core.PipelineSpec([core.Stage(
            [core.TaskSpec("no.such.kernel")], name="s0")], name="q")):
        with pytest.raises(diag.DiagnosticError) as e:
            core.AppManager(m.executor.PilotRuntime(slots=2, mode="sim")).run(
                app, validate="off")
        raised.append([d.code for d in e.value.diagnostics])
    out["raised"] = raised
    assert raised == [["E115"], ["E107"]]
    return out


def _serve_ensemble_run(m, ex, mode, journal=None):
    """The example's ``main``: its pilot (``preempt=True``, a staging
    layer), its app and its assertions; returns (profile, channels)."""
    staging = m.staging.StagingLayer(
        locality=m.staging.LocalityMap(ex.SLOTS, slots_per_pod=2),
        threshold_bytes=1 << 10)
    rt = m.executor.PilotRuntime(slots=ex.SLOTS, mode=mode, staging=staging,
                                 preempt=True, journal=journal)
    am = m.core.AppManager(rt)
    pipes, channels, metrics = ex.build(mode)
    if mode == "real" and m.name == "repro_torch":
        for p in pipes:          # the port's entry points default to cuda
            for st in p.stages:
                for sp in st.tasks:
                    if sp.kernel.name == "serve.decode":
                        sp.kernel.arguments["device"] = "cpu"
    prof = am.run(pipes, validate="error")
    metrics.install(am, prof)
    s = prof.results["serving"]
    assert prof.n_failed == 0
    assert all(info["state"] == "done"
               for info in prof.results["pipelines"].values())
    assert sum(c["n"] for c in s["classes"].values()) == \
        ex.MODEL.total_requests(ex.WINDOWS)
    for ch in channels.values():
        assert ch.peak_unconsumed_bytes <= ex.CAPACITY_BYTES
        assert ch.n_unconsumed() == 0
    return prof, channels


def sc_serve_ensemble_sim(m, tmp):
    """``examples/serve_ensemble.py --sim``: two SLA classes of traffic
    windows through byte-metered Channels, co-tenant with a training bag on
    a preemptive pilot; latency windows evict their way in."""
    ex = example_module("serve_ensemble", m.name)
    prof, channels = _serve_ensemble_run(
        m, ex, "sim", m.journal.Journal(str(tmp / "j.jsonl")))
    assert prof.n_preempted >= 1
    return {**_profile(prof), "n_preempted": prof.n_preempted,
            "serving": prof.results["serving"],
            "pipelines": prof.results["pipelines"],
            "peaks": {n: ch.peak_unconsumed_bytes
                      for n, ch in channels.items()},
            "journal": _journal_order(tmp / "j.jsonl")}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_charcount, sc_pipeline_sim, sc_bag_sim, sc_re_sim, sc_sal_sim,
    sc_adaptive_pst, sc_channel, sc_staged, sc_fail_retries,
    sc_journal_restart, sc_diagnostics, sc_serve_ensemble_sim)}

_REFERENCE = {}


def _reference(name, tmp_path_factory):
    if name not in _REFERENCE:
        tmp = tmp_path_factory.mktemp(f"ref_{name}")
        _REFERENCE[name] = SCENARIOS[name](_pkg("repro"), tmp)
    return _REFERENCE[name]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_front_end_matches_reference(scenario, pkg, tmp_path,
                                     tmp_path_factory):
    """The scenario on ``pkg`` gives what it gives on ``repro`` (for
    ``repro`` itself: a second run gives the same, so the comparison is
    exact where it claims to be)."""
    got = SCENARIOS[scenario](_pkg(pkg), tmp_path)
    assert got == _reference(scenario, tmp_path_factory)


# ------------------------------------------------------------ port only

def test_serving_and_checkpoint_plugins_validate_without_e107():
    """``lm.checkpoint``, ``serve.source`` and ``serve.decode`` are
    registered in the port: a pattern that names them validates clean of
    E107, as it does on the JAX package."""
    from repro_torch.analysis import validate_app
    from repro_torch.core import PipelineSpec, Stage, TaskSpec
    from repro_torch.core.kernel_plugin import kernel_registered
    for kname in ("lm.checkpoint", "serve.source", "serve.decode"):
        assert kernel_registered(kname)
        app = PipelineSpec([Stage([TaskSpec(kname)], name="s0")], name="p")
        assert "E107" not in validate_app([app]).codes()


def test_serve_ensemble_example_real_mode_on_serve_tiny():
    """The example's app in real mode on the port: every serve window
    decodes on ``serve-tiny`` (CPU) with its full token count, the
    example's assertions hold."""
    m = _pkg("repro_torch")
    ex = example_module("serve_ensemble", m.name)
    prof, _ = _serve_ensemble_run(m, ex, "real")
    tasks = prof.results["tasks"]
    for k in range(ex.WINDOWS):
        for sla in ("latency", "throughput"):
            reqs = ex.MODEL.requests(k, sla)
            if reqs:
                out = tasks[f"serve.{sla}.w{k:05d}"]
                assert out["served"] == len(reqs)
                assert out["tokens"] == sum(r.max_new_tokens for r in reqs)


def test_topology_slots_and_submesh_for(monkeypatch):
    """A topology makes the pilot's slots: its slot count, one slot id a
    task; ``submesh_for`` needs a topology, and a submesh needs an
    initialised process group of ranks (real submeshes:
    ``tests/test_torch_dist_gloo.py``)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.dist.topology import SlotTopology
    from repro_torch.runtime.executor import PilotRuntime
    from repro_torch.runtime.states import Task, TaskGraph
    rt = PilotRuntime(topology=SlotTopology.even(np.arange(4), 4),
                      mode="sim")
    assert rt.slots == 4
    g = TaskGraph()
    for i in range(6):
        g.add(Task(name=f"t{i}", duration=1.0))
    prof = rt.run(g)
    assert prof.ttc == 2.0 and sorted(rt._free_ids) == [0, 1, 2, 3]
    assert all(len(t.meta["slot_ids"]) == 1 for t in g.tasks.values())
    with pytest.raises(ValueError, match="no device topology"):
        PilotRuntime(slots=2, mode="sim").submesh_for(Task(name="t"))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    t = Task(name="u")
    t.meta["slot_ids"] = [1]
    with pytest.raises(RuntimeError, match="init_process_group"):
        rt.submesh_for(t)


def test_kernel_attributes_match_reference():
    import repro.core.kernel_plugin as ref
    import repro_torch.core.kernel_plugin as port
    a, b = ref.Kernel("synthetic.noop"), port.Kernel("synthetic.noop")
    assert sorted(vars(a)) == sorted(vars(b))
    assert port.kernel_registered("lm.train")
    assert port.kernel_registered("lm.checkpoint")
    names = {"lm.checkpoint", "lm.decode", "lm.eval", "lm.train",
             "misc.ccount", "misc.mkfile", "re.exchange", "serve.decode",
             "serve.source", "synthetic.echo", "synthetic.fail",
             "synthetic.flops", "synthetic.noop", "synthetic.sleep"}
    assert set(port.kernel_names()) == names
    # the reference's registry also holds kernels its own tests register
    assert names <= set(ref.kernel_names())


def test_public_names_match_reference():
    import repro.core as ref
    import repro_torch.core as port
    public = lambda mod: {n for n in vars(mod) if not n.startswith("_")
                          and not isinstance(vars(mod)[n], type(sys))}
    assert public(ref) - public(port) == set()
    assert public(port) <= public(ref)


def test_cuda_resource_needs_a_card(monkeypatch):
    import torch

    from repro_torch.core import SingleClusterEnvironment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cl = SingleClusterEnvironment(resource="cuda.h100", cores=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cl.allocate()
    cl = SingleClusterEnvironment(cores=2)
    assert cl.allocate().device is None
    cl.deallocate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cl = SingleClusterEnvironment(resource="cuda.h100", cores=2)
    assert cl.allocate().device == torch.device("cuda")
    cl.deallocate()


def test_core_imports_without_jax():
    """The front end, in a process where ``jax`` cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.core import (SingleClusterEnvironment, "
        "ReplicaExchange, SimulationAnalysisLoop, Pipeline, AppManager, "
        "PipelineSpec, Stage, TaskSpec, Kernel)\n"
        "import repro_torch.analysis, repro_torch.staging\n"
        "import repro_torch.runtime.strategy\n"
        "import repro_torch.launch.train, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.mesh, repro_torch.roofline.report\n"
        "import repro_torch.roofline.op_costs\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ------------------------------------------------------------ thread safety

def test_build_load_from_threads_builds_once(tmp_path, monkeypatch):
    """Threads that need one library at once: one nvcc run, one handle."""
    from repro_torch.kernels import _build
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write('x\\n')\n"
        "time.sleep(0.2)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    nvcc.chmod(0o755)
    opened = []

    class FakeCDLL:
        def __init__(self, path):
            opened.append(path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    got, errors = [], []
    barrier = threading.Barrier(8)

    def worker():
        try:
            barrier.wait(timeout=30)
            got.append(_build.load("linear_scan"))
        except Exception as e:     # read below: a lost error fails the test
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert calls.read_text().count("x") == 1
    assert len(opened) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_launch_counts_lose_nothing_across_threads():
    from repro_torch.kernels import LAUNCHES, count_launch
    before = LAUNCHES["linear_scan"], LAUNCHES["gmm"]
    n, per = 8, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch("linear_scan", "gmm")
                            for _ in range(per)]) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        got = LAUNCHES["linear_scan"], LAUNCHES["gmm"]
        LAUNCHES["linear_scan"], LAUNCHES["gmm"] = before
    assert not any(t.is_alive() for t in threads)
    assert got == (before[0] + n * per, before[1] + n * per)


def test_step_cache_builds_each_step_once(monkeypatch):
    from repro_torch.plugins import lm
    built = []

    def slow_build(cfg, hyper):
        built.append(hyper)
        threading.Event().wait(0.05)
        return object()
    monkeypatch.setattr(lm, "_STEP_CACHE", {})
    monkeypatch.setattr(lm, "build_train_step", slow_build)
    cfg = lm.resolve_cfg("reduced:gemma2-2b")
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        lm._steps(cfg, "train"))) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(got) == 6
    assert all(s is got[0] for s in got)

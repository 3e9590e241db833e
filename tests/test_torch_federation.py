"""The port's federation layer (``repro_torch.federation``) held against the
JAX package's (``repro.federation``) on the CPU.

Sim mode (``synthetic.*`` kernels): each scenario runs through both
packages, as the cases of one parametrised test, and gives the same TTC,
per-pilot dispatch, cross-pilot bytes, recruiter decisions and per-pilot
journal record order.  Real mode: the RE app of ``lm.train`` members on a
reduced gemma2-2b runs on a two-pilot fleet in both packages from the same
member states, and a run that loses a pilot mid-task leaves the member at
the same step in both.  ``examples/pst_federated.py`` runs through both
packages, and ``chip_smoke.py``'s ``federation`` phase is rehearsed.
"""
import importlib
import importlib.util
import json
import os
import threading
from collections import Counter
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

from _port_examples import example_module, printed

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")


def _pkg(name):
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")
    return SimpleNamespace(
        name=name, core=mod("core"), fed=mod("federation"),
        executor=mod("runtime.executor"), journal=mod("runtime.journal"),
        states=mod("runtime.states"), analysis=mod("analysis"),
        obs=mod("obs"), lm=mod("plugins.lm"), kp=mod("core.kernel_plugin"),
        plugin=mod("core.execution_plugin"))


def _bag(m, n, dur=1.0, slots=1):
    g = m.states.TaskGraph()
    for i in range(n):
        g.add(m.states.Task(name=f"t{i:03d}", duration=dur, slots=slots))
    return g


def _member(m, dur=1.0, nbytes=None, cores=None):
    k = m.core.Kernel("synthetic.noop")
    k.sim_duration = dur
    if nbytes is not None:
        k.output_nbytes = nbytes
    if cores is not None:
        k.cores = cores
    return k


def _coupled(m, pipelines=2, cycles=3, members=4, nbytes=64 << 20):
    """``examples/pst_federated.py``'s coupled shape: producer ensembles
    streaming cycle outputs through Channels into analysis pipelines."""
    c = m.core
    pipes = []
    for p in range(pipelines):
        ch = c.Channel(f"traj{p}")
        pipes.append(c.PipelineSpec(
            [c.Stage([c.TaskSpec(_member(m, nbytes=nbytes),
                                 name=f"p{p}.c{i}.m{j}")
                      for j in range(members)], name=f"cycle{i}",
                     outputs=[ch])
             for i in range(cycles)], name=f"producer{p}"))
        pipes.append(c.PipelineSpec(
            [c.Stage([c.TaskSpec(_member(m, dur=0.5), name=f"a{p}.r{i}")],
                     name=f"round{i}", inputs={"traj": ch})
             for i in range(cycles)], name=f"analysis{p}"))
    return pipes


def _journals(tmp):
    """Every record of every journal under ``tmp`` in write order, without
    the wall clock: (file, pilot, task or None, event, attempts, vt)."""
    out = {}
    for path in sorted(Path(tmp).glob("*.jsonl")):
        recs = []
        for line in path.read_text().splitlines():
            r = json.loads(line)
            recs.append((r.get("pilot"), r.get("task"), r["event"],
                         r.get("attempts"), r.get("vt"), r.get("pod")))
        out[path.name] = recs
    return out


def _by_pilot(graph):
    return dict(sorted(Counter(t.meta.get("pilot")
                               for t in graph.tasks.values()).items()))


def _chaos(fleet, at, pilot="p2"):
    killed = {}

    def chaos(rt, graph, now):
        if now >= at and not killed:
            killed["t"] = now
            fleet.inject_pilot_failure(pilot)
    for rt in fleet.pilots.values():
        rt.on_schedule = chaos
    return killed


# ------------------------------------------------------------ scenarios

def sc_bag(m, tmp):
    """A bag late-binds across two pilots (``Fleet.run``)."""
    fleet = m.fed.build_fleet(2, slots=4, staging=False)
    g = _bag(m, 40)
    prof = fleet.run(g)
    return {"ttc": prof.ttc, "n_failed": prof.n_failed,
            "dispatch": _by_pilot(g), "summary": fleet.summary()}


def sc_coupled_journaled(m, tmp):
    """The coupled app through ``AppManager`` on a staged two-pilot fleet
    with per-pilot journals: every analysis round binds to the pilot that
    holds its inputs."""
    with mock.patch.dict(os.environ, {"REPRO_JOURNAL_DIR": str(tmp)}):
        fleet = m.fed.build_fleet(2, slots=8, slots_per_pod=2,
                                  journal_base="fed")
    prof = m.core.AppManager(fleet).run(_coupled(m), validate="error")
    planner = fleet.staging.planner
    fleet.close()
    # every pilot's journal, whichever package wrote it, read by the JAX
    # package's report
    report = importlib.import_module("repro.obs.report")
    return {"ttc": prof.ttc, "n_tasks": prof.n_tasks,
            "n_failed": prof.n_failed, "t_data": prof.t_data,
            "federation": prof.results["federation"],
            "planner": planner.summary(), "stats": dict(planner.stats),
            "journals": _journals(tmp),
            "decomposed": {p.name: report.decompose(
                report.load_segments(str(p))[-1])["totals"]
                for p in sorted(Path(tmp).glob("*.jsonl"))}}


def sc_cross_pilot_fetch(m, tmp):
    """The producer's pilot retired between runs: the consumer fetches its
    input pilot to pilot, at ``cross_gbps``."""
    c = m.core
    fleet = m.fed.build_fleet(2, slots=4, slots_per_pod=2)
    am = c.AppManager(fleet)
    ch = c.Channel("traj")
    prod = c.PipelineSpec([c.Stage([c.TaskSpec(_member(m, nbytes=64 << 20),
                                               name="prod")],
                                   name="s0", outputs=[ch])], name="P")
    first = am.run([prod])
    src = am.session.graph.tasks["prod"].meta["pilot"]
    fleet.retire_pilot(src)
    cons = c.PipelineSpec([c.Stage([c.TaskSpec(_member(m), name="cons")],
                                   name="r0", inputs={"traj": ch})],
                          name="C")
    second = am.run([cons])
    t = am.session.graph.tasks["cons"]
    out = {"ttc": [first.ttc, second.ttc], "src": src,
           "cons_pilot": t.meta["pilot"], "cons_t_data": t.t_data,
           "stats": dict(fleet.staging.planner.stats),
           "federation": second.results["federation"]}
    fleet.close()
    return out


def sc_pilot_loss(m, tmp):
    """Whole-pilot death mid-run: in-flight attempts are lost and retried
    on the survivor; per-pilot journals record it."""
    with mock.patch.dict(os.environ, {"REPRO_JOURNAL_DIR": str(tmp)}):
        fleet = m.fed.build_fleet(2, slots=4, max_retries=2,
                                  journal_base="loss")
    killed = _chaos(fleet, 2.0)
    g = _bag(m, 16, dur=2.0)
    prof = fleet.run(g)
    fleet.close()
    return {"ttc": prof.ttc, "n_failed": prof.n_failed,
            "n_pod_lost": prof.n_pod_lost, "n_retries": prof.n_retries,
            "killed": killed, "dead_pods": sorted(fleet.dead_pods),
            "dispatch": _by_pilot(g),
            "history": {n: [(h["outcome"], h["pod"]) for h in t.history]
                        for n, t in sorted(g.tasks.items())},
            "journals": _journals(tmp)}


def sc_replay(m, tmp):
    """A second run over the first run's per-pilot journals skips every
    task they record done; only the new task runs."""
    with mock.patch.dict(os.environ, {"REPRO_JOURNAL_DIR": str(tmp)}):
        fleet = m.fed.build_fleet(2, slots=4, staging=False,
                                  journal_base="run")
        first = fleet.run(_bag(m, 8))
        fleet.close()
        fleet2 = m.fed.build_fleet(2, slots=4, staging=False,
                                   journal_base="run")
        g = _bag(m, 8)
        g.add(m.states.Task(name="fresh", duration=1.0))
        second = fleet2.run(g)
        fleet2.close()
    return {"ttc": [first.ttc, second.ttc], "events": second.events,
            "attempts": {n: t.attempts for n, t in sorted(g.tasks.items())},
            "files": sorted(p.name for p in Path(tmp).glob("*.jsonl"))}


def sc_recruiter(m, tmp):
    """An elastic fleet: the Recruiter grows it against the backlog (with
    modeled spin-up and hysteresis), then shrinks it once idle."""
    rec = m.fed.Recruiter(min_pilots=1, max_pilots=4, slots_per_pilot=4,
                          budget_slots=16, hysteresis_s=6.0, spinup_s=2.0)
    fleet = m.fed.build_fleet(1, slots=4, staging=False, recruiter=rec)
    prof = fleet.run(_bag(m, 200))
    shrink = m.fed.Recruiter(min_pilots=1, max_pilots=4, slots_per_pilot=4,
                             budget_slots=16, hysteresis_s=1.0, spinup_s=0.5)
    fleet2 = m.fed.build_fleet(3, slots=4, staging=False, recruiter=shrink)
    sess = fleet2.session()
    sess.graph.add(m.states.Task(name="long", duration=40.0))
    for i in range(8):
        sess.graph.add(m.states.Task(name=f"s{i}", duration=1.0))
    prof2 = sess.drain()
    return {"ttc": [prof.ttc, prof2.ttc], "events": [rec.events,
                                                     shrink.events],
            "summary": [rec.summary(), shrink.summary()],
            "fleet": [fleet.summary(), fleet2.summary()]}


def sc_traced(m, tmp):
    """A tracer on the fleet: per-pilot dispatch instants, attempt spans
    tagged with their pilot, per-pilot load gauges in the timeline."""
    fleet = m.fed.build_fleet(2, slots=8, slots_per_pod=2)
    fleet.tracer = tr = m.obs.Tracer()
    prof = m.core.AppManager(fleet).run(_coupled(m))
    ts = prof.results["timeseries"]
    fleet.close()
    return {"ttc": prof.ttc, "spans": tr.spans, "events": tr.events,
            "gauges": sorted(ts["gauges"]), "counters": ts["counters"],
            "n_samples": ts["n_samples"], "trace": prof.results["trace"],
            "decompose": m.obs.decompose(
                m.obs.report.segment_from_tracer(tr))["totals"]}


def sc_validate(m, tmp):
    """E114 (wider than any pilot the fleet can field), W202 (only a
    recruited pilot fits), W205 (hysteresis under spin-up) and their
    clean twins, on real fleets."""
    c, v = m.core, m.analysis.validate_app

    def pipes(cores):
        return [c.PipelineSpec([c.Stage([c.TaskSpec(
            _member(m, cores=cores))], name="s0")], name="p")]
    fleet = m.fed.build_fleet(2, slots=4, staging=False)
    wide = m.fed.build_fleet(1, slots=4, staging=False,
                             recruiter=m.fed.Recruiter(
                                 max_pilots=4, slots_per_pilot=8,
                                 budget_slots=16, hysteresis_s=10.0,
                                 spinup_s=5.0))
    blind = m.fed.build_fleet(1, slots=4, staging=False,
                              recruiter=m.fed.Recruiter(hysteresis_s=2.0,
                                                        spinup_s=10.0))
    return {"e114": v(pipes(6), runtime=fleet).codes(),
            "clean": v(pipes(4), runtime=fleet).codes(),
            "w202": v(pipes(6), runtime=wide).codes(),
            "w205": v(pipes(1), runtime=blind).codes(),
            "example": printed(example_module("pst_federated", m.name)
                               .validate_only, fast=True)}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_bag, sc_coupled_journaled, sc_cross_pilot_fetch, sc_pilot_loss,
    sc_replay, sc_recruiter, sc_traced, sc_validate)}

_REFERENCE = {}


def _reference(name, tmp_path_factory):
    if name not in _REFERENCE:
        tmp = tmp_path_factory.mktemp(f"ref_{name}")
        _REFERENCE[name] = SCENARIOS[name](_pkg("repro"), tmp)
    return _REFERENCE[name]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_federation_matches_reference(scenario, pkg, tmp_path,
                                      tmp_path_factory):
    got = SCENARIOS[scenario](_pkg(pkg), tmp_path)
    assert got == _reference(scenario, tmp_path_factory)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pst_federated_example_matches_reference(pkg):
    """``examples/pst_federated.py --fast`` on ``pkg``: the same printed
    TTC, n_failed, dispatch and cross-pilot bytes of its four runs (one
    pilot, two, elastic, a pilot lost) as on the JAX package."""
    def run(name):
        return printed(example_module("pst_federated", name).main,
                       fast=True)[1]
    out = run(pkg)
    assert "cross_pilot_bytes=" in out and "pilot p2 died" in out
    assert out == run("repro")


# ------------------------------------------------------------ port only

def test_app_manager_reports_the_fleet():
    """``AppManager`` on a ``repro_torch.federation.Fleet``: the profile's
    ``federation`` entry (fleet shape, dispatch per pilot) and, with a
    tracer, the timeline and trace summary."""
    from repro_torch.core import AppManager
    from repro_torch.federation import Fleet, make_pilot
    from repro_torch.obs import Tracer
    m = _pkg("repro_torch")
    fleet = Fleet({"a": make_pilot("a", slots=2), "b": make_pilot("b",
                                                                slots=4)},
                  tracer=Tracer())
    prof = AppManager(fleet).run(_coupled(m, nbytes=None))
    fed = prof.results["federation"]
    assert fed["n_pilots"] == 2 and fed["pilot_slots"] == {"a": 2, "b": 4}
    assert sum(fed["dispatch"].values()) == prof.n_tasks
    assert prof.results["timeseries"]["n_samples"] > 0
    assert "pilot_busy:a" in prof.results["timeseries"]["gauges"]
    assert prof.results["trace"]["n_open"] == 0


# ------------------------------------------------------------ real mode

ARCH = "reduced:gemma2-2b"
# as tests/test_torch_system.py: f32 on both sides, the losses of cycle 1
# follow one AdamW step of different summation orders
LOSS_TOL = 1e-4


@pytest.fixture
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _re_app(m, ensemble, cycles, replicas):
    """tests/test_system.py's RE app of lm.train members on ``m``."""
    extra = {"device": "cpu"} if m.name == "repro_torch" else {}

    class PBT(m.core.ReplicaExchange):
        def __init__(self):
            super().__init__(cycles, replicas)
            self.temps = [3e-4 * 1.5 ** i for i in range(replicas)]
            self.temp_history = [list(self.temps)]

        def prepare_replica_for_md(self, r):
            k = m.core.Kernel("lm.train")
            k.arguments = {"arch": ARCH, "steps": 1, "member": r.id,
                           "ensemble": ensemble, "lr": self.temps[r.id],
                           "batch": 2, "seq": 32, **extra}
            return k

        def prepare_exchange(self, replicas_):
            k = m.core.Kernel("re.exchange")
            k.arguments = {"replicas": len(replicas_),
                           "cycle": replicas_[0].cycle,
                           "temps": self.temps, "ensemble": ensemble}
            return k

        def apply_exchange(self, result, replicas_):
            self.temps = result["temps"]
            self.temp_history.append(list(self.temps))
    return PBT()


def _seed_members(ensemble, n):
    """The same initial member states in both packages' stores (JAX's
    ``make_train_state`` for member i, carried into the port)."""
    import jax

    from repro.checkpoint.checkpoint import _flatten
    from repro.plugins import lm as jlm
    from repro.train import make_train_state
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.plugins import lm as tlm
    cfg = jlm.resolve_cfg(ARCH)
    for i in range(n):
        state = make_train_state(cfg, jax.random.PRNGKey(i))
        jlm.STATE_STORE[(ensemble, i)] = state
        flat = {k: np.asarray(v) for k, v in _flatten(state).items()}
        tlm.STATE_STORE[(ensemble, i)] = train_state_from_numpy(
            flat, tlm.resolve_cfg(ARCH))


def _lose_first_attempt_on(m, lose, monkeypatch):
    """Wrap ``m``'s lm.train so that the first attempt dispatched to pilot
    ``lose`` runs only after that pilot is dead, and its member's retry
    only after that attempt (now a zombie) has written the member's state:
    the interleaving the port's per-member lock gives, forced in both
    packages.  The pilots' on_schedule hook kills ``lose`` once the
    attempt runs.  Returns the hook and a record of the lost attempt."""
    real = m.kp._KERNEL_REGISTRY["lm.train"]
    lost = {}
    zombie_done = threading.Event()

    def train(args, ctx):
        task, fleet = ctx["task"], ctx["runtime"]
        first = not lost and task.meta.get("pilot") == lose
        if first:
            lost.update(task=task.name, member=int(args["member"]))
            ok = threading.Event()
            for _ in range(6000):
                if fleet.pilots[lose].dead_pods:
                    ok.set()
                    break
                ok.wait(0.01)
            assert ok.is_set(), "the pilot was never lost"
            try:
                return real.fn(args, ctx)
            finally:
                zombie_done.set()
        if lost and task.name == lost["task"]:
            assert zombie_done.wait(60), "the lost attempt never ended"
        return real.fn(args, ctx)
    monkeypatch.setitem(m.kp._KERNEL_REGISTRY, "lm.train",
                        m.kp.KernelDef("lm.train", train))

    def hook(fleet):
        def chaos(rt, graph, now):
            if lost.get("task") and not fleet.pilots[lose].dead_pods \
                    and "killed" not in lost:
                lost["killed"] = True
                fleet.inject_pilot_failure(lose)
        for rt in fleet.pilots.values():
            rt.on_schedule = chaos
    return hook, lost


def _fleet_re(m, ensemble, cycles, replicas, hook=None):
    fleet = m.fed.build_fleet(2, slots=1, mode="real")
    if hook is not None:
        hook(fleet)
    app = _re_app(m, ensemble, cycles, replicas)
    plugin = m.plugin.get_plugin(app, fleet)     # as plugin.execute() runs
    am = m.core.AppManager(fleet, profile=plugin.profile)
    prof = am.run(plugin.compile())
    for th in list(am.session._zombie_threads):
        th.join(60)
        assert not th.is_alive(), "the lost attempt never ended"
    steps = {i: int(np.asarray(m.lm.STATE_STORE[(ensemble, i)]["step"]))
             for i in range(replicas)}
    fleet.close()
    return prof, am, app, steps


def _release(ensemble):
    from repro.plugins import lm as jlm
    from repro_torch.plugins import lm as tlm
    for store in (jlm.STATE_STORE, tlm.STATE_STORE):
        for sid in [s for s in store if s[0] == ensemble]:
            del store[sid]


def test_fleet_re_with_lm_members_matches_jax(_full_f32_matmuls):
    """The RE app (4 members, 2 cycles) on a fleet of two one-slot pilots
    in both packages from the same member states: both pilots take work
    (the first two members bind to p1 and p2), the losses of every cycle
    agree within LOSS_TOL, the temperature histories and accepted pairs
    are identical."""
    ens = "fed_parity_re"
    out = {}
    try:
        _seed_members(ens, 4)
        for pkg in PACKAGES:
            out[pkg] = _fleet_re(_pkg(pkg), ens, cycles=2, replicas=4)
    finally:
        _release(ens)
    (jp, _, japp, jsteps), (tp, _, tapp, tsteps) = out["repro"], \
        out["repro_torch"]
    for prof in (jp, tp):
        assert prof.n_failed == 0 and prof.n_retries == 0
        assert set(prof.results["federation"]["dispatch"]) == {"p1", "p2"}
    for c in range(2):
        want, got = jp.results[f"exchange_{c}"], tp.results[f"exchange_{c}"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_TOL)
        assert got["temps"] == want["temps"]
        assert [tuple(p) for p in got["accepted"]] == \
            [tuple(p) for p in want["accepted"]]
    assert tapp.temp_history == japp.temp_history
    # which pilot frees first decides the rest of the dispatch (real mode)
    assert tsteps == jsteps == {i: 2 for i in range(4)}


def test_pilot_lost_mid_train_leaves_the_member_at_the_same_step(
        monkeypatch, _full_f32_matmuls):
    """Pilot p2 lost while its first lm.train attempt runs: the attempt is
    retried on p1, and the lost attempt trains on as a zombie (ROADMAP
    C5), so in both packages its member ends one step past the others."""
    ens = "fed_parity_loss"
    out = {}
    try:
        _seed_members(ens, 2)
        for pkg in PACKAGES:
            m = _pkg(pkg)
            with monkeypatch.context() as mp:
                hook, lost = _lose_first_attempt_on(m, "p2", mp)
                prof, am, _, steps = _fleet_re(m, ens, cycles=2, replicas=2,
                                               hook=hook)
            hist = [(h["outcome"], h["pod"])
                    for h in am.session.graph.tasks[lost["task"]].history]
            out[pkg] = (prof.n_failed, prof.n_retries, prof.n_pod_lost,
                        lost["member"], hist, steps)
            _release(ens)
            _seed_members(ens, 2)
    finally:
        _release(ens)
    assert out["repro_torch"] == out["repro"]
    n_failed, n_retries, n_lost, member, hist, steps = out["repro_torch"]
    assert (n_failed, n_retries, n_lost) == (0, 1, 1)
    assert hist == [("pod_lost", "p2:pod0"), ("done", "p1:pod0")]
    assert steps == {i: 3 if i == member else 2 for i in range(2)}


# ------------------------------------------------ chip_smoke rehearsal

def test_chip_smoke_federation_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``federation`` phase on the CPU at a reduced
    size (the ensemble rehearsal's members and counted attention calls),
    after the ``ensemble`` phase whose losses it must give again; run 2's
    lost attempt is held until the pilot is dead, as a member's first step
    on the card outlasts the drain loop's poll."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import kernel_plugin as kp
    from repro_torch.core import resource_handler
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.plugins import lm as tlm

    E = chip_smoke.ENSEMBLE
    cfg = reduced(get_config(E["base"]), layers=E["layers"]).replace(
        name=E["arch"], remat="full", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, cfg.name, cfg)
    monkeypatch.setitem(E, "seq", 64)

    def counted(fn, name, variant):
        def run(q, *a, **kw):
            count_launch(name, f"{name}.{variant(q.dtype, q.shape[-1])}")
            return fn(q, *a, **kw)
        return run
    for attr, name in (("attention_fwd_ref", "flash_attention"),
                       ("attention_ref", "flash_attention"),
                       ("attention_bwd_ref", "flash_attention_bwd")):
        monkeypatch.setattr(ops, attr, counted(getattr(ops, attr), name,
                                               ops.variant))
    monkeypatch.setattr(resource_handler, "resolve_device",
                        lambda d: torch.device("cpu"))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "_card", lambda: "cpu, 0 W")
    dev = torch.device("cpu")
    ens = chip_smoke.phase_ensemble(dev)
    real = kp._KERNEL_REGISTRY["lm.train"]

    def held(args, ctx):
        fleet, task = ctx["runtime"], ctx["task"]
        lose = chip_smoke.FED["lost"]
        if task.meta.get("pilot") == lose and lose in fleet.pilots:
            for _ in range(6000):
                if fleet.pilots[lose].dead_pods:
                    break
                threading.Event().wait(0.01)
        return real.fn(args, ctx)
    runs = []
    emit = chip_smoke.emit
    monkeypatch.setattr(chip_smoke, "emit",
                        lambda obj: (runs.append(obj), emit(obj)))
    original = chip_smoke._fleet_run

    def fleet_run(dev, app, tag, jdir, lose=None):
        with monkeypatch.context() as mp:
            if lose is not None:
                mp.setitem(kp._KERNEL_REGISTRY, "lm.train",
                           kp.KernelDef("lm.train", held))
            return original(dev, app, tag, jdir, lose)
    monkeypatch.setattr(chip_smoke, "_fleet_run", fleet_run)
    got = chip_smoke.phase_federation(dev)
    steps = E["replicas"] * E["cycles"]
    assert got == {"flash_attention": 8 * (2 * steps + 1),
                   "flash_attention.wgmma": 8 * (2 * steps + 1),
                   "flash_attention_bwd": 4 * (2 * steps + 1),
                   "flash_attention_bwd.wgmma": 4 * (2 * steps + 1)}
    rows = [r for r in runs if "run" in r]
    assert [r["run"] for r in rows] == [1, 2] and all(r["ok"] for r in rows)
    assert rows[0]["ensemble_phase"]["bitwise_equal"]
    assert rows[1]["lost_attempt"]["spans"][0]["outcome"] == "pod_lost"
    assert ens["flash_attention"] > 0
    assert not [s for s in tlm.STATE_STORE if s[0].startswith("fed_")]

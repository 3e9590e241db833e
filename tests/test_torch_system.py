"""The paper's ensembles on the port's task kernels, on the CPU: the RE app
(``tests/test_system.py:36``) and the SAL app (``:73``) through
``repro_torch.core`` with ``lm.train``/``lm.eval`` on ``reduced:gemma2-2b``
and ``"device": "cpu"``, and the same apps through both packages from the
same initial member states (JAX's ``make_train_state``, carried across
with ``train_state_from_numpy``): per-cycle member losses within
``LOSS_TOL``, identical temperature histories and accepted pairs.
"""
import importlib.util
import math
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.plugins.lm as jlm  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.plugins.re_exchange import metropolis_swaps  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro_torch.models.convert import train_state_from_numpy  # noqa: E402
from repro_torch.plugins import lm as tlm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "reduced:gemma2-2b"
# f32 on both sides; the losses of cycle 1 follow one AdamW step of
# different summation orders (the train step alone agrees at 1e-5,
# tests/test_torch_train.py)
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _extra(core):
    """The port's kernels take the torch device; the reference's none."""
    return {"device": "cpu"} if core is tcore else {}


def pbt_app(core, ensemble, cycles, replicas):
    """``tests/test_system.py:36``'s population-based RE, on ``core``."""
    class PBT(core.ReplicaExchange):
        def __init__(self):
            super().__init__(cycles, replicas)
            self.temps = [3e-4 * 1.5 ** i for i in range(replicas)]
            self.temp_history = [list(self.temps)]

        def prepare_replica_for_md(self, r):
            k = core.Kernel("lm.train")
            k.arguments = {"arch": ARCH, "steps": 1, "member": r.id,
                           "ensemble": ensemble, "lr": self.temps[r.id],
                           "batch": 2, "seq": 32, **_extra(core)}
            return k

        def prepare_exchange(self, replicas):
            k = core.Kernel("re.exchange")
            k.arguments = {"replicas": len(replicas),
                           "cycle": replicas[0].cycle,
                           "temps": self.temps, "ensemble": ensemble}
            return k

        def apply_exchange(self, result, replicas):
            self.temps = result["temps"]
            self.temp_history.append(list(self.temps))
    return PBT()


def sal_app(core, ensemble):
    """``tests/test_system.py:73``'s train-until loop, on ``core``."""
    class TrainUntil(core.SimulationAnalysisLoop):
        def simulation_stage(self, it, i):
            k = core.Kernel("lm.train")
            k.arguments = {"arch": ARCH, "steps": 1, "member": i,
                           "ensemble": ensemble, "batch": 2, "seq": 32,
                           **_extra(core)}
            return k

        def analysis_stage(self, it, j):
            k = core.Kernel("lm.eval")
            k.arguments = {"arch": ARCH, "member": j, "ensemble": ensemble,
                           "batch": 2, "seq": 32, **_extra(core)}
            return k

        def should_continue(self, it, results):
            return results[0]["loss"] > 1.0 and it < 1
    return TrainUntil(maxiterations=5, simulation_instances=2,
                      analysis_instances=1)


def run(core, app, cores):
    cl = core.SingleClusterEnvironment(cores=cores)
    cl.allocate()
    try:
        return cl.run(app)
    finally:
        cl.deallocate()


def _release(store, ensemble):
    for sid in [s for s in store if s[0] == ensemble]:
        del store[sid]


def test_replica_exchange_with_lm_members():
    app = pbt_app(tcore, "torch_systest_pbt", cycles=2, replicas=3)
    try:
        prof = run(tcore, app, cores=3)
    finally:
        _release(tlm.STATE_STORE, "torch_systest_pbt")
    assert prof.n_failed == 0 and prof.n_tasks == 8
    assert len(app.temp_history) == 3
    for c in range(2):
        assert all(np.isfinite(prof.results[f"exchange_{c}"]["losses"]))
        assert sorted(app.temp_history[c + 1]) == sorted(app.temp_history[0])


def test_sal_convergence_with_lm():
    try:
        prof = run(tcore, sal_app(tcore, "torch_systest_sal"), cores=2)
    finally:
        _release(tlm.STATE_STORE, "torch_systest_sal")
    assert prof.n_failed == 0 and prof.n_tasks == 6
    assert "analysis_0" in prof.results and "analysis_1" in prof.results
    for it in range(2):
        assert all(math.isfinite(r["loss"])
                   for r in prof.results[f"analysis_{it}"])


def _seed_members(ensemble, n):
    """The same initial member states in both packages' stores: what the
    reference's ``lm.train`` would make for member i (PRNGKey(i))."""
    cfg = jlm.resolve_cfg(ARCH)
    for i in range(n):
        state = jax_make_train_state(cfg, jax.random.PRNGKey(i))
        jlm.STATE_STORE[(ensemble, i)] = state
        flat = {k: np.asarray(v) for k, v in _flatten(state).items()}
        tlm.STATE_STORE[(ensemble, i)] = train_state_from_numpy(
            flat, tlm.resolve_cfg(ARCH))


@pytest.mark.parametrize("app", ["re", "sal"])
def test_ensemble_matches_jax(app):
    """The same app through both packages from the same member states:
    losses per cycle within LOSS_TOL; for RE the temperature history and
    the accepted pairs identical."""
    ens = f"torch_parity_{app}"
    profs, apps = {}, {}
    try:
        _seed_members(ens, 3)
        for core in (jcore, tcore):
            apps[core] = (pbt_app(core, ens, cycles=2, replicas=3)
                          if app == "re" else sal_app(core, ens))
            profs[core] = run(core, apps[core], cores=3)
    finally:
        _release(jlm.STATE_STORE, ens)
        _release(tlm.STATE_STORE, ens)
    for prof in profs.values():
        assert prof.n_failed == 0
    jp, tp = profs[jcore], profs[tcore]
    keys = ([f"exchange_{c}" for c in range(2)] if app == "re"
            else [f"analysis_{it}" for it in range(2)])
    for key in keys:
        if app == "re":
            want, got = jp.results[key], tp.results[key]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=LOSS_TOL, err_msg=key)
            assert got["temps"] == want["temps"]
            assert [tuple(p) for p in got["accepted"]] == \
                [tuple(p) for p in want["accepted"]]
        else:
            np.testing.assert_allclose(
                [r["loss"] for r in tp.results[key]],
                [r["loss"] for r in jp.results[key]], rtol=LOSS_TOL,
                err_msg=key)
    sims = sorted(n for n in tp.results["tasks"] if ".md" in n or ".sim" in n)
    assert sims and sims == sorted(
        n for n in jp.results["tasks"] if ".md" in n or ".sim" in n)
    np.testing.assert_allclose(
        [tp.results["tasks"][n]["loss"] for n in sims],
        [jp.results["tasks"][n]["loss"] for n in sims], rtol=LOSS_TOL)
    if app == "re":
        assert apps[tcore].temp_history == apps[jcore].temp_history


@pytest.mark.parametrize("seed", range(4))
def test_exchange_matches_reference_swaps(seed):
    """The port's ``re.exchange`` (host path) gives exactly the
    reference's ``metropolis_swaps`` on seeded losses, cycle after cycle."""
    rng = np.random.default_rng(seed)
    n = 3 + seed
    temps = [float(t) for t in 3e-4 * 1.5 ** np.arange(n)]
    for cycle in range(4):
        losses = [float(x) for x in rng.normal(5.0, 2.0, n)]
        k = tcore.Kernel("re.exchange")
        k.arguments = {"replicas": n, "cycle": cycle, "temps": temps,
                       "losses": losses, "seed": seed}
        out = k.execute()
        want, accepted = metropolis_swaps(losses, temps, cycle, seed)
        assert out["temps"] == [float(t) for t in want]
        assert out["accepted"] == accepted
        assert out["losses"] == losses
        temps = out["temps"]


def test_chip_smoke_ensemble_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``ensemble`` phase on the CPU at a reduced size
    (its 4 layers, bf16 compute, head_dim 64 so that the counted variant
    is the card's, 64 tokens): the plain attention calls are counted as
    the wrappers count kernel launches, from the pilot's threads, and the
    phase's own checks (exact counts, replayed swaps, the rerun) pass."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import resource_handler
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops

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
    got = chip_smoke.phase_ensemble(torch.device("cpu"))
    steps = E["replicas"] * E["cycles"] + E["sal_sims"] * E["sal_iters"]
    evals = E["sal_iters"]
    assert got == {
        "flash_attention": 8 * steps + 4 * evals,
        "flash_attention.wgmma": 8 * steps + 4 * evals,
        "flash_attention_bwd": 4 * steps,
        "flash_attention_bwd.wgmma": 4 * steps}
    assert not [s for s in tlm.STATE_STORE if s[0].startswith("ens_")]


def _zombie_app(core, kp, lm_mod, ensemble, extra, monkeypatch):
    """A preemptive real-mode pilot of 2 slots: ``lm.train`` (one step,
    throughput) runs beside a task that waits for the step to start; then
    a latency task needing both slots evicts the train attempt.  Its
    thread runs on as a zombie and writes the member's state while the
    latency task waits for that write; the retry trains after it.  Test
    kernels are registered for the run; the first train step waits until
    the eviction has happened, so the interleaving is forced."""
    started, evicted = threading.Event(), threading.Event()
    real_steps = lm_mod._steps

    def gated_steps(cfg, kind, *a, **kw):
        step = real_steps(cfg, kind, *a, **kw)

        def run(state, batch):
            started.set()
            assert evicted.wait(60), "the train attempt was never evicted"
            return step(state, batch)
        return run
    monkeypatch.setattr(lm_mod, "_steps", gated_steps)

    def wait_started(args, ctx):
        assert started.wait(60)
        return {}

    def evict(args, ctx):
        evicted.set()
        deadline = time.time() + 60
        while lm_mod.STATE_STORE.get((ensemble, 0)) is None:
            assert time.time() < deadline, "the zombie never wrote"
            time.sleep(0.01)
        return {"step_seen": int(lm_mod.STATE_STORE[(ensemble, 0)]["step"])}
    for name, fn in (("test.wait_started", wait_started),
                     ("test.evict", evict)):
        monkeypatch.setitem(kp._KERNEL_REGISTRY, name,
                            kp.KernelDef(name, fn))
    train = core.Kernel("lm.train")
    train.arguments = {"arch": ARCH, "steps": 1, "member": 0,
                       "ensemble": ensemble, "batch": 2, "seq": 32, **extra}
    latency = core.Kernel("test.evict")
    latency.cores = 2
    return [core.PipelineSpec([core.Stage(
                [core.TaskSpec(train, name="train.m0", sla="throughput")],
                name="train")], name="train"),
            core.PipelineSpec([
                core.Stage([core.TaskSpec(core.Kernel("test.wait_started"),
                                          name="gate", sla="throughput")],
                           name="gate"),
                core.Stage([core.TaskSpec(latency, name="latency",
                                          sla="latency")], name="latency")],
                name="serve")]


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_preempted_train_attempt_runs_on_as_a_zombie(pkg, monkeypatch):
    """ROADMAP C5, in both packages: an ``lm.train`` task evicted by a
    latency task is retried, but its evicted attempt cannot be stopped:
    it trains on and writes the member's state, and the retry trains from
    that state, so a one-step task leaves the member at step 2."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    kp = importlib.import_module(f"{pkg}.core.kernel_plugin")
    lm_mod = importlib.import_module(f"{pkg}.plugins.lm")
    executor = importlib.import_module(f"{pkg}.runtime.executor")
    ensemble = f"zombie_{pkg}"
    pipes = _zombie_app(core, kp, lm_mod, ensemble, _extra(core),
                        monkeypatch)
    am = core.AppManager(executor.PilotRuntime(slots=2, mode="real",
                                               preempt=True))
    try:
        prof = am.run(pipes)
        for th in list(am.session._zombie_threads):
            th.join(60)
        step = int(np.asarray(lm_mod.STATE_STORE[(ensemble, 0)]["step"]))
    finally:
        _release(lm_mod.STATE_STORE, ensemble)
    tasks = am.session.graph.tasks
    assert prof.n_failed == 0 and prof.n_preempted == 1
    assert tasks["train.m0"].attempts == 2
    assert prof.results["tasks"]["latency"] == {"step_seen": 1}
    assert prof.results["tasks"]["train.m0"]["step"] == 2
    assert step == 2

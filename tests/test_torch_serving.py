"""The port's serving subsystem (``repro_torch.serving``, the
``serve.source`` and ``serve.decode`` plugins and the dense configs they
serve) against the JAX package's, on the CPU: the same traffic windows,
the same DES cost model and serving app (exact in the DES), the same
tokens from ``serve.decode`` given the same params, the same greedy tokens
from reduced minicpm-2b, gemma3-4b and nemotron-4-15b through the port's
own registered configs, and a rehearsal of ``chip_smoke.py``'s
``serve_ensemble`` phase.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.plugins.serve as jserve  # noqa: E402
import repro.runtime.executor as jexecutor  # noqa: E402
import repro.serving as js  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.plugins.serve as tserve  # noqa: E402
import repro_torch.runtime.executor as texecutor  # noqa: E402
import repro_torch.serving as ts  # noqa: E402
from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import BatchedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEW_ARCHS = ["minicpm-2b", "gemma3-4b", "nemotron-4-15b"]
# examples/serve_ensemble.py's traffic, with more bursts
TRAFFIC = dict(window_s=5.0, base_rps=4.0, peak_rps=16.0, period_s=120.0,
               burst_prob=0.3, prompt_tokens=32, latency_new_tokens=8,
               throughput_new_tokens=24)


def _fields(jcfg) -> dict:
    """The JAX config's values of the port's ModelConfig fields."""
    return {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(ModelConfig)}


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registered_config_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == _fields(
        jax_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == _fields(
        jax_reduced(jax_get_config(arch)))


def test_minicpm_schedule_and_toy_config_match_reference():
    import repro.configs.minicpm_2b as jminicpm
    import repro.configs.toy as jtoy
    import repro_torch.configs.minicpm_2b as tminicpm
    import repro_torch.configs.toy as ttoy
    assert tminicpm.SCHEDULE == jminicpm.SCHEDULE == "wsd"
    assert dataclasses.asdict(ttoy.CONFIG) == dataclasses.asdict(jtoy.CONFIG)


# ------------------------------------------------------------ traffic

@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_traffic_windows_match_reference(seed):
    jm, tm = js.TrafficModel(seed=seed, **TRAFFIC), \
        ts.TrafficModel(seed=seed, **TRAFFIC)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for k in range(12):
        assert tm.rate(k) == jm.rate(k)
        for sla in (None, "latency", "throughput"):
            got = [dataclasses.asdict(r) for r in tm.requests(k, sla)]
            assert got == [dataclasses.asdict(r) for r in jm.requests(k, sla)]
        assert tm.batch_nbytes(tm.window(k)) == jm.batch_nbytes(jm.window(k))
    assert tm.total_requests(12) == jm.total_requests(12) > 0


# ------------------------------------------------- DES cost model

SIM_CASES = {   # window, slots, step cost, prefill cost
    "window": (2, 4, 0.01, 0.1),
    "bursty": (5, 16, 0.02, 0.05),
    "empty": (None, 8, 0.01, 0.0),
    "single_slot": (1, 1, 1.0, 0.0),
    "more_slots_than_requests": (0, 512, 0.02, 0.05),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulate_continuous_matches_reference(case):
    k, slots, step, pre = SIM_CASES[case]

    def run(pkg):
        reqs = [] if k is None else pkg.TrafficModel(seed=0).window(k)
        return dataclasses.asdict(pkg.simulate_continuous(
            reqs, slots, step_cost_s=step, prefill_cost_s=pre))
    got = run(ts)
    assert got == run(js)
    if case == "empty":
        assert (got["makespan_s"], got["steps"], got["prefills"]) == \
            (0.0, 0, 0)
    if case == "single_slot":
        reqs = ts.TrafficModel(seed=0).window(k)
        assert got["steps"] == sum(r.max_new_tokens for r in reqs)
        assert got["occupancy"] == pytest.approx(1.0)


@pytest.mark.parametrize("prioritize", [True, False])
def test_des_serving_app_matches_reference(prioritize):
    """``tests/test_serving.py``'s DES app (metrics; the baseline mode
    strips the SLA annotations) through both packages: the DES makes
    every number exact."""
    def run(pkg, core, executor):
        m = pkg.TrafficModel(seed=7, window_s=10.0, base_rps=3.0,
                             peak_rps=9.0, period_s=120.0)
        pipes, channels, metrics = pkg.build_serving_app(
            m, 6, decode_slots=4, step_cost_s=0.01, prioritize=prioritize,
            deadlines={"latency": 15.0, "throughput": 600.0})
        specs = [(sp.name, sp.sla, sp.kernel.name, sp.kernel.arguments,
                  sp.kernel.sim_duration, sp.kernel.output_nbytes)
                 for p in pipes for st in p.stages for sp in st.tasks]
        am = core.AppManager(executor.PilotRuntime(slots=8, mode="sim",
                                                   preempt=True))
        prof = am.run(pipes, validate="error")
        metrics.install(am, prof)
        assert all(ch.n_unconsumed() == 0 for ch in channels.values())
        return {"specs": specs, "serving": prof.results["serving"],
                "ttc": prof.ttc, "n_tasks": prof.n_tasks,
                "n_preempted": prof.n_preempted,
                "pipelines": prof.results["pipelines"],
                "total": sum(len(m.window(k)) for k in range(6))}
    got = run(ts, tcore, texecutor)
    assert got == run(js, jcore, jexecutor)
    s = got["serving"]
    assert sum(c["n"] for c in s["classes"].values()) == got["total"]
    assert s["classes"]["latency"]["met_tokens"] == \
        s["classes"]["latency"]["tokens"]
    slas = {sla for _, sla, *_ in got["specs"]}
    assert slas == ({"latency", "throughput"} if prioritize else {None})


# ------------------------------------------------ real-mode kernels

def _capture(monkeypatch, cls, sink):
    """Record every served request's tokens from ``cls.run``."""
    orig = cls.run

    def run(self):
        done = orig(self)
        sink.extend((r.rid, r.sla, list(r.out_tokens)) for r in done)
        return done
    monkeypatch.setattr(cls, "run", run)


@pytest.mark.parametrize("window", [0, 3])
def test_serve_kernels_real_mode_tokens_match_reference(monkeypatch, window):
    """``serve.source`` and ``serve.decode`` on ``serve-tiny`` through both
    packages, the port's params cache holding the JAX package's params:
    the same results and the same tokens for every request."""
    model = dataclasses.asdict(js.TrafficModel(seed=11, **{
        **TRAFFIC, "latency_new_tokens": 3, "throughput_new_tokens": 6}))
    jtok, ttok = [], []
    _capture(monkeypatch, JaxServer, jtok)
    _capture(monkeypatch, BatchedServer, ttok)
    cfg = get_config("serve-tiny")
    jparams = jax_init_params(jserve._serve_cfg(None), jax.random.PRNGKey(0))
    monkeypatch.setitem(jserve._PARAMS_CACHE, ("serve-tiny", 0), jparams)
    monkeypatch.setitem(tserve._PARAMS_CACHE, ("serve-tiny", 0, "cpu"),
                        params_from_numpy({k: np.asarray(v) for k, v in
                                           _flatten(jparams).items()}, cfg))
    for sla in ("latency", "throughput"):
        args = {"model": model, "window": window, "sla": sla,
                "decode_slots": 4, "prompt_len": 8}
        outs = []
        for core, extra in ((jcore, {}), (tcore, {"device": "cpu"})):
            src = core.Kernel("serve.source")
            src.arguments = dict(args)
            dec = core.Kernel("serve.decode")
            dec.arguments = {**args, **extra}
            outs.append((src.execute(), dec.execute()))
        assert outs[1] == outs[0]
        assert outs[1][1]["served"] == outs[1][0]["n"] > 0
    assert ttok == jtok and len(ttok) > 8


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_serve_tokens_match_reference(arch):
    """Greedy tokens of the JAX ``BatchedServer`` and the port's, the port
    on its own registered config (reduced): gemma3-4b's local layers run
    the wave loop, minicpm-2b and nemotron-4-15b the continuous loop; the
    cache holds exactly prompt + the longest request (a slot emptied
    while others decode steps past its end, as ``serve.decode`` sizes it)."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in _flatten(jparams).items()}, cfg)
    S0, new = 6, [3, 5, 2, 4, 3]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, S0) for _ in new]
    max_len = S0 + max(new)
    jsrv = JaxServer(jcfg, jparams, batch=2, prompt_len=S0, max_len=max_len)
    jsrv.submit([JaxRequest(rid=i, prompt=p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, new))])
    want = {r.rid: r.out_tokens for r in jsrv.run()}
    srv = BatchedServer(cfg, params, batch=2, prompt_len=S0,
                        max_len=max_len, device="cpu")
    srv.submit([Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new))])
    got = {r.rid: r.out_tokens for r in srv.run()}
    assert srv.continuous == jsrv.continuous == (arch != "gemma3-4b")
    assert got == want
    assert srv.stats == jsrv.stats
    assert [len(got[i]) for i in range(len(new))] == new


# ------------------------------------------------ chip_smoke rehearsal

def test_chip_smoke_serve_ensemble_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``serve_ensemble`` phase on the CPU at reduced
    widths: its members are the ensemble rehearsal's (4 layers, bf16
    compute, head_dim 64, 64 tokens), its server a reduced minicpm-2b with
    head_dim 64 and bf16 compute (so that the counted variant is the
    card's); the plain attention calls are counted as the wrappers count
    kernel launches, and CUDA event timing is replaced by one call.  The phase's own checks pass: the example's
    assertions, full token counts, launches of every attempt, the
    checkpoints restored bitwise, each member's step equal to its
    attempts."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.plugins import lm

    E = chip_smoke.ENSEMBLE
    members = reduced(get_config(E["base"]), layers=E["layers"]).replace(
        name=E["arch"], remat="full", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, members.name, members)
    server = reduced(get_config("minicpm-2b")).replace(
        name="minicpm-2b", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, server.name, server)
    monkeypatch.setitem(chip_smoke.SE, "seq", 64)

    def counted(fn, name):
        def run(q, *a, **kw):
            count_launch(name, f"{name}.{ops.variant(q.dtype, q.shape[-1])}")
            return fn(q, *a, **kw)
        return run
    for attr, name in (("attention_fwd_ref", "flash_attention"),
                       ("attention_ref", "flash_attention"),
                       ("attention_bwd_ref", "flash_attention_bwd")):
        monkeypatch.setattr(ops, attr, counted(getattr(ops, attr), name))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters, warmup=1: (fn(), 0.0)[1])
    got = chip_smoke.phase_serve_ensemble(torch.device("cpu"))
    SE = chip_smoke.SE
    steps = SE["members"] * SE["cycles"]
    assert got["flash_attention_bwd"] >= 4 * steps
    assert got["flash_attention_bwd"] % 4 == 0
    assert got["flash_attention"] == got["flash_attention.wgmma"]
    # prefills: at least one admission group of each served window
    assert got["flash_attention"] - 2 * got["flash_attention_bwd"] >= \
        server.num_layers * 2 * SE["windows"]
    assert not [s for s in lm.STATE_STORE if s[0] == "serve_ens"]
    assert not tserve._PARAMS_CACHE

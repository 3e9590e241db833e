"""The examples that use only the runtime (``quickstart``,
``pst_adaptive``, ``pst_staged``, ``elastic_faults``), run on the port
through ``tests/_port_examples.py::example_module`` (their ``from repro.``
imports read ``from repro_torch.``) beside the JAX package.

Runs in virtual time (``mode="sim"``) print the same lines, character for
character.  Real-mode runs print measured seconds, so their lines are
compared with every number masked, and their task results exactly.

The examples that call JAX (``serve_batched``, ``replica_exchange_pbt``,
``train_100m``) have the port's own counterparts,
``repro_torch.examples.<name>`` (``_port_examples.port_example``), held
against the reference example from the same parameters: the reference's
initial ones carried across with ``models.convert`` and patched into the
port's module (its ``init_params``, ``FusedEnsemble.init``,
``make_train_state``, or ``lm.train``'s member states).
"""
import ast
import re

import pytest

pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
from _port_examples import example_module, port_example, printed  # noqa: E402,E501

PACKAGES = ("repro", "repro_torch")
_NUMBER = re.compile(r"\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _both(name, *args):
    return {pkg: printed(example_module(name, pkg).main, *args)[1]
            for pkg in PACKAGES}


def _masked(text):
    return [_NUMBER.sub("#", line) for line in text.splitlines()]


_PER_TASK = "  per-task t_data (charged tasks): "


def _per_task_sorted(text):
    """(``text`` with its per-task t_data line's entries in task-name
    order, those task names).  The example prints the tasks in the order
    they entered the graph, and in real mode that order follows which of
    the previous round's analyses finished first: thread timing."""
    lines, names = text.splitlines(), []
    for i, line in enumerate(lines):
        if line.startswith(_PER_TASK):
            charged = dict(sorted(ast.literal_eval(
                line[len(_PER_TASK):]).items()))
            lines[i] = _PER_TASK + repr(charged)
            names.append(list(charged))
    return "\n".join(lines), names


def test_quickstart_matches_reference():
    """The five-step flow in real mode: the TTC decomposition's lines
    (their seconds masked), and every character-count result."""
    out = _both("quickstart")
    assert out["repro"].startswith("TTC decomposition (paper eq. 1-2):")
    assert _masked(out["repro_torch"]) == _masked(out["repro"])

    def results(pkg):
        m = example_module("quickstart", pkg)
        cl = m.SingleClusterEnvironment(resource="local.cpu", cores=16,
                                        walltime=10)
        cl.allocate()
        prof = cl.run(m.CharCountApp(stages=2, instances=16))
        cl.deallocate()
        assert prof.n_failed == 0
        return prof.results["tasks"]
    want, got = results("repro"), results("repro_torch")
    assert sorted(got) == sorted(want) and len(got) == 32
    counts = {k: v for k, v in got.items() if k.endswith("stage2")}
    assert len(counts) == 16
    assert counts == {k: want[k] for k in counts}


def test_pst_adaptive_matches_reference():
    out = _both("pst_adaptive")
    assert "no global barrier" in out["repro"]
    assert out["repro_torch"] == out["repro"]


@pytest.mark.parametrize("mode", ["sim", "real"])
def test_pst_staged_matches_reference(mode):
    out = _both("pst_staged", mode)
    assert out["repro"].startswith(f"mode={mode}: ttc=")
    if mode == "sim":
        assert out["repro_torch"] == out["repro"]
    else:
        assert "identical payloads: ok" in out["repro_torch"]
        (got, got_names), (want, want_names) = (
            _per_task_sorted(out[pkg]) for pkg in ("repro_torch", "repro"))
        assert len(want_names) == 1 and got_names == want_names
        assert _masked(got) == _masked(want)


def test_elastic_faults_matches_reference(tmp_path):
    """The fast chaos bench too; the example writes ``BENCH_faults.json``
    beside its ``examples`` directory, here a temporary one per package
    (the repo's own file stays as it is), and the two files agree."""
    import json
    out = {}
    for pkg in PACKAGES:
        m = example_module("elastic_faults", pkg)
        (tmp_path / pkg / "examples").mkdir(parents=True)
        m.__file__ = str(tmp_path / pkg / "examples" / "elastic_faults.py")
        out[pkg] = printed(m.main, True)[1]
    assert "== 4) journal restart" in out["repro"]
    assert out["repro_torch"] == out["repro"]
    bench = {pkg: json.loads((tmp_path / pkg / "BENCH_faults.json")
                             .read_text()) for pkg in PACKAGES}
    assert bench["repro_torch"] == bench["repro"]


# ------------------------------------------------ the examples that call JAX

def _jax_flat(tree):
    import numpy as np
    from repro.checkpoint.checkpoint import _flatten
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _recording(cls, method):
    """A subclass of ``cls`` whose ``method`` keeps its result in
    ``got``."""
    class Rec(cls):
        got = []

    def wrapped(self, *a, **k):
        out = getattr(super(Rec, self), method)(*a, **k)
        Rec.got.append(out)
        return out
    setattr(Rec, method, wrapped)
    return Rec


def test_serve_batched_matches_reference(monkeypatch):
    """Default options; the port serves the reference's seed-0 parameters:
    every request's tokens equal, the printed lines equal with their
    numbers masked, the stats and request 0's tokens exactly."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import init_params as jax_init_params
    from repro_torch.models.convert import params_from_numpy

    ref = example_module("serve_batched", "repro")
    port = port_example("serve_batched")
    ref.BatchedServer = _recording(ref.BatchedServer, "run")
    port.BatchedServer = _recording(port.BatchedServer, "run")
    flat = _jax_flat(jax_init_params(reduced(get_config("gemma2-2b")),
                                     jax.random.PRNGKey(0)))
    port.init_params = lambda cfg, gen: params_from_numpy(flat, cfg)
    monkeypatch.setattr("sys.argv", ["serve_batched.py"])
    want = printed(ref.main)[1]
    got = printed(port.main, ["--device", "cpu"])[1]

    def tokens(done):
        return {r.rid: [int(t) for t in r.out_tokens] for r in done}
    assert tokens(port.BatchedServer.got[0]) == \
        tokens(ref.BatchedServer.got[0])
    assert len(port.BatchedServer.got[0]) == 12
    assert _masked(got) == _masked(want)
    exact = [ln for ln in want.splitlines()
             if ln.startswith(("stats:", "request 0 tokens:"))]
    assert len(exact) == 2 and all(ln in got.splitlines() for ln in exact)


def test_replica_exchange_pbt_matches_reference(monkeypatch):
    """2 members, 2 cycles.  Task mode from the reference's member states
    (``lm.train``'s PRNGKey(i) states in both stores), fused mode from the
    reference's initial ensemble: the printed lines equal with their
    numbers masked, and the fused mode's first cycle's losses within the
    port's train-parity tolerance (1e-5 relative).  Later fused cycles
    swap on each package's own uniforms."""
    import jax
    import numpy as np
    import repro.plugins.lm as jlm
    from repro.configs import get_config, reduced
    from repro.core import FusedEnsemble as JaxFusedEnsemble
    from repro.train import make_train_state as jax_make_train_state
    from repro_torch.models.convert import (ensemble_state_from_numpy,
                                            train_state_from_numpy)
    from repro_torch.plugins import lm as tlm

    n, argv = 2, ["--members", "2", "--cycles", "2"]
    ref = example_module("replica_exchange_pbt", "repro")
    port = port_example("replica_exchange_pbt")
    ref.FusedEnsemble = _recording(ref.FusedEnsemble, "run")
    jcfg = reduced(get_config("gemma2-2b"))
    ens0 = _jax_flat(JaxFusedEnsemble(jcfg, n).init(jax.random.PRNGKey(0)))

    class PortFused(_recording(port.FusedEnsemble, "run")):
        def init(self, gen):
            return ensemble_state_from_numpy(ens0, self.cfg, self.device)
    port.FusedEnsemble = PortFused
    try:
        for i in range(n):
            state = jax_make_train_state(jlm.resolve_cfg("reduced:gemma2-2b"),
                                         jax.random.PRNGKey(i))
            jlm.STATE_STORE[("ex_pbt", i)] = state
            tlm.STATE_STORE[("ex_pbt", i)] = train_state_from_numpy(
                _jax_flat(state), tlm.resolve_cfg("reduced:gemma2-2b"))
        monkeypatch.setattr("sys.argv", ["replica_exchange_pbt.py", *argv])
        want = printed(ref.main)[1]
        for i in range(n):
            jlm.STATE_STORE[("ex_pbt", i)] = jax_make_train_state(
                jlm.resolve_cfg("reduced:gemma2-2b"), jax.random.PRNGKey(i))
        got = printed(port.main, [*argv, "--device", "cpu"])[1]
    finally:
        for store in (jlm.STATE_STORE, tlm.STATE_STORE):
            for i in range(n):
                store.pop(("ex_pbt", i), None)
    assert "== fused SPMD mode ==" in want
    assert _masked(got) == _masked(want)
    task = [ln for ln in want.splitlines() if "accepted=[" in ln]
    assert len(task) == 2 and all(ln in got.splitlines() for ln in task)
    np.testing.assert_allclose(
        PortFused.got[0][1][0]["losses"],
        np.asarray(ref.FusedEnsemble.got[0][1][0]["losses"]), rtol=1e-5)


def test_train_100m_matches_reference_and_resumes_its_checkpoint(
        tmp_path, monkeypatch):
    """``--steps 3 --batch 1 --seq 32`` from the reference's PRNGKey(0)
    state: the printed losses and gradient norms agree (to the lines'
    precision and 1e-5 relative); then the port resumes from the
    checkpoint the reference's run wrote (``--steps 4``): it restores
    step 3 and its step-3 loss agrees with the reference's own resumed
    run."""
    import re
    import shutil

    import jax
    from repro.train import make_train_state as jax_make_train_state
    from repro_torch.models.convert import train_state_from_numpy

    ref = example_module("train_100m", "repro")
    port = port_example("train_100m")
    jstate = _jax_flat(jax_make_train_state(ref.model_100m(),
                                            jax.random.PRNGKey(0)))
    port.make_train_state = lambda cfg, gen: train_state_from_numpy(
        jstate, cfg)
    size = ["--batch", "1", "--seq", "32"]

    def run_ref(steps, d):
        monkeypatch.setattr("sys.argv", ["train_100m.py", "--steps",
                                         str(steps), *size, "--ckpt-dir",
                                         str(d)])
        return printed(ref.main)[1].replace(str(d), "DIR")

    def run_port(steps, d):
        return printed(port.main, ["--steps", str(steps), *size,
                                   "--ckpt-dir", str(d), "--device",
                                   "cpu"])[1].replace(str(d), "DIR")

    def readings(text):
        return [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
            r"step +(\d+)  loss ([\d.]+)  lr \S+  gnorm ([\d.]+)", text)]

    def agree(got, want):
        assert [s for s, _, _ in got] == [s for s, _, _ in want]
        for (_, lg, gg), (_, lw, gw) in zip(got, want):
            assert abs(lg - lw) <= 1e-4 + 1e-5 * abs(lw), (got, want)
            assert abs(gg - gw) <= 1e-3 + 1e-5 * abs(gw), (got, want)

    want = run_ref(3, tmp_path / "ref")
    got = run_port(3, tmp_path / "port")
    assert _masked(got) == _masked(want)
    agree(readings(got), readings(want))
    assert [s for s, _, _ in readings(got)] == [0, 2]
    shutil.copytree(tmp_path / "ref", tmp_path / "ref_again")
    resumed = run_port(4, tmp_path / "ref")
    want = run_ref(4, tmp_path / "ref_again")
    assert "restored checkpoint at step 3" in resumed.splitlines()
    assert _masked(resumed) == _masked(want)
    agree(readings(resumed), readings(want))

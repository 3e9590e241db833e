"""The port's analysis CLI (``python -m repro_torch.analysis``) held against
the JAX package's on the CPU: ``lint``, ``sanitize`` and ``codes`` give the
same exit codes and the same output in both packages."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _threads import _one_thread  # noqa: F401
from _port_examples import printed

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")

# pipelines of three apps, written once for either package: clean, an
# orphan channel (E102) beside two tasks of one name (E112; not E107,
# whose message lists the kernels registered in the process), and two
# pipelines of one name
APP = '''
from {pkg}.core import Channel, Kernel, PipelineSpec, Stage, TaskSpec


def _k(dur=1.0):
    k = Kernel("synthetic.noop")
    k.sim_duration = dur
    return k


def build():
    ch = Channel("traj")
    prod = PipelineSpec([Stage([TaskSpec(_k(), name=f"p.m{{i}}")
                                for i in range(3)], name="s0",
                               outputs=[ch])], name="producer")
    cons = PipelineSpec([Stage([TaskSpec(_k(0.5), name="c.r0")],
                               name="r0", inputs={{"traj": ch}})],
                        name="consumer")
    return [prod, cons]


def broken():
    orphan = Channel("nobody")
    a = PipelineSpec([Stage([TaskSpec(_k())], name="s0",
                            inputs={{"x": orphan}})], name="a")
    b = PipelineSpec([Stage([TaskSpec(_k(), name="x"),
                             TaskSpec(_k(), name="x")], name="s0")],
                     name="b")
    return [a, b]


def twins():
    # a tuple: the CLI lints its first element
    return ([PipelineSpec([Stage([TaskSpec(_k())], name="s0")], name="p"),
             PipelineSpec([Stage([TaskSpec(_k())], name="s0")], name="p")],
            "metadata")
'''


@pytest.fixture
def apps(tmp_path, monkeypatch):
    """Module ``lint_app_<pkg>`` for each package, on ``sys.path``."""
    for pkg in PACKAGES:
        (tmp_path / f"lint_app_{pkg}.py").write_text(APP.format(pkg=pkg))
    monkeypatch.syspath_prepend(str(tmp_path))
    yield tmp_path
    for pkg in PACKAGES:
        sys.modules.pop(f"lint_app_{pkg}", None)


def _cli(pkg, argv):
    main = importlib.import_module(f"{pkg}.analysis.__main__").main
    rc, out = printed(main, argv)
    return rc, out.replace(f"lint_app_{pkg}", "APP")


def test_lint_matches_reference(apps):
    got = {pkg: [_cli(pkg, ["lint", f"lint_app_{pkg}"]),
                 _cli(pkg, ["lint", f"lint_app_{pkg}:broken"]),
                 _cli(pkg, ["lint", f"lint_app_{pkg}:twins",
                            f"lint_app_{pkg}"])]
           for pkg in PACKAGES}
    assert got["repro_torch"] == got["repro"]
    clean, broken, twins = got["repro"]
    assert clean[0] == 0 and broken[0] == 1
    assert "E102" in broken[1] and "E112" in broken[1]
    assert twins[0] == 1


def _journals(tmp):
    """A clean sim journal of each package, and one whose two attempts
    overlap on one slot (S306)."""
    jdir = tmp / "journals"
    jdir.mkdir()
    for pkg in PACKAGES:
        ex = importlib.import_module(f"{pkg}.runtime.executor")
        jn = importlib.import_module(f"{pkg}.runtime.journal")
        st = importlib.import_module(f"{pkg}.runtime.states")
        g = st.TaskGraph()
        for i in range(6):
            g.add(st.Task(name=f"t{i}", duration=1.0 + i))
        ex.PilotRuntime(slots=2, mode="sim", staging=None,
                        journal=jn.Journal(str(jdir / f"{pkg}.jsonl"))).run(g)
    bad = tmp / "overlap.jsonl"

    def rec(task, event, vt, **kw):
        return {"t": vt, "vt": vt, "task": task, "event": event,
                "attempts": 1, **kw}
    recs = [{"t": 0.0, "vt": 0.0, "event": "session_start", "mode": "sim"},
            rec("a", "scheduled", 0.0, state="SCHEDULED", slot_ids=[0]),
            rec("b", "scheduled", 1.0, state="SCHEDULED", slot_ids=[0]),
            rec("a", "finished", 3.0, state="DONE", v_started=0.0,
                v_finished=3.0, t_exec=3.0, t_data=0.0),
            rec("b", "finished", 4.0, state="DONE", v_started=1.0,
                v_finished=4.0, t_exec=3.0, t_data=0.0)]
    bad.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return jdir, bad


def test_sanitize_matches_reference(tmp_path):
    jdir, bad = _journals(tmp_path)
    got = {pkg: [_cli(pkg, ["sanitize", str(jdir)]),
                 _cli(pkg, ["sanitize", str(bad)]),
                 _cli(pkg, ["sanitize", str(tmp_path / "missing.jsonl")]),
                 _cli(pkg, ["sanitize", str(tmp_path / "journals" / "x")])]
           for pkg in PACKAGES}
    assert got["repro_torch"] == got["repro"]
    clean, overlap, missing, empty = got["repro"]
    assert clean[0] == 0 and clean[1].count("clean") == 2
    assert overlap[0] == 1 and "S306" in overlap[1]
    assert missing[0] == 1 and empty[0] == 1


def test_codes_match_reference():
    got = {pkg: _cli(pkg, ["codes"]) for pkg in PACKAGES}
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0] == 0 and "E114" in got["repro"][1]


@pytest.mark.parametrize("module", ["repro_torch.analysis", "repro_torch.obs"])
def test_cli_runs_as_a_module(module):
    """``python -m repro_torch.analysis codes`` prints the reference's
    registry; ``python -m repro_torch.obs --help`` names its commands."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    argv = ["codes"] if module.endswith("analysis") else ["--help"]
    got = subprocess.run([sys.executable, "-m", module, *argv],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert got.returncode == 0, got.stderr
    if module.endswith("analysis"):
        assert got.stdout == _cli("repro", ["codes"])[1]
    else:
        assert "python -m repro_torch.obs" in got.stdout
        assert all(c in got.stdout
                   for c in ("trace", "decompose", "critical-path"))


def test_validate_warn_names_the_port_package(capsys):
    """``AppManager.run(validate="warn")`` on an app with an error proceeds
    and records the diagnostics in both packages; the warning on stderr
    names the package that linted (the reference's own suite checks for
    ``repro.analysis``, the port's says ``repro_torch.analysis``: the one
    reference test not run against the port for this, ROADMAP C14)."""
    err = {}
    for pkg in PACKAGES:
        c = importlib.import_module(f"{pkg}.core")
        ex = importlib.import_module(f"{pkg}.runtime.executor")
        k = c.Kernel("synthetic.noop")
        k.sim_duration = 1.0
        app = c.PipelineSpec([c.Stage([c.TaskSpec(k)], name="s0",
                                      inputs={"x": c.Channel("nope")})],
                             name="c")
        prof = c.AppManager(ex.PilotRuntime(slots=2, mode="sim")).run(
            [app], validate="warn")
        assert any("E102" in d for d in prof.results["diagnostics"])
        assert prof.results["pipelines"]["c"]["state"] == "blocked"
        err[pkg] = capsys.readouterr().err
    assert err["repro"].startswith("repro.analysis: ")
    assert err["repro_torch"] == "repro_torch" + err["repro"][len("repro"):]

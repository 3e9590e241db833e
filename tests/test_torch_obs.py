"""The port's flight recorder (``repro_torch.obs``) held against the JAX
package's (``repro.obs``) on the CPU.

A traced sim run gives the same spans, instants and timeline in both
packages; a journal written by either package is read by both reports
with the same ``decompose`` and ``critical_path`` and a byte-identical
``to_chrome``; the ``python -m ... obs`` CLIs print the same and exit
alike; ``examples/pst_coupled.py --sim --trace-out`` runs through both.
In real mode the journal's per-slot decomposition matches the live
tracer's.
"""
import importlib
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from _threads import _one_thread  # noqa: F401
from _port_examples import example_module, printed

PACKAGES = ("repro", "repro_torch")
# chip_smoke.py's federation phase: an attempt's exec seconds by the
# journal and by the live tracer (stamped a few statements apart)
FED_DECOMP_TOL_S = 0.02


def _pkg(name):
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")
    return SimpleNamespace(
        name=name, core=mod("core"), obs=mod("obs"), report=mod("obs.report"),
        cli=mod("obs.__main__"), executor=mod("runtime.executor"),
        faults=mod("runtime.faults"), journal=mod("runtime.journal"),
        states=mod("runtime.states"))


def _dag(m, n=24):
    """A DAG of ``n`` tasks of 2 s (every third waits on two earlier ones)
    and a wide high-priority task that evicts running work."""
    g = m.states.TaskGraph()
    for i in range(n):
        deps = [f"t{i - 1:03d}", f"t{i - 2:03d}"] if i % 3 == 2 else []
        g.add(m.states.Task(name=f"t{i:03d}", duration=2.0 + 0.25 * (i % 4),
                            stage="s", deps=deps))
    g.add(m.states.Task(name="hi", duration=3.0, slots=2, priority=10,
                        deps=["t001"], stage="s"))
    return g


def _traced_run(m, path):
    """Sim run of ``_dag`` with pod kills (respawned) and preemption,
    journaled to ``path`` and traced."""
    tr = m.obs.Tracer()
    faults = m.faults.FaultInjector(kill_every=7.0, pods=["pod0", "pod1"],
                                    max_kills=2, respawn_after=3.0)
    prof = m.executor.PilotRuntime(
        slots=4, mode="sim", journal=m.journal.Journal(str(path)),
        faults=faults, preempt=True, tracer=tr).run(_dag(m))
    return prof, tr


def _reports(m, path):
    segs = m.report.load_segments(str(path))
    seg = segs[-1]
    return {"decompose": m.obs.decompose(seg),
            "critical_path": m.obs.critical_path(seg, k=3),
            "chrome": m.obs.to_chrome([("run", s) for s in segs])}


def test_traced_run_matches_reference(tmp_path):
    """Spans, instants, the timeline and the tracer's own decomposition of
    the same faulty, preemptive sim run, in both packages."""
    out = {}
    for pkg in PACKAGES:
        m = _pkg(pkg)
        prof, tr = _traced_run(m, tmp_path / f"{pkg}.jsonl")
        assert prof.n_failed == 0 and prof.n_pod_lost and prof.n_preempted
        out[pkg] = {"spans": tr.spans, "events": tr.events,
                    "timeseries": tr.timeseries(), "summary": tr.summary(),
                    "unpaired": tr.unpaired(),
                    "live": m.obs.decompose(
                        m.report.segment_from_tracer(tr))}
    assert out["repro_torch"] == out["repro"]
    assert {s["outcome"] for s in out["repro"]["spans"]} >= {
        "done", "pod_lost", "preempted"}


@pytest.mark.parametrize("writer", PACKAGES)
def test_journal_reports_match_in_both_packages(writer, tmp_path):
    """A journal written by ``writer`` decomposes, walks and exports the
    same in both readers (the Chrome trace byte for byte), and as the
    reference's own journal of the same run does."""
    path = tmp_path / "run.jsonl"
    _traced_run(_pkg(writer), path)
    got = {pkg: _reports(_pkg(pkg), path) for pkg in PACKAGES}
    assert got["repro_torch"] == got["repro"]
    ref = tmp_path / "ref.jsonl"
    _traced_run(_pkg("repro"), ref)
    assert got["repro"] == _reports(_pkg("repro"), ref)
    dec = got["repro"]["decompose"]
    assert dec["residual_max"] < 1e-6 and dec["n_open"] == 0
    assert dec["totals"]["n_pod_lost"] and dec["totals"]["n_preempted"]


def _cli(m, argv):
    rc, out = printed(m.cli.main, argv)
    return rc, out.replace("repro_torch.obs", "repro.obs")


def test_obs_cli_matches_reference(tmp_path):
    """``trace``, ``decompose`` (text and JSON) and ``critical-path`` over
    the same journals: the same exit codes and output (the package's name
    aside), the same trace file; ``decompose`` exits 1 on a residual over
    ``--tol`` and on an unpaired attempt span."""
    jdir = tmp_path / "journals"
    jdir.mkdir()
    _traced_run(_pkg("repro"), jdir / "a.jsonl")
    _traced_run(_pkg("repro_torch"), jdir / "b.jsonl")
    torn = tmp_path / "torn.jsonl"
    shutil.copy(jdir / "a.jsonl", torn)
    with open(torn, "a") as f:
        f.write(json.dumps({"t": 1e9, "vt": 1e3, "task": "late",
                            "event": "scheduled", "state": "RUNNING",
                            "attempts": 1}) + "\n")
    runs = {}
    for pkg in PACKAGES:
        m = _pkg(pkg)
        out = tmp_path / f"{pkg}.trace.json"
        runs[pkg] = [
            _cli(m, ["trace", str(jdir), "--out", str(out)])[0],
            out.read_bytes(),
            _cli(m, ["decompose", str(jdir)]),
            _cli(m, ["decompose", str(jdir), "--json"]),
            _cli(m, ["decompose", str(jdir), "--tol", "-1"])[0],
            _cli(m, ["decompose", str(torn)])[0],
            _cli(m, ["critical-path", str(jdir / "a.jsonl"), "-k", "2"]),
            _cli(m, ["critical-path", str(jdir / "b.jsonl"), "--json"])]
    assert runs["repro_torch"] == runs["repro"]
    rc_trace, _, text, js, rc_tol, rc_torn, _, _ = runs["repro"]
    assert (rc_trace, text[0], js[0], rc_tol, rc_torn) == (0, 0, 0, 1, 1)


def test_pst_coupled_example_matches_reference(tmp_path):
    """``examples/pst_coupled.py --sim --trace-out``: the same printed TTC,
    pipelines, channels and trace line, and a byte-identical Chrome trace
    from the live tracer, in both packages."""
    out = {}
    for pkg in PACKAGES:
        trace = tmp_path / f"{pkg}.json"
        _, text = printed(example_module("pst_coupled", pkg).main, "sim",
                          trace_out=str(trace))
        out[pkg] = (text.replace(str(trace), "TRACE"), trace.read_bytes())
    assert "cross-pipeline DAG confirmed" in out["repro"][0]
    assert out["repro_torch"] == out["repro"]


def test_real_mode_journal_decomposes_as_the_live_tracer():
    """A real-mode run of the port: its journal's per-slot attempt counts
    equal the live tracer's, and each slot's exec seconds agree within
    ``chip_smoke.FED_DECOMP_TOL_S`` an attempt (wall stamps of the
    journal against the tracer's clock)."""
    import tempfile
    import time

    m = _pkg("repro_torch")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "real.jsonl"
        tr = m.obs.Tracer()
        # a fault injector (with nothing to inject) tracks slot ids
        rt = m.executor.PilotRuntime(slots=2, mode="real",
                                     journal=m.journal.Journal(str(path)),
                                     faults=m.faults.FaultInjector(),
                                     tracer=tr)
        g = m.states.TaskGraph()
        for i in range(6):
            g.add(m.states.Task(name=f"r{i}",
                                run=lambda task: time.sleep(0.02)))
        prof = rt.run(g)
        rt.close()
        assert prof.n_failed == 0
        journal = m.obs.decompose(m.report.load_segments(str(path))[-1])
    live = m.obs.decompose(m.report.segment_from_tracer(tr))
    assert sorted(journal["slots"]) == sorted(live["slots"])
    assert len(journal["slots"]) == 2
    for name, c in journal["slots"].items():
        assert c["n_attempts"] == live["slots"][name]["n_attempts"]
        assert abs(c["t_exec"] - live["slots"][name]["t_exec"]) <= \
            FED_DECOMP_TOL_S * c["n_attempts"]
    assert journal["residual_max"] < 1e-6 and journal["n_open"] == 0

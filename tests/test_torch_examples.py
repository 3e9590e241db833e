"""The examples that use only the runtime (``quickstart``,
``pst_adaptive``, ``pst_staged``, ``elastic_faults``), run on the port
through ``tests/_port_examples.py::example_module`` (their ``from repro.``
imports read ``from repro_torch.``) beside the JAX package.

Runs in virtual time (``mode="sim"``) print the same lines, character for
character.  Real-mode runs print measured seconds, so their lines are
compared with every number masked, and their task results exactly.
"""
import re

import pytest

pytest.importorskip("torch")

from _port_examples import example_module, printed  # noqa: E402

PACKAGES = ("repro", "repro_torch")
_NUMBER = re.compile(r"\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _both(name, *args):
    return {pkg: printed(example_module(name, pkg).main, *args)[1]
            for pkg in PACKAGES}


def _masked(text):
    return [_NUMBER.sub("#", line) for line in text.splitlines()]


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
        assert _masked(out["repro_torch"]) == _masked(out["repro"])


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

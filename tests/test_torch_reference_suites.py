"""The JAX package's own front-end suites run against the port.

Each suite below runs in a pytest process of its own with the plugin
``tests/_torch_alias.py``, which resolves ``repro.core``, ``repro.runtime``,
``repro.staging``, ``repro.analysis``, ``repro.serving``, ``repro.plugins``,
``repro.federation``, ``repro.obs`` and ``repro.dist`` to the port's
modules (the alias
never enters this process).  Every reference test is a case here, named by
its own id; a case passes when that test passed against the port.

``EXCLUDED`` names the tests that do not run as cases, each with what it
waits for; ``test_excluded_tests_fail_for_their_stated_reason`` holds that
each still fails against the port for that reason, so an exclusion is
dropped once its item lands.
"""
import ast
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SUITES = ("flow", "staging", "faults", "strategy", "patterns", "pst",
          "runtime", "serving", "federation", "obs", "analysis")
# suites per subprocess, run side by side (test_serving alone takes most
# of the time: it serves a JAX model)
GROUPS = (("serving",), ("flow", "pst", "analysis"),
          ("staging", "faults", "strategy", "patterns", "runtime",
           "federation", "obs"))

_SWAP = ("the port's on-device swap takes a uniforms tensor and "
         "device=True means cuda; held against the reference by "
         "tests/test_torch_ensemble.py::{}")
EXCLUDED = {
    "tests/test_pst.py::test_exchange_kernel_swaps_on_granted_submesh":
        "its topology's devices are jax.devices(); the port's slots are "
        "process ranks, whose submesh is a DeviceMesh; held by "
        "tests/test_torch_dist_gloo.py::"
        "test_exchange_swaps_on_the_granted_submesh",
    "tests/test_pst.py::test_device_swap_keeps_float64_temps_exact":
        _SWAP.format("test_device_swaps_keep_float64_temps_exact"),
    "tests/test_pst.py::test_device_swap_preserves_temps_and_pair_symmetry":
        _SWAP.format("test_metropolis_swap_matches_reference"),
    "tests/test_runtime.py::test_metropolis_host_vs_device":
        _SWAP.format("test_metropolis_swap_deterministic_cases"),
    "tests/test_analysis.py::test_run_validate_warn_proceeds_and_records":
        "the port's warning names its own package, repro_torch.analysis "
        "(ROADMAP C14); held by tests/test_torch_analysis_cli.py::"
        "test_validate_warn_names_the_port_package",
}


def reference_tests(suite):
    """The ids of ``tests/test_<suite>.py``'s tests: its module-level
    ``test_*`` functions (the reference suites parametrise none)."""
    path = ROOT / "tests" / f"test_{suite}.py"
    tree = ast.parse(path.read_text())
    return [f"tests/test_{suite}.py::{node.name}" for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and node.name.startswith("test_")]


ALL = [tid for s in SUITES for tid in reference_tests(s)]
CASES = [tid for tid in ALL if tid not in EXCLUDED]


def _run_group(suites, out):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "TORCH_ALIAS_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["JAX_PLATFORMS"] = "cpu"
    env["TORCH_ALIAS_RESULTS"] = out
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-p", "no:randomly", "-p", "no:xdist", "-p", "_torch_alias",
           *[f"tests/test_{s}.py" for s in suites]]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if not os.path.exists(out):
        raise AssertionError(f"pytest {suites} wrote no results "
                             f"(rc {proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(GROUPS)) as pool:
        runs = [pool.submit(_run_group, g, os.path.join(tmp, f"{i}.json"))
                for i, g in enumerate(GROUPS)]
        out = {}
        for r in runs:
            out.update(r.result())
    return out


@pytest.mark.parametrize("test_id", CASES)
def test_reference_test_passes_on_the_port(test_id, results):
    got = results.get(test_id)
    assert got is not None, f"{test_id} did not run"
    assert got["outcome"] == "passed", got.get("longrepr", got)


def test_suites_run_every_reference_test(results):
    """Every collected reference test is a case or a named exclusion, and
    the subprocesses ran exactly those tests."""
    assert set(EXCLUDED) <= set(ALL)
    assert sorted(results) == sorted(ALL)
    assert {g for grp in GROUPS for g in grp} == set(SUITES)


def test_excluded_tests_fail_for_their_stated_reason(results):
    for test_id in EXCLUDED:
        got = results[test_id]
        assert got["outcome"] == "failed", (test_id, got)

"""pytest plugin that runs the JAX package's front-end suites against the
port: ``repro.<sub>`` resolves to ``repro_torch.<sub>`` for every
subpackage in ``ALIASED`` (and their submodules), and each test's outcome
is written as JSON to the path in ``$TORCH_ALIAS_RESULTS``.

    python -m pytest -p _torch_alias tests/test_flow.py

Load it only in a process of its own (``-p`` before any ``repro`` import):
the alias stays for the life of the interpreter.  ``repro.dist`` is the
port's too, so a test's device topology is ``repro_torch.dist.topology.
SlotTopology`` and its recarve rules the port's sharding contract.
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import json
import os
import sys

ALIASED = ("core", "runtime", "staging", "analysis", "serving", "plugins",
           "federation", "obs", "dist")


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolve ``repro.<sub>[.x]`` to the already-imported module
    ``repro_torch.<sub>[.x]``: one module object under both names, so
    ``isinstance`` and module state agree whichever name a test used."""

    def find_spec(self, name, path=None, target=None):
        parts = name.split(".")
        if len(parts) < 2 or parts[0] != "repro" or parts[1] not in ALIASED:
            return None
        return importlib.util.spec_from_loader(name, self)

    def create_module(self, spec):
        return importlib.import_module("repro_torch" + spec.name[5:])

    def exec_module(self, module):
        # undo the import system's stamp of the alias's spec
        module.__spec__ = importlib.util.find_spec(module.__name__)


sys.meta_path.insert(0, _Alias())

_RESULTS: dict = {}


def pytest_runtest_logreport(report):
    entry = _RESULTS.setdefault(report.nodeid, {"outcome": "passed"})
    if report.failed:
        entry["outcome"] = "failed"
        entry["when"] = report.when
        entry["longrepr"] = str(report.longrepr)[-4000:]
    elif report.skipped and entry["outcome"] == "passed":
        entry["outcome"] = "skipped"


def pytest_sessionfinish(session, exitstatus):
    path = os.environ.get("TORCH_ALIAS_RESULTS")
    if path:
        with open(path, "w") as f:
            json.dump(_RESULTS, f)

"""Load an example under ``examples/`` as a module on either package: for
the port its ``from repro.`` imports read ``from repro_torch.``, so both
packages run the example's own code (no file under ``examples/`` is
edited).  ``port_example`` loads a fresh copy of one of the port's own
examples (``repro_torch.examples``: those that call JAX), whose names a
test may patch."""
import contextlib
import io
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


def example_module(name: str, pkg: str) -> ModuleType:
    path = ROOT / "examples" / f"{name}.py"
    src = path.read_text()
    if pkg == "repro_torch":
        src = src.replace("from repro.", "from repro_torch.")
    mod = ModuleType(f"{name}_{pkg}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def port_example(name: str) -> ModuleType:
    """A fresh module of ``src/repro_torch/examples/<name>.py`` (its
    globals this test's own to patch)."""
    path = ROOT / "src" / "repro_torch" / "examples" / f"{name}.py"
    mod = ModuleType(f"{name}_port_example")
    mod.__file__ = str(path)
    exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
    return mod


def printed(fn, *args, **kwargs):
    """(return value, standard output) of ``fn(*args, **kwargs)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rv = fn(*args, **kwargs)
    return rv, out.getvalue()

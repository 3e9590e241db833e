"""Load an example under ``examples/`` as a module on either package: for
the port its ``from repro.`` imports read ``from repro_torch.``, so both
packages run the example's own code (no file under ``examples/`` is
edited)."""
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


def printed(fn, *args, **kwargs):
    """(return value, standard output) of ``fn(*args, **kwargs)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rv = fn(*args, **kwargs)
    return rv, out.getvalue()

"""Every port test module runs torch on one intra-op thread
(``tests/_threads.py``), or says here why it does not: a new module that
leaves torch's pool of a thread a core in each of the suite's workers
slows every worker beside it several-fold."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401

TESTS = Path(__file__).resolve().parent
# module file name -> why it keeps torch's default thread count
EXEMPT: dict = {}
MODULES = sorted(p.name for p in TESTS.glob("test_torch_*.py"))


def _imports_one_thread(path: Path) -> bool:
    tree = ast.parse(path.read_text())
    return any(isinstance(node, ast.ImportFrom) and node.module == "_threads"
               and any(a.name == "_one_thread" for a in node.names)
               for node in tree.body)


def test_every_module_runs_torch_on_one_thread():
    unmarked = [m for m in MODULES
                if m not in EXEMPT and not _imports_one_thread(TESTS / m)]
    assert not unmarked, ("import the fixture (from _threads import "
                          "_one_thread) or name the module in EXEMPT with "
                          f"the reason: {unmarked}")
    for m, why in EXEMPT.items():
        assert not _imports_one_thread(TESTS / m), \
            f"{m} is exempt but imports _one_thread"
        assert why.strip(), f"{m}: no reason given"


def test_one_thread_restores_the_count():
    """The fixture sets one thread and gives back the count it found."""
    import torch
    outer = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        gen = _one_thread.__wrapped__()
        next(gen)
        assert torch.get_num_threads() == 1
        with pytest.raises(StopIteration):
            next(gen)
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(outer)

"""One intra-op thread for the port's test modules.

The suite runs in 6 xdist workers on one host.  Torch's default pool of
one intra-op thread a core, in each worker at once, oversubscribes the
cores: the port's small CPU ops wait on each other's threads and run
several-fold slower, and the single-threaded subprocesses of the dry-run
and process-group tests wait behind them.  A module takes the setting by
importing the fixture (``from _threads import _one_thread``).  It is
autouse and module-scoped, so the module's fixtures and tests all run on
one thread, and the previous count comes back after the module's last
test: nothing leaks into the next module's tests (the JAX package's among
them).  ``tests/test_torch_threads.py`` checks that
every ``tests/test_torch_*.py`` module imports it or says why not.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

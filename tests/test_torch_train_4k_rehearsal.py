"""CPU rehearsals of ``chip_smoke.py``'s ``train_4k <arch>`` phases, each
``TRAIN_4K`` entry's (``tests/test_torch_train_4k.py``'s helper
``rehearse_train_4k_phase``): the five of ``tests/test_torch_train_4k.py``
and the four of ``tests/test_torch_train_4k_grid.py``, kept apart so that
each file stays short enough for the suite's workers."""
import pytest

pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
from test_torch_train_4k import ARCHS, rehearse_train_4k_phase  # noqa: E402
from test_torch_train_4k_grid import ARCHS as GRID_ARCHS  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_train_4k_phase_rehearsal(arch, monkeypatch, capsys):
    """``chip_smoke.py``'s ``train_4k <arch>`` phase on the CPU: a reduced
    config under the phase's arch, the cell at 128 positions (past eight
    of the reduced windows), 2 steps through ``launch.train.main``: the
    batch rule on the reckonings (gemma3-4b-L30's 2 rows by a limit set
    between its reckonings of 2 and 4), exact launches a step (flash,
    gmm and gmm_bwd on wgmma), the comparison with ``impl="ref"`` (plain
    against plain: 0) over the picked leaves (recurrentgemma-2b's first
    local layer too; falcon-mamba at 4 layers), and the dryrun row."""
    rehearse_train_4k_phase(arch, monkeypatch, capsys)


@pytest.mark.parametrize("arch", GRID_ARCHS)
def test_chip_smoke_train_4k_grid_phase_rehearsal(arch, monkeypatch, capsys):
    """The arch's ``train_4k`` phase on the CPU, as
    ``test_chip_smoke_train_4k_phase_rehearsal`` runs the first archs'."""
    rehearse_train_4k_phase(arch, monkeypatch, capsys)

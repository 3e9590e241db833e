"""CPU rehearsals of ``chip_smoke.py``'s ``long <arch>`` phases (the
reference's long-context cells) of gemma2-2b, recurrentgemma-2b,
falcon-mamba-7b, qwen3-moe-30b-a3b and gemma3-4b (its three cells);
``tests/test_torch_long_context_grid.py`` rehearses the other archs'.  The helper is
``tests/test_torch_long_context.py``'s ``rehearse_long_phase``; each file
stays short enough for the suite's workers."""
import pytest

pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
from test_torch_long_context import rehearse_long_phase  # noqa: E402


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b",
                                  "falcon-mamba-7b", "qwen3-moe-30b-a3b",
                                  "gemma3-4b"])
def test_chip_smoke_long_phase_rehearsal(arch, monkeypatch):
    """``chip_smoke.py``'s ``long <arch>`` phases on the CPU at reduced
    widths (bf16 compute, head_dim 64) and short cells (prefill 96
    positions, past the reduced window of 16; decode 64; long_500k 128):
    the wrappers the model calls count as launches (not under
    impl="ref"), the reckonings are stand-ins that keep the batch rule,
    and the peak check is off (the CPU has no device memory).  Each row's
    own checks pass: the server's launches and loop, the comparison's
    launches at its depth, the hidden states at 0 with each control above
    CPU_H_LIMIT, the long_500k tokens equal, a decode step's launches the
    entry's."""
    got = rehearse_long_phase(arch, monkeypatch)
    if arch == "gemma3-4b":   # every cell, prefill_32k and decode_32k too
        assert set(got) == {"prefill_32k", "decode_32k", "long_500k"}

"""The rest of the reference's ``train_4k`` grid on the port: minicpm-2b
(its WSD schedule), whisper-large-v3 (4 x 1500 frames), nemotron-4-15b-L3
and internvl2-26b-L9 (4 microbatches; vision embeddings), held as
``tests/test_torch_train_4k.py`` holds the first five archs (its helpers):
2 steps of ``launch.train.train_loop`` against the JAX package's loop,
each ``TRAIN_4K`` entry's batch rule and launch tally on the dry run's
full-width reckonings, the backward kernels' cases at these archs'
train_4k problems, and the dry run's tracker summing a gradient in
place (their ``train_4k`` phases' CPU rehearsals are in
``tests/test_torch_train_4k_rehearsal.py``)."""
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
from test_torch_train_4k import (  # noqa: E402
    CS,
    _attention_case,
    _Reckonings,
    check_batch_rule,
    check_form_matches_jax,
    check_launches_tally,
)

ARCHS = ["minicpm-2b", "whisper-large-v3",
         f"nemotron-4-15b-L{CS.NEMOTRON_4K_LAYERS}",
         f"internvl2-26b-L{CS.INTERNVL_4K_LAYERS}"]
RECKONINGS = _Reckonings(CS)


def test_train_4k_entries_are_held_by_the_two_files():
    """Every TRAIN_4K entry is this file's or the first file's."""
    import test_torch_train_4k as first
    assert sorted(ARCHS + first.ARCHS) == sorted(s["arch"]
                                                 for s in CS.TRAIN_4K)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_grid_form_matches_jax(arch):
    """As ``test_train_4k_form_matches_jax``: minicpm-2b under its WSD
    schedule, whisper-large-v3 with its frames, nemotron-4-15b and
    internvl2-26b (vision embeddings) in 4 microbatches of one row."""
    check_form_matches_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_grid_batch_rule(arch):
    """B = 4 for each, the cap deciding (and nemotron-4-15b-L3's limit):
    twice it reckons 66.98 (minicpm), 35.01 (whisper), 78.36 (nemotron-L3)
    and 72.72 GB (internvl-L9)."""
    check_batch_rule(arch, RECKONINGS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_grid_launches_are_the_dry_runs_tally(arch):
    """Each entry's launches a step are the dry run's tally: whisper's 96
    flash calls a forward (encoder, decoder self- and cross-attention)
    twice under remat and its backward once; nemotron's and internvl's
    layers in 4 microbatches."""
    check_launches_tally(arch, RECKONINGS)


@pytest.mark.parametrize("case,arch,extra", [
    ("minicpm_4k", "minicpm-2b", {}),
    ("whisper_4k", "whisper-large-v3", {}),
    ("whisper_4k_cross", "whisper-large-v3",
     dict(Sk=1500, causal=False, seg=0)),
    ("nemotron_4k", f"nemotron-4-15b-L{CS.NEMOTRON_4K_LAYERS}", {}),
    ("nemotron_4k", f"internvl2-26b-L{CS.INTERNVL_4K_LAYERS}", {}),
])
def test_backward_kernel_cases_are_the_grid_train_4k_problems(case, arch,
                                                                extra):
    """Each flash backward ``*_4k`` case is the problem its arch's train_4k
    microbatch gives the kernel: minicpm-2b's 4 rows (G = 1, D = 64),
    whisper's decoder and its cross-attention over the 1500 frames,
    nemotron-4-15b's and internvl2-26b's microbatch of one row (G = 6)."""
    c = next(c for c in CS.FA_BWD_CASES if c["name"] == case)
    want = {**_attention_case(arch), **extra}
    assert {k: c[k] for k in want} == pytest.approx(want)


@pytest.mark.parametrize("uses", [1, 2, 3, 4])
def test_reckoning_sums_a_gradient_in_place(uses):
    """The dry run's tracker counts the autograd engine's sum of a tensor's
    gradients as eager mode makes it, in place into the first: a weight
    used ``uses`` times holds one gradient buffer, and a second while the
    next is summed in, never a third (the f32 LM head's gradient over the
    loss's chunks, nemotron-4-15b-L3's train_4k peak)."""
    import torch

    from repro_torch.launch.dryrun import MemoryTracker, block_bytes
    w = torch.zeros((256, 256), device="meta", requires_grad=True)
    xs = [torch.zeros((256, 256), device="meta") for _ in range(uses)]
    with MemoryTracker("meta") as m:
        sum((x * w).sum() for x in xs).backward()
    grad = block_bytes(256 * 256 * 4)
    assert min(uses, 2) * grad <= m.peak < (min(uses, 2) + 0.01) * grad


class _TwoTerms(torch.autograd.Function):
    """y = 7 x, whose backward sums two terms it makes itself."""

    @staticmethod
    def forward(ctx, x):
        return x * 7

    @staticmethod
    def backward(ctx, g):
        return g * 3 + g * 4


def test_reckoning_keeps_a_backwards_own_sum_out_of_place():
    """An ``add`` inside a node's backward is not the engine's sum of
    gradients: eager mode runs it out of place, and so does the tracker
    (``g * 3``, ``g * 4`` and their sum live at once); the engine's sum of
    two such nodes' gradients of one tensor is still taken in place (the
    first node's gradient held, the second's three buffers, no fifth)."""
    from repro_torch.launch.dryrun import MemoryTracker, block_bytes
    n = block_bytes(256 * 256 * 4)
    for uses in (1, 2):
        x = torch.zeros((256, 256), device="meta", requires_grad=True)
        with MemoryTracker("meta") as m:
            sum(_TwoTerms.apply(x).sum() for _ in range(uses)).backward()
        assert (2 + uses) * n <= m.peak < (2.01 + uses) * n

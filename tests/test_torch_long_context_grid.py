"""The rest of the reference's long-context grid on the port: prefill_32k
and decode_32k of gemma3-4b, minicpm-2b, nemotron-4-15b,
whisper-large-v3, internvl2-26b and grok-1-314b-L4.

* Against the JAX package on the CPU at reduced widths (parameters from
  the JAX ``init_params`` through ``params_from_numpy``, tokens and stub
  inputs from numpy; 1e-4, as ``tests/test_torch_long_context.py``):
  whisper-large-v3's decode over a 32,768-position cache that holds the
  encoder's cross k, v; internvl2-26b's long prefill with vision
  embeddings; grok-1-314b's long prefill past its capacity block.
* ``chip_smoke.py``: every applicable cell of the grid is run by a
  ``LONG`` or ``TRAIN_4K`` entry or named in ``GRID_LEFT``; each new
  ``LONG`` entry's batches follow the rule on the dry run's full-width
  reckonings, and their launches are its tally; CPU rehearsals of the new
  ``long`` phases.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import forward as jax_forward  # noqa: E402
from repro.serve import build_prefill_step as jax_prefill_step  # noqa: E402
from repro.serve import build_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import SHAPES, cell_applicable  # noqa: E402
from repro_torch.configs import list_configs, resolve_config  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    build_prefill_step,
    build_serve_step,
)
from test_torch_long_context import (  # noqa: E402
    ATOL,
    _assert_caches_equal,
    _chip_smoke,
    _setup,
    _tokens,
    rehearse_long_phase,
)
from test_torch_models import _stub_inputs  # noqa: E402

GRID_ARCHS = ["gemma3-4b", "minicpm-2b", "nemotron-4-15b",
              "whisper-large-v3", "internvl2-26b", "grok-1-314b-L4"]
CS = _chip_smoke()


# ------------------------------------------------------ against the JAX package

def test_whisper_decode_over_a_long_cache_with_frames_matches_jax():
    """decode_32k as ``launch.dryrun`` builds it, with whisper's frames: a
    PROMPT-token prompt and 2 rows of frames prefilled into a cache of
    32,768 positions (every layer's cross k, v: ``xk``, ``xv`` over the
    encoder's output), then 4 decode steps at its end (each attends over
    the cached frames): the logits of the prefill and of every step within
    1e-4, then every cache leaf, ``xk`` and ``xv`` among them."""
    from repro_torch.launch.dryrun import PROMPT
    jcfg, jparams, cfg, params = _setup("whisper-large-v3")
    S, steps, B = SHAPES["decode_32k"].seq_len, 4, 2
    tok = _tokens(cfg, B, PROMPT + steps)
    frames = _stub_inputs(cfg, B)["enc_frames"]
    jout = jax.jit(jax_prefill_step(jcfg, cache_len=S))(
        jparams, {"tokens": jnp.asarray(tok[:, :PROMPT]),
                  "enc_frames": jnp.asarray(frames)})
    with torch.inference_mode():
        out = build_prefill_step(cfg, cache_len=S)(
            params, {"tokens": torch.from_numpy(tok[:, :PROMPT]).long(),
                     "enc_frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(jout["logits"]), atol=ATOL)
    jcache, cache = jout["cache"], out["cache"]
    assert all({"xk", "xv"} <= set(c) for c in cache)
    assert cache[0]["xk"].shape[1] == cfg.encoder_seq
    jstep, step = jax.jit(jax_serve_step(jcfg)), build_serve_step(cfg)
    for t in range(steps):
        pos = np.full((B,), S - steps + t, np.int32)
        x = tok[:, PROMPT + t:PROMPT + t + 1]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(x),
                                jnp.asarray(pos))
        with torch.inference_mode():
            logits, cache = step(params, cache, torch.from_numpy(x).long(),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
    _assert_caches_equal(cache, jcache, cfg)


@pytest.mark.parametrize("arch,S", [("internvl2-26b", 512),
                                    ("grok-1-314b", 512)])
def test_long_prefill_with_stubs_or_past_capacity_matches_jax(arch, S):
    """A 2 x 512-token prefill against the JAX package's: every position's
    hidden states and every cache leaf within 1e-4.  internvl2-26b takes
    its vision embeddings in place of the first positions; grok-1-314b's
    1,024 tokens route 512 assignments an expert on average (top-2 of 4),
    past the 128-row capacity block (C = 640), as its 32k prefill's
    10,240."""
    jcfg, jparams, cfg, params = _setup(arch)
    B, clen = 2, S + 8
    tok = _tokens(cfg, B, S)
    kw = _stub_inputs(cfg, B)
    assert bool(kw) == (arch == "internvl2-26b")
    if cfg.num_experts:
        T, k, E = B * S, cfg.experts_per_tok, cfg.num_experts
        assert T * k // E >= 128    # the 128-row block
        C = max(128, -(-math.ceil(T * k / E * 1.25) // 128) * 128)
        assert C == 640
    jout = jax_forward(jcfg, jparams, jnp.asarray(tok), cache_len=clen,
                       **{k_: jnp.asarray(v) for k_, v in kw.items()})
    with torch.inference_mode():
        out = forward(cfg, params, torch.from_numpy(tok).long(),
                      cache_len=clen,
                      **{k_: torch.from_numpy(v) for k_, v in kw.items()})
    np.testing.assert_allclose(out["h"].numpy(), np.asarray(jout["h"]),
                               atol=ATOL)
    _assert_caches_equal(out["cache"], jout["cache"], cfg)


# ------------------------------------------------------------- chip_smoke

def _base(arch):
    """The registered config of an entry's arch (``<base>-L<n>``: base)."""
    base, _, n = arch.rpartition("-L")
    return base if n.isdigit() else arch


def test_chip_smoke_runs_every_cell_of_the_grid():
    """Every SHAPES cell that ``cell_applicable`` admits for a registered
    arch is run by a ``LONG`` entry (serving cells) or a ``TRAIN_4K`` entry
    (train_4k), or ``GRID_LEFT`` names it with its reason; a LONG entry
    that runs a depth cut is named there too (grok-1-314b, served at
    ``GROK_LAYERS``), and grok-1-314b's train_4k is the one cell not run."""
    runs = {}
    for spec in CS.LONG:
        cfg = resolve_config(spec["arch"])
        for cell in spec.get("cells", CS.LONG_CELLS):
            if cell_applicable(cfg, SHAPES[cell])[0]:
                runs.setdefault((_base(spec["arch"]), cell), []).append(
                    spec["arch"])
    for spec in CS.TRAIN_4K:
        runs.setdefault((_base(spec["arch"]), "train_4k"), []).append(
            spec["arch"])
    grid = {(arch, cell) for arch in list_configs()
            for cell, shape in SHAPES.items()
            if not arch.startswith(("toy", "serve-"))
            and cell_applicable(resolve_config(arch), shape)[0]}
    assert len(grid) == 10 * 3 + 4   # four archs also take long_500k
    missing = [c for c in grid if c not in runs and c not in CS.GRID_LEFT]
    assert not missing, missing
    assert set(CS.GRID_LEFT) <= grid
    for (arch, cell), by in runs.items():
        assert (arch, cell) in grid
        cut = any(a != arch for a in by)
        if cell != "train_4k":   # a serving cell at a cut is named
            assert cut == ((arch, cell) in CS.GRID_LEFT), (arch, cell)
    assert ("grok-1-314b", "train_4k") not in runs
    assert "G2" in CS.GRID_LEFT[("grok-1-314b", "train_4k")]


class _Reckonings:
    """``chip_smoke._long_cells`` of the grid's archs, reckoned here, once
    each."""

    def __init__(self):
        self.cells = {k: v for k, v in CS._long_cells().items()
                      if k.split()[1] in GRID_ARCHS}

    @functools.lru_cache(maxsize=None)
    def get(self, key):
        return CS._reckon(**self.cells[key])


RECKONINGS = _Reckonings()
# the decode cells' reckonings decide: 2B over ENS_PEAK_LIMIT_GB (the
# prefill cells' 2B too; gemma3-4b's prefill_32k at 16 rows reckons 76.82)
_CELLS = [(a, c) for a in GRID_ARCHS for c in ("prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,cell", _CELLS)
def test_long_grid_batch_rule_and_tally(arch, cell):
    """Each new entry's batch of the cell (``profile_serve.LONG_BATCH``) is
    the largest power of two, up to the cell's global batch, whose
    full-width dry-run peak stays under ``ENS_PEAK_LIMIT_GB``; the dry
    run's tally is the phase's launches: a prefill's the serve entry's
    (an arch with a stubbed frontend: ``STUB_PREFILL``'s, the reckoning
    taking its stub inputs), a decode step's the entry's ``decode``
    (grok-1-314b-L4: mma_sync at C = 16) or the serve entry's."""
    spec = next(s for s in CS.LONG if s["arch"] == arch)
    B = CS._long_batch(spec, cell)
    assert f"long {arch} {cell} {B}" in RECKONINGS.cells
    rule = CS._long_rule(RECKONINGS, arch, cell, B)
    assert rule["ok"], rule
    assert rule["next_batch_reckoned_peak_gb"] >= CS.ENS_PEAK_LIMIT_GB
    _, _, per_prefill, per_decode = next(e for e in CS.SERVE
                                         if e[0] == arch)
    calls = RECKONINGS.get(f"long {arch} {cell} {B}")["kernel_calls"]
    if cell == "prefill_32k":
        assert calls == CS.STUB_PREFILL.get(arch, per_prefill)
    else:
        assert calls == spec.get("decode", per_decode)
    if arch.startswith("grok") and cell == "decode_32k":
        assert calls == {"gmm": 3 * CS.GROK_LAYERS,
                         "gmm.mma_sync": 3 * CS.GROK_LAYERS}


def test_grok_router_sizes_rehearsal(monkeypatch):
    """``chip_smoke._router_sizes`` of grok-1-314b's router on its long
    prefill's first prompt (the ``grok_32k_wi`` gmm case's sizes) on a reduced grok-1-314b with its 8 experts, top-2, and the
    prefill_32k cell cut to 1,024 positions: the layer-0 router's group
    sizes of the long phase's first prompt (1,007 tokens), at most its
    tokens times top-k assignments, none past the capacity (C = 384, the
    128-row block)."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    full = get_config("grok-1-314b")
    cfg = reduced(full).replace(num_experts=full.num_experts,
                                experts_per_tok=full.experts_per_tok)
    monkeypatch.setitem(cfg_base._REGISTRY, "grok-1-314b", cfg)
    monkeypatch.setitem(SHAPES, "prefill_32k",
                        ShapeSpec("prefill_32k", "prefill", 1024, 32))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    try:
        sizes = CS._router_sizes(torch.device("cpu"), CS.GROK_ROUTER,
                                 CS._long_router_rows)["grok_32k"]
    finally:
        cfg_base._REGISTRY.pop("grok-1-314b-L1", None)
    T, k, E = 1024 - CS.LONG_NEW - 1, 2, 8
    C = max(128, -(-math.ceil(T * k / E * 1.25) // 128) * 128)
    assert C == 384
    assert sizes.shape == (E,) and sizes.dtype == torch.int32
    assert T * k // 2 <= int(sizes.sum()) <= T * k
    assert int(sizes.max()) <= C


@pytest.mark.parametrize("arch", GRID_ARCHS[1:])
def test_chip_smoke_long_grid_phase_rehearsal(arch, monkeypatch):
    """The arch's ``long`` phases on the CPU, as
    ``test_chip_smoke_long_phase_rehearsal`` runs the first archs' (and
    gemma3-4b's, its prefill_32k and decode_32k with its long_500k):
    whisper's and internvl's comparisons take their stub inputs (whisper's
    first attention sublayers read too; its decode cache holds the cross
    k, v), grok-1-314b-L4's decode launches its entry's variant."""
    got = rehearse_long_phase(arch, monkeypatch)
    assert set(got) >= {"prefill_32k", "decode_32k"}
    if arch == "whisper-large-v3":
        assert got["decode_32k"]["cross_cache_every_layer"]
        assert got["prefill_32k"]["check"]["stub_inputs"]["enc_frames"]

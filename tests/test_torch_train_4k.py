"""The reference's training cell, ``train_4k`` (4,096-token rows), on the
port: the slice's form against the JAX package on the CPU, and the
``train_4k`` phases of ``chip_smoke.py`` that run the cell on the card.

* The form: for each arch the phases train (gemma2-2b, recurrentgemma-2b,
  falcon-mamba-7b, qwen3-moe-30b-a3b, gemma3-4b) a reduced config at 128
  positions, eight of its 16-position windows a row, 4 rows (qwen3-moe in
  its config's 4 microbatches, one row each), 2 steps of the JAX package's
  train loop and of ``repro_torch.launch.train.train_loop`` from the same
  state: losses within ``STEP_ATOL`` and every parameter and Adam moment
  within it, gemma3-4b's and gemma2-2b's near-eps elements
  (``NEAR_EPS_4K``) within the two steps' learning rates, as
  ``tests/test_torch_train.py`` holds one step's.
* ``launch.train`` takes a depth cut ``<base>-L<n>``: the cut's depth, its
  base's schedule (minicpm-2b-L3: wsd), the losses of ``train_loop`` on
  ``resolve_config``'s config.
* ``TRAIN_4K``: each entry's batch is the one its rule picks on the dry
  run's full-width reckonings of it and of twice it (fake tensors, nothing
  allocated), and its launches a step are the dry run's tally; each
  backward kernel's ``*_4k`` case is its model's problem at the cell.
* CPU rehearsals of the five phases on reduced configs, the plain versions
  counted as the kernels' launches.
"""
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.train import TrainHyper as JaxTrainHyper  # noqa: E402
from repro.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SHAPES,
    get_config,
    reduced,
    resolve_config,
)
from repro_torch.configs import base as cfg_base  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.kernels import count_launch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.mamba import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    train_state_from_numpy,
    train_state_to_flat,
)
from repro_torch.optim import make_schedule  # noqa: E402
from repro_torch.plugins import lm  # noqa: E402
from repro_torch.train import make_train_state  # noqa: E402
from test_torch_train import (  # noqa: E402
    ADAM_B1,
    ADAM_EPS,
    NEAR_EPS_STEP,
    STEP_ATOL,
)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
# the archs this file holds; tests/test_torch_train_4k_grid.py holds the
# other TRAIN_4K entries (minicpm-2b, whisper-large-v3, nemotron-4-15b-L3,
# internvl2-26b-L9) with these helpers, so that each file stays short
ARCHS = ["gemma2-2b", "recurrentgemma-2b", f"falcon-mamba-7b-L{CS.FALCON_LAYERS}",
         f"qwen3-moe-30b-a3b-L{CS.QWEN_LAYERS}",
         f"gemma3-4b-L{CS.GEMMA3_LAYERS}"]


def base_of(arch):
    """The registered config a TRAIN_4K arch cuts (``<base>-L<n>``)."""
    return arch.rpartition("-L")[0] if "-L" in arch else arch


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


# ------------------------------------------------ the form against JAX

FORM = dict(seq=128, batch=4, steps=2)
# NEAR_EPS_STEP's rule over two steps: a parameter whose reference
# gradient at either step lies within 10 eps of 0, and is not 0 (from the
# reference's
# moments, g_i = (m_i - b1 m_(i-1)) / (1 - b1)) takes a step of about lr
# whose sign float32 rounding decides; where it lies past STEP_ATOL it is
# held within the two steps' learning rates, every other element and
# every moment at STEP_ATOL.
# Reduced gemma2-2b at this form has one: blocks/sub_1/mlp/wi at (0, 43,
# 7), first gradient 3.3e-9 in the reference, 1.9e-5 apart after the two
# steps (the CPU, float32).
NEAR_EPS_4K = NEAR_EPS_STEP + ("gemma2-2b",)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_form_matches_jax(arch):
    """2 steps of ``launch.train.train_loop`` against the JAX package's
    train loop from one state: 4 rows of 128 positions, past eight of the
    reduced windows of 16 (gemma2-2b, recurrentgemma-2b, gemma3-4b);
    qwen3-moe in 4 microbatches of one row in both."""
    check_form_matches_jax(arch)


def check_form_matches_jax(arch):
    """``test_train_4k_form_matches_jax``'s check of one arch: the config's
    microbatches in both loops, its stub inputs (frames, vision
    embeddings) from each package's SyntheticLM."""
    base = base_of(arch)
    jcfg = jax_reduced(jax_get_config(base)).replace(
        microbatches=get_config(base).microbatches)
    assert FORM["seq"] == 8 * jcfg.sliding_window or not jcfg.sliding_window
    sched = launch_train.arch_schedule(arch)
    hyper = launch_train.make_hyper(FORM["steps"], 3e-4, sched)
    jstate = jax_make_train_state(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    step = jax.jit(jax_build_train_step(jcfg, None, JaxTrainHyper(
        base_lr=hyper.base_lr, warmup=hyper.warmup,
        total_steps=hyper.total_steps, schedule=sched)))
    data = JaxSyntheticLM(jcfg, JaxShapeSpec("cli", "train", FORM["seq"],
                                             FORM["batch"]), seed=0)
    want_loss, lrs = [], []
    near = {}   # elements whose reference gradient is within 10 eps of 0
    m_prev = {k: 0.0 for k in flat if k.startswith("opt/m/")}
    for i in range(FORM["steps"]):
        jstate, m = step(jstate, data.batch_at(i))
        want_loss.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        for k in m_prev:   # g = (m_i - b1 m_(i-1)) / (1 - b1)
            m_i = np.asarray(_flatten(jstate)[k])
            g = (m_i - ADAM_B1 * m_prev[k]) / (1 - ADAM_B1)
            near[k] = near.get(k, False) | ((g != 0)
                                             & (np.abs(g) < 10 * ADAM_EPS))
            m_prev[k] = m_i
    cfg = port_cfg(jcfg)
    state = train_state_from_numpy(flat, cfg)
    got = launch_train.train_loop(
        cfg, ShapeSpec("cli", "train", FORM["seq"], FORM["batch"]), state,
        steps=FORM["steps"], hyper=hyper, device="cpu", log=lambda s: None)
    assert cfg.microbatches == get_config(base).microbatches
    np.testing.assert_allclose([h["loss"] for h in got], want_loss,
                               atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose([h["lr"] for h in got], lrs, rtol=1e-6)
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(jstate).items()}
    have = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in train_state_to_flat(state, cfg).items()}
    assert set(have) == set(want) and int(state["step"]) == FORM["steps"]
    n_held = n_all = 0
    for k in want:
        held = np.zeros(want[k].shape, bool)
        if base in NEAR_EPS_4K and k.startswith("params/"):
            held = near["opt/m/" + k[len("params/"):]] & ~np.isclose(
                have[k], want[k], rtol=0, atol=STEP_ATOL)
            assert (np.abs(have[k] - want[k]) <= sum(lrs))[held].all(), k
            n_held, n_all = n_held + int(held.sum()), n_all + held.size
        np.testing.assert_allclose(np.where(held, want[k], have[k]), want[k],
                                   atol=STEP_ATOL, err_msg=k)
    assert n_held <= 1e-3 * max(n_all, 1)   # a tail: gemma2-2b 1 of 90,752


# ---------------------------------------------- launch.train takes a cut


def test_launch_train_takes_a_depth_cut_with_its_bases_schedule(
        monkeypatch):
    """``launch.train --arch minicpm-2b-L3 --reduced`` trains 3 layers
    (reduced alone would give 2) under minicpm-2b's WSD schedule, with
    ``train_loop``'s losses on ``resolve_config``'s config; ``lm.train``'s
    configs and the train phases' registered cuts are the same config."""
    seen = []
    real = launch_train.train_loop

    def recording(cfg, *a, **kw):
        seen.append((cfg, kw["hyper"]))
        return real(cfg, *a, **kw)
    monkeypatch.setattr(launch_train, "train_loop", recording)
    steps, B, S = 6, 2, 32
    hist = launch_train.main(["--arch", "minicpm-2b-L3", "--reduced",
                              "--steps", str(steps), "--batch", str(B),
                              "--seq", str(S), "--device", "cpu"])
    (cfg, hyper), = seen
    assert cfg.num_layers == 3 and reduced(get_config("minicpm-2b")
                                           ).num_layers == 2
    assert hyper.schedule == "wsd"
    assert launch_train.arch_schedule("minicpm-2b-L3") == "wsd"
    assert launch_train.arch_schedule("gemma3-4b-L30") == "cosine"
    want_cfg = reduced(resolve_config("minicpm-2b-L3"), layers=3)
    assert cfg == want_cfg
    want = real(want_cfg, ShapeSpec("cli", "train", S, B),
                make_train_state(want_cfg,
                                 torch.Generator().manual_seed(0)),
                steps=steps, hyper=launch_train.make_hyper(steps, 3e-4,
                                                           "wsd"),
                device="cpu", log=lambda s: None)
    assert [h["loss"] for h in hist] == [h["loss"] for h in want]
    lrs = [h["lr"] for h in hist]
    kw = dict(base_lr=3e-4, warmup=hyper.warmup, total_steps=steps)
    wsd, cos = make_schedule("wsd", **kw), make_schedule("cosine", **kw)
    np.testing.assert_allclose(lrs, [float(wsd(torch.tensor(i)))
                                     for i in range(steps)], rtol=1e-6)
    assert not np.allclose(lrs, [float(cos(torch.tensor(i)))
                                 for i in range(steps)])
    cut = f"gemma3-4b-L{CS.GEMMA3_LAYERS}"
    try:
        registered = CS._cut_cfg(cut, "gemma3-4b", CS.GEMMA3_LAYERS)
        assert lm.resolve_cfg(cut) == registered
    finally:
        cfg_base._REGISTRY.pop(cut, None)
    assert lm.resolve_cfg(cut) == resolve_config(cut) == registered
    assert resolve_config(cut).num_layers == CS.GEMMA3_LAYERS


# ------------------------------------ TRAIN_4K's batches and launches


class _Reckonings:
    """``chip_smoke._train_4k_cells`` reckoned in this process, each once."""

    def __init__(self, cs):
        self.cs, self.cells = cs, cs._train_4k_cells()

    @functools.lru_cache(maxsize=None)
    def get(self, key):
        return self.cs._reckon(**self.cells[key])


RECKONINGS = _Reckonings(CS)


def test_train_4k_cells_are_reckoned_by_the_run():
    """The run reckons every entry at its batch and at twice it, at the
    cell's 4,096 positions and the config's microbatches."""
    cells = CS._reckon_cells()
    for spec in CS.TRAIN_4K:
        for b in (spec["batch"], 2 * spec["batch"]):
            assert cells[f"train_4k {spec['arch']} {b}"] == dict(
                arch=spec["arch"], batch=b, seq=4096)
    assert SHAPES[CS.TRAIN_4K_SHAPE].seq_len == 4096


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_batch_rule(arch):
    """Each entry's batch is the largest power of two, at most
    ``TRAIN_4K_CAP`` rows, whose full-width dry-run peak stays under
    ``ENS_PEAK_LIMIT_GB``; the cap stops every batch but gemma3-4b-L30's,
    whose 4 rows reckon over the limit."""
    check_batch_rule(arch, RECKONINGS)


def check_batch_rule(arch, reckonings):
    spec = next(s for s in CS.TRAIN_4K if s["arch"] == arch)
    rule = CS._train_4k_rule(reckonings, spec)
    assert rule["ok"], rule
    assert rule["decided_by"] == (["limit"] if arch.startswith("gemma3")
                                  else ["cap"] if rule[
                                      "next_batch_reckoned_peak_gb"]
                                  < CS.ENS_PEAK_LIMIT_GB
                                  else ["limit", "cap"])
    assert spec["batch"] == (2 if arch.startswith("gemma3") else 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_launches_are_the_dry_runs_tally(arch):
    """Each entry's launches a step are the dry run's tally of its cell:
    flash on wgmma, linear_scan and selective_scan forward twice (remat)
    and backward once, gmm and gmm_bwd (dx, dw) on wgmma at C = 384."""
    check_launches_tally(arch, RECKONINGS)


def check_launches_tally(arch, reckonings):
    spec = next(s for s in CS.TRAIN_4K if s["arch"] == arch)
    calls = reckonings.get(f"train_4k {arch} {spec['batch']}")[
        "kernel_calls"]
    assert calls == spec["launches"]
    if "qwen3" in arch:
        assert calls["gmm.wgmma"] == calls["gmm"] == 2 * 3 * 4 * 4
        assert calls["gmm_bwd.wgmma"] == calls["gmm_bwd.dx"] == 3 * 4 * 4


def _capacity(T, k, E, factor=1.25):
    """An expert's capacity C at T tokens, top-k of E
    (``models/layers.py``: rounded up to a block of 128 rows, or 8 when
    T k / E < 128)."""
    block = 128 if T * k // E >= 128 else 8
    return max(block, -(-math.ceil(T * k / E * factor) // block) * block)


def _attention_case(arch):
    cfg = resolve_config(arch)
    spec = next(s for s in CS.TRAIN_4K if s["arch"] == arch)
    local = any(cfg.layer_kind(i) == "local" for i in range(cfg.num_layers))
    return dict(B=spec["batch"] // cfg.microbatches, Sq=4096, Sk=4096,
                H=cfg.num_heads, KH=cfg.num_kv_heads, D=cfg.head_dim,
                causal=True, window=cfg.sliding_window if local else 0,
                softcap=cfg.attn_softcap,
                scale=cfg.attn_scale or cfg.head_dim ** -0.5, seg=1)


@pytest.mark.parametrize("case,want", [
    ("gemma2_4k", lambda: _attention_case("gemma2-2b")),
    ("recurrentgemma_4k", lambda: _attention_case("recurrentgemma-2b")),
    ("gemma3_4k", lambda: _attention_case(f"gemma3-4b-L{CS.GEMMA3_LAYERS}")),
    ("qwen3_4k", lambda: _attention_case(
        f"qwen3-moe-30b-a3b-L{CS.QWEN_LAYERS}")),
    ("rg_4k", lambda: dict(B=4, T=4096, C=resolve_config(
        "recurrentgemma-2b").lru_width, dtype="float32")),
    ("falcon_4k", lambda: dict(B=4, T=4096, d=resolve_config(
        "falcon-mamba-7b").d_inner, n=resolve_config(
        "falcon-mamba-7b").ssm_state, dtype="bfloat16")),
    ("qwen3_4k_wi", lambda: dict(
        E=resolve_config("qwen3-moe-30b-a3b").num_experts,
        C=_capacity(4096, 8, 128), D=resolve_config(
            "qwen3-moe-30b-a3b").d_model,
        F=resolve_config("qwen3-moe-30b-a3b").moe_d_ff, router="train_4k",
        variant="wgmma")),
])
def test_backward_kernel_cases_are_the_train_4k_problems(case, want):
    """Each backward kernel phase's ``*_4k`` case is the problem its
    model's train_4k microbatch gives the kernel (window 4,096 for
    gemma2-2b's local layers, which equals the row)."""
    cases = {c["name"]: c for c in (CS.FA_BWD_CASES + CS.LS_BWD_CASES
                                    + CS.SS_BWD_CASES + CS.GMM_BWD_CASES)}
    c, want = cases[case], want()
    assert {k: c[k] for k in want} == pytest.approx(want)
    if case == "qwen3_4k_wi":
        assert c["C"] == 384 and c["C"] % 128 == 0


# ------------------------------------------------------ CPU rehearsals


def _counted(monkeypatch):
    """The plain versions the wrappers and Functions call on the CPU count
    as the kernels' launches (flash and gmm with their variants, gmm's
    backward with dx and dw)."""
    def counted(module, attr, names):
        fn = getattr(module, attr)

        def run(*a, **kw):
            count_launch(*names(*a))
            return fn(*a, **kw)
        monkeypatch.setattr(module, attr, run)
    for attr, name in (("attention_fwd_ref", "flash_attention"),
                       ("attention_ref", "flash_attention"),
                       ("attention_bwd_ref", "flash_attention_bwd")):
        counted(fops, attr, lambda q, *_, n=name: (
            n, f"{n}.{fops.variant(q.dtype, q.shape[-1])}"))
    counted(rglru_ops, "linear_scan_ref", lambda *_: ("linear_scan",))
    counted(rglru_ops, "linear_scan_bwd_ref",
            lambda *_: ("linear_scan_bwd",))
    counted(mamba_ops, "selective_scan_ref", lambda *_: ("selective_scan",))
    counted(mamba_ops, "selective_scan_bwd_ref",
            lambda *_: ("selective_scan_bwd",))
    counted(gops, "gmm_ref", lambda x, w, *_: (
        "gmm", "gmm." + gops.variant(x.dtype, *x.shape, w.shape[2])))
    counted(gops, "gmm_bwd_ref", lambda x, w, *_: (
        "gmm_bwd", "gmm_bwd.dx", "gmm_bwd.dw",
        "gmm_bwd." + gops.bwd_variant(x.dtype, *x.shape, w.shape[2])))


def _rehearsal_cfg(arch):
    """A reduced config registered under the phase's arch: remat, bf16
    compute, head_dim 64 (the card's flash variant); falcon-mamba at 6
    layers (the comparison cuts it to 4), recurrentgemma-2b at 6 (two
    local layers), qwen3-moe with 16 experts top-8 (C > 16 a microbatch:
    gmm's wgmma variant) in its config's 4 microbatches."""
    base = base_of(arch)
    layers = {"falcon-mamba-7b": 6, "recurrentgemma-2b": 6,
              "qwen3-moe-30b-a3b": 2}.get(base)
    cfg = reduced(get_config(base), layers=layers).replace(
        name=arch, remat="full", dtype="bfloat16", head_dim=64,
        microbatches=get_config(base).microbatches)
    if cfg.num_experts:
        cfg = cfg.replace(num_experts=16, experts_per_tok=8)
    return cfg


def rehearse_train_4k_phase(arch, monkeypatch, capsys):
    """The rehearsal of ``arch``'s TRAIN_4K entry; an encoder's flash
    calls (its layers, the decoder's self- and cross-attention) and an
    entry's ``f32_held`` leaves (held against the plain run itself here:
    ratio 1) counted too."""
    import json
    cs = _chip_smoke()
    cfg = _rehearsal_cfg(arch)
    monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
    monkeypatch.setitem(cfg_base.SHAPES, cs.TRAIN_4K_SHAPE,
                        ShapeSpec(cs.TRAIN_4K_SHAPE, "train", 128, 256))
    spec = dict(next(s for s in cs.TRAIN_4K if s["arch"] == arch))
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    mbs = cfg.microbatches
    attn = kinds.count("local") + kinds.count("global")
    per = {"flash": attn * (2 if cfg.encoder_layers else 1)
           + cfg.encoder_layers,
           "rec": kinds.count("rec"), "mamba": kinds.count("mamba"),
           "moe": cfg.num_layers if cfg.num_experts else 0}
    spec["launches"] = cs._launches(**{f: (n, mbs) for f, n in per.items()
                                       if n})
    reck = _Reckonings(cs)
    B = spec["batch"]
    if B < cs.TRAIN_4K_CAP:   # the limit stops twice the batch
        lo, hi = (reck.get(f"train_4k {arch} {b}")["peak_bytes"] / 1e9
                  for b in (B, 2 * B))
        monkeypatch.setattr(cs, "ENS_PEAK_LIMIT_GB", (lo + hi) / 2)
    peak = reck.get(f"train_4k {arch} {B}")["peak_bytes"]
    _counted(monkeypatch)
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: peak)
    monkeypatch.setattr(cs, "_card", lambda: "rehearsal card, 700.00 W")
    got = cs.phase_train_4k(torch.device("cpu"), spec, reck)
    assert got == {k: v * cs.TRAIN_4K_STEPS
                   for k, v in spec["launches"].items()}
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    row, dry = rows[-2], rows[-1]
    assert row["phase"] == f"train_4k {arch}" and row["ok"]
    assert row["batch"] == B and row["seq"] == 128
    assert row["batch_rule"]["decided_by"] == (
        ["limit"] if B < cs.TRAIN_4K_CAP else ["cap"])
    assert all(s["launches"] == spec["launches"] for s in row["steps_run"])
    assert all(np.isfinite(h["loss"]) for h in row["history"])
    vs = row["vs_ref"]
    assert vs["layers"] == spec.get("check_layers", cfg.num_layers)
    assert vs["past_window"] and vs["positions"] == 128
    names = {w if w == "head" else (
        f"layer{w[1:w.index(':')]}/{w[w.index(':') + 1:]}"
        if w.startswith("L") else f"layer0/{w}") for w in spec["picked"]}
    held = {w if w in ("head", "embed") else f"layer0/{w}"
            for w in spec.get("f32_held", ())}
    assert set(vs["grad_rel_frobenius"]) == ({"embed"} | names) - held
    assert all(g == 0.0 for g in vs["grad_rel_frobenius"].values())
    assert set(vs["f32_held"] or {}) == held
    assert all(h["kernels_vs_ref"] == 0.0 and h["ratio"] == 1.0
               for h in (vs["f32_held"] or {}).values())
    assert vs["loss_kernels"] == vs["loss_ref"]
    if cfg.num_experts:
        assert vs["same_group_sizes"] and vs["gmm_calls"] == 3 * 2
    assert dry["phase"] == "dryrun" and dry["of"] == row["phase"]
    assert dry["ok"] and dry["tally_equal"]
    assert dry["roofline"]["model_flop_share"] > 0

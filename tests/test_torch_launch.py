"""The port's training CLI and cost tooling against the JAX package's, on
the CPU.

``repro_torch.configs`` (``SHAPES``, ``cell_applicable``, ``input_specs``,
``active_param_count``), ``SyntheticLM.batches``, ``roofline.report``,
``roofline.op_costs``, ``launch.train`` and ``launch.dryrun`` are held
against ``repro.configs``, ``repro.data``, ``repro.roofline`` and
``repro.launch.train`` on the same inputs; the kernels' fake-tensor route
and ``cost()`` functions, and the CPU rehearsals of ``chip_smoke.py``'s
``dryrun`` and ``launch train`` phases.  The dry run's fake tensors stand
on the meta device (``dryrun.FAKE_DEVICE``), as on the card's host.

Tolerances:
  * configs, counts, model FLOPs, batches, the report's row: exact;
  * the op counter's FLOPs of a reduced train step against
    ``module_costs`` of the JAX step's compiled HLO: within 10%.  The gap
    is the attention masks' dead pairs: the hand kernels' ``cost()``
    counts the (q, k) pairs the causal and window masks leave (reduced
    gemma2-2b: 8.4% fewer FLOPs, its local layers' window is 16 of 64
    positions), where XLA's attention computes every pair;
  * the training loop's per-step losses and learning rates, from one
    JAX state: 1e-5 relative (f32; the two frameworks sum in different
    orders, ~1e-6 a step); a resumed run's final state within 1e-5.
"""
import dataclasses
import importlib.util
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import cell_applicable as jax_cell_applicable  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.launch.mesh import HardwareSpec as JaxHardwareSpec  # noqa: E402
from repro.roofline import report as jax_report  # noqa: E402
from repro.roofline.hlo_costs import Costs as JaxCosts  # noqa: E402
from repro.roofline.hlo_costs import module_costs  # noqa: E402
from repro.train import TrainHyper as JaxTrainHyper  # noqa: E402
from repro.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    LAYER_KINDS,
    SHAPES,
    cell_applicable,
    get_config,
    input_specs,
    list_configs,
    reduced,
)
from repro_torch.configs import base as cfg_base  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import FAKE_CALLS, LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.mamba import ops as mops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.rglru import ops as rops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import train_state_from_numpy  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.op_costs import Costs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BOTH = sorted(set(jax_list_configs()) & set(list_configs()))

# ------------------------------------------------------------------ configs


def test_shapes_and_layer_kinds_are_the_jax_packages():
    from repro.configs.base import LAYER_KINDS as JAX_KINDS
    assert LAYER_KINDS == JAX_KINDS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    assert len(BOTH) == 10


@pytest.mark.parametrize("arch", BOTH)
def test_config_counts_and_cells_match_jax(arch):
    """param_count, active_param_count, the properties, and at every
    ``SHAPES`` cell the verdict and reason of ``cell_applicable`` and
    ``model_flops``, for the full config and its reduced form."""
    for jcfg, cfg in ((jax_get_config(arch), get_config(arch)),
                      (jax_reduced(jax_get_config(arch)),
                       reduced(get_config(arch)))):
        assert cfg == port_cfg(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        for prop in ("is_attention_free", "is_pure_full_attention",
                     "supports_long_context", "has_decode"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        for name in SHAPES:
            assert cell_applicable(cfg, SHAPES[name]) == \
                jax_cell_applicable(jcfg, JAX_SHAPES[name])
            assert report.model_flops(cfg, SHAPES[name]) == \
                jax_report.model_flops(jcfg, JAX_SHAPES[name])


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-30b-a3b",
                                  "whisper-large-v3", "internvl2-26b"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_input_specs_have_the_jax_shapes_and_dtypes(arch, name):
    got = input_specs(get_config(arch), SHAPES[name], batch_override=3)
    want = jax_input_specs(jax_get_config(arch), JAX_SHAPES[name],
                           batch_override=3)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


# ------------------------------------------------------------------ batches


def test_batches_bit_equal_to_jax_and_producer_stops():
    jcfg = jax_reduced(jax_get_config("gemma2-2b"))
    shape = ShapeSpec("t", "train", 48, 3)
    jdata = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 48, 3), seed=2)
    before = set(threading.enumerate())
    gen = SyntheticLM(port_cfg(jcfg), shape, seed=2,
                      device="cpu").batches(start=5, prefetch=2)
    for step in range(5, 9):
        got, want = next(gen), jdata.batch_at(step)
        assert set(got) == set(want)
        for k, t in got.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[k]))
    producers = [t for t in set(threading.enumerate()) - before
                 if t.name == "SyntheticLM.batches"]
    assert len(producers) == 1 and producers[0].is_alive()
    gen.close()
    assert not producers[0].is_alive()


def test_synthetic_lm_defaults_to_the_card(monkeypatch):
    cfg = reduced(get_config("gemma2-2b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(cfg, ShapeSpec("t", "train", 8, 2))
    assert SyntheticLM(cfg, ShapeSpec("t", "train", 8, 2),
                       device="cpu").device == torch.device("cpu")


# ------------------------------------------------------------ mesh, report


def test_hardware_is_the_h100_data_sheet():
    hw = mesh.HW
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes, hw.ici_bw,
            hw.peak_flops_f32) == (989e12, 3.35e12, 80e9, 450e9, 67e12)
    assert [f.name for f in dataclasses.fields(JaxHardwareSpec)] == \
        [f.name for f in dataclasses.fields(mesh.HardwareSpec)][:5]
    # the meshes are over an initialised process group, never made up
    # without one (fake and gloo groups: tests/test_torch_dist_*.py)
    import torch.distributed as dist
    if not dist.is_initialized():
        for fn in (mesh.make_production_mesh, mesh.make_host_mesh):
            with pytest.raises(RuntimeError, match="init_process_group"):
                fn()


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "train_4k"),
                                        ("qwen3-moe-30b-a3b", "prefill_32k"),
                                        ("falcon-mamba-7b", "decode_32k")])
def test_make_row_matches_jax_field_by_field(arch, shape):
    """The same costs on a v5e ``HardwareSpec`` give the JAX row."""
    v5e = JaxHardwareSpec()
    costs, jcosts = Costs(3.1e15, 2.2e12), JaxCosts(3.1e15, 2.2e12)
    for c in (costs, jcosts):
        c.collectives["all-reduce"]["wire_bytes"] += 4.4e9
        c.collectives["all-reduce"]["count"] += 3
    hw = mesh.HardwareSpec(**dataclasses.asdict(v5e))
    got = report.make_row(get_config(arch), SHAPES[shape], "pod16x16", 256,
                          costs, {"temp": 1.0}, ideal_bytes_total=5e12, hw=hw)
    want = jax_report.make_row(jax_get_config(arch), JAX_SHAPES[shape],
                               "pod16x16", 256, jcosts, {"temp": 1.0},
                               ideal_bytes_total=5e12)
    assert got.to_dict() == want.to_dict()
    assert report.format_table([got]) == jax_report.format_table([want])


# ------------------------------------------------------- cost functions


def _old_flash(B, Sq, Sk, H, KH, D, esz, pairs, seg, bwd=False):
    """``chip_smoke.py``'s inline formulas before the ``cost()``
    functions (flash forward and backward)."""
    q, k = B * Sq * H * D, B * Sk * KH * D
    if bwd:
        flops = 5 * 2 * D * pairs * H
        nbytes = (4 * q + 4 * k) * esz + B * H * Sq * 4
    else:
        flops, nbytes = 4 * D * pairs * H, (2 * q + 2 * k) * esz
    return flops, nbytes + (4 * B * (Sq + Sk) if seg else 0)


@pytest.mark.parametrize("c", [
    dict(B=4, Sq=1024, Sk=1024, H=8, KH=4, D=256, causal=True, window=0,
         q_offset=0),
    dict(B=2, Sq=1024, Sk=1024, H=10, KH=1, D=256, causal=True, window=512,
         q_offset=0),
    dict(B=3, Sq=7, Sk=300, H=4, KH=2, D=64, causal=True, window=0,
         q_offset=293),
    dict(B=1, Sq=64, Sk=96, H=2, KH=2, D=16, causal=False, window=20,
         q_offset=10)])
def test_flash_cost_is_the_masks_pairs(c):
    """``mask_pairs`` counts the plain mask's live pairs, and ``cost`` /
    ``bwd_cost`` equal the formulas the kernel phases used before."""
    qpos = c["q_offset"] + torch.arange(c["Sq"])[:, None]
    kpos = torch.arange(c["Sk"])[None, :]
    m = torch.ones(c["Sq"], c["Sk"], dtype=torch.bool)
    if c["causal"]:
        m &= kpos <= qpos
    if c["window"]:
        m &= qpos - kpos < c["window"]
    pairs = int(m.sum())
    kw = {k: c[k] for k in ("causal", "window", "q_offset")}
    assert fops.mask_pairs(c["Sq"], c["Sk"], **kw) == pairs
    shape = [c[k] for k in ("B", "Sq", "Sk", "H", "KH", "D")]
    for seg in (False, True):
        assert fops.cost(*shape, 2, segments=seg, **kw) == \
            _old_flash(*shape, 2, c["B"] * pairs, seg)
        assert fops.bwd_cost(*shape, 2, segments=seg, **kw) == \
            _old_flash(*shape, 2, c["B"] * pairs, seg, bwd=True)
        assert fops.cost(*shape, 4, segments=seg, live_pairs=7, **kw)[0] == \
            4 * c["D"] * 7 * c["H"]


def test_scan_and_gmm_costs_are_the_old_formulas():
    B, T, C, d, n = 3, 100, 40, 24, 12
    for esz in (2, 4):
        assert rops.cost(B, T, C, esz) == (2 * B * T * C,
                                           3 * B * T * C * esz + 2 * B * C * 4)
        assert rops.bwd_cost(B, T, C, esz) == (
            (3 if esz == 4 else 5) * B * T * C,
            5 * B * T * C * esz + 3 * B * C * 4)
        bc = B * T * n * esz
        assert mops.cost(B, T, d, n, esz, esz) == (
            B * T * d * (7 * n + 3),
            2 * B * T * d * esz + B * T * d * 4 + d * n * 4 + 2 * bc
            + d * 4 + 2 * B * d * n * 4)
        assert mops.bwd_cost(B, T, d, n, esz, esz) == (
            B * T * d * (22 * n + 10),
            2 * B * T * d * esz + 2 * B * T * d * 4 + 4 * bc
            + 4 * (2 * d * n + 2 * d) + 4 * 4 * B * d * n)
    E, C, D, F, rows, live = 8, 80, 64, 48, 300, 6
    assert gops.cost(E, C, D, F, 2, live_rows=rows, live_experts=live) == (
        2 * rows * D * F, (rows * D + live * D * F + E * C * F) * 2 + 4 * E)
    assert gops.bwd_cost(E, C, D, F, 2, live_rows=rows,
                         live_experts=live) == (
        4 * rows * D * F,
        (rows * (D + F) + E * C * D + live * D * F + E * D * F) * 2 + 4 * E)
    # without the data's counts: every capacity row of every expert
    assert gops.cost(E, C, D, F, 2) == gops.cost(E, C, D, F, 2,
                                                 live_rows=E * C,
                                                 live_experts=E)


def test_kernel_bounds_are_perfs_records():
    """The kernels line's cases (and the flash backward's train case)
    bound at the H100's peaks as ``PERF.md`` §6 records them (4 digits;
    selective_scan_bwd's 0.181 was recorded to 3)."""
    cs = _chip_smoke()

    def bound(cost, dtype):
        return round(cs._bound(*cost, dtype)[0], 4)
    g2 = dict(causal=True, window=0, q_offset=0)
    assert bound(fops.cost(4, 1024, 1024, 8, 4, 256, 2, **g2),
                 "bfloat16") == 0.0174
    assert bound(fops.bwd_cost(2, 1024, 1024, 8, 4, 256, 2, segments=True,
                               **g2), "bfloat16") == 0.0217
    assert bound(rops.cost(4, 1024, 2560, 4), "float32") == 0.0376
    assert bound(rops.bwd_cost(2, 1024, 2560, 4), "float32") == 0.0313
    assert bound(mops.cost(4, 1024, 8192, 16, 2, 2), "float32") == 0.0816
    assert round(bound(mops.bwd_cost(4, 1024, 8192, 16, 2, 2), "float32"),
                 3) == 0.181


# ------------------------------------------------------- fake-tensor route


def _fake_inputs(mode, dev):
    with mode:
        z = dict(device=dev)
        return {
            "flash": (torch.empty(2, 64, 4, 64, dtype=torch.bfloat16, **z),
                      torch.empty(2, 64, 2, 64, dtype=torch.bfloat16, **z)),
            "scan": (torch.empty(2, 16, 8, **z), torch.empty(2, 8, **z)),
            "ss": (torch.empty(2, 16, 8, **z), torch.empty(8, 4, **z),
                   torch.empty(2, 16, 4, **z), torch.empty(8, **z),
                   torch.empty(2, 8, 4, **z)),
            "gmm": (torch.empty(4, 32, 64, dtype=torch.bfloat16, **z),
                    torch.empty(4, 64, 48, dtype=torch.bfloat16, **z),
                    torch.empty(4, dtype=torch.int32, **z))}


def test_launchers_take_the_fake_route_before_the_library(monkeypatch):
    """Every ``*_cuda`` launcher on fake tensors: its outputs and
    workspaces, ``FAKE_CALLS`` (with the variant) and its ``cost()`` to an
    active sink, and no ``_library``, ``data_ptr`` or ``torch.cuda``
    call; ``LAUNCHES`` stays.  A CPU tensor still raises."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    def boom(*a, **k):
        raise AssertionError("the fake route reached the library")
    for mod in (fops, rops, mops, gops):
        monkeypatch.setattr(mod, "_library", boom)
    monkeypatch.setattr(FakeTensor, "data_ptr", boom)
    monkeypatch.setattr(torch.cuda, "device", boom)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dev = dryrun.FAKE_DEVICE
    t = _fake_inputs(mode, dev)
    launches = dict(LAUNCHES)
    kernels.reset_fake_calls()
    got = []
    with mode, kernels.cost_sink(lambda *a: got.append(a[:3])):
        q, k = t["flash"]
        o, lse = fops.flash_attention_cuda(q, k, k, return_lse=True)
        dq, dk, dv = fops.flash_attention_bwd_cuda(q, k, k, o, lse, q)
        x, h0 = t["scan"]
        y, h = rops.linear_scan_cuda(x, x, h0)
        grads = rops.linear_scan_bwd_cuda(x, x, h0, y, x, h0)
        xs, A, Bm, D, hs = t["ss"]
        ys, hl, ck = mops.selective_scan_cuda(xs, xs, A, Bm, Bm, D, hs,
                                              checkpoints=True)
        sgrads = mops.selective_scan_bwd_cuda(xs, xs, A, Bm, Bm, D, hs, ck,
                                              xs, hs)
        gx, gw, gs = t["gmm"]
        out = gops.gmm_cuda(gx, gw, gs)
        gdx, gdw = gops.gmm_bwd_cuda(gx, gw, gs, out)
    assert LAUNCHES == launches
    assert (o.shape, lse.shape, dq.shape, dk.shape, dv.shape) == (
        q.shape, (2, 4, 64), q.shape, k.shape, k.shape)
    assert (y.shape, h.shape) == (x.shape, h0.shape)
    assert [g.shape for g in grads] == [x.shape, x.shape, h0.shape]
    assert (ys.shape, hl.shape, ck.shape) == (xs.shape, hs.shape,
                                              (2, 2, 8, 4))
    assert len(sgrads) == 7 and sgrads[3].shape == Bm.shape
    assert out.shape == (4, 32, 48)
    assert (gdx.shape, gdw.shape) == (gx.shape, gw.shape)
    assert {k_: v for k_, v in FAKE_CALLS.items() if v} == {
        "flash_attention": 1, "flash_attention.wgmma": 1,
        "flash_attention_bwd": 1, "flash_attention_bwd.wgmma": 1,
        "linear_scan": 1, "linear_scan_bwd": 1, "selective_scan": 1,
        "selective_scan_bwd": 1, "gmm": 1, "gmm.wgmma": 1, "gmm_bwd": 1,
        "gmm_bwd.dx": 1, "gmm_bwd.dw": 1, "gmm_bwd.wgmma": 1}
    assert got == [
        ("flash_attention", *fops.cost(2, 64, 64, 4, 2, 64, 2, lse=True)),
        ("flash_attention_bwd", *fops.bwd_cost(2, 64, 64, 4, 2, 64, 2)),
        ("linear_scan", *rops.cost(2, 16, 8, 4)),
        ("linear_scan_bwd", *rops.bwd_cost(2, 16, 8, 4)),
        ("selective_scan", *mops.cost(2, 16, 8, 4, 4, 4, checkpoints=True)),
        ("selective_scan_bwd", *mops.bwd_cost(2, 16, 8, 4, 4, 4)),
        ("gmm", *gops.cost(4, 32, 64, 48, 2)),
        ("gmm_bwd", *gops.bwd_cost(4, 32, 64, 48, 2))]
    kernels.reset_fake_calls()
    cpu = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        rops.linear_scan_cuda(cpu, cpu, torch.zeros(2, 8))


def test_fake_calls_and_sinks_lose_nothing_across_threads():
    """``count_fake`` from 8 threads at once, with a sink taking every
    call's cost: no count or cost is lost."""
    got = []
    n, per = 8, 1000
    kernels.reset_fake_calls()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with kernels.cost_sink(lambda name, f, b, launch: got.append(f)):
            threads = [threading.Thread(target=lambda: [
                kernels.count_fake((1.0, 2.0), "gmm", "gmm.wgmma")
                for _ in range(per)]) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        calls = dict(FAKE_CALLS)
        kernels.reset_fake_calls()
    assert not any(t.is_alive() for t in threads)
    assert calls["gmm"] == calls["gmm.wgmma"] == n * per
    assert len(got) == n * per and sum(got) == n * per
    assert not kernels._COST_SINKS


def test_flash_backward_host_allocations():
    """The C launcher's plan and scratch bytes: one plan a shape, chunked
    dK/dV partials only where one kv head's items outlast the blocks'
    mean (recurrentgemma's KH = 1), segment-id ranges with segments."""
    g2 = fops.bwd_host_alloc_bytes(2, 1024, 1024, 8, 4, 256)
    assert g2["nchunk"] == 1 and g2["scratch"] == 0
    items = 2 * 4 * (16 + 32)          # kv tiles of 64, folded q tiles of 32
    assert g2["plan"] == 4 * (132 + 1 + items)
    rg = fops.bwd_host_alloc_bytes(2, 1024, 1024, 10, 1, 256, window=2048,
                                   segments=True)
    assert rg["nchunk"] > 1
    nq = -(-1024 // (64 // 10))
    assert rg["scratch"] == (2 * rg["nchunk"] * 2 * 1024 * 256 * 4
                             + 8 * 2 * (nq + 16))


# ------------------------------------------------------------ op counter


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-30b-a3b"])
def test_op_counter_flops_near_jax_hlo(arch):
    """The dry run's FLOPs of a reduced train step (4 x 64) within 10% of
    ``module_costs`` of the JAX step's compiled HLO (see the module
    docstring for the gap)."""
    jcfg = jax_reduced(jax_get_config(arch))
    jstate = jax_make_train_state(jcfg, jax.random.PRNGKey(0))
    jbatch = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 64,
                                               4)).batch_at(0)
    step = jax_build_train_step(jcfg, None, JaxTrainHyper(warmup=2,
                                                          total_steps=1000))
    hlo = jax.jit(step).lower(jstate, jbatch).compile().as_text()
    want = module_costs(hlo).flops
    got = dryrun.reckon(port_cfg(jcfg), ShapeSpec("t", "train", 64, 4))
    flops = got["roofline"]["flops_per_dev"]
    assert want > 1e8
    assert abs(flops / want - 1) <= 0.10, (flops, want)
    assert flops <= want      # the masks' dead pairs are the gap


# ------------------------------------------------------------ dry run


def _hand(cs, **per):
    return cs._launches(**per)


@pytest.mark.parametrize("cell", [
    "gemma2-2b 4x1024 mb2", "qwen3-moe-30b-a3b-L4 4x1024 mb4",
    "4 fused gemma2-2b-L2", "reduced recurrentgemma-2b",
    "reduced falcon-mamba-7b", "whisper-large-v3 4x1024 mb1",
    "reduced whisper-large-v3", "reduced internvl2-26b"])
def test_dryrun_cells_on_the_cpu(cell):
    """The dry run completes here (no nvcc, no card) in under 60 s,
    launches nothing, and its kernel-call tally equals chip_smoke.py's
    hand counts for the phase."""
    cs = _chip_smoke()
    t0 = time.perf_counter()
    launches = dict(LAUNCHES)
    if cell.startswith("gemma2-2b"):
        r = dryrun.reckon(get_config("gemma2-2b"),
                          ShapeSpec("t", "train", 1024, 4), microbatches=2)
        want = _hand(cs, flash=(26, 2))
        assert 55e9 < r["peak_bytes"] < 70e9 and r["fits"]
    elif cell.startswith("qwen3"):
        r = cs._reckon("qwen3-moe-30b-a3b-L4", 4, 1024, microbatches=4)
        want = _hand(cs, flash=(4, 4), moe=(4, 4))
    elif cell.startswith("whisper"):
        # 32 encoder, 32 decoder self- and 32 cross-attention calls
        r = cs._reckon("whisper-large-v3", 4, 1024)
        want = _hand(cs, flash=(96, 1))
        assert 20e9 < r["peak_bytes"] < 76e9 and r["fits"]
    elif cell.startswith("4 fused"):
        F = cs.FUSED
        r = cs._reckon(F["arch"], F["batch"], F["seq"], members=F["members"],
                       steps=F["steps"])
        want = _hand(cs, flash=(F["layers"], F["steps"]))
    else:
        arch = cell.split()[1]
        cfg = reduced(get_config(arch)).replace(remat="full")
        r = dryrun.reckon(cfg, ShapeSpec("t", "train", 64, 4),
                          microbatches=2)
        kind = {"r": "rec", "f": "mamba"}.get(arch[0])
        n = sum(k == kind for k in cfg.layer_kinds)
        want = _hand(cs, **{kind: (n, 2)}) if kind else {}
        att = sum(k in ("global", "local") for k in cfg.layer_kinds)
        att *= 2 if cfg.encoder_layers else 1     # and cross-attention
        att += cfg.encoder_layers
        if att:
            want.update(_hand(cs, flash=(att, 2)))
        for k in list(want):     # f32 reduced configs: the f32 variants
            if k.endswith(".wgmma"):
                want[k.replace(".wgmma", ".f32")] = want.pop(k)
    assert LAUNCHES == launches
    assert r["kernel_calls"] == want
    assert r["state_bytes"] >= 2 * r["param_bytes"]   # params, m and v
    assert time.perf_counter() - t0 < 60


def test_dryrun_peak_is_the_trackers_to_the_byte():
    """The tracker's peak of a scripted allocation sequence on fake device
    tensors, to the byte (512-byte blocks), and the dry run's peak of a
    reduced step equals the tracker's reading of the same step built and
    run by hand."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = dryrun.FAKE_DEVICE
    with FakeTensorMode(), dryrun.MemoryTracker(dev.type) as mem:
        a = torch.empty(1000, device=dev)                 # 4000 -> 4096
        b = torch.empty(10, dtype=torch.bfloat16, device=dev)   # -> 512
        v = a[10:]                                         # a view: 0
        assert mem.live == 4608
        del a
        assert mem.live == 4608                            # v holds it
        del v
        c = torch.ones(3000, device=dev) * 2               # 2 x 12288
        assert mem.peak == 512 + 2 * 12288 and mem.live == 512 + 12288
        del b, c
    assert mem.live == 0

    cfg = reduced(get_config("gemma2-2b"))
    shape = ShapeSpec("t", "train", 32, 2)
    got = dryrun.reckon(cfg, shape)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import TrainHyper, build_train_step
    with FakeTensorMode(allow_non_fake_inputs=True), \
            torch.autograd.set_multithreading_enabled(False), \
            dryrun.MemoryTracker(dev.type) as mem:
        params = dryrun._params(cfg, dev)
        state = {"params": params, "opt": adamw_init(params, "float32"),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = dryrun._batch(cfg, shape, dev)
        build_train_step(cfg, TrainHyper(warmup=2, total_steps=1000))(
            state, batch)
    assert got["peak_bytes"] == mem.peak


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k", "long_500k"])
def test_dryrun_cli_reports_pod_cells(name, tmp_path, monkeypatch, capsys):
    """Serving cells of ``SHAPES`` at pod scale on one device: reported
    with their bytes and ``fits`` (never skipped for size); long_500k on
    a pure full-attention arch is skipped with the JAX package's
    reason."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    arch = "falcon-mamba-7b" if name == "long_500k" else "gemma2-2b"
    assert dryrun.main(["--arch", arch, "--shape", name]) == 0
    assert "[ok]" in capsys.readouterr().out
    import json
    res = json.loads((tmp_path / f"{arch}_{name}_h100.json").read_text())
    assert res["status"] == "ok" and isinstance(res["fits"], bool)
    assert res["param_bytes"] == pytest.approx(
        2 * get_config(arch).param_count(), rel=1e-2)
    if name != "prefill_32k":
        assert res["cache_bytes"] > 0
    if name == "long_500k":
        assert dryrun.main(["--arch", "minicpm-2b", "--shape", name]) == 0
        res = json.loads((tmp_path / f"minicpm-2b_{name}_h100.json")
                         .read_text())
        assert res["status"] == "skipped"
        assert res["reason"] == jax_cell_applicable(
            jax_get_config("minicpm-2b"), JAX_SHAPES[name])[1]


# ------------------------------------------------------ training loop


def _jax_loop(jcfg, jstate, steps, hyper, B, S, start=0):
    """``repro.launch.train``'s loop: (losses, lrs, state)."""
    step = jax.jit(jax_build_train_step(jcfg, None, hyper))
    data = JaxSyntheticLM(jcfg, JaxShapeSpec("cli", "train", S, B), seed=0)
    losses, lrs = [], []
    for i in range(start, steps):
        jstate, m = step(jstate, data.batch_at(i))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    return losses, lrs, jstate


@pytest.mark.parametrize("arch", ["gemma2-2b", "minicpm-2b",
                                  "whisper-large-v3"])
def test_train_loop_matches_jax_loop(arch, capsys):
    """``launch.train``'s loop from a JAX train state (carried across by
    ``train_state_from_numpy``) against ``repro.launch.train``'s loop:
    per-step losses and learning rates; the config module's schedule in
    both (minicpm-2b: wsd) and the warmup rule."""
    import importlib
    steps, B, S = 6, 2, 32
    jcfg = jax_reduced(jax_get_config(arch))
    sched = getattr(importlib.import_module(
        f"repro.configs.{arch.replace('-', '_')}"), "SCHEDULE", "cosine")
    assert launch_train.arch_schedule(arch) == sched
    assert (sched == "wsd") == (arch == "minicpm-2b")
    jstate = jax_make_train_state(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    jhyper = JaxTrainHyper(base_lr=3e-4, warmup=min(100, steps // 10 + 1),
                           total_steps=steps, schedule=sched)
    want_loss, want_lr, _ = _jax_loop(jcfg, jstate, steps, jhyper, B, S)
    hyper = launch_train.make_hyper(steps, 3e-4, sched)
    assert dataclasses.asdict(hyper) == dataclasses.asdict(jhyper)
    cfg = port_cfg(jcfg)
    got = launch_train.train_loop(
        cfg, ShapeSpec("cli", "train", S, B),
        train_state_from_numpy(flat, cfg), steps=steps, hyper=hyper,
        device="cpu")
    assert [h["step"] for h in got] == list(range(steps))
    np.testing.assert_allclose([h["loss"] for h in got], want_loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([h["lr"] for h in got], want_lr,
                               rtol=LOSS_RTOL)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ") and \
        out[-1].startswith(f"{steps} steps in ")


def test_resume_replays_a_step_in_both_packages(tmp_path, monkeypatch,
                                                capsys):
    """ROADMAP C12: the reference saves the state after step i under label
    i.  A run stopped after its label-4 save (the final label-5 one
    removed) resumes at 4 in both packages from the same files: batch 4
    is trained again, and the final checkpoint (label 5) holds step 6,
    one optimizer step past --steps; the two final states agree."""
    import shutil

    from repro.launch import train as jax_train
    from repro_torch.checkpoint import Checkpointer
    argv = ["--arch", "gemma2-2b", "--reduced", "--steps", "5", "--batch",
            "2", "--seq", "32", "--ckpt-every", "2"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(jdir)])
    jax_train.main()
    ck = Checkpointer(str(jdir))
    assert ck.all_steps() == [2, 4, 5]
    for label, want_step in ((2, 3), (4, 5), (5, 5)):
        flat, _ = ck.restore(None, label, device="cpu")
        assert int(flat["step"]) == want_step
    shutil.rmtree(jdir / "step_0000000005")       # stopped before the end
    shutil.copytree(jdir, pdir)
    capsys.readouterr()
    # the resumed runs save only at their end: at --ckpt-every 2 the
    # reference would save its restored label again, which its writer
    # cannot publish over the existing directory (C12)
    argv[-1] = "100"
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(jdir)])
    jax_train.main()                              # resumes from jdir
    jax_out = capsys.readouterr().out
    hist = launch_train.main([*argv, "--ckpt-dir", str(pdir), "--device",
                              "cpu"])
    port_out = capsys.readouterr().out
    for out in (jax_out, port_out):
        assert out.splitlines()[0] == "restored step 4"
        assert "step     4 loss" in out and "1 steps in" in out
    assert [h["step"] for h in hist] == [4]
    jflat, _ = Checkpointer(str(jdir)).restore(None, 5, device="cpu")
    pflat, _ = Checkpointer(str(pdir)).restore(None, 5, device="cpu")
    assert int(jflat["step"]) == int(pflat["step"]) == 6
    assert set(jflat) == set(pflat)
    for k in jflat:
        np.testing.assert_allclose(pflat[k].float().numpy(),
                                   jflat[k].float().numpy(), atol=1e-5,
                                   err_msg=k)


def test_train_cli_refuses_meshes():
    """``--mesh prod`` builds the production mesh over the default process
    group and refuses to run without one (a mesh the group cannot hold:
    ``test_production_meshes_need_their_world``; the loop on gloo meshes:
    ``tests/test_torch_dist_gloo.py``)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    for flag in (["--mesh", "prod"], ["--mesh", "prod", "--multi-pod"]):
        with pytest.raises(RuntimeError, match="init_process_group"):
            launch_train.main(["--arch", "gemma2-2b", "--device", "cpu",
                               *flag])


def test_production_meshes_need_their_world():
    """In a process group of one rank the production meshes raise, naming
    the world each needs, and ``make_host_mesh`` builds only the shapes
    the group holds: a mesh is never shrunk."""
    code = (
        "import torch.distributed as dist, tempfile, os\n"
        "from repro_torch.launch import mesh\n"
        "f = os.path.join(tempfile.mkdtemp(), 's')\n"
        "dist.init_process_group('gloo', store=dist.FileStore(f, 1), "
        "rank=0, world_size=1)\n"
        "for mp, n in ((False, 256), (True, 512)):\n"
        "    try:\n"
        "        mesh.make_production_mesh(multi_pod=mp)\n"
        "    except ValueError as e:\n"
        "        assert f'world of {n} ranks' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error')\n"
        "m = mesh.make_host_mesh((1, 1))\n"
        "assert tuple(m.mesh_dim_names) == ('data', 'model')\n"
        "assert m.device_type == 'cpu' and m.size() == 1\n"
        "try:\n"
        "    mesh.make_host_mesh((2, 1))\n"
        "except ValueError as e:\n"
        "    assert 'world of 2 ranks' in str(e)\n"
        "else:\n"
        "    raise AssertionError('no error')\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT / "src")
    import subprocess
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "ok", proc.stdout + proc.stderr


# ------------------------------------------- chip_smoke.py rehearsals


class _InProcess:
    """The dryrun phase's reckonings computed here, in this process."""

    def __init__(self, cs):
        self.cells = cs._reckon_cells()
        self.cs = cs

    def get(self, key):
        return self.cs._reckon(**self.cells[key])


def _count_refs(monkeypatch):
    """The plain attention versions count as the flash kernels' launches
    (variant by head dim), as on the card."""
    from repro_torch.kernels import count_launch

    def counted(fn, name):
        def run(q, *a, **kw):
            count_launch(name, f"{name}.{fops.variant(q.dtype, q.shape[-1])}")
            return fn(q, *a, **kw)
        return run
    for attr, name in (("attention_fwd_ref", "flash_attention"),
                       ("attention_ref", "flash_attention"),
                       ("attention_bwd_ref", "flash_attention_bwd")):
        monkeypatch.setattr(fops, attr, counted(getattr(fops, attr), name))


def test_chip_smoke_launch_train_phase_rehearsal(monkeypatch, capsys):
    """``chip_smoke.py``'s ``launch train`` phase on the CPU: a reduced
    gemma2-2b (bf16, head_dim 64, remat, 2 layers) registered under the
    phase's arch, 64 tokens: ``launch.train.main`` runs its steps, every
    step launches the hand count of flash calls (wgmma), and the dryrun
    row holds the reckoning's tally against them and prints the roofline
    and the model-FLOP share."""
    cs = _chip_smoke()
    cfg = reduced(get_config("gemma2-2b")).replace(
        name="gemma2-2b", remat="full", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, "gemma2-2b", cfg)
    monkeypatch.setitem(cs.LAUNCH_TRAIN, "seq", 64)
    _count_refs(monkeypatch)
    reck = _InProcess(cs)
    peak = reck.get("launch train 4")["peak_bytes"]
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: peak)
    monkeypatch.setattr(cs, "_card", lambda: "rehearsal card, 700.00 W")
    got = cs.phase_launch_train(torch.device("cpu"), reck)
    steps = cs.LAUNCH_TRAIN["steps"]
    per = cs._launches(flash=(cfg.num_layers, 1))
    assert got == {k: v * steps for k, v in per.items()}
    rows = [__import__("json").loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]
    row, dry = rows[-2], rows[-1]
    assert row["phase"] == "launch train" and row["ok"]
    assert row["batch"] == 4 and row["batch_fallback_reason"] is None
    assert dry["phase"] == "dryrun" and dry["ok"] and dry["tally_equal"]
    assert dry["roofline"]["card"] == "rehearsal card, 700.00 W"
    assert dry["roofline"]["model_flop_share"] > 0


def test_chip_smoke_dryrun_phase_rejects_a_wrong_tally_or_peak(capsys):
    cs = _chip_smoke()
    r = cs._reckon("gemma2-2b-L1", 1, 64, microbatches=1)
    hand = cs._launches(flash=(1, 1))
    peak = r["peak_bytes"] / 1e9
    row = cs.phase_dryrun("t", r, peak * 1.04, [hand, hand], hand)
    assert row["ok"] and row["host_alloc_bytes"]["total"] > 0
    with pytest.raises(AssertionError, match="dryrun of t"):
        cs.phase_dryrun("t", r, peak * 1.06, [hand], hand)
    short = dict(hand, flash_attention_bwd=0)
    with pytest.raises(AssertionError, match="dryrun of t"):
        cs.phase_dryrun("t", r, peak, [hand, short], hand)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") is None

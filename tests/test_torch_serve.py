"""The port's serving path against the JAX package's, on the CPU.

Both ``BatchedServer``s get the same params (JAX ``init_params`` through
``params_from_numpy``) and the same numpy prompts; their greedy tokens must
be identical, in the wave loop (reduced gemma2-2b and recurrentgemma-2b,
sliding-window layers) and in the continuous loop (``serve-tiny``, reduced
falcon-mamba-7b, qwen3-moe-30b-a3b, whisper-large-v3 and internvl2-26b,
unequal ``max_new_tokens``).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.plugins.serve import _serve_cfg  # noqa: E402
from repro.serve import BatchedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.kernel_plugin import Kernel, kernel_names  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm_ref  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.serve.engine import _merge_rows  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _serve_both(jcfg, *, batch, S0, new):
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in _flatten(jparams).items()}, cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, S0) for _ in new]
    max_len = S0 + max(new) + 1

    jsrv = JaxServer(jcfg, jparams, batch=batch, prompt_len=S0,
                     max_len=max_len)
    jsrv.submit([JaxRequest(rid=i, prompt=p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, new))])
    want = {r.rid: r.out_tokens for r in jsrv.run()}

    srv = BatchedServer(cfg, params, batch=batch, prompt_len=S0,
                        max_len=max_len, device="cpu")
    srv.submit([Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new))])
    got = {r.rid: r.out_tokens for r in srv.run()}
    return srv, jsrv, got, want


def test_wave_loop_tokens_match_jax():
    srv, jsrv, got, want = _serve_both(
        jax_reduced(jax_get_config("gemma2-2b")), batch=2, S0=20,
        new=[4, 6, 3])
    assert not srv.continuous and not jsrv.continuous
    assert got == want
    assert srv.stats == jsrv.stats


def test_continuous_loop_tokens_match_jax():
    jcfg = _serve_cfg(None)
    assert get_config("serve-tiny") == port_cfg(jcfg)
    srv, jsrv, got, want = _serve_both(jcfg, batch=2, S0=6,
                                       new=[3, 5, 2, 4, 3])
    assert srv.continuous and jsrv.continuous
    assert got == want
    assert srv.stats == jsrv.stats
    assert [len(got[i]) for i in range(5)] == [3, 5, 2, 4, 3]


def test_wave_loop_tokens_match_jax_recurrentgemma():
    """RG-LRU layers and the local-attention ring cache in the wave loop."""
    srv, jsrv, got, want = _serve_both(
        jax_reduced(jax_get_config("recurrentgemma-2b")), batch=2, S0=20,
        new=[4, 6, 3])
    assert not srv.continuous and not jsrv.continuous
    assert got == want
    assert srv.stats == jsrv.stats


def test_continuous_loop_tokens_match_jax_falcon_mamba():
    """Mamba rows join mid-wave: their ``h`` and ``conv`` states are merged
    row-wise into the live cache."""
    srv, jsrv, got, want = _serve_both(
        jax_reduced(jax_get_config("falcon-mamba-7b")), batch=2, S0=6,
        new=[3, 5, 2, 4, 3])
    assert srv.continuous and jsrv.continuous
    assert got == want
    assert srv.stats == jsrv.stats
    assert srv.stats["prefills"] > 2          # admissions into a live wave
    assert [len(got[i]) for i in range(5)] == [3, 5, 2, 4, 3]


def test_continuous_loop_tokens_match_jax_qwen3_moe():
    """MoE layers in prefill and decode; a joiner's zero rows still route
    tokens and compete for capacity, as in the JAX server."""
    srv, jsrv, got, want = _serve_both(
        jax_reduced(jax_get_config("qwen3-moe-30b-a3b")), batch=2, S0=6,
        new=[3, 5, 2, 4, 3])
    assert srv.continuous and jsrv.continuous
    assert got == want
    assert srv.stats == jsrv.stats
    assert [len(got[i]) for i in range(5)] == [3, 5, 2, 4, 3]


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-26b"])
def test_continuous_loop_tokens_match_jax_stub_archs(arch):
    """The server prefills tokens alone, as the JAX server does: whisper
    decodes without its encoder (no cross k, v in the cache, so merged
    rows carry k, v only) and internvl serves text."""
    srv, jsrv, got, want = _serve_both(
        jax_reduced(jax_get_config(arch)), batch=2, S0=6,
        new=[3, 5, 2, 4, 3])
    assert srv.continuous and jsrv.continuous
    assert got == want
    assert srv.stats == jsrv.stats
    assert srv.stats["prefills"] > 2
    assert [len(got[i]) for i in range(5)] == [3, 5, 2, 4, 3]


@pytest.mark.parametrize("impl", [None, "ref"])
def test_server_impl_reaches_every_gmm_call(monkeypatch, impl):
    """``BatchedServer(impl=...)`` hands ``impl`` to the grouped matmuls of
    decode steps as well as of prefills: three calls per MoE layer each."""
    from repro_torch.models import layers
    seen = []

    def counting_gmm(x, w, group_sizes, *, impl=None):
        seen.append(impl)
        return gmm_ref(x, w, group_sizes)

    monkeypatch.setattr(layers, "gmm", counting_gmm)
    cfg = port_cfg(jax_reduced(jax_get_config("qwen3-moe-30b-a3b")))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    srv = BatchedServer(cfg, params, batch=2, prompt_len=4, max_len=9,
                        device="cpu", impl=impl)
    rng = np.random.default_rng(0)
    srv.submit([Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 4),
                        max_new_tokens=n) for i, n in enumerate([2, 4, 3])])
    srv.run()
    steps = srv.stats["prefills"] + srv.stats["decode_steps"]
    assert srv.stats["decode_steps"] > 0
    assert len(seen) == 3 * cfg.num_layers * steps
    assert set(seen) == {impl}


def test_merge_rows_carries_recurrent_states():
    old = [{"h": torch.zeros(3, 4, 2), "conv": torch.zeros(3, 3, 4)}]
    new = [{"h": torch.ones(3, 4, 2), "conv": torch.ones(3, 3, 4)}]
    out = _merge_rows(old, new, torch.tensor([False, True, False]))
    for key in ("h", "conv"):
        assert out[0][key][1].eq(1).all()
        assert out[0][key][[0, 2]].eq(0).all()


def test_submit_guard_and_clock():
    cfg = get_config("serve-tiny")
    tick = iter(range(100))
    srv = BatchedServer(cfg, None, batch=2, prompt_len=4, max_len=8,
                        device="cpu", clock=lambda: float(next(tick)))
    with pytest.raises(ValueError):
        srv.submit([Request(rid=9, prompt=np.zeros(4, int),
                            max_new_tokens=99)])
    ok = Request(rid=1, prompt=np.zeros(4, int), max_new_tokens=2)
    assert ok.sla == "throughput"       # the reference's default class
    lat = Request(rid=2, prompt=np.zeros(4, int), max_new_tokens=2,
                  sla="latency")
    srv.submit([ok, lat])
    assert ok.submitted_at == 0.0 and lat.submitted_at == 1.0
    assert [r.sla for r in srv.queue] == ["throughput", "latency"]


def test_lm_decode_task_serves_on_cpu():
    assert "lm.decode" in kernel_names()
    k = Kernel("lm.decode")
    k.arguments = {"arch": "reduced:gemma2-2b", "device": "cpu",
                   "requests": 3, "batch": 2, "new_tokens": 3}
    out = k.execute()
    assert out["served"] == 3
    assert all(len(t) == 3 for t in out["tokens"].values())
    assert out["stats"]["prefills"] == 2          # two waves of batch 2
    assert k.timings["exec"] > 0


def test_lm_decode_task_serves_falcon_mamba_on_cpu():
    k = Kernel("lm.decode")
    k.arguments = {"arch": "reduced:falcon-mamba-7b", "device": "cpu",
                   "requests": 3, "batch": 2, "new_tokens": 3}
    out = k.execute()
    assert out["served"] == 3
    assert all(len(t) == 3 for t in out["tokens"].values())
    assert out["stats"]["prefills"] == 2      # continuous loop: 2 admissions


def test_lm_decode_task_serves_qwen3_moe_on_cpu():
    k = Kernel("lm.decode")
    k.arguments = {"arch": "reduced:qwen3-moe-30b-a3b", "device": "cpu",
                   "requests": 3, "batch": 2, "new_tokens": 3}
    out = k.execute()
    assert out["served"] == 3
    assert all(len(t) == 3 for t in out["tokens"].values())
    assert out["stats"]["prefills"] == 2      # continuous loop: 2 admissions


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        BatchedServer(get_config("serve-tiny"), None, batch=1, prompt_len=2,
                      max_len=4)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    banned = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                        r"import repro\s*$|from repro\.|from repro import)",
                        re.M)
    for f in files:
        hits = banned.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


# ------------------------------------------------ chip_smoke rehearsal

SERVE_ARCHS = ["gemma2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
               "qwen3-moe-30b-a3b", "gemma3-4b", "minicpm-2b",
               "nemotron-4-15b", "whisper-large-v3", "internvl2-26b"]
# the rehearsal's limit on the relative distance of the final hidden states:
# plain against plain is exactly 0 on the CPU, and the weakest control at
# these widths (recurrentgemma-2b's linear_scan) reads ~4e-4
CPU_H_LIMIT = 1e-4
_MIXER_KIND = {"flash_attention": ("global", "local"), "gmm": ("global",
                                                               "local"),
               "linear_scan": ("rec",), "selective_scan": ("mamba",)}


def _per_layer(counts, full, cfg):
    """A SERVE entry's launches per call for ``full``, rescaled to
    ``cfg``'s layers of each wrapper's kind."""
    def layers(c, name):
        kinds = _MIXER_KIND[name.split(".")[0]]
        return sum(c.layer_kind(i) in kinds for i in range(c.num_layers))
    return {k: v * layers(cfg, k) // layers(full, k)
            for k, v in counts.items()}


def _flash_calls(c):
    """Flash calls of a prefill with the stub inputs: each attention layer's
    (and its cross-attention's), and each encoder layer's."""
    attn = sum(k in ("global", "local") for k in c.layer_kinds)
    return attn * (2 if c.encoder_layers else 1) + c.encoder_layers


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_chip_smoke_serve_phase_rehearsal(arch, monkeypatch):
    """``chip_smoke.py``'s ``serve <arch>`` phase on the CPU at reduced
    widths (bf16 compute, head_dim 64 so that the counted variants are the
    card's) and 64-token prompts: the wrappers the model calls are counted
    as kernel launches (not under ``impl="ref"``).  The CPU's "kernels" are
    the plain versions, so the sound reading is exactly 0, and the limit is
    ``CPU_H_LIMIT`` (the card's, ``PREFILL_H_LIMIT``, sit above the card's
    bf16 differences, which the CPU does not have; at these widths a
    mixer's share of the residual stream is small).  The phase's own checks
    pass, and each off-by-one control (``LOGIT_CONTROL``: linear_scan's
    too) reads above the limit, after the first block too where the phase
    reads there (``PREFILL_H1``)."""
    import importlib.util

    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import reduced
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gmm import ops as gops
    from repro_torch.models import layers, transformer

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    full = get_config(arch)
    cfg = reduced(full).replace(name=arch, dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
    variants = {
        "flash_attention": lambda q, *_: fops.variant(q.dtype, q.shape[-1]),
        "gmm": lambda x, w, *_: gops.variant(x.dtype, x.shape[0], x.shape[1],
                                             x.shape[2], w.shape[2])}

    def counted(fn, name):
        def run(*a, impl=None, **kw):
            if impl is None:
                var = variants.get(name)
                count_launch(name, *([f"{name}.{var(*a)}"] if var else []))
            return fn(*a, impl=impl, **kw)
        return run
    for mod in (layers, transformer):
        for name in _MIXER_KIND:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, counted(getattr(mod, name),
                                                       name))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters, warmup=1: (fn(), 0.0)[1])
    monkeypatch.setitem(chip_smoke.SERVE_SHAPE, "prompt", 64)
    monkeypatch.setitem(chip_smoke.PREFILL_H_LIMIT, arch, CPU_H_LIMIT)
    if arch in chip_smoke.PREFILL_H1:
        monkeypatch.setitem(chip_smoke.PREFILL_H1, arch,
                            (chip_smoke.PREFILL_H1[arch][0], CPU_H_LIMIT))
    if arch in chip_smoke.PREFILL_ATTN1:
        monkeypatch.setitem(chip_smoke.PREFILL_ATTN1, arch, CPU_H_LIMIT)
    if arch in chip_smoke.STUB_PREFILL:
        monkeypatch.setitem(chip_smoke.STUB_PREFILL, arch, {
            k: v * _flash_calls(cfg) // _flash_calls(full)
            for k, v in chip_smoke.STUB_PREFILL[arch].items()})
    _, loop, per_prefill, per_decode = next(
        e for e in chip_smoke.SERVE if e[0] == arch)
    row = chip_smoke.phase_serve(torch.device("cpu"), arch, loop,
                                 _per_layer(per_prefill, full, cfg),
                                 _per_layer(per_decode, full, cfg))
    limit = CPU_H_LIMIT
    assert row["prefill_h_rel_frobenius"] == 0.0
    assert set(row["controls"]) == set(chip_smoke._controls(cfg,
                                                            per_prefill))
    assert all(c["h_rel_frobenius"] > limit
               for c in row["controls"].values()), row["controls"]
    assert bool(row["stub_inputs"]) == (arch in chip_smoke.STUB_PREFILL)
    assert row["checked_prefill_launches"] == \
        row["checked_prefill_launches_expected"]
    first = row["first_block"]
    assert bool(first) == (arch in chip_smoke.PREFILL_H1)
    if first:   # the first block's own reading and its control
        assert first["h_rel_frobenius"] == 0.0
        assert all(c > limit for c in first["controls"].values()), first
    subs = row["first_attention_sublayers"]
    assert bool(subs) == (arch in chip_smoke.PREFILL_ATTN1)
    for sub in subs.values():   # whisper's first attention sublayers
        assert sub["h_rel_frobenius"] == 0.0
        assert all(c > limit for c in sub["controls"].values()), subs

"""The port's long-context serving cells against the JAX package, on the CPU.

The reference's serving cells (``configs.SHAPES``: prefill_32k, decode_32k,
long_500k) at reduced widths: the long_500k cell as the dry run builds it
(a 16-token prompt's cache of 524,288 positions, then decode at its end),
a prefill far past the reduced sliding windows (16) through both packages'
forward and servers, the query-chunked plain attention against its
unchunked form, and CPU rehearsals of ``chip_smoke.py``'s ``long`` phases
and of their reckonings.  Parameters come from the JAX ``init_params``
through ``params_from_numpy``, token ids from numpy; f32 is compared with
f32 at 1e-4 absolute (``tests/test_torch_models.py``'s tolerance: the two
frameworks' CPU matmuls sum in other orders over a few layers).
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import BatchedServer as JaxServer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import build_prefill_step as jax_prefill_step  # noqa: E402
from repro.serve import build_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import SHAPES, get_config, reduced  # noqa: E402
from repro_torch.configs import cell_applicable, list_configs  # noqa: E402
from repro_torch.configs import resolve_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    layers_from_numpy,
    params_from_numpy,
)
from repro_torch.serve import (  # noqa: E402
    BatchedServer,
    Request,
    build_prefill_step,
    build_serve_step,
)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


LONG_ARCHS = ["gemma2-2b", "gemma3-4b", "recurrentgemma-2b",
              "falcon-mamba-7b"]
PREFILL_ARCHS = LONG_ARCHS + ["qwen3-moe-30b-a3b"]


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _setup(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in _flatten(jparams).items()}, cfg)
    return jcfg, jparams, cfg, params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _assert_caches_equal(got, jcache, cfg):
    """Every leaf of the port's cache (a list of per-layer dicts) against
    the JAX cache: the attention k, v (global: every position; local: the
    ring and its ``pos``) and the recurrent ``h`` and ``conv`` states."""
    want = layers_from_numpy({k: np.asarray(v) for k, v in
                              _flatten(jcache).items()}, cfg)
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
            if key == "pos":
                assert torch.equal(g[key], w[key])
            else:
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                           atol=ATOL)


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_long_500k_decode_matches_jax(arch):
    """long_500k as ``launch.dryrun`` builds it: a PROMPT-token prompt
    prefilled into a cache of 524,288 positions, then 8 decode steps at
    positions 524,280 to 524,287 (RoPE in f32 past 2^19, the ring mask's
    arithmetic there), through the JAX package's build_prefill_step /
    build_serve_step, jitted as its server runs them, and the port's: the
    logits of every step within 1e-4, then every cache leaf, the ring
    ``pos`` exactly.  (Past 2^19 an ulp of RoPE's f32 inverse frequency
    moves an angle by up to 0.03 rad: the port rounds it as XLA's
    compiled step does, ``layers.apply_rope``.)"""
    from repro_torch.launch.dryrun import PROMPT
    jcfg, jparams, cfg, params = _setup(arch)
    S = SHAPES["long_500k"].seq_len
    assert S == 524_288
    steps = 8
    tok = _tokens(cfg, 1, PROMPT + steps)
    jout = jax.jit(jax_prefill_step(jcfg, cache_len=S))(
        jparams, {"tokens": jnp.asarray(tok[:, :PROMPT])})
    with torch.inference_mode():
        out = build_prefill_step(cfg, cache_len=S)(
            params, {"tokens": torch.from_numpy(tok[:, :PROMPT]).long()})
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(jout["logits"]), atol=ATOL)
    jcache, cache = jout["cache"], out["cache"]
    del jout, out
    jstep, step = jax.jit(jax_serve_step(jcfg)), build_serve_step(cfg)
    for t in range(steps):
        pos = np.full((1,), S - steps + t, np.int32)
        x = tok[:, PROMPT + t:PROMPT + t + 1]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(x),
                                jnp.asarray(pos))
        with torch.inference_mode():
            logits, cache = step(params, cache, torch.from_numpy(x).long(),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
    _assert_caches_equal(cache, jcache, cfg)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_long_prefill_past_the_window_matches_jax(arch):
    """A 512-token prefill, far past the reduced sliding windows (16):
    every position's hidden states and every cache leaf (the local layers'
    ring filled from the prompt's last 16 positions) against the JAX
    package's within 1e-4; then both packages' BatchedServers on 512-token
    prompts (the wave loop for the windowed archs, the continuous loop with
    rows merged into a live cache for the others) give the same greedy
    tokens."""
    jcfg, jparams, cfg, params = _setup(arch)
    S, clen = 512, 520
    assert not cfg.sliding_window or cfg.sliding_window < S
    tok = _tokens(cfg, 2, S)
    jout = jax_forward(jcfg, jparams, jnp.asarray(tok), cache_len=clen)
    out = forward(cfg, params, torch.from_numpy(tok).long(), cache_len=clen)
    np.testing.assert_allclose(out["h"].numpy(), np.asarray(jout["h"]),
                               atol=ATOL)
    _assert_caches_equal(out["cache"], jout["cache"], cfg)

    rng = np.random.default_rng(0)
    new = [3, 5, 2]
    prompts = [rng.integers(0, cfg.vocab_size, S) for _ in new]
    jsrv = JaxServer(jcfg, jparams, batch=2, prompt_len=S,
                     max_len=S + max(new) + 1)
    jsrv.submit([JaxRequest(rid=i, prompt=p, max_new_tokens=n)
                 for i, (p, n) in enumerate(zip(prompts, new))])
    want = {r.rid: r.out_tokens for r in jsrv.run()}
    srv = BatchedServer(cfg, params, batch=2, prompt_len=S,
                        max_len=S + max(new) + 1, device="cpu")
    srv.submit([Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new))])
    got = {r.rid: r.out_tokens for r in srv.run()}
    assert srv.continuous == jsrv.continuous == (not cfg.sliding_window)
    assert got == want
    assert srv.stats == jsrv.stats


def _attention_cases():
    cases = []
    for causal in (True, False):
        for window in (0, 7, 40):
            for softcap in (0.0, 5.0):
                for q_offset in (0, 13):
                    for seg in (False, True):
                        cases.append((causal, window, softcap, q_offset,
                                      seg))
    return cases


@pytest.mark.parametrize("causal,window,softcap,q_offset,seg",
                         _attention_cases())
def test_chunked_plain_attention_matches_unchunked(monkeypatch, causal,
                                                   window, softcap,
                                                   q_offset, seg):
    """``attention_fwd_ref`` in query-row chunks (CHUNK_BYTES set so that a
    chunk holds 3 rows of scores over every key), each chunk given only
    the keys its masks leave live, against one chunk of every row and key:
    o and lse within 1e-6 in f32 (the same f32 arithmetic; only the sums'
    blocking over the keys differs), -inf rows the same."""
    B, Sq, H, KH, D = 2, 50, 4, 2, 8
    Sk = Sq if causal and not q_offset else 63
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, Sq, H, D, generator=gen)
    k = torch.randn(B, Sk, KH, D, generator=gen)
    v = torch.randn(B, Sk, KH, D, generator=gen)
    sq = sk = None
    if seg:
        sq = (torch.arange(Sq)[None] >= torch.randint(
            1, Sq, (B, 1), generator=gen)).int()
        sk = (torch.arange(Sk)[None] >= torch.randint(
            1, Sk, (B, 1), generator=gen)).int()
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, seg_q=sq, seg_kv=sk)
    monkeypatch.setattr(fref, "CHUNK_BYTES", 1 << 40)
    assert len(fref._row_chunks(B, Sq, H, Sk, 0)) == 1
    o1, l1 = fref.attention_fwd_ref(q, k, v, **kw)
    monkeypatch.setattr(fref, "CHUNK_BYTES", 4 * B * H * Sk * 3)
    chunks = fref._row_chunks(B, Sq, H, Sk, window)
    assert len(chunks) > 1 and chunks[-1][1] == Sq
    o, lse = fref.attention_fwd_ref(q, k, v, **kw)
    live = torch.isfinite(l1)
    assert torch.equal(torch.isfinite(lse), live)
    assert float((o - o1).abs().max()) <= 1e-6
    assert float((lse[live] - l1[live]).abs().max()) <= 1e-6


def test_chunked_plain_attention_stays_in_its_byte_budget():
    """A 32,768-position row of gemma2-2b's global layer is taken 1,024
    query rows at a time (1 GiB of f32 scores), its local layer (window
    4,096) 4,096 rows at a time against at most 8,192 keys."""
    assert fref._row_chunks(1, 32768, 8, 32768, 0)[0] == (0, 1024)
    local = fref._row_chunks(1, 32768, 8, 32768, 4096)
    assert local[0] == (0, 4096) and len(local) == 8
    lo, hi = fref._key_range(8192, 12288, 32768, causal=True, window=4096,
                             q_offset=0)
    assert (lo, hi) == (4097, 12288) and hi - lo <= 2 * 4096


# ------------------------------------------------------------- chip_smoke

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_cli_reckons_a_depth_cut():
    """``launch.dryrun --arch falcon-mamba-7b-L8 --shape prefill_32k
    --batch 1`` resolves the cut (``configs.resolve_config``) and reports
    [ok], its peak below the full depth's."""
    from repro_torch.launch import dryrun
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--arch", "falcon-mamba-7b-L8", "--shape",
                          "prefill_32k", "--batch", "1"])
    assert rc == 0
    line = next(x for x in buf.getvalue().splitlines() if x.startswith("["))
    assert line.startswith("[ok]") and "falcon-mamba-7b-L8" in line
    cut = dryrun.run_cell("falcon-mamba-7b-L8", "prefill_32k", batch=1,
                          save=False)
    full = dryrun.run_cell("falcon-mamba-7b", "prefill_32k", batch=1,
                           save=False)
    assert cut["status"] == full["status"] == "ok"
    assert cut["arch"] == "falcon-mamba-7b-L8"
    assert cut["param_bytes"] < full["param_bytes"]
    assert cut["peak_bytes"] < full["peak_bytes"]
    assert resolve_config("falcon-mamba-7b-L8").num_layers == 8
    with pytest.raises(KeyError):
        resolve_config("no-such-arch-L8")


@pytest.mark.parametrize("kind,shape,batch,seq", [
    ("prefill", "prefill_32k", 1, 2048), ("decode", "decode_32k", 2, 4096)])
def test_chip_smoke_reckon_takes_a_shape_kind(kind, shape, batch, seq):
    """``chip_smoke._reckon`` of a prefill and a decode kind gives the peak
    that ``launch.dryrun.run_cell`` reckons for the same cell."""
    from repro_torch.launch.dryrun import run_cell
    cs = _chip_smoke()
    got = cs._reckon("gemma2-2b", batch, seq, kind=kind)
    want = run_cell("gemma2-2b", shape, batch=batch, seq=seq, save=False)
    assert got["kind"] == kind
    assert got["peak_bytes"] == want["peak_bytes"]
    assert got["kernel_calls"] == want["kernel_calls"]


def test_chip_smoke_long_cells_cover_every_applicable_cell():
    """The long phases' reckonings: each arch's cell at its batch and at
    twice it (within the cell's global batch), every serving cell of
    SHAPES that applies to the arch, qwen3-moe's long_500k skipped; every
    registered arch has a LONG entry (grok-1-314b as its serve entry's
    cut)."""
    cs = _chip_smoke()
    cells = cs._long_cells()
    assert cells["long gemma2-2b prefill_32k 8"] == dict(
        arch="gemma2-2b", batch=8, seq=32768, kind="prefill")
    assert cells["long gemma2-2b decode_32k 32"]["kind"] == "decode"
    assert "long recurrentgemma-2b decode_32k 256" not in cells
    assert "long qwen3-moe-30b-a3b long_500k 1" not in cells
    assert cells["long gemma3-4b long_500k 1"]["seq"] == 524_288
    assert cells["long whisper-large-v3 decode_32k 8"] == dict(
        arch="whisper-large-v3", batch=8, seq=32768, kind="decode")
    assert cells["long grok-1-314b-L4 prefill_32k 1"]["kind"] == "prefill"
    archs = {s["arch"] for s in cs.LONG}
    assert {k.split()[1] for k in cells} == archs
    for spec in cs.LONG:
        assert any(e[0] == spec["arch"] for e in cs.SERVE)
        cfg = resolve_config(spec["arch"])
        for cell in cs.LONG_CELLS:   # every applicable cell, at its batch
            B = cs._long_batch(spec, cell)
            assert (f"long {spec['arch']} {cell} {B}" in cells) == \
                cell_applicable(cfg, SHAPES[cell])[0], (spec, cell)
    # every registered arch's serving cells (tests/test_torch_long_context_
    # grid.py holds the whole grid, train_4k too)
    assert {resolve_config(a).name.split("-L")[0] for a in archs} == {
        a for a in list_configs() if not a.startswith("serve-")}


_LONG_REHEARSAL = {"prefill_32k": 96, "decode_32k": 64, "long_500k": 128}
CPU_H_LIMIT = 1e-4   # as the serve rehearsal: plain against plain is 0


def rehearse_long_phase(arch, monkeypatch):
    """The rehearsal of ``arch``'s LONG entry (``arch`` its name: a
    registered config or ``<base>-L<n>``); returns its rows by cell.  A
    stubbed frontend's checked prefill takes its stub inputs (STUB_PREFILL
    and an entry's own ``decode`` launches rescaled to the reduced
    config), whisper's first attention sublayers read under CPU_H_LIMIT
    too."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gmm import ops as gops
    from repro_torch.models import layers, transformer

    cs = _chip_smoke()
    spec = dict(next(s for s in cs.LONG if s["arch"] == arch))
    full = resolve_config(arch)
    base = arch.rpartition("-L")[0] if arch not in cfg_base._REGISTRY \
        else arch
    cfg = reduced(get_config(base)).replace(name=arch, dtype="bfloat16",
                                            head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
    if "check" in spec:     # the comparison's cut within the reduced depth
        spec["check"] = dict(spec["check"], layers=spec["check"]["layers"]
                             and min(spec["check"]["layers"],
                                     cfg.num_layers))
    if "decode" in spec:   # the entry's decode variant: the card's routes
        cfg = cfg.replace(num_experts=full.num_experts,
                          experts_per_tok=full.experts_per_tok)
        monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
        spec["decode"] = cs._layer_counts(spec["decode"], full, cfg)
    for cell, seq in _LONG_REHEARSAL.items():
        old = SHAPES[cell]
        monkeypatch.setitem(SHAPES, cell, ShapeSpec(
            old.name, old.kind, seq, old.global_batch))
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
        for name in cs._MIXER_KINDS:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, counted(getattr(mod, name),
                                                       name))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    for fn in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    monkeypatch.setattr(cs, "time_ms",
                        lambda fn, iters, warmup=1: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "_card", lambda: "CPU rehearsal")
    monkeypatch.setattr(cs, "DRYRUN_PEAK_RTOL", float("inf"))
    monkeypatch.setitem(cs.PREFILL_H_LIMIT, arch, CPU_H_LIMIT)
    monkeypatch.setattr(cs, "LONG_H_LIMIT", {})
    if arch in cs.PREFILL_ATTN1:
        monkeypatch.setitem(cs.PREFILL_ATTN1, arch, CPU_H_LIMIT)
    if arch in cs.STUB_PREFILL:   # an encoder's flash launches, one a layer
        e, e_r = full.encoder_layers, cfg.encoder_layers
        monkeypatch.setitem(cs.STUB_PREFILL, arch, {
            k: e_r + (v - e) * cfg.num_layers // full.num_layers
            for k, v in cs.STUB_PREFILL[arch].items()})
    entry = next(e for e in cs.SERVE if e[0] == arch)
    monkeypatch.setattr(cs, "SERVE", [(
        arch, entry[1], cs._layer_counts(entry[2], full, cfg),
        cs._layer_counts(entry[3], full, cfg))])

    class Reckonings:      # the batch rule holds: B under, 2B over; a
        def get(self, key):   # decode step's tally is the entry's
            b = int(key.split()[-1])
            cell = key.split()[2]
            return {"peak_bytes": 1e9 if b == cs._long_batch(spec, cell)
                    else 1e12,
                    "kernel_calls": spec.get("decode", cs.SERVE[0][3])}
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    with torch.inference_mode():
        paths = cs.phase_long(torch.device("cpu"), spec, Reckonings())
    got = {r["cell"]: r for r in rows}
    assert all(r["ok"] for r in rows)
    assert set(got) == {c for c in spec.get("cells", cs.LONG_CELLS)
                        if not (c == "long_500k"
                                and not cfg.supports_long_context)}
    assert set(paths) == {r["phase"] for r in rows}
    if "prefill_32k" in got:
        row = got["prefill_32k"]
        assert row["prompt_len"] == 96 - cs.LONG_NEW - 1
        assert row["stats"]["prefills"] == 1
        chk = row["check"]
        assert chk["h_rel_frobenius"] == 0.0
        assert chk["greedy_token_agreement"] == 1.0
        assert set(chk["controls"]) == set(cs._controls(cfg, entry[2]))
        assert all(c["h_rel_frobenius"] > CPU_H_LIMIT
                   for c in chk["controls"].values())
        assert chk["rows"] == spec["check"]["rows"]
        f32 = chk["f32_held"]
        assert bool(f32) == bool(spec["check"].get("f32_rows"))
        if f32:   # the plain bf16 run is the kernels' here
            assert f32["kernels_vs_ref"] == 0.0 and f32["ratio"] == 1.0
        if cfg.num_experts:
            assert chk["routing"]["assignments"] > 0
        assert bool(chk["stub_inputs"]) == (arch in cs.STUB_PREFILL)
        assert row["peak_held"] == (arch not in cs.STUB_PREFILL)
        subs = chk["first_attention_sublayers"]
        assert bool(subs) == (arch in cs.PREFILL_ATTN1)
        for sub in subs.values():
            assert sub["h_rel_frobenius"] == 0.0
            assert all(c > CPU_H_LIMIT for c in sub["controls"].values())
    if "long_500k" in got:
        row = got["long_500k"]
        assert row["tokens_equal"] and row["logit_max_abs_err"] == 0.0
        assert row["positions"] == [128 - cs.LONG_NEW, 127]
    if "decode_32k" in got:
        row = got["decode_32k"]
        assert row["position"] == 63
        assert row["step_launches"] == row["step_launches_expected"]
        assert bool(row["cross_cache"]) == bool(cfg.encoder_layers)
    return got

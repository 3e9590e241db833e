"""The port's models against the JAX package's, on reduced configs in f32:
the dense attention archs, recurrentgemma-2b (RG-LRU + local attention),
falcon-mamba-7b (Mamba-1), qwen3-moe-30b-a3b (mixture of experts),
whisper-large-v3 (encoder, cross-attention) and internvl2-26b (vision
embeddings spliced over the first positions), whose scans and grouped
matmuls run their plain versions here.

Parameters come from the JAX ``init_params`` and reach the port through
``params_from_numpy``; token ids come from numpy.  JAX runs its default
``xla`` path on the CPU with matmul precision "highest"
(``tests/conftest.py``), so f32 is compared with f32: hidden states and
logits at 1e-4 absolute, which leaves room for the different summation
order of the two frameworks' CPU matmuls over a few layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.transformer import lm_logits as jax_lm_logits  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import decode_step, forward, init_params, lm_logits  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    layers_from_numpy,
    params_from_numpy,
    params_to_flat,
)

DENSE_ARCHS = ["gemma2-2b", "gemma3-4b", "minicpm-2b", "nemotron-4-15b"]
SCAN_ARCHS = ["recurrentgemma-2b", "falcon-mamba-7b"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
STUB_ARCHS = ["whisper-large-v3", "internvl2-26b"]   # frontends stubbed
ATOL = 1e-4


def to_numpy(flat):
    """A ``convert.*_to_flat`` result as numpy; bfloat16 comes back as
    float32 (exact: every bf16 value is an f32)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in flat.items()}


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _setup(arch, seed=0):
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    cfg = port_cfg(jcfg)
    return jcfg, jparams, cfg, params_from_numpy(flat, cfg), flat


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_configs_match_jax():
    for name in ("gemma2-2b", *SCAN_ARCHS, *MOE_ARCHS):
        jcfg = jax_get_config(name)
        assert get_config(name) == port_cfg(jcfg)
        assert reduced(get_config(name)) == port_cfg(jax_reduced(jcfg))
        assert get_config(name).param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch",
                         DENSE_ARCHS + SCAN_ARCHS + MOE_ARCHS + STUB_ARCHS)
def test_init_params_match_jax_layout(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    want = {k: (v.shape, str(v.dtype)) for k, v in
            _flatten(jax.eval_shape(lambda: jax_init_params(
                jcfg, jax.random.PRNGKey(0)))).items()}
    mine = to_numpy(params_to_flat(
        init_params(port_cfg(jcfg), torch.Generator().manual_seed(0)),
        port_cfg(jcfg)))
    assert {k: (v.shape, str(v.dtype)) for k, v in mine.items()} == want


@pytest.mark.parametrize("arch", DENSE_ARCHS + SCAN_ARCHS + MOE_ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jparams, cfg, params, _ = _setup(arch)
    tok = _tokens(cfg, 2, 32)
    jh = jax_forward(jcfg, jparams, jnp.asarray(tok))["h"]
    h = forward(cfg, params, torch.from_numpy(tok).long())["h"]
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(lm_logits(cfg, params, h).numpy(),
                               np.asarray(jax_lm_logits(jcfg, jparams, jh)),
                               atol=ATOL)


def test_prefill_cache_matches_jax():
    jcfg, jparams, cfg, params, _ = _setup("gemma2-2b")
    tok = _tokens(cfg, 2, 24)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok), cache_len=40)["cache"]
    want = layers_from_numpy({k: np.asarray(v) for k, v in
                              _flatten(jcache).items()}, cfg)
    got = forward(cfg, params, torch.from_numpy(tok).long(),
                  cache_len=40)["cache"]
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=ATOL)


def test_decode_step_matches_jax():
    jcfg, jparams, cfg, params, _ = _setup("gemma2-2b")
    B, S, EXTRA = 2, 24, 4
    tok = _tokens(cfg, B, S + EXTRA)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok[:, :S]),
                         cache_len=40)["cache"]
    cache = layers_from_numpy({k: np.asarray(v) for k, v in
                               _flatten(jcache).items()}, cfg)
    for t in range(EXTRA):
        pos = np.full((B,), S + t, np.int32)
        step = tok[:, S + t:S + t + 1]
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(step), jnp.asarray(pos))
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step).long(),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """As ``test_models.py``: prefill-then-decode equals the full forward."""
    cfg = reduced(port_cfg(jax_get_config(arch)))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    B, S, EXTRA, CLEN = 2, 24, 4, 48
    tok = torch.from_numpy(_tokens(cfg, B, S + EXTRA)).long()
    full = lm_logits(cfg, params, forward(cfg, params, tok)["h"])
    cache = forward(cfg, params, tok[:, :S], cache_len=CLEN)["cache"]
    errs = []
    for t in range(EXTRA):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = decode_step(cfg, params, cache,
                                    tok[:, S + t:S + t + 1], pos)
        errs.append(float((logits[:, 0] - full[:, S + t]).abs().max()))
    assert max(errs) < 2e-2, (arch, errs)


def test_params_roundtrip_exact():
    _, _, cfg, params, flat = _setup("gemma2-2b")
    back = to_numpy(params_to_flat(params, cfg))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype
        np.testing.assert_array_equal(back[key], arr)
    # bfloat16 leaves keep their values (returned as float32)
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in flat.items()}
    back = to_numpy(params_to_flat(params_from_numpy(bf, cfg), cfg))
    for key, arr in bf.items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))


def _jax_cache_layers(jcache, cfg):
    return layers_from_numpy({k: np.asarray(v) for k, v in
                              _flatten(jcache).items()}, cfg)


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_scan_prefill_cache_matches_jax(arch):
    """The recurrent ``h`` (f32) and ``conv`` states, and recurrentgemma's
    local-attention ring cache."""
    jcfg, jparams, cfg, params, _ = _setup(arch)
    tok = _tokens(cfg, 2, 24)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok), cache_len=40)["cache"]
    want = _jax_cache_layers(jcache, cfg)
    got = forward(cfg, params, torch.from_numpy(tok).long(),
                  cache_len=40)["cache"]
    assert len(got) == len(want) == cfg.num_layers
    kinds = set()
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        kinds.add((cfg.layer_kind(i), tuple(sorted(g))))
        for key in g:
            assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=ATOL)
        if "h" in g:
            assert g["h"].dtype == torch.float32
    assert {k for k, _ in kinds} == set(cfg.layer_kinds)


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_scan_decode_steps_match_jax(arch):
    jcfg, jparams, cfg, params, _ = _setup(arch)
    B, S, EXTRA = 2, 24, 4
    tok = _tokens(cfg, B, S + EXTRA)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok[:, :S]),
                         cache_len=40)["cache"]
    cache = _jax_cache_layers(jcache, cfg)
    for t in range(EXTRA):
        pos = np.full((B,), S + t, np.int32)
        step = tok[:, S + t:S + t + 1]
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(step), jnp.asarray(pos))
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step).long(),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
    for g, w in zip(cache, _jax_cache_layers(jcache, cfg)):
        for key in ("h", "conv"):
            if key in g:
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                           atol=ATOL)


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_scan_prefill_decode_matches_forward(arch):
    """Prefill, then decode token by token, equals the full forward: the
    sequential decode recurrences continue the prefill scans exactly."""
    cfg = reduced(port_cfg(jax_get_config(arch)))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    B, S, EXTRA, CLEN = 2, 24, 6, 48
    tok = torch.from_numpy(_tokens(cfg, B, S + EXTRA)).long()
    full = lm_logits(cfg, params, forward(cfg, params, tok)["h"])
    cache = forward(cfg, params, tok[:, :S], cache_len=CLEN)["cache"]
    for t in range(EXTRA):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = decode_step(cfg, params, cache,
                                    tok[:, S + t:S + t + 1], pos)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, S + t].numpy(), atol=ATOL)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_scan_params_carry_layout_and_float32_leaves(arch):
    """bf16 params: recurrentgemma (unscanned, every layer under
    ``tail/block_j``) and falcon-mamba (scanned ``(G, ...)`` stacks) convert
    exactly, and ``a_param``, ``A_log``, ``D`` and ``dt_bias`` stay f32, in
    the converted params and in the port's own init."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(param_dtype="bfloat16")
    flat = {k: np.asarray(v) for k, v in _flatten(
        jax_init_params(jcfg, jax.random.PRNGKey(0))).items()}
    cfg = port_cfg(jcfg)
    roots = {k.split("/", 1)[0] for k in flat}
    if cfg.scan_layers:          # falcon-mamba: (num_layers, ...) stacks
        assert "blocks" in roots and "tail" not in roots
        assert all(v.shape[0] == cfg.num_layers for k, v in flat.items()
                   if k.startswith("blocks/"))
    else:                        # recurrentgemma: one tail block per layer
        assert "tail" in roots and "blocks" not in roots
    conv = dict(_paths(params_from_numpy(flat, cfg)))
    mine = dict(_paths(init_params(cfg, torch.Generator().manual_seed(0))))
    assert conv.keys() == mine.keys()
    f32 = set()
    for key, t in conv.items():
        assert (t.dtype, t.shape) == (mine[key].dtype, mine[key].shape), key
        if t.dtype == torch.float32:
            f32.add(key.rsplit("/", 1)[-1])
    assert f32 == ({"a_param"} if arch == "recurrentgemma-2b"
                   else {"A_log", "D", "dt_bias"})
    back = to_numpy(params_to_flat(params_from_numpy(flat, cfg), cfg))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_aux_and_prefill_cache_match_jax(arch):
    """The summed load-balance loss of the MoE layers, and the kv cache."""
    jcfg, jparams, cfg, params, _ = _setup(arch)
    tok = _tokens(cfg, 2, 24)
    jout = jax_forward(jcfg, jparams, jnp.asarray(tok), cache_len=40)
    out = forward(cfg, params, torch.from_numpy(tok).long(), cache_len=40)
    assert float(out["aux"]) > 0
    np.testing.assert_allclose(float(out["aux"]), float(jout["aux"]),
                               atol=ATOL)
    np.testing.assert_allclose(out["h"].numpy(), np.asarray(jout["h"]),
                               atol=ATOL)
    want = _jax_cache_layers(jout["cache"], cfg)
    assert len(out["cache"]) == len(want) == cfg.num_layers
    for g, w in zip(out["cache"], want):
        assert set(g) == set(w) == {"k", "v"}
        for key in g:
            assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_jax(arch):
    jcfg, jparams, cfg, params, _ = _setup(arch)
    B, S, EXTRA = 2, 24, 4
    tok = _tokens(cfg, B, S + EXTRA)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok[:, :S]),
                         cache_len=40)["cache"]
    cache = _jax_cache_layers(jcache, cfg)
    for t in range(EXTRA):
        pos = np.full((B,), S + t, np.int32)
        step = tok[:, S + t:S + t + 1]
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(step), jnp.asarray(pos))
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step).long(),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_roundtrip_exact(arch):
    """bf16 params: the router stays f32, and ``wi``/``wg`` (E, D, F) and
    ``wo`` (E, F, D) are stacked as (G, E, ...) under ``blocks/sub_0/moe``;
    both directions of the conversion are exact."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(param_dtype="bfloat16")
    flat = {k: np.asarray(v) for k, v in _flatten(
        jax_init_params(jcfg, jax.random.PRNGKey(0))).items()}
    cfg = port_cfg(jcfg)
    E, D, Fe, G = cfg.num_experts, cfg.d_model, cfg.expert_ff, cfg.num_layers
    moe = {k.rsplit("/", 1)[-1]: v for k, v in flat.items()
           if k.startswith("blocks/sub_0/moe/")}
    assert {k: v.shape for k, v in moe.items()} == {
        "router": (G, D, E), "wi": (G, E, D, Fe), "wg": (G, E, D, Fe),
        "wo": (G, E, Fe, D)}
    assert moe["router"].dtype == np.float32
    params = params_from_numpy(flat, cfg)
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    for layer, ref in zip(params["layers"], mine["layers"]):
        assert "mlp" not in layer and set(layer["moe"]) == set(ref["moe"])
        for key, t in layer["moe"].items():
            assert (t.dtype, t.shape) == (ref["moe"][key].dtype,
                                          ref["moe"][key].shape), key
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["wi"].dtype == torch.bfloat16
    back = to_numpy(params_to_flat(params, cfg))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))
    for g in range(G):
        np.testing.assert_array_equal(
            params["layers"][g]["moe"]["wo"].float().numpy(),
            moe["wo"][g].astype(np.float32))


# ------------------------------------------------ encoder and vision inputs

def _stub_inputs(cfg, B, seed=2):
    """The frontends' stub inputs of ``cfg`` (numpy f32, 0.02 std): vision
    embeddings for internvl2-26b, frame embeddings for whisper-large-v3."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.vision_tokens:
        kw["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.encoder_layers:
        kw["enc_frames"] = (0.02 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return kw


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_configs_match_jax(arch):
    """Full and reduced configs as the JAX package's; the parameter counts
    (whisper 1.53 B with its encoder; internvl2-26b's InternLM2-20B
    backbone 19.86 B, its ViT stubbed)."""
    jcfg = jax_get_config(arch)
    assert get_config(arch) == port_cfg(jcfg)
    assert reduced(get_config(arch)) == port_cfg(jax_reduced(jcfg))
    assert get_config(arch).param_count() == jcfg.param_count()
    assert round(get_config(arch).param_count() / 1e9, 2) == {
        "whisper-large-v3": 1.53, "internvl2-26b": 19.86}[arch]


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_forward_with_stub_inputs_matches_jax(arch):
    jcfg, jparams, cfg, params, _ = _setup(arch)
    tok = _tokens(cfg, 2, 32)
    kw = _stub_inputs(cfg, 2)
    jh = jax_forward(jcfg, jparams, jnp.asarray(tok), **_j(kw))["h"]
    h = forward(cfg, params, torch.from_numpy(tok).long(), **_t(kw))["h"]
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(lm_logits(cfg, params, h).numpy(),
                               np.asarray(jax_lm_logits(jcfg, jparams, jh)),
                               atol=ATOL)


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_prefill_cache_matches_jax(arch):
    """whisper's cache gains the cross-attention's ``xk`` / ``xv`` (B,
    encoder_seq, KH, D) in every decoder layer; internvl's is k, v."""
    jcfg, jparams, cfg, params, _ = _setup(arch)
    tok = _tokens(cfg, 2, 24)
    kw = _stub_inputs(cfg, 2)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok), cache_len=40,
                         **_j(kw))["cache"]
    want = _jax_cache_layers(jcache, cfg)
    got = forward(cfg, params, torch.from_numpy(tok).long(), cache_len=40,
                  **_t(kw))["cache"]
    keys = {"k", "v", "xk", "xv"} if cfg.encoder_layers else {"k", "v"}
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for key in g:
            assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=ATOL)
    if cfg.encoder_layers:
        assert got[0]["xk"].shape == (2, cfg.encoder_seq, cfg.num_kv_heads,
                                      cfg.head_dim)


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_decode_steps_match_jax(arch):
    """Decode from a JAX prefill cache (whisper: attending ``xk`` / ``xv``
    in every layer), step by step, logits and the cache after."""
    jcfg, jparams, cfg, params, _ = _setup(arch)
    B, S, EXTRA = 2, 24, 4
    tok = _tokens(cfg, B, S + EXTRA)
    jcache = jax_forward(jcfg, jparams, jnp.asarray(tok[:, :S]),
                         cache_len=40, **_j(_stub_inputs(cfg, B)))["cache"]
    cache = _jax_cache_layers(jcache, cfg)
    for t in range(EXTRA):
        pos = np.full((B,), S + t, np.int32)
        step = tok[:, S + t:S + t + 1]
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(step), jnp.asarray(pos))
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step).long(),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
    for g, w in zip(cache, _jax_cache_layers(jcache, cfg)):
        assert set(g) == set(w)
        for key in g:
            np.testing.assert_allclose(g[key].numpy(), w[key].numpy(),
                                       atol=ATOL)


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_prefill_decode_matches_forward(arch):
    """As ``test_models.py``: prefill (with the stub inputs), then decode,
    equals the full forward, 2e-2."""
    cfg = reduced(port_cfg(jax_get_config(arch)))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    B, S, EXTRA, CLEN = 2, 24, 4, 48
    tok = torch.from_numpy(_tokens(cfg, B, S + EXTRA)).long()
    kw = _t(_stub_inputs(cfg, B))
    full = lm_logits(cfg, params, forward(cfg, params, tok, **kw)["h"])
    cache = forward(cfg, params, tok[:, :S], cache_len=CLEN, **kw)["cache"]
    errs = []
    for t in range(EXTRA):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        logits, cache = decode_step(cfg, params, cache,
                                    tok[:, S + t:S + t + 1], pos)
        errs.append(float((logits[:, 0] - full[:, S + t]).abs().max()))
    assert max(errs) < 2e-2, (arch, errs)


def test_whisper_prefill_without_frames_matches_jax():
    """Tokens alone (the server's prefill): no encoder, no cross k, v in
    the cache, and decode steps without cross-attention, as in JAX."""
    jcfg, jparams, cfg, params, _ = _setup("whisper-large-v3")
    B, S = 2, 16
    tok = _tokens(cfg, B, S + 1)
    jout = jax_forward(jcfg, jparams, jnp.asarray(tok[:, :S]), cache_len=24)
    out = forward(cfg, params, torch.from_numpy(tok[:, :S]).long(),
                  cache_len=24)
    np.testing.assert_allclose(out["h"].numpy(), np.asarray(jout["h"]),
                               atol=ATOL)
    assert all(set(c) == {"k", "v"} for c in out["cache"])
    pos = np.full((B,), S, np.int32)
    jlogits, _ = jax_decode_step(jcfg, jparams, jout["cache"],
                                 jnp.asarray(tok[:, S:]), jnp.asarray(pos))
    logits, _ = decode_step(cfg, params, out["cache"],
                            torch.from_numpy(tok[:, S:]).long(),
                            torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_params_roundtrip_exact(arch, param_dtype):
    """whisper's encoder stacks as ``enc/blocks/sub_0/...`` (leading axis
    encoder_layers) beside ``enc/final_norm``, and its decoder layers carry
    ``lnx`` / ``xattn``; both directions are exact, and the converted
    params have the port's own init layout."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(param_dtype=param_dtype)
    flat = {k: np.asarray(v) for k, v in _flatten(
        jax_init_params(jcfg, jax.random.PRNGKey(0))).items()}
    cfg = port_cfg(jcfg)
    params = params_from_numpy(flat, cfg)
    mine = dict(_paths(init_params(cfg, torch.Generator().manual_seed(0))))
    conv = dict(_paths(params))
    assert conv.keys() == mine.keys()
    for key, t in conv.items():
        assert (t.dtype, t.shape) == (mine[key].dtype, mine[key].shape), key
    back = to_numpy(params_to_flat(params, cfg))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr.astype(np.float32))
    if cfg.encoder_layers:
        enc = {k for k in flat if k.startswith("enc/")}
        assert {k for k in enc if not k.startswith("enc/blocks/sub_0/")} == {
            "enc/final_norm/scale", "enc/final_norm/bias"}
        assert all(flat[k].shape[0] == cfg.encoder_layers for k in enc
                   if k.startswith("enc/blocks/"))
        assert len(params["enc"]["layers"]) == cfg.encoder_layers
        assert "xattn" in params["layers"][0] and "lnx" in params["layers"][0]
        assert "q_norm" not in params["layers"][0]["xattn"]
        for i, layer in enumerate(params["enc"]["layers"]):
            np.testing.assert_array_equal(
                layer["attn"]["wq"].float().numpy(),
                flat["enc/blocks/sub_0/attn/wq"][i].astype(np.float32))


def test_vision_embeds_change_output():
    """``tests/test_models.py``'s case on the port."""
    cfg = reduced(get_config("internvl2-26b"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(cfg, 1, 32)).long()
    v1 = torch.from_numpy(_stub_inputs(cfg, 1)["vision_embeds"])
    out1 = forward(cfg, params, tok, vision_embeds=v1)["h"]
    out2 = forward(cfg, params, tok, vision_embeds=2 * v1)["h"]
    assert float((out1 - out2).abs().max()) > 1e-6
    # the splice replaces the first vision_tokens positions' embeddings
    assert torch.equal(out1, forward(cfg, params, tok.clone().index_fill_(
        1, torch.arange(cfg.vision_tokens), 0), vision_embeds=v1)["h"])


def test_encoder_changes_decoder_output():
    """``tests/test_models.py``'s case on the port."""
    cfg = reduced(get_config("whisper-large-v3"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(cfg, 1, 16)).long()
    f1 = torch.from_numpy(_stub_inputs(cfg, 1)["enc_frames"])
    out1 = forward(cfg, params, tok, enc_frames=f1)["h"]
    out2 = forward(cfg, params, tok, enc_frames=-f1)["h"]
    assert float((out1 - out2).abs().max()) > 1e-6

"""The port's MoE grouped matmul and MoE layer against the JAX package's.

On the CPU the port's ``gmm`` runs its plain PyTorch version.  It is held
against the JAX Pallas kernel in interpret mode on the block-aligned sweep
of ``test_pallas_kernels.py`` and against the JAX oracle (``gmm_ref``) on
ragged shapes the Pallas kernel cannot take; padding rows must come out
exactly 0.  ``apply_moe`` is held against JAX ``apply_moe`` on reduced
qwen3-moe-30b-a3b in three regimes: capacity drops, no drops, and a T large
enough for 128-row capacity blocks.  Inputs and parameters come from numpy
seeds (JAX ``init_moe`` through numpy for the layer).  Tolerances: f32 at
1e-3 for the kernel sweeps (as ``test_pallas_kernels.py``) and 1e-4 for the
layer (the two frameworks' CPU matmuls sum in different orders); bf16 at one
bf16 step of the largest output (both round an f32 sum that agrees to ~1e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.moe_gmm.ops import gmm as jax_gmm  # noqa: E402
from repro.kernels.moe_gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm, gmm_ref  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import (  # noqa: E402
    MAX_WGMMA_EXPERTS,
    VARIANTS,
    check_inputs,
    gmm_cuda,
    variant,
)
from repro_torch.models import layers as L  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"


def _inputs(seed, E, C, D, F, sizes=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    if sizes is None:
        sizes = rng.integers(0, C + 1, (E,))
    return x, w, np.asarray(sizes, np.int32)


def _port(x, w, sizes, dtype="float32"):
    dt = getattr(torch, dtype)
    return gmm(torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt),
               torch.from_numpy(sizes))


def _padding_is_zero(out, sizes):
    C = out.shape[1]
    valid = np.arange(C)[None, :] < np.asarray(sizes)[:, None]
    return bool((out.float().numpy()[~valid] == 0).all())


@pytest.mark.parametrize("E,C,D,F", [(4, 256, 128, 256), (8, 128, 256, 128)])
def test_gmm_matches_jax_pallas_interpret(E, C, D, F):
    x, w, sizes = _inputs(0, E, C, D, F)
    want = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
                   impl="pallas_interpret")
    got = _port(x, w, sizes)
    assert got.shape == (E, C, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert _padding_is_zero(got, sizes)


@pytest.mark.parametrize("E,C,D,F,sizes", [
    (5, 100, 200, 300, [0, 100, 37, 64, 1]),     # 0, C and in between
    (3, 8, 24, 40, [8, 0, 3]),                   # a decode-sized capacity
    (2, 70, 9, 13, [70, 69]),                    # depth and width not % 8
])
def test_gmm_ragged_matches_jax_ref(E, C, D, F, sizes):
    """Shapes the Pallas kernel cannot take (C, F not block multiples)."""
    x, w, sizes = _inputs(1, E, C, D, F, sizes)
    want = jax_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes))
    got = _port(x, w, sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert _padding_is_zero(got, sizes)


def test_gmm_bf16_matches_jax_ref():
    x, w, sizes = _inputs(2, 6, 40, 64, 48, [40, 0, 17, 1, 39, 8])
    want = np.asarray(jax_gmm_ref(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(sizes)), np.float32)
    got = _port(x, w, sizes, "bfloat16")
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    assert _padding_is_zero(got, sizes)


# ---------------------------------------------------------------- wrapper

@pytest.mark.parametrize("bad", ["mixed_dtype", "float16", "sizes_dtype",
                                 "sizes_shape", "w_shape", "layout"])
def test_gmm_rejects_what_the_kernel_does_not_take(bad):
    E, C, D, F = 3, 8, 16, 24
    a = dict(x=torch.zeros(E, C, D), w=torch.zeros(E, D, F),
             group_sizes=torch.zeros(E, dtype=torch.int32))
    check_inputs(**a)
    if bad == "mixed_dtype":
        a["w"] = a["w"].to(torch.bfloat16)
    elif bad == "float16":
        a["x"], a["w"] = a["x"].half(), a["w"].half()
    elif bad == "sizes_dtype":
        a["group_sizes"] = torch.zeros(E, dtype=torch.int64)
    elif bad == "sizes_shape":
        a["group_sizes"] = torch.zeros(E + 1, dtype=torch.int32)
    elif bad == "w_shape":
        a["w"] = torch.zeros(E, D + 1, F)
    else:
        a["x"] = torch.zeros(E, D, C).transpose(1, 2)
    with pytest.raises(ValueError):
        check_inputs(**a)


def test_cpu_tensors_take_the_plain_version():
    before = dict(LAUNCHES)
    x, w, sizes = (torch.from_numpy(a) for a in _inputs(3, 2, 8, 16, 8))
    torch.testing.assert_close(gmm(x, w, sizes), gmm_ref(x, w, sizes),
                               rtol=0, atol=0)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA"):
        gmm_cuda(x, w, sizes)
    with pytest.raises(ValueError):
        gmm(x, w, sizes, impl="xla")


# (dtype, E, C, D, F, aligned) -> the kernel a CUDA launch takes.  The
# wgmma/TMA kernel needs bf16, C > 16 (decode's C = 8 stays on mma.sync),
# D > 0, 16-byte rows and pointers (TMA's stride and address rule), E
# small enough to stage the sizes on chip and C F / 8 within 32 bits.
@pytest.mark.parametrize("dtype,E,C,D,F,aligned,want", [
    ("bfloat16", 128, 384, 2048, 768, True, "wgmma"),       # qwen3 wi / wg
    ("bfloat16", 128, 384, 768, 2048, True, "wgmma"),       # qwen3 wo
    ("bfloat16", 128, 8, 2048, 768, True, "mma_sync"),      # qwen3 decode
    ("bfloat16", 6, 16, 136, 264, True, "mma_sync"),        # C = 16
    ("bfloat16", 6, 17, 136, 264, True, "wgmma"),           # C = 17
    ("bfloat16", 5, 100, 204, 296, True, "mma_sync"),       # D % 8 != 0
    ("bfloat16", 5, 100, 200, 300, True, "mma_sync"),       # F % 8 != 0
    ("bfloat16", 5, 100, 200, 296, False, "mma_sync"),      # unaligned
    ("bfloat16", 5, 100, 0, 296, True, "mma_sync"),         # D = 0
    ("bfloat16", MAX_WGMMA_EXPERTS, 64, 64, 64, True, "wgmma"),
    ("bfloat16", MAX_WGMMA_EXPERTS + 1, 64, 64, 64, True, "mma_sync"),
    ("bfloat16", 1, 2 ** 17, 8, 2 ** 17, True, "mma_sync"),  # C F >= 2^34
    ("float32", 128, 384, 2048, 768, True, "f32"),
    ("float32", 128, 8, 2048, 768, True, "f32"),
])
def test_gmm_variant_rule(dtype, E, C, D, F, aligned, want):
    assert variant(getattr(torch, dtype), E, C, D, F, aligned) == want
    assert want in VARIANTS and f"gmm.{want}" in LAUNCHES


def test_gmm_build_is_registered():
    assert "gmm" in LAUNCHES
    path = _build.library_path("gmm")
    assert path.parent == _build.BUILD_DIR and "gmm" in path.name
    assert (_build._KERNELS_DIR / _build.SOURCES["gmm"]).is_file()


# ---------------------------------------------------------------- layer

def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _moe_setup(seed=0):
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, _port_cfg(jcfg), jp, tp


def _tokens(seed, B, S, D, skew=0.0):
    """Activations; ``skew`` adds one direction to every token, so the
    router favours the same experts and their capacity overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return x + skew * rng.standard_normal((1, 1, D)).astype(np.float32)


def _counts_and_capacity(jcfg, jp, x, capacity_factor):
    E, k = jcfg.num_experts, jcfg.experts_per_tok
    T = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jp["router"], -1)
    idx = np.asarray(jax.lax.top_k(probs, k)[1])
    counts = np.bincount(idx.reshape(-1), minlength=E)
    cap_block = 128 if T * k // E >= 128 else 8
    C = max(cap_block, L._round_up(int(np.ceil(T * k / E * capacity_factor)),
                                   cap_block))
    return counts, C, cap_block


@pytest.mark.parametrize("regime", ["drops", "no_drops", "cap_block_128"])
def test_apply_moe_matches_jax(regime):
    jcfg, cfg, jp, tp = _moe_setup()
    B, S, skew, cf = {"drops": (2, 16, 3.0, 1.25),
                      "no_drops": (2, 16, 0.0, float(cfg.num_experts)),
                      "cap_block_128": (2, 128, 0.0, 1.25)}[regime]
    x = _tokens(1, B, S, cfg.d_model, skew)
    counts, C, cap_block = _counts_and_capacity(jcfg, jp, x, cf)
    if regime == "drops":
        assert counts.max() > C, (counts, C)
    else:
        assert counts.max() <= C, (counts, C)
    assert cap_block == (128 if regime == "cap_block_128" else 8)
    jy, jaux = JL.apply_moe(jcfg, jp, jnp.asarray(x), capacity_factor=cf)
    y, aux = L.apply_moe(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-4)


def test_moe_no_drop_matches_dense_reference():
    """As ``test_models.py``: with generous capacity, the sorted dispatch
    equals computing every expert on every token and weighting the top k."""
    _, cfg, _, p = _moe_setup()
    x = 0.1 * torch.from_numpy(_tokens(2, 2, 16, cfg.d_model))
    y, _ = L.apply_moe(cfg, p, x, capacity_factor=float(cfg.num_experts))
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], -1)
    w, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    dense = torch.stack([(torch.nn.functional.silu(xt @ p["wg"][e])
                          * (xt @ p["wi"][e])) @ p["wo"][e]
                         for e in range(cfg.num_experts)], 1)  # (T, E, D)
    sel = torch.gather(dense, 1, idx[..., None].expand(-1, -1, cfg.d_model))
    y_ref = (sel * w[..., None]).sum(1).reshape(x.shape)
    scale = float(y_ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5 * scale)


def test_apply_moe_over_a_mesh_raises():
    """Expert parallelism needs the experts to split evenly over the model
    ranks (the reference's ``E // model``); a mesh where they do not raises
    before any collective (the layer over real meshes:
    ``tests/test_torch_dist_gloo.py``)."""
    from repro_torch.dist.sharding import abstract_mesh
    _, cfg, _, p = _moe_setup()
    cfg = cfg.replace(sharding_profile="tp_ep")
    mdl = cfg.num_experts + 1
    with pytest.raises(ValueError, match="do not split"):
        L.apply_moe(cfg, p, torch.zeros(1, 4, cfg.d_model),
                    mesh=abstract_mesh((1, mdl), ("data", "model")))

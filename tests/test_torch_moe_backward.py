"""The gradient of the port's grouped matmul against the JAX package's.

The JAX package differentiates its plain einsum (``gmm_ref``); the port's
``gmm`` goes through ``GroupedMatmul`` whenever autograd records the call
or ``torch.func.vmap`` wraps its inputs, and on the CPU that Function's
backward is ``gmm_bwd_ref``.  Inputs come from numpy seeds; dy is nonzero
on the padding rows too, which the gradient must ignore.  Tolerances: f32
within 1e-5 of the largest gradient (the two frameworks' CPU einsums sum
up to F or C products in different orders; measured differences ~1e-7 of
it); bf16 within one bf16 step of the largest gradient (both round an f32
sum that agrees to ~1e-6).  Padding rows of dx and the dw of an empty
expert must be exactly 0.

Also here: the CPU rehearsals of ``chip_smoke.py``'s MoE phases (the
``kernel gmm_bwd`` phase, the router-size cases, ``train
qwen3-moe-30b-a3b-L4`` and the fused MoE population) at reduced widths,
with the plain versions counted as the wrappers count kernel launches.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build, count_launch  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm, gmm_bwd_ref, gmm_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import (  # noqa: E402
    GroupedMatmul,
    bwd_variant,
    gmm_bwd_cuda,
)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _inputs(seed, E, C, D, F, sizes):
    """x, w, dy as float32 numpy (dy nonzero on every row) and the sizes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal((E, D, F))).astype(np.float32)
    dy = rng.standard_normal((E, C, F)).astype(np.float32)
    return x, w, dy, np.asarray(sizes, np.int32)


def _jax_vjp(x, w, dy, sizes, dtype):
    """(out, dx, dw) of the JAX oracle by ``jax.vjp``, as float32 numpy."""
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b: jax_gmm_ref(a, b, jnp.asarray(sizes)),
                       jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    dx, dw = vjp(jnp.asarray(dy, jdt))
    return tuple(np.asarray(t, np.float32) for t in (out, dx, dw))


def _port_grads(x, w, dy, sizes, dtype):
    dt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(dt).requires_grad_(True)
    tw = torch.from_numpy(w).to(dt).requires_grad_(True)
    out = gmm(tx, tw, torch.from_numpy(sizes))
    assert type(out.grad_fn).__name__ == "GroupedMatmulBackward"
    out.backward(torch.from_numpy(dy).to(dt))
    assert tx.grad.dtype == dt and tw.grad.dtype == dt
    return tuple(t.detach().float().numpy() for t in (out, tx.grad, tw.grad))


def _close(got, want, dtype):
    tol = (F32_TOL if dtype == "float32" else BF16_TOL) * max(
        1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _zeros_where_dead(dx, dw, sizes):
    C = dx.shape[1]
    live = np.arange(C)[None, :] < sizes[:, None]
    assert (dx[~live] == 0).all()
    assert (dw[sizes == 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,sizes", [
    (5, 100, 200, 300, [0, 100, 37, 64, 1]),     # 0, C and in between
    (3, 8, 24, 40, [8, 0, 3]),                   # a decode-sized capacity
    (2, 70, 9, 13, [70, 69]),                    # depth and width not % 8
    (4, 16, 32, 48, [0, 0, 0, 0]),               # every expert empty
    (3, 12, 16, 8, [-2, 40, 5]),                 # sizes clipped to [0, C]
])
def test_gmm_grads_match_jax_vjp(E, C, D, F, sizes, dtype):
    x, w, dy, sz = _inputs(0, E, C, D, F, sizes)
    want = _jax_vjp(x, w, dy, sz, dtype)
    got = _port_grads(x, w, dy, sz, dtype)
    for g, wnt in zip(got, want):
        _close(g, wnt, dtype)
    _zeros_where_dead(got[1], got[2], np.clip(sz, 0, C))


def test_gmm_bwd_ref_is_the_autograd_of_gmm_ref():
    """The Function's plain backward equals torch autograd through the
    plain forward, bitwise on these f32 inputs."""
    x, w, dy, sz = _inputs(1, 4, 20, 24, 16, [20, 0, 7, 13])
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    gmm_ref(tx, tw, torch.from_numpy(sz)).backward(torch.from_numpy(dy))
    dx, dw = gmm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(sz), torch.from_numpy(dy))
    torch.testing.assert_close(dx, tx.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(dw, tw.grad, rtol=0, atol=1e-6)


def test_gmm_bwd_ref_finite_differences():
    """Central differences of L = <gmm_ref(x, w), dy> at sampled elements
    of x and w (padding rows among them).  L is bilinear, so a central
    difference is exact up to float32 rounding of L."""
    x, w, dy, sz = _inputs(2, 3, 6, 5, 4, [6, 2, 0])
    tx, tw, tdy, tsz = (torch.from_numpy(a) for a in (x, w, dy, sz))
    dx, dw = gmm_bwd_ref(tx, tw, tsz, tdy)

    def loss(a, b):
        return float((gmm_ref(a, b, tsz).double() * tdy.double()).sum())
    rng = np.random.default_rng(3)
    h = 0.5
    for t, g in ((tx, dx), (tw, dw)):
        for flat in rng.choice(t.numel(), 24, replace=False):
            idx = np.unravel_index(flat, t.shape)
            plus, minus = t.clone(), t.clone()
            plus[idx] += h
            minus[idx] -= h
            args = ((plus, tw), (minus, tw)) if t is tx else \
                ((tx, plus), (tx, minus))
            fd = (loss(*args[0]) - loss(*args[1])) / (2 * h)
            assert abs(fd - float(g[idx])) <= 1e-4 * max(1.0, abs(fd)), idx
    assert (dx[1, 2:] == 0).all() and (dx[2] == 0).all()
    assert (dw[2] == 0).all()


@pytest.mark.parametrize("w_batched", [True, False])
def test_gmm_vmap_matches_jax_vmap(w_batched):
    """``torch.func.vmap(gmm)`` over 3 members, forward and gradients,
    against ``jax.vmap`` of the oracle and its ``jax.vjp``; w shared by
    the members (not batched) gets their summed gradient.  The CPU
    launches no kernel."""
    rng = np.random.default_rng(4)
    N, E, C, D, F = 3, 4, 10, 12, 8
    x = rng.standard_normal((N, E, C, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal((N, E, D, F) if w_batched
                                   else (E, D, F))).astype(np.float32)
    dy = rng.standard_normal((N, E, C, F)).astype(np.float32)
    sizes = rng.integers(0, C + 1, (N, E)).astype(np.int32)
    sizes[0, 1] = 0
    w_dim = 0 if w_batched else None
    jf = jax.vmap(jax_gmm_ref, in_axes=(0, w_dim, 0))
    want, vjp = jax.vjp(lambda a, b: jf(a, b, jnp.asarray(sizes)),
                        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))

    before = dict(LAUNCHES)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = torch.func.vmap(gmm, in_dims=(0, w_dim, 0))(
        tx, tw, torch.from_numpy(sizes))
    out.backward(torch.from_numpy(dy))
    assert LAUNCHES == before
    for got, wnt in ((out.detach(), want), (tx.grad, want_dx),
                     (tw.grad, want_dw)):
        _close(got.numpy(), np.asarray(wnt), "float32")


def test_gmm_vmap_rule_folds_members_into_experts(monkeypatch):
    """The rule makes one call of the Function for all members, on the
    (N * E, ...) folded arguments, and its backward one call too."""
    calls = []
    fwd, bwd = gops.gmm_ref, gops.gmm_bwd_ref

    def fwd_counted(x, w, s):
        calls.append(("fwd", tuple(x.shape), tuple(w.shape), tuple(s.shape)))
        return fwd(x, w, s)

    def bwd_counted(x, w, s, dy):
        calls.append(("bwd", tuple(x.shape), tuple(w.shape), tuple(s.shape)))
        return bwd(x, w, s, dy)
    monkeypatch.setattr(gops, "gmm_ref", fwd_counted)
    monkeypatch.setattr(gops, "gmm_bwd_ref", bwd_counted)
    x = torch.randn(2, 3, 5, 4, requires_grad=True)
    w = torch.randn(2, 3, 4, 6, requires_grad=True)
    s = torch.tensor([[5, 0, 2], [1, 5, 3]], dtype=torch.int32)
    torch.func.vmap(gmm)(x, w, s).sum().backward()
    assert calls == [("fwd", (6, 5, 4), (6, 4, 6), (6,)),
                     ("bwd", (6, 5, 4), (6, 4, 6), (6,))]


def test_no_grad_skips_the_function():
    x, w, _, sz = _inputs(5, 2, 4, 3, 5, [4, 1])
    tx = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        out = gmm(tx, torch.from_numpy(w), torch.from_numpy(sz))
    assert out.grad_fn is None
    out = gmm(tx.detach(), torch.from_numpy(w), torch.from_numpy(sz))
    assert out.grad_fn is None


def test_backward_cuda_entry_needs_cuda_and_checks_dy():
    x, w, dy, sz = (torch.from_numpy(a) for a in
                    _inputs(6, 2, 4, 8, 8, [4, 1]))
    with pytest.raises(ValueError, match="needs CUDA"):
        gmm_bwd_cuda(x, w, sz, dy)
    # qwen3's train microbatch takes the wgmma kernels, f32 the CUDA cores
    assert bwd_variant(torch.bfloat16, 128, 80, 2048, 768) == "wgmma"
    assert bwd_variant(torch.float32, 128, 80, 2048, 768) == "f32"
    assert issubclass(GroupedMatmul, torch.autograd.Function)
    for name in ("gmm_bwd", "gmm_bwd.dx", "gmm_bwd.dw", "gmm_bwd.wgmma",
                 "gmm_bwd.mma_sync", "gmm_bwd.f32"):
        assert name in LAUNCHES
    src = _build._KERNELS_DIR / _build.SOURCES["gmm_bwd"]
    assert src.is_file() and src.name == "gmm_bwd.cu"
    path = _build.library_path("gmm_bwd")
    assert path.parent == _build.BUILD_DIR and "gmm_bwd" in path.name


@pytest.mark.parametrize("dtype,E,C,D,F,aligned,want", [
    ("bfloat16", 128, 80, 2048, 768, True, "wgmma"),     # qwen3's train
    ("bfloat16", 256, 80, 2048, 768, True, "wgmma"),     # fused, 2 members
    ("bfloat16", 8, 1280, 6144, 32768, True, "wgmma"),   # grok-1-314b
    ("bfloat16", 16, 100, 184, 520, True, "wgmma"),      # ragged_wgmma
    ("bfloat16", 4, 3, 8, 8, True, "wgmma"),             # no lower limit
    ("bfloat16", 5, 100, 200, 300, True, "mma_sync"),    # F % 8 != 0
    ("bfloat16", 5, 100, 204, 304, True, "mma_sync"),    # D % 8 != 0
    ("bfloat16", 128, 80, 2048, 768, False, "mma_sync"),  # misaligned
    ("bfloat16", 1025, 80, 2048, 768, True, "mma_sync"),  # E over the limit
    ("bfloat16", 1024, 80, 2048, 768, True, "wgmma"),     # E at the limit
    ("bfloat16", 2, 2 ** 28, 2 ** 11, 8, True, "mma_sync"),   # C*D = 2^39
    ("bfloat16", 2, 2 ** 28 - 1, 2 ** 11, 8, True, "wgmma"),  # just under
    ("bfloat16", 1, 8, 2 ** 20, 2 ** 19, True, "mma_sync"),   # D*F = 2^39
    ("float32", 128, 80, 2048, 768, True, "f32"),
    ("float32", 5, 100, 200, 300, False, "f32"),
])
def test_bwd_variant_rule(dtype, E, C, D, F, aligned, want):
    """``bwd_variant``'s rule: bf16 with D % 8 == F % 8 == 0, aligned
    pointers, at most ``MAX_WGMMA_EXPERTS`` experts and tensor-map strides
    under 2^40 bytes takes the wgmma kernels, other bf16 mma.sync, f32 the
    CUDA cores."""
    assert gops.MAX_WGMMA_EXPERTS == 1024
    assert bwd_variant(getattr(torch, dtype), E, C, D, F, aligned) == want


# ------------------------------------------------ chip_smoke rehearsals

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_cuda_calls(monkeypatch, chip_smoke):
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters, warmup=1: (fn(), 0.1)[1])
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, iters, warmup=1: (fn(), 0.1)[1])


def _count_plain_versions(monkeypatch):
    """The plain versions the wrappers and Functions call on the CPU count
    as the kernels' launches: flash (variant by head dim), gmm (variant by
    ``ops.variant``) and gmm's backward (dx, dw and the variant)."""
    from repro_torch.kernels.flash_attention import ops as fops

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
    counted(gops, "gmm_ref", lambda x, w, *_: (
        "gmm", "gmm." + gops.variant(x.dtype, x.shape[0], x.shape[1],
                                     x.shape[2], w.shape[2])))
    counted(gops, "gmm_bwd_ref", lambda x, w, *_: (
        "gmm_bwd", "gmm_bwd.dx", "gmm_bwd.dw",
        "gmm_bwd." + bwd_variant(x.dtype, x.shape[0], x.shape[1], x.shape[2],
                                 w.shape[2])))


def _reduced_moe(monkeypatch, name, layers):
    """A reduced qwen3-moe-30b-a3b registered as ``name``: bf16 compute,
    head_dim 64 (the card's flash variant), remat, 16 experts top-8 so
    that a 64-token microbatch routes C > 16 rows an expert (gmm's wgmma
    variant, as the card's C = 80)."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("qwen3-moe-30b-a3b"), layers=layers).replace(
        name=name, remat="full", dtype="bfloat16", head_dim=64,
        num_experts=16, experts_per_tok=8)
    monkeypatch.setitem(cfg_base._REGISTRY, name, cfg)
    return cfg


def _plain_gmm_bwd(x, w, s, dy, need_dx=True, need_dw=True):
    """``gmm_bwd_cuda``'s stand-in on the CPU: the plain backward, counted
    as the launches of the variant ``bwd_variant`` names."""
    E, C, D = x.shape
    count_launch("gmm_bwd",
                 f"gmm_bwd.{bwd_variant(x.dtype, E, C, D, w.shape[2])}",
                 *(["gmm_bwd.dx"] if need_dx else []),
                 *(["gmm_bwd.dw"] if need_dw else []))
    dx, dw = gmm_bwd_ref(x, w, s, dy)
    return dx if need_dx else None, dw if need_dw else None


def test_chip_smoke_gmm_bwd_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``kernel gmm_bwd`` phase on the CPU at small
    shapes, ``gmm_bwd_cuda`` standing in as the plain backward counted as
    its launches: every case passes the phase's own checks (its variant by
    ``bwd_variant``, the library's rule and the counters; tolerances,
    padding rows and empty experts 0, bitwise repeat, launches), a case
    with router sizes, every tail of the wgmma kernels and NaN padding
    rows among them; with ``--baseline`` (the plain backward again) each
    case also carries the baseline's time and checks."""
    chip_smoke = _chip_smoke()
    _no_cuda_calls(monkeypatch, chip_smoke)
    monkeypatch.setattr(gops, "gmm_bwd_cuda", _plain_gmm_bwd)
    monkeypatch.setattr(gops, "kernel_bwd_variant", gops.bwd_variant)
    monkeypatch.setattr(chip_smoke, "_baseline",
                        lambda name, path: path and _plain_gmm_bwd)
    monkeypatch.setattr(chip_smoke, "GMM_BWD_CASES", [
        dict(name="train_wi", E=8, C=16, D=32, F=24, route=(16, 4),
             dtype="bfloat16", variant="wgmma"),
        dict(name="fused", E=8, C=16, D=32, F=24, route=(16, 4), members=2,
             dtype="bfloat16", variant="wgmma"),
        dict(name="train_router", E=8, C=16, D=32, F=24, router="train",
             dtype="bfloat16", variant="wgmma"),
        dict(name="ragged_wgmma", E=8, C=10, D=16, F=24,
             sizes=[0, 1, 3, 9, 10, -3, 15, 5], dtype="bfloat16",
             variant="wgmma"),
        dict(name="nan_padding", E=8, C=16, D=32, F=24, route=(16, 4),
             nan_padding=True, dtype="bfloat16", variant="wgmma"),
        dict(name="ragged", E=5, C=10, D=20, F=30, sizes=[0, 10, 3, 6, 1],
             dtype="bfloat16", variant="mma_sync"),
        dict(name="empty", E=4, C=8, D=16, F=8, sizes=[0] * 4,
             dtype="bfloat16", variant="wgmma"),
        dict(name="f32", E=4, C=16, D=16, F=8, route=(16, 2),
             dtype="float32", variant="f32")])
    router = {"train": torch.tensor([16, 0, 3, 9, 16, 1, 7, 12],
                                    dtype=torch.int32)}
    before = dict(LAUNCHES)
    rows = chip_smoke.phase_kernel_gmm_bwd(torch.device("cpu"), router,
                                           baseline=ROOT / "chip_smoke.py")
    assert set(rows) == {"train_wi", "fused", "train_router", "ragged_wgmma",
                         "nan_padding", "ragged", "empty", "f32"}
    assert rows["train_router"]["live_rows"] == 64
    assert rows["ragged_wgmma"]["live_rows"] == 0 + 1 + 3 + 9 + 10 + 10 + 5
    for r in rows.values():
        assert r["ok"] and r["bitwise_repeat"] and r["dx_padding_rows_zero"]
        assert r["baseline"]["ok"] and r["baseline_ms"] is not None
        assert set(r) >= {"max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "variant"}
    assert {n: r["variant"] for n, r in rows.items()} == {
        "train_wi": "wgmma", "fused": "wgmma", "train_router": "wgmma",
        "ragged_wgmma": "wgmma", "nan_padding": "wgmma",
        "ragged": "mma_sync", "empty": "wgmma", "f32": "f32"}
    assert LAUNCHES["gmm_bwd.mma_sync"] > before["gmm_bwd.mma_sync"]
    assert rows["nan_padding"]["checks"]["dw"]["ok"]
    assert rows["fused"]["live_rows"] <= 2 * 16 * 4
    assert rows["empty"]["live_rows"] == 0


def test_chip_smoke_gmm_bwd_phase_rejects_a_wrong_variant(monkeypatch):
    """The phase fails a case whose variant the library's rule names
    otherwise than ``bwd_variant``, and a case the rule gives to another
    variant than the case states."""
    chip_smoke = _chip_smoke()
    _no_cuda_calls(monkeypatch, chip_smoke)
    monkeypatch.setattr(gops, "gmm_bwd_cuda", _plain_gmm_bwd)
    case = dict(name="train_wi", E=8, C=16, D=32, F=24, route=(16, 4),
                dtype="bfloat16", variant="wgmma")
    monkeypatch.setattr(chip_smoke, "GMM_BWD_CASES", [case])
    monkeypatch.setattr(gops, "kernel_bwd_variant",
                        lambda *a, **kw: "mma_sync")
    with pytest.raises(AssertionError, match="the library mma_sync"):
        chip_smoke.phase_kernel_gmm_bwd(torch.device("cpu"), {})
    monkeypatch.setattr(gops, "kernel_bwd_variant", gops.bwd_variant)
    monkeypatch.setitem(case, "variant", "mma_sync")
    with pytest.raises(AssertionError, match="the case mma_sync"):
        chip_smoke.phase_kernel_gmm_bwd(torch.device("cpu"), {})


def test_chip_smoke_router_sizes_rehearsal(monkeypatch):
    """``_router_sizes`` on a reduced qwen3 (16 experts top-8, the train
    phase's 4 x 1024 batch cut to 4 x 64): the layer-0 router's sizes of
    the whole batch and of its first row: at most its tokens times top-k
    assignments (capacity may drop some), none past the capacity C."""
    chip_smoke = _chip_smoke()
    _no_cuda_calls(monkeypatch, chip_smoke)
    cfg = _reduced_moe(monkeypatch, chip_smoke.ROUTER["arch"], 1)
    monkeypatch.setitem(chip_smoke.ROUTER, "seq", 64)
    sizes = chip_smoke._router_sizes(torch.device("cpu"))
    for name, tokens in (("serve", 4 * 64), ("train", 64)):
        s = sizes[name]
        assert s.shape == (cfg.num_experts,) and s.dtype == torch.int32
        k, E = cfg.experts_per_tok, cfg.num_experts
        block = 128 if tokens * k // E >= 128 else 8
        cap = max(block, -(-int(np.ceil(tokens * k / E * 1.25)) // block)
                  * block)
        assert int(s.sum()) <= tokens * k and int(s.max()) <= cap
        assert int(s.sum()) >= tokens * k * 0.5


def test_chip_smoke_moe_train_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``train qwen3-moe-30b-a3b-L4`` phase on the CPU
    at reduced widths (2 layers, 64 tokens, the config's 4 microbatches):
    exact gmm (forward twice a layer, remat), gmm_bwd (dx and dw once)
    and flash launches a step, every gmm forward on the wgmma variant; and
    the phase's comparison of one microbatch with ``impl="ref"``, the MoE
    leaves included, the plain run replaying the kernel run's routing;
    routed freely it routes alike here (the CPU's kernels are the plain
    versions)."""
    from repro_torch.launch import profile_train
    chip_smoke = _chip_smoke()
    spec = dict(next(s for s in chip_smoke.TRAIN_PHASES
                     if s.get("base") == "qwen3-moe-30b-a3b"))
    base = _reduced_moe(monkeypatch, "qwen3-moe-30b-a3b", 2)
    spec.update(arch="qwen3-moe-30b-a3b-Lrehearsal", layers=base.num_layers,
                launches=chip_smoke._launches(flash=(2, 4), moe=(2, 4)))
    monkeypatch.setitem(profile_train.TRAIN, "seq", 64)
    _count_plain_versions(monkeypatch)
    _no_cuda_calls(monkeypatch, chip_smoke)
    from repro_torch.configs import base as cfg_base
    try:
        row = chip_smoke.phase_train(torch.device("cpu"), spec)
    finally:
        cfg_base._REGISTRY.pop(spec["arch"], None)
    assert row["ok"], row
    assert all(s["launches"] == spec["launches"] for s in row["steps_run"])
    step = spec["launches"]
    assert step["gmm"] == step["gmm.wgmma"] == 2 * 3 * 2 * 4
    assert step["gmm_bwd.dx"] == step["gmm_bwd.dw"] == 3 * 2 * 4
    assert step["gmm_bwd.wgmma"] == step["gmm_bwd"] == 3 * 2 * 4
    assert {"layer0/moe/router", "layer0/moe/wi", "layer0/moe/wg",
            "layer0/moe/wo"} <= set(row["vs_ref"]["grad_rel_frobenius"])
    vs = row["vs_ref"]
    assert vs["gmm_calls"] == 3 * 2 and vs["same_group_sizes"]
    free = vs["free_routing"]
    assert free["assignments_routed_elsewhere"] == 0
    assert free["assignments"] == 2 * 64 * 8     # layers x tokens x top-k
    assert free["grad_rel_frobenius"] == vs["grad_rel_frobenius"]
    assert row["microbatches"] == 4


def test_chip_smoke_fused_moe_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s fused MoE population on the CPU (2 reduced
    qwen3 members of 1 layer, 64 tokens): a cycle launches one member's
    gmm and gmm_bwd counts for both members (the rule folds them), the
    swaps replay, no task mode."""
    from repro_torch.core import resource_handler
    chip_smoke = _chip_smoke()
    F = chip_smoke.FUSED_MOE
    _reduced_moe(monkeypatch, F["arch"], F["layers"])
    monkeypatch.setitem(F, "seq", 64)
    _count_plain_versions(monkeypatch)
    _no_cuda_calls(monkeypatch, chip_smoke)
    monkeypatch.setattr(resource_handler, "resolve_device",
                        lambda d: torch.device("cpu"))
    got = chip_smoke.phase_fused(torch.device("cpu"), F)
    per_cycle = chip_smoke._launches(flash=(1, 1), moe=(1, 1))
    assert got == {k: v * F["cycles"] for k, v in per_cycle.items()}
    assert per_cycle["gmm_bwd.dx"] == 3 and per_cycle["gmm"] == 6
    assert per_cycle["gmm_bwd.wgmma"] == 3

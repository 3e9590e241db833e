"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version;
it is held against the JAX Pallas kernel in interpret mode (block-aligned
cases, as ``test_pallas_kernels.py`` runs it) and against the JAX oracle
(ragged and single-query cases).  Inputs come from one numpy generator and
go to both packages.  Tolerances are those of ``test_pallas_kernels.py``:
3e-5 for f32 (sum order), 3e-2 for bf16 (one rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    HEAD_DIMS,
    MAX_GROUP,
    check_inputs,
    flash_attention_cuda,
    variant,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

DTYPES = [("float32", 3e-5), ("bfloat16", 3e-2)]


def _inputs(seed, B, Sq, Sk, H, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize(
    "B,Sq,Sk,H,KH,D,causal,window,cap,qoff",
    [(1, 256, 256, 4, 2, 32, True, 0, 0.0, 0),
     (2, 128, 128, 8, 4, 16, True, 64, 50.0, 0),
     (1, 256, 256, 2, 1, 32, False, 0, 0.0, 0),
     (1, 128, 384, 4, 2, 16, True, 0, 0.0, 256),
     (1, 128, 128, 6, 2, 64, True, 96, 30.0, 0),
     (1, 128, 384, 4, 4, 64, False, 0, 0.0, 0)])   # cross: Sq != Sk, MHA
def test_matches_jax_pallas_interpret(B, Sq, Sk, H, KH, D, causal, window,
                                      cap, qoff, dtype, atol):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(42, B, Sq, Sk, H, KH, D),
                                       dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     q_offset=qoff, impl="pallas_interpret")
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          softcap=cap, q_offset=qoff)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize(
    "B,Sq,Sk,H,KH,D,causal,window,cap,qoff,scale",
    [(2, 100, 100, 4, 2, 16, True, 30, 50.0, 0, None),      # ragged
     (2, 1, 512, 8, 4, 32, True, 0, 50.0, 511, 1.0 / 16),   # one query
     (1, 16, 16, 4, 2, 16, True, 0, 0.0, -5, None),         # masked rows
     (2, 24, 40, 2, 2, 64, False, 0, 0.0, 0, None),         # cross, MHA
     (1, 100, 100, 4, 4, 64, False, 0, 0.0, 0, None)])      # encoder
def test_matches_jax_oracle(B, Sq, Sk, H, KH, D, causal, window, cap, qoff,
                            scale, dtype, atol):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(7, B, Sq, Sk, H, KH, D),
                                       dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff,
              scale=scale)
    got = flash_attention(tq, tk, tv, **kw)
    _close(got, jax_ref(jq, jk, jv, **kw), atol)
    if qoff < 0:     # rows before the first key see nothing and give 0
        assert (got[:, :-qoff] == 0).all()


def test_segment_ids_match_jax_oracle():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(3, 2, 64, 64, 4, 2, 16),
                                       "float32")
    seg = np.repeat(np.arange(4), 16)[None].repeat(2, 0).astype(np.int32)
    got = flash_attention(tq, tk, tv, seg_q=torch.from_numpy(seg),
                          seg_kv=torch.from_numpy(seg))
    want = jax_ref(jq, jk, jv, seg_q=jnp.asarray(seg), seg_kv=jnp.asarray(seg))
    _close(got, want, 3e-5)


def test_cpu_tensors_take_the_plain_version():
    before = dict(LAUNCHES)
    _, (tq, tk, tv) = _both(_inputs(1, 1, 32, 32, 2, 1, 16), "float32")
    flash_attention(tq, tk, tv)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_cuda(tq, tk, tv)
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, impl="pallas")


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout", "heads",
                                 "group"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 16)
    check_inputs(q, k, v)
    if bad == "head_dim":
        q, k, v = q[..., :8].contiguous(), k[..., :8].contiguous(), \
            v[..., :8].contiguous()
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "layout":
        q = torch.zeros(1, 4, 8, 16).transpose(1, 2)
    elif bad == "heads":
        q = torch.zeros(1, 8, 3, 16)
    else:              # more q heads per kv head than a block folds
        q = torch.zeros(1, 8, 2 * (MAX_GROUP + 1), 16)
    with pytest.raises(ValueError):
        check_inputs(q, k, v)


def test_build_path_is_content_addressed(tmp_path, monkeypatch):
    path = _build.library_path("flash_attention_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("flash_attention_fwd")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    src = _build._KERNELS_DIR / _build.SOURCES["flash_attention_fwd"]
    header = _build._KERNELS_DIR / "common" / "hopper.cuh"
    assert header.resolve() in _build.source_files(src)
    # a copy of the kernels' sources: touching the header moves the path
    for rel in (_build.SOURCES["flash_attention_fwd"], "common/hopper.cuh"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes((_build._KERNELS_DIR / rel).read_bytes())
    monkeypatch.setattr(_build, "_KERNELS_DIR", tmp_path)
    before = _build.library_path("flash_attention_fwd")
    assert before.name == path.name
    with open(tmp_path / "common" / "hopper.cuh", "a") as f:
        f.write("// touched\n")
    assert _build.library_path("flash_attention_fwd") != before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 8, 10, 64])
def test_wrapper_takes_every_group_and_head_dim(G, D, dtype):
    """Every (G, D, dtype) the kernels are built for passes the wrapper's
    checks, and the variant rule names the kernel that takes it."""
    KH = 2
    q = torch.zeros(1, 3, G * KH, D, dtype=dtype)
    k = torch.zeros(1, 5, KH, D, dtype=dtype)
    check_inputs(q, k, k.clone())
    want = ("f32" if dtype == torch.float32 else
            "wgmma" if D >= 64 else "mma_sync")
    assert variant(dtype, D) == want


LOG2E = 1.4426950408889634


def _emulate_wgmma_kernel(q, k, v, *, causal, window, softcap, scale, bk,
                          tanh_err=0.0, seed=0):
    """The wgmma kernel's arithmetic in plain torch: per kv tile of ``bk``
    keys, f32 scores of the bf16 inputs in log2 units (log2 e folded into
    the scale, or into the softcap's output scale), online softmax with
    exp2, p rounded to bf16 before p.v, f32 m, l and acc.  ``tanh_err``
    adds an error of that size, of a random sign per score, to tanh."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5 if scale is None else scale
    gen = torch.Generator().manual_seed(seed)
    qf = q.float().reshape(B, Sq, KH, G, D).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(B, KH, Sq * G, D)            # row = position * G + head
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    qpos = torch.arange(Sq).repeat_interleave(G)[:, None]
    m = torch.full((B, KH, Sq * G, 1), float("-inf"))
    l = torch.zeros((B, KH, Sq * G, 1))
    acc = torch.zeros((B, KH, Sq * G, D))
    for k0 in range(0, Sk, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if softcap:
            t = torch.tanh(s * (scale / softcap))
            sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
            x = softcap * LOG2E * (t + tanh_err * sign)
        else:
            x = s * (scale * LOG2E)
        kp = torch.arange(k0, min(k0 + bk, Sk))[None, :]
        ok = torch.ones_like(qpos - kp, dtype=torch.bool)
        if causal:
            ok &= kp <= qpos
        if window:
            ok &= qpos - kp < window
        x = x.masked_fill(~ok, float("-inf"))
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        m_use = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
        m = mx
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), torch.zeros_like(acc))
    out = out.reshape(B, KH, Sq, G, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, D).to(torch.bfloat16)


# The wgmma kernel's tanh, 1 - 2 / (2^y + 1) from ex2.approx and rcp.approx,
# is within 1e-6 of tanh; the emulation adds that much.  (An error of the
# size of tanh.approx.f32's bound, about 2**-11, takes the softcap_saturated
# case past the tolerance.)
TANH_ERR = 1e-6


def test_kernel_tanh_is_within_its_error_bound():
    """tanh(y / (2 log2 e)) as the kernel forms it, in f32 with ex2 and rcp
    off by their PTX bounds (2**-22, 2**-23) either way, against tanh."""
    y = torch.linspace(-200.0, 200.0, 400_001, dtype=torch.float32)
    want = torch.tanh(y.double() / (2 * LOG2E))
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            e = (torch.exp2(y.double()) * (1 + s1 * 2.0 ** -22)).float()
            r = (1 / (e.double() + 1) * (1 + s2 * 2.0 ** -23)).float()
            got = 1 - 2 * r
            assert (got.double() - want).abs().max() < TANH_ERR


@pytest.mark.parametrize("against", ["port_ref", "jax_oracle"])
@pytest.mark.parametrize(
    "H,KH,D,cap,scale,window",
    [(4, 2, 256, 50.0, 1.0 / 16, 4096),       # gemma2-2b widths (G = 2)
     (8, 1, 128, 0.0, 128 ** -0.5, 0),        # qwen3-moe widths (G = 8)
     (4, 2, 256, 50.0, 2.0, 4096),            # scores past the softcap
     (6, 2, 64, 0.0, None, 0)])               # the smallest wgmma head dim
def test_wgmma_kernel_arithmetic_holds_bf16_tolerance(H, KH, D, cap, scale,
                                                       window, against):
    """p as one bf16 (no hi/lo split) and the kernel's tanh stay inside the
    bf16 tolerance, in kv tiles of the kernel's BK at D (Tile<D>::BK)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(11, 1, 256, 256, H, KH, D),
                                       "bfloat16")
    kw = dict(causal=True, window=window, softcap=cap, scale=scale)
    got = _emulate_wgmma_kernel(tq, tk, tv, bk=64 if D == 256 else 128,
                                tanh_err=TANH_ERR, **kw)
    if against == "port_ref":
        _close(got, attention_ref(tq, tk, tv, **kw).float(), 3e-2)
    else:
        _close(got, jax_ref(jq, jk, jv, **kw), 3e-2)

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
    check_inputs,
    flash_attention_cuda,
)

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
     (1, 128, 128, 6, 2, 64, True, 96, 30.0, 0)])
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
     (1, 16, 16, 4, 2, 16, True, 0, 0.0, -5, None)])        # masked rows
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


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout", "heads"])
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
    else:
        q = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        check_inputs(q, k, v)


def test_build_path_is_content_addressed():
    path = _build.library_path("flash_attention_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("flash_attention_fwd")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)

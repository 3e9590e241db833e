"""The port's flash-attention gradient against the JAX package's.

``attention_bwd_ref`` (the plain version the backward kernels are held to
on the card) is compared with ``jax.grad`` of the JAX oracle
(``repro.kernels.flash_attention.ref.attention_ref``) and of its chunked
``impl="xla"`` path, the gradient the JAX package trains with.  Inputs come
from one numpy generator and go to both packages; the loss is
``sum(o ** 2)``, as in ``tests/test_kernels.py``, so ``do = 2 o``.
Tolerances: 5e-4 for f32 gradients (that test's; summation order and the
chunked path's online softmax), bf16 as stated where it is used.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build, grad_required  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FlashAttention,
    bwd_variant,
    check_inputs,
    flash_attention_bwd_cuda,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_fwd_ref,
    attention_ref,
)
from repro_torch.kernels.mamba.ops import selective_scan  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import gmm  # noqa: E402
from repro_torch.kernels.rglru.ops import linear_scan  # noqa: E402

GRAD_ATOL = 5e-4
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py, the card's check, as a module (it imports no torch
    at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, B, Sq, Sk, H, KH, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))]


def _segments(seed, B, S, n):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, n, (B, S)), axis=1).astype(np.int32)


def _jax_grads(fn, arrays):
    loss = lambda q, k, v: (fn(q, k, v) ** 2).sum()  # noqa: E731
    return jax.grad(loss, argnums=(0, 1, 2))(*[jnp.asarray(a)
                                               for a in arrays])


def _port_grads(arrays, **kw):
    q, k, v = (torch.from_numpy(a) for a in arrays)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    return attention_bwd_ref(q, k, v, o, lse, 2 * o, **kw)


def _close(port, want, atol):
    for a, b in zip(port, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=atol)


@pytest.mark.parametrize("against", ["ref", "xla"])
def test_bwd_ref_matches_jax_grad(against):
    """The ``tests/test_kernels.py`` gradient case: B=1, S=128, H=4, KH=2,
    D=16, causal, window 48, softcap 30."""
    arrays = _inputs(0, 1, 128, 128, 4, 2, 16)
    kw = dict(causal=True, window=48, softcap=30.0)
    fn = (lambda q, k, v: jax_ref(q, k, v, **kw)) if against == "ref" else (
        lambda q, k, v: jax_flash(q, k, v, impl="xla", q_chunk=64,
                                  kv_chunk=64, **kw))
    _close(_port_grads(arrays, **kw), _jax_grads(fn, arrays), GRAD_ATOL)


@pytest.mark.parametrize("against", ["ref", "xla"])
@pytest.mark.parametrize("G,seg,q_offset,Sq,Sk,window,cap", [
    (1, 3, 0, 128, 128, 0, 0.0),      # segment ids, no GQA
    (2, 4, 0, 128, 128, 48, 30.0),    # segment ids, G = 2, window, softcap
    (4, 3, 0, 128, 128, 0, 50.0),     # segment ids, G = 4
    (2, 0, 64, 64, 128, 0, 0.0),      # q_offset: the q block at 64..127
    (4, 2, 64, 64, 128, 40, 0.0),     # q_offset with segments and window
])
def test_bwd_ref_matches_jax_grad_segments_gqa_offset(G, seg, q_offset, Sq,
                                                      Sk, window, cap,
                                                      against):
    KH = 2
    arrays = _inputs(1, 2, Sq, Sk, G * KH, KH, 16)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset)
    if seg:
        segs = _segments(2, 2, Sk, seg)
        sq_np, skv_np = segs[:, Sk - Sq:], segs
        kw_t = dict(kw, seg_q=torch.from_numpy(np.ascontiguousarray(sq_np)),
                    seg_kv=torch.from_numpy(skv_np))
        kw_j = dict(kw, seg_q=jnp.asarray(sq_np), seg_kv=jnp.asarray(skv_np))
    else:
        kw_t = kw_j = kw
    fn = (lambda q, k, v: jax_ref(q, k, v, **kw_j)) if against == "ref" else (
        lambda q, k, v: jax_flash(q, k, v, impl="xla", q_chunk=32,
                                  kv_chunk=32, **kw_j))
    _close(_port_grads(arrays, **kw_t), _jax_grads(fn, arrays), GRAD_ATOL)


@pytest.mark.parametrize("against", ["ref", "xla"])
@pytest.mark.parametrize("Sq,Sk", [(24, 40), (100, 100)])
def test_bwd_ref_matches_jax_grad_non_causal(Sq, Sk, against):
    """whisper's calls at a small width: cross-attention (Sq != Sk) and the
    encoder's self-attention, non-causal, MHA (G = 1), D = 64, no segment
    ids."""
    arrays = _inputs(5, 2, Sq, Sk, 2, 2, 64)
    kw = dict(causal=False, window=0, softcap=0.0)
    fn = (lambda q, k, v: jax_ref(q, k, v, **kw)) if against == "ref" else (
        lambda q, k, v: jax_flash(q, k, v, impl="xla", q_chunk=8,
                                  kv_chunk=8, **kw))
    _close(_port_grads(arrays, **kw), _jax_grads(fn, arrays), GRAD_ATOL)


@pytest.mark.parametrize("q_offset,seg", [(0, 3), (-5, 0), (16, 2)])
def test_fwd_ref_lse_matches_logsumexp_of_jax_scores(q_offset, seg):
    """lse: natural log, (B, H, Sq), -inf on fully masked rows (q_offset
    -5 puts the first 5 rows before every key)."""
    B, Sq, Sk, H, KH, D = 2, 32, 48, 4, 2, 16
    q, k, v = _inputs(3, B, Sq, Sk, H, KH, D)
    scale, cap = D ** -0.5, 30.0
    G = H // KH
    s = jnp.einsum("bqhgd,bkhd->bhgqk", jnp.asarray(q).reshape(B, Sq, KH, G, D),
                   jnp.asarray(k)) * scale
    s = jnp.tanh(s / cap) * cap
    qpos = q_offset + jnp.arange(Sq)[:, None]
    mask = (jnp.arange(Sk)[None, :] <= qpos)[None, None, None]
    kw = dict(causal=True, softcap=cap, q_offset=q_offset)
    if seg:
        segs = _segments(4, B, Sk, seg)
        mask = mask & (segs[:, Sk - Sq:, None] == segs[:, None, :])[
            :, None, None]
        kw.update(seg_q=torch.from_numpy(np.ascontiguousarray(
            segs[:, Sk - Sq:])), seg_kv=torch.from_numpy(segs))
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    want = np.asarray(want).reshape(B, H, Sq)
    _, lse = attention_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(lse.numpy()[live], want[live], atol=1e-5)
    if q_offset < 0:
        assert np.isneginf(lse.numpy()[:, :, :-q_offset]).all()


@pytest.mark.parametrize("seg", [0, 3])
def test_autograd_function_matches_torch_autograd_of_ref(seg):
    """On CPU tensors that require grad, flash_attention runs the
    autograd.Function (attention_fwd_ref + attention_bwd_ref); its
    gradients match torch.autograd through attention_ref, fully masked
    rows (q_offset -3) give zero gradients, and no kernel is counted."""
    arrays = _inputs(5, 2, 40, 40, 4, 2, 16)
    kw = dict(causal=True, window=9, softcap=30.0, q_offset=-3)
    if seg:
        s = torch.from_numpy(_segments(6, 2, 40, seg))
        kw.update(seg_q=s, seg_kv=s)
    before = dict(LAUNCHES)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    o = flash_attention(q, k, v, **kw)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        o.shape).astype(np.float32))
    got = torch.autograd.grad(o, (q, k, v), do)
    want_o = attention_ref(q, k, v, **kw)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert (got[0][:, :3] == 0).all()
    assert LAUNCHES == before


def test_no_grad_skips_the_function():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(8, 1, 16, 16, 2, 1, 16))
    with torch.no_grad():
        o = flash_attention(q, k, v)
    assert o.grad_fn is None
    o = flash_attention(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None


LOG2E = 1.4426950408889634


TILE = 64   # the wgmma backward's tile: 64 kv positions or folded q rows


def _dkdv_tiles(tk, Sq, BQ, causal, window):
    """The folded q tiles (first, count) that kv tile tk's dK/dV item
    streams (flash_attention_bwd.cu, ``dkdv_tiles``; q_offset 0)."""
    k0 = TILE * tk
    lo = k0 if causal else 0
    hi = min(Sq, k0 + TILE - 1 + window) if window > 0 else Sq
    return (lo // BQ, (hi - 1) // BQ - lo // BQ + 1) if lo < hi else (0, 0)


def _dq_tiles(tq, BQ, Sq, Sk, causal, window):
    """The kv tiles (first, count) that folded q tile tq's dQ item streams
    (``dq_tiles``; q_offset 0)."""
    q0 = tq * BQ
    end = min(Sk, min(q0 + BQ, Sq)) if causal else Sk
    begin = max(0, q0 - window + 1) if window > 0 else 0
    return ((begin // TILE, (end - 1) // TILE - begin // TILE + 1)
            if begin < end else (0, 0))


def _emulate_bwd_kernel(q, k, v, o, lse, do, *, causal, window, softcap,
                        scale, chain_factor=True, nchunk=1):
    """The wgmma backward kernel's arithmetic in plain torch: f32 scores of
    the bf16 inputs, P = exp2((s - lse) log2 e), Delta from the bf16 o and
    do, P and dS rounded to bf16 for their products, outputs rounded to
    bf16.  The sums run in the kernel's order: the G q heads of a kv head
    are folded into one operand (row = position * G + head, tiles of
    64 // G positions); dk and dv add the live folded q tiles of each
    64-position kv tile in f32, within each of ``nchunk`` contiguous chunks,
    and then the chunks' partials in chunk order; dq adds the live kv tiles
    of each folded q tile.  ``chain_factor=False`` leaves out the softcap's
    1 - t^2, a fault the card's check must catch."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    BQ = TILE // G
    qf = q.float().reshape(B, Sq, KH, G, D)
    dof = do.float().reshape(B, Sq, KH, G, D)
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    x = raw * scale
    chain = torch.full_like(x, scale)
    if softcap:
        t = torch.tanh(x / softcap)
        x = t * softcap
        if chain_factor:
            chain = chain * (1 - t * t)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= qpos - kpos < window
    lse5 = lse.reshape(B, KH, G, Sq)[..., None]
    p = torch.where(ok, torch.exp2((x - lse5) * LOG2E), torch.zeros_like(x))
    delta = (dof * o.float().reshape(B, Sq, KH, G, D)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta) * chain

    def fold(a):   # (B, KH, G, Sq, X) or (B, Sq, KH, G, X) -> (B, KH, Sq G, X)
        if a.shape[1] == KH:
            a = a.permute(0, 1, 3, 2, 4)
        else:
            a = a.permute(0, 2, 1, 3, 4)
        return a.reshape(B, KH, Sq * G, a.shape[-1])
    pb, dsb = fold(p.bfloat16().float()), fold(ds.bfloat16().float())
    qfold, dofold = fold(qf), fold(dof)
    dk = torch.zeros(B, Sk, KH, D)
    dv = torch.zeros(B, Sk, KH, D)
    for tk in range((Sk + TILE - 1) // TILE):
        kv = slice(TILE * tk, min(TILE * (tk + 1), Sk))
        first, n = _dkdv_tiles(tk, Sq, BQ, causal, window)
        sums_k, sums_v = [], []
        for c in range(nchunk):
            ak = torch.zeros(B, KH, kv.stop - kv.start, D)
            av = torch.zeros_like(ak)
            for tq in range(first + n * c // nchunk,
                            first + n * (c + 1) // nchunk):
                rows = slice(tq * BQ * G, min((tq + 1) * BQ, Sq) * G)
                ak = ak + dsb[:, :, rows, kv].transpose(2, 3) @ qfold[:, :, rows]
                av = av + pb[:, :, rows, kv].transpose(2, 3) @ dofold[:, :, rows]
            sums_k.append(ak)
            sums_v.append(av)
        for sums, out in ((sums_k, dk), (sums_v, dv)):
            total = sums[0]
            for part in sums[1:]:
                total = total + part
            out[:, kv] = total.permute(0, 2, 1, 3)
    dqf = torch.zeros(B, KH, Sq * G, D)
    kt = k.float().permute(0, 2, 1, 3)                      # (B, KH, Sk, D)
    for tq in range((Sq + BQ - 1) // BQ):
        rows = slice(tq * BQ * G, min((tq + 1) * BQ, Sq) * G)
        first, n = _dq_tiles(tq, BQ, Sq, Sk, causal, window)
        acc = torch.zeros(B, KH, rows.stop - rows.start, D)
        for tk in range(first, first + n):
            kv = slice(TILE * tk, min(TILE * (tk + 1), Sk))
            acc = acc + dsb[:, :, rows, kv] @ kt[:, :, kv]
        dqf[:, :, rows] = acc
    dq = dqf.reshape(B, KH, Sq, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, H, D)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _emulated_and_jax(H, KH, D, cap, scale, window, **emulate):
    """The emulated kernel's (dq, dk, dv) and jax.grad of the JAX oracle,
    on the same bf16 inputs (B=1, S=128, do = 2 o)."""
    arrays = [a.astype(np.float32) for a in _inputs(9, 1, 128, 128, H, KH, D)]
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
    kw = dict(causal=True, window=window, softcap=cap, scale=scale)
    o, lse = attention_fwd_ref(tq, tk, tv, **kw)
    got = _emulate_bwd_kernel(tq, tk, tv, o, lse, 2 * o,
                              scale=scale or D ** -0.5, **{
                                  k_: kw[k_] for k_ in ("causal", "window",
                                                        "softcap")},
                              **emulate)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = jax.grad(lambda q, k, v: (jax_ref(q, k, v, **kw).astype(
        jnp.float32) ** 2).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    return got, [torch.from_numpy(np.asarray(b, np.float32)) for b in want]


@pytest.mark.parametrize("H,KH,D,cap,scale,window", [
    (4, 2, 256, 50.0, 1.0 / 16, 0),      # gemma2-2b widths
    (4, 2, 256, 50.0, 2.0, 0),           # scores at the softcap
    (8, 1, 128, 0.0, 128 ** -0.5, 0),    # G = 8
    (4, 2, 64, 30.0, None, 40),
    (10, 1, 256, 0.0, 1.0 / 16, 0),      # G = 10: recurrentgemma's grouping
    (12, 2, 128, 0.0, 128 ** -0.5, 0),   # G = 6: nemotron / internvl / grok
    (4, 4, 64, 0.0, 1.0 / 8, 0),         # G = 1, D = 64: minicpm-2b
    (4, 2, 256, 0.0, 1.0 / 16, 48),      # gemma3-4b: window, no softcap
])
def test_bwd_kernel_arithmetic_holds_bf16_tolerance(H, KH, D, cap, scale,
                                                    window):
    """P and dS as one bf16 each for their products, summed in the wgmma
    kernel's order (folded heads; dk and dv whole and cut into 3 chunks),
    pass the backward phase's bf16 check of chip_smoke.py (``grad_check``:
    relative Frobenius distance and largest error) against jax.grad of the
    JAX oracle on the same bf16 inputs."""
    grad_check = _chip_smoke().grad_check
    for nchunk in (1, 3):
        got, want = _emulated_and_jax(H, KH, D, cap, scale, window,
                                      nchunk=nchunk)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            check = grad_check(a, b, "bfloat16")
            assert check["ok"], (nchunk, name, check)


@pytest.mark.parametrize("Sq,Sk", [(96, 150), (150, 150)])
def test_bwd_kernel_arithmetic_holds_bf16_tolerance_non_causal(Sq, Sk):
    """whisper's non-causal calls in the wgmma backward's tiling, at a
    small width: every folded q tile meets every kv tile, the last of which
    is ragged (150 = 2 * 64 + 22, as 1500 = 23 * 64 + 28), Sq != Sk for the
    cross-attention; dk and dv whole and in 3 chunks pass chip_smoke.py's
    bf16 check against jax.grad of the JAX oracle."""
    grad_check = _chip_smoke().grad_check
    arrays = _inputs(13, 1, Sq, Sk, 2, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
    kw = dict(causal=False, window=0, softcap=0.0)
    o, lse = attention_fwd_ref(tq, tk, tv, **kw)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = jax.grad(lambda q, k, v: (jax_ref(q, k, v, **kw).astype(
        jnp.float32) ** 2).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    want = [torch.from_numpy(np.asarray(b, np.float32)) for b in want]
    for nchunk in (1, 3):
        got = _emulate_bwd_kernel(tq, tk, tv, o, lse, 2 * o, scale=64 ** -0.5,
                                  nchunk=nchunk, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            check = grad_check(a, b, "bfloat16")
            assert check["ok"], (nchunk, name, check)


def test_bwd_check_catches_a_dropped_softcap_factor():
    """At scores near the softcap, a kernel that leaves out 1 - t^2 fails
    chip_smoke.py's check of dq and dk (dv does not involve it)."""
    grad_check = _chip_smoke().grad_check
    got, want = _emulated_and_jax(4, 2, 256, 50.0, 2.0, 0,
                                  chain_factor=False)
    for name, a, b in zip(("dq", "dk"), got, want):
        assert not grad_check(a, b, "bfloat16")["ok"], name
    assert grad_check(got[2], want[2], "bfloat16")["ok"]


def test_segment_id_checks():
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(2, 6, 2, 16)
    seg_q = torch.zeros(2, 8, dtype=torch.int32)
    seg_kv = torch.zeros(2, 6, dtype=torch.int32)
    check_inputs(q, k, k.clone(), seg_q, seg_kv)
    for bad_q, bad_kv in ((seg_q.long(), seg_kv), (seg_q, seg_kv[:, :5]),
                          (seg_q[:1], seg_kv), (seg_q, None),
                          (torch.zeros(8, 2, dtype=torch.int32).T, seg_kv)):
        with pytest.raises(ValueError):
            check_inputs(q, k, k.clone(), bad_q, bad_kv)
    with pytest.raises(ValueError, match="both"):
        flash_attention(q, k, k.clone(), seg_q=seg_q)


def test_backward_cuda_entry_needs_cuda_and_variants():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_bwd_cuda(q, k, k, q, lse, q)
    for D, want in ((16, "mma_sync"), (32, "mma_sync"), (64, "wgmma"),
                    (128, "wgmma"), (256, "wgmma")):
        assert bwd_variant(torch.bfloat16, D) == want
        assert bwd_variant(torch.float32, D) == "f32"
    assert _build.SOURCES["flash_attention_bwd"].endswith(
        "flash_attention_bwd.cu")
    src = _build._KERNELS_DIR / _build.SOURCES["flash_attention_bwd"]
    header = _build._KERNELS_DIR / "common" / "hopper.cuh"
    assert header.resolve() in _build.source_files(src)
    assert issubclass(FlashAttention, torch.autograd.Function)


def test_grad_required_predicate():
    """The check the wrappers make before a call: where it holds, flash
    attention, the two scans and gmm go through their
    ``autograd.Function``s (backward kernels on CUDA, plain backwards on
    the CPU)."""
    x = torch.zeros(2, 3)
    w = torch.zeros(2, 3, requires_grad=True)
    assert not grad_required(x, None, 3)
    assert grad_required(x, w)
    with torch.no_grad():
        assert not grad_required(x, w)
    with torch.inference_mode():
        assert not grad_required(torch.zeros(1))
    assert not grad_required(w.detach())


def test_scan_and_gmm_wrappers_differentiate_on_cpu():
    """On the CPU the three wrappers carry gradients (so the reduced scan
    and MoE archs train there): each through its Function's plain
    backward."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3)).astype(
        np.float32)).requires_grad_(True)
    a = torch.full((2, 5, 3), 0.9, requires_grad=True)
    y, _ = linear_scan(x, a, torch.zeros(2, 3))
    assert torch.autograd.grad(y.sum(), x)[0].abs().sum() > 0
    A = -torch.ones(3, 4)
    Bm = torch.ones(2, 5, 4)
    yy, _ = selective_scan(x, torch.full((2, 5, 3), 0.1), A, Bm, Bm,
                           torch.ones(3), torch.zeros(2, 3, 4))
    assert torch.autograd.grad(yy.sum(), x)[0].abs().sum() > 0
    xe = torch.ones(2, 4, 3, requires_grad=True)
    out = gmm(xe, torch.ones(2, 3, 5), torch.tensor([4, 2], dtype=torch.int32))
    assert torch.autograd.grad(out.sum(), xe)[0].abs().sum() > 0

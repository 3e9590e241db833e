"""The scans' gradients in the port on the CPU: ``linear_scan_bwd_ref`` and
``selective_scan_bwd_ref`` against ``jax.grad`` of the JAX package's plain
and XLA scans (the sweeps of ``tests/test_kernels.py``, a bfloat16 case and
a nonzero ``dh_last``); the ``LinearScan`` and ``SelectiveScan``
``autograd.Function``s by ``gradcheck`` in float64 and through their
``vmap`` rules (folded members, and per-member A and D); and one train step
of reduced recurrentgemma-2b and falcon-mamba-7b through those Functions
against the JAX step.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``'s ``kernel linear_scan_bwd`` and ``kernel
selective_scan_bwd`` phases).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.kernels.mamba.ops import selective_scan as jax_selective_scan  # noqa: E402
from repro.kernels.rglru.ops import linear_scan as jax_linear_scan  # noqa: E402
from repro.train import TrainHyper as JaxTrainHyper  # noqa: E402
from repro.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.mamba import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.mamba import (  # noqa: E402
    selective_scan,
    selective_scan_bwd_ref,
    selective_scan_ref,
)
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru import (  # noqa: E402
    linear_scan,
    linear_scan_bwd_ref,
    linear_scan_ref,
)
from repro_torch.models.convert import (  # noqa: E402
    train_state_from_numpy,
    train_state_to_flat,
)
from repro_torch.train import TrainHyper, build_train_step  # noqa: E402

RNG = np.random.default_rng(20)
# float32 against float32: reverse sums of up to 256 steps of terms up to
# ~1/(1 - a) in size, in another order than XLA's
F32_RTOL, F32_ATOL = 1e-4, 1e-4
STEP_RTOL, STEP_ATOL = 1e-5, 1e-5   # tests/test_torch_train.py's


def _f32(*shape, lo=None, hi=None):
    if lo is None:
        return RNG.standard_normal(shape).astype(np.float32)
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, rtol=F32_RTOL, atol=F32_ATOL, msg=""):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# ------------------------------------------------------------ linear scan

def _ls_inputs(B, T, C):
    return (_f32(B, T, C), _f32(B, T, C, lo=0.5, hi=0.999), _f32(B, C),
            _f32(B, T, C), _f32(B, C))


def _jax_ls_grads(x, a, h0, dy, dh, impl, chunk=512):
    def loss(x, a, h0):
        y, h = jax_linear_scan(x, a, h0, impl=impl, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    return jax.grad(loss, argnums=(0, 1, 2))(x, a, h0)


@pytest.mark.parametrize("impl", ["ref", "xla"])
@pytest.mark.parametrize("B,T,C,chunk", [(2, 256, 32, 64), (1, 128, 8, 128),
                                         (3, 64, 16, 16)])
def test_linear_scan_bwd_ref_matches_jax_grad(B, T, C, chunk, impl):
    x, a, h0, dy, dh = _ls_inputs(B, T, C)
    want = _jax_ls_grads(x, a, h0, dy, dh, impl, chunk)
    got = linear_scan_bwd_ref(_t(x), _t(a), _t(h0), _t(dy), _t(dh))
    for name, g, w in zip(("dx", "da", "dh0"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, msg=name)


def test_linear_scan_bwd_ref_bf16_and_zero_dh_last():
    """bf16 x and a: the gradients in bf16, within one bf16 step of the
    float32 gradient of the same (rounded) inputs; dh_last None is 0."""
    x, a, h0, dy, _ = _ls_inputs(2, 48, 24)
    xb, ab, dyb = (_t(v).to(torch.bfloat16) for v in (x, a, dy))
    got = linear_scan_bwd_ref(xb, ab, _t(h0), dyb, None)
    want = _jax_ls_grads(*(np.asarray(v.float()) for v in (xb, ab)), h0,
                         np.asarray(dyb.float()), np.zeros((2, 24),
                                                           np.float32), "ref")
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for name, g, w in zip(("dx", "da", "dh0"), got, want):
        scale = float(np.abs(np.asarray(w)).max())
        _close(g.float(), w, rtol=0, atol=2.0 ** -7 * scale + 1e-6, msg=name)


def test_linear_scan_function_gradcheck_f64():
    x, a, h0, _, _ = _ls_inputs(2, 7, 3)
    args = [torch.from_numpy(v.astype(np.float64)).requires_grad_(True)
            for v in (x, a, h0)]
    assert torch.autograd.gradcheck(lambda *t: linear_scan(*t), args)
    y, _ = linear_scan(*args)
    assert type(y.grad_fn).__name__.startswith("LinearScan")


def test_linear_scan_vmap_rule_folds_members():
    """Vmapped over 3 members the Function makes one call for all (the
    folded batch) and equals a loop of per-member calls in value and
    gradient."""
    n = 3
    x, a, h0, dy, dh = (torch.from_numpy(np.stack([v] * n) + 0.01 * _f32(
        n, *v.shape)) for v in _ls_inputs(2, 20, 5))
    x.requires_grad_(True)
    a = a.clamp(0.5, 0.999).requires_grad_(True)
    h0.requires_grad_(True)
    calls = []
    orig = rglru_ops.linear_scan_ref

    def counted(*args):
        calls.append(args[0].shape)
        return orig(*args)
    rglru_ops.linear_scan_ref = counted
    try:
        y, h = torch.func.vmap(linear_scan)(x, a, h0)
    finally:
        rglru_ops.linear_scan_ref = orig
    assert calls == [(n * 2, 20, 5)]
    grads = torch.autograd.grad((y, h), (x, a, h0), (dy, dh))
    outs = [linear_scan(x[i], a[i], h0[i]) for i in range(n)]
    yl, hl = torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    loop = torch.autograd.grad((yl, hl), (x, a, h0), (dy, dh))
    torch.testing.assert_close(y, yl, rtol=0, atol=0)
    for g, w in zip(grads, loop):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ------------------------------------------------------- selective scan

def _ss_inputs(B, T, d, n):
    return (_f32(B, T, d), _f32(B, T, d, lo=1e-3, hi=0.1),
            -_f32(d, n, lo=0.5, hi=2.0), _f32(B, T, n), _f32(B, T, n),
            _f32(d), _f32(B, d, n), _f32(B, T, d), _f32(B, d, n))


def _jax_ss_grads(x, dt, A, Bm, C, D, h0, dy, dh, impl, chunk=256):
    def loss(*args):
        y, h = jax_selective_scan(*args, impl=impl, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    return jax.grad(loss, argnums=tuple(range(7)))(x, dt, A, Bm, C, D, h0)


SS_NAMES = ("dx", "ddt", "dA", "dBm", "dC", "dD", "dh0")


@pytest.mark.parametrize("impl", ["ref", "xla"])
@pytest.mark.parametrize("B,T,d,n,chunk", [(2, 128, 16, 4, 32),
                                           (1, 64, 8, 8, 64),
                                           (2, 96, 4, 2, 32)])
def test_selective_scan_bwd_ref_matches_jax_grad(B, T, d, n, chunk, impl):
    args = _ss_inputs(B, T, d, n)
    want = _jax_ss_grads(*args, impl, chunk)
    got = selective_scan_bwd_ref(*(_t(v) for v in args))
    for name, g, w in zip(SS_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == np.shape(w)
        _close(g, w, msg=name)


def test_selective_scan_bwd_ref_bf16_and_zero_dh_last():
    """bf16 x, Bm, C, dy (as the model gives them): dx, dBm, dC come back in
    bf16 within one bf16 step of the float32 gradient of the same rounded
    inputs, the rest float32 and close; dh_last None is 0."""
    x, dt, A, Bm, C, D, h0, dy, _ = _ss_inputs(2, 40, 12, 16)
    xb, Bb, Cb, dyb = (_t(v).to(torch.bfloat16) for v in (x, Bm, C, dy))
    got = selective_scan_bwd_ref(xb, _t(dt), _t(A), Bb, Cb, _t(D), _t(h0),
                                 dyb, None)
    r = [np.asarray(v.float()) for v in (xb, Bb, Cb, dyb)]
    want = _jax_ss_grads(r[0], dt, A, r[1], r[2], D, h0, r[3],
                         np.zeros_like(h0), "ref")
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32,
                                      torch.float32]
    for name, g, w in zip(SS_NAMES, got, want):
        if g.dtype == torch.bfloat16:
            scale = float(np.abs(np.asarray(w)).max())
            _close(g.float(), w, rtol=0, atol=2.0 ** -7 * scale + 1e-6,
                   msg=name)
        else:
            _close(g, w, msg=name)


def test_selective_scan_function_gradcheck_f64():
    x, dt, A, Bm, C, D, h0, _, _ = _ss_inputs(2, 5, 3, 2)
    args = [torch.from_numpy(v.astype(np.float64)).requires_grad_(True)
            for v in (x, dt, A, Bm, C, D, h0)]
    assert torch.autograd.gradcheck(lambda *t: selective_scan(*t), args)
    y, _ = selective_scan(*args)
    assert type(y.grad_fn).__name__.startswith("SelectiveScan")


@pytest.mark.parametrize("per_member_weights", [False, True])
def test_selective_scan_vmap_rule(per_member_weights):
    """Vmapped over 3 members: with shared A and D one call takes the folded
    batch; with per-member A and D (as a fused ensemble's members hold
    them) one call a member.  Both equal a loop of per-member calls in
    value and gradient."""
    n, B, T, d, s = 3, 2, 9, 4, 3
    base = _ss_inputs(B, T, d, s)[:7]
    stacked = [torch.from_numpy(np.stack([v] * n) + 0.01 * _f32(n, *v.shape))
               for v in base]
    stacked[1] = stacked[1].abs()
    if not per_member_weights:
        stacked[2], stacked[5] = _t(base[2]), _t(base[5])
    for t in stacked:
        t.requires_grad_(True)
    dims = tuple(None if (not per_member_weights and i in (2, 5)) else 0
                 for i in range(7))
    calls = []
    orig = mamba_ops.selective_scan_ref

    def counted(*args):
        calls.append(args[0].shape)
        return orig(*args)
    mamba_ops.selective_scan_ref = counted
    try:
        y, h = torch.func.vmap(selective_scan, in_dims=dims)(*stacked)
    finally:
        mamba_ops.selective_scan_ref = orig
    assert calls == ([(B, T, d)] * n if per_member_weights
                     else [(n * B, T, d)])
    dy = torch.from_numpy(_f32(n, B, T, d))
    dh = torch.from_numpy(_f32(n, B, d, s))
    grads = torch.autograd.grad((y, h), stacked, (dy, dh))
    outs = [selective_scan(*(t if dd is None else t[i]
                             for t, dd in zip(stacked, dims)))
            for i in range(n)]
    yl = torch.stack([o[0] for o in outs])
    hl = torch.stack([o[1] for o in outs])
    loop = torch.autograd.grad((yl, hl), stacked, (dy, dh))
    torch.testing.assert_close(y, yl, rtol=0, atol=1e-6)
    for name, g, w in zip(SS_NAMES, grads, loop):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_backward_wrappers_need_cuda_tensors():
    """The kernels' launchers take CUDA tensors only (no fallback)."""
    x, a, h0, dy, dh = (_t(v) for v in _ls_inputs(1, 4, 2))
    with pytest.raises(ValueError, match="needs CUDA"):
        rglru_ops.linear_scan_bwd_cuda(x, a, h0, x, dy, dh)
    args = [_t(v) for v in _ss_inputs(1, 4, 2, 2)]
    ckpt = torch.zeros(1, 1, 2, 2)
    with pytest.raises(ValueError, match="needs CUDA"):
        mamba_ops.selective_scan_bwd_cuda(*args[:7], ckpt, *args[7:])


# ------------------------------------ mirrors of the backward kernels' schedules
#
# The CUDA kernels run only on the card.  These plain-PyTorch mirrors follow
# their schedules step for step at small sizes (test code; nothing on the
# main path calls them), so the algebra of each schedule is held here
# against the plain gradients and the JAX package's.

LS_CHUNK, LS_CHUNKS = 16, 8      # linear_scan_chunked.cuh: kL, kChunks


def _linear_scan_bwd_chunked(x, a, h0, dy, dh_last):
    """linear_scan_bwd.cu's chunked reverse scan: segments of LS_CHUNKS
    chunks of LS_CHUNK steps, the last segment first; each chunk's carry
    out L from a carry of 0 and its product of a's P; each chunk's carry in
    folded from the segment's carry over the later chunks, last first; the
    chunk rerun from it.  float32, states recomputed in float32."""
    xf, af, dyf = x.float(), a.float(), dy.float()
    B, T, C = x.shape
    h = h0.float()
    hs = torch.empty_like(xf)
    for t in range(T):
        h = af[:, t] * h + xf[:, t]
        hs[:, t] = h
    hprev = torch.cat([h0.float()[:, None], hs[:, :-1]], 1)
    dx, da = torch.empty_like(xf), torch.empty_like(xf)
    carry = dh_last.float().clone()
    seg = LS_CHUNK * LS_CHUNKS
    for s0 in reversed(range(0, T, seg)):
        chunks = [(t0, min(t0 + LS_CHUNK, T))
                  for t0 in range(s0, min(s0 + seg, T), LS_CHUNK)]
        LP = []
        for t0, t1 in chunks:                       # 1. from a carry of 0
            L, P = torch.zeros_like(carry), torch.ones_like(carry)
            for t in reversed(range(t0, t1)):
                L = af[:, t] * (dyf[:, t] + L)
                P = P * af[:, t]
            LP.append((L, P))
        cin = [None] * len(chunks)
        c = carry
        for j in reversed(range(len(chunks))):      # 2. fold, last first
            cin[j] = c
            c = LP[j][1] * c + LP[j][0]
        for (t0, t1), cr in zip(chunks, cin):       # 3. rerun
            for t in reversed(range(t0, t1)):
                g = dyf[:, t] + cr
                dx[:, t], da[:, t] = g, g * hprev[:, t]
                cr = af[:, t] * g
        carry = c
    return dx.to(x.dtype), da.to(a.dtype), carry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,C", [(2, 300, 40), (1, 256, 33), (3, 7, 5)])
def test_linear_scan_bwd_chunked_schedule(B, T, C, dtype):
    """The chunked reverse scan (ragged T: a partial last segment and
    chunk) against linear_scan_bwd_ref and jax.grad of the reference."""
    x, a, h0, dy, dh = _ls_inputs(B, T, C)
    dt = getattr(torch, dtype)
    xt, at, dyt = (_t(v).to(dt) for v in (x, a, dy))
    got = _linear_scan_bwd_chunked(xt, at, _t(h0), dyt, _t(dh))
    ref = linear_scan_bwd_ref(xt, at, _t(h0), dyt, _t(dh))
    want = _jax_ls_grads(*(np.asarray(v.float()) for v in (xt, at)), h0,
                         np.asarray(dyt.float()), dh, "ref")
    for name, g, r, w in zip(("dx", "da", "dh0"), got, ref, want):
        assert g.dtype == r.dtype
        if g.dtype == torch.bfloat16:
            scale = float(np.abs(np.asarray(w)).max())
            _close(g.float(), w, rtol=0, atol=2.0 ** -7 * scale + 1e-6,
                   msg=name)
            _close(g.float(), r.float(), rtol=0,
                   atol=2.0 ** -7 * scale + 1e-6, msg=name)
        else:
            _close(g, w, msg=name)
            _close(g, r, msg=name)


SS_CH, SS_LANES, SS_NP, SS_K = 128, 4, 16, 8    # selective_scan_bwd.cu
SS_WARP_CH = 32 // SS_LANES                      # channels a warp


def _warp_tree(v):
    """Sum over axis -1 of 8 channels (a warp's) as the kernel's shuffles
    group them: pairs differing in channel bit 2, then bit 1, then bit 0."""
    v = v[..., :4] + v[..., 4:]
    v = v[..., :2] + v[..., 2:]
    return v[..., 0] + v[..., 1]


def _selective_scan_bwd_lanes(x, dt, A, Bm, C, D, h0, dy, dh_last):
    """selective_scan_bwd.cu's schedule in float32.  n padded to 16; each
    channel's states on 4 lanes of 4, lane q's slot s holding state
    4 q + (s ^ p), p = (channel in its warp >> 1) & 3; checkpoints every 8
    steps; per chunk, last first, the states recomputed from the
    checkpoint with every exponential evaluated once and kept for the
    reverse pass; dx, ddt from each lane's slot-ordered sums added over the
    4 lanes as (q0 + q1) + (q2 + q3); dBm, dC over a warp's 8 channels by
    the shuffle tree, the block's 16 warps in order, then the blocks in
    order; dA, dD over T in registers, then the batch rows in order.
    Returns the gradients and the number of exponentials evaluated."""
    B, T, d = x.shape
    n = A.shape[1]
    K, NP = SS_K, SS_NP
    dp = -(-d // SS_CH) * SS_CH
    Tp = -(-T // K) * K

    def pad(v, shape):
        out = torch.zeros(shape)
        out[tuple(slice(0, s) for s in v.shape)] = v.float()
        return out
    xf, dtf, dyf = (pad(v, (B, Tp, dp)) for v in (x, dt, dy))
    Bf, Cf = pad(Bm, (B, Tp, NP)), pad(C, (B, Tp, NP))
    A2 = pad(A, (dp, NP)) * 1.4426950408889634
    Df = pad(D, (dp,))
    h = pad(h0, (B, dp, NP))
    g = pad(dh_last, (B, dp, NP))
    # the forward's checkpoints: the state before steps 0, K, 2K, ...
    ckpt = []
    for t in range(Tp):
        if t % K == 0:
            ckpt.append(h.clone())
        e = torch.exp2(dtf[:, t, :, None] * A2)
        h = e * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
    # slot layout: (B, dp, lane q, slot s) <- state perm[ch, q, s]
    cl = torch.arange(dp) % SS_CH
    p = ((cl % SS_WARP_CH) >> 1) & 3
    perm = (4 * torch.arange(SS_LANES)[None, :, None]
            + (torch.arange(4)[None, None, :] ^ p[:, None, None]))

    def slots(v):       # (..., dp, NP) -> (..., dp, 4, 4)
        idx = perm.expand(*v.shape[:-2], dp, 4, 4).reshape(
            *v.shape[:-2], dp, NP)
        return torch.gather(v, -1, idx).reshape(*v.shape[:-1], 4, 4)

    def unslot(v):      # (..., dp, 4, 4) -> (..., dp, NP)
        out = torch.empty(*v.shape[:-2], NP)
        idx = perm.expand(*v.shape[:-3], dp, 4, 4).reshape(
            *v.shape[:-3], dp, NP)
        return out.scatter_(-1, idx, v.reshape(*v.shape[:-2], NP))
    A2s, g = slots(A2), slots(g)
    dA = torch.zeros(B, dp, 4, 4)
    dD = torch.zeros(B, dp)
    dx, ddt = torch.empty(B, Tp, dp), torch.empty(B, Tp, dp)
    dB, dC = torch.empty(B, Tp, NP), torch.empty(B, Tp, NP)
    n_exp = 0
    nblk, nw = dp // SS_CH, SS_CH // SS_WARP_CH
    for c in reversed(range(Tp // K)):
        h = slots(ckpt[c])
        hs, es = [], []
        for u in range(K):                    # recompute, exps kept
            t = c * K + u
            hs.append(h)
            es.append(torch.exp2(dtf[:, t, :, None, None] * A2s))
            n_exp += es[-1].numel()
            bb = slots(Bf[:, t, None, :].expand(B, dp, NP))
            h = es[-1] * h + (dtf[:, t] * xf[:, t])[..., None, None] * bb
        for u in reversed(range(K)):          # reverse, the same exps
            t = c * K + u
            dyv, dtv, xv = (v[:, t, :, None, None] for v in (dyf, dtf, xf))
            bb = slots(Bf[:, t, None, :].expand(B, dp, NP))
            cc = slots(Cf[:, t, None, :].expand(B, dp, NP))
            hp = hs[u]
            g = dyv * cc + g
            vC, vB = dyv * h, g * (dtv * xv)
            ge = g * es[u]
            ghe = ge * hp
            dA = ghe * dtv + dA
            gea = (ghe * A2s).cumsum(-1)[..., -1]     # slot order
            gb = (g * bb).cumsum(-1)[..., -1]
            gea = (gea[..., 0] + gea[..., 1]) + (gea[..., 2] + gea[..., 3])
            gb = (gb[..., 0] + gb[..., 1]) + (gb[..., 2] + gb[..., 3])
            g, h = ge, hp
            dD = dyv[..., 0, 0] * xv[..., 0, 0] + dD
            dx[:, t] = gb * dtv[..., 0, 0] + Df * dyv[..., 0, 0]
            ddt[:, t] = gea * 0.6931471805599453 + gb * xv[..., 0, 0]
            for kind, v, out in ((0, vB, dB), (1, vC, dC)):
                w = _warp_tree(unslot(v).reshape(
                    B, nblk, nw, SS_WARP_CH, NP).transpose(-1, -2))
                blk = torch.zeros(B, nblk, NP)
                for j in range(nw):                  # the block's warps
                    blk = blk + w[:, :, j]
                tot = torch.zeros(B, NP)
                for j in range(nblk):                # the blocks
                    tot = tot + blk[:, j]
                out[:, t] = tot
    dA, dh0 = unslot(dA), unslot(g)
    dAs, dDs = torch.zeros(dp, NP), torch.zeros(dp)
    for b in range(B):                               # the batch rows
        dAs, dDs = dAs + dA[b], dDs + dD[b]
    grads = (dx[:, :T, :d].to(x.dtype), ddt[:, :T, :d],
             dAs[:d, :n], dB[:, :T, :n].to(Bm.dtype),
             dC[:, :T, :n].to(C.dtype), dDs[:d], dh0[:, :d, :n])
    return grads, n_exp


@pytest.mark.parametrize("B,T,d,n", [(2, 40, 136, 12), (1, 32, 128, 16),
                                     (2, 9, 20, 5)])
def test_selective_scan_bwd_lane_schedule(B, T, d, n):
    """The lane split of the states with its fixed-order sums and the
    exponentials kept from the recompute (ragged T and d, n = 12) against
    selective_scan_bwd_ref and jax.grad of the reference; it evaluates
    B * T * d * 16 exponentials (padded), once each."""
    args = _ss_inputs(B, T, d, n)
    got, n_exp = _selective_scan_bwd_lanes(*(_t(v) for v in args))
    assert n_exp == B * (-(-T // SS_K) * SS_K) * (-(-d // SS_CH) * SS_CH) \
        * SS_NP
    ref = selective_scan_bwd_ref(*(_t(v) for v in args))
    want = _jax_ss_grads(*args, "ref")
    for name, g, r, w in zip(SS_NAMES, got, ref, want):
        assert g.shape == r.shape == np.shape(w)
        _close(g, w, msg=name)
        _close(g, r, msg=name)


def test_selective_scan_bwd_lane_permutation_covers_states():
    """Each channel's 4 lanes x 4 slots hold its 16 states once, and after
    the shuffles a warp's 32 lanes hold the 32 (kind, state) sums once:
    lane bit 2 picks the kind, state 4 q + p."""
    for cl in range(SS_CH):
        p = ((cl % SS_WARP_CH) >> 1) & 3
        held = sorted(4 * q + (s ^ p) for q in range(4) for s in range(4))
        assert held == list(range(SS_NP))
    slots = sorted(((lane >> 2) & 1) * SS_NP + 4 * (lane & 3)
                   + ((lane >> 3) & 3) for lane in range(32))
    assert slots == list(range(2 * SS_NP))


# ------------------------------------------- train steps through the Functions

def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.mark.parametrize("arch,bwd", [
    ("recurrentgemma-2b", (rglru_ops, "linear_scan_bwd_ref")),
    ("falcon-mamba-7b", (mamba_ops, "selective_scan_bwd_ref"))])
def test_train_step_through_the_functions_matches_jax(arch, bwd, monkeypatch):
    """One train step (microbatches 2, remat on) of a reduced scan arch from
    the JAX state: the scans' backward runs in their Functions (counted at
    the plain backward they call on the CPU: one a scan layer and
    microbatch), and loss, grad norm and every leaf after the step agree
    with the JAX step."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(microbatches=2,
                                                     remat="full")
    jstate = jax_make_train_state(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    hyper = dict(warmup=1, total_steps=10)
    jstep = jax.jit(jax_build_train_step(jcfg, hyper=JaxTrainHyper(**hyper)))
    jstate, jm = jstep(jstate, JaxSyntheticLM(
        jcfg, JaxShapeSpec("t", "train", 32, 4)).batch_at(0))

    cfg = _port_cfg(jcfg)
    module, name = bwd
    calls = []
    orig = getattr(module, name)

    def counted(*args):
        calls.append(1)
        return orig(*args)
    monkeypatch.setattr(module, name, counted)
    before = dict(LAUNCHES)
    state = train_state_from_numpy(flat, cfg)
    state, m = build_train_step(cfg, TrainHyper(**hyper))(
        state, SyntheticLM(cfg, ShapeSpec("t", "train", 32, 4),
                           device="cpu").batch_at(0))
    kind = "rec" if arch.startswith("recurrent") else "mamba"
    n_scan = sum(cfg.layer_kind(i) == kind for i in range(cfg.num_layers))
    assert len(calls) == n_scan * 2
    assert LAUNCHES == before        # the CPU launches no kernel
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=key)
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(jstate).items()}
    got = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
           for k, v in train_state_to_flat(state, cfg).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL,
                                   err_msg=k)


def test_plain_forwards_unchanged_by_the_functions():
    """Through the Functions (grad recorded) the forward values are the
    plain versions' bitwise."""
    x, a, h0, _, _ = (_t(v) for v in _ls_inputs(2, 16, 8))
    want = linear_scan_ref(x, a, h0)
    got = linear_scan(x.requires_grad_(True), a, h0)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    args = [_t(v) for v in _ss_inputs(2, 16, 8, 4)[:7]]
    want = selective_scan_ref(*args)
    args[0].requires_grad_(True)
    got = selective_scan(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "falcon-mamba-7b"])
def test_chip_smoke_train_phase_rehearsal(arch, monkeypatch):
    """``chip_smoke.py``'s ``train`` phase of a scan arch on the CPU at
    reduced widths (remat, bf16 compute, head_dim 64; 64 tokens): the plain
    versions the Functions call are counted as the wrappers count kernel
    launches, so the phase's exact counts a step (forward twice, backward
    once, a scan layer and microbatch; flash on the local layers) and its
    check of one microbatch against ``impl="ref"`` pass."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import profile_train

    root = Path(__file__).resolve().parents[1]
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(chip_smoke)
    spec = dict(next(s for s in chip_smoke.TRAIN_PHASES
                     if s.get("base", s["arch"]) == arch))
    cfg = reduced(get_config(arch), layers=6 if arch.startswith("rec")
                  else 3).replace(name=arch, remat="full", dtype="bfloat16",
                                  head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
    if "base" in spec:
        spec.update(arch=f"{arch}-Lrehearsal", layers=cfg.num_layers)
    mbs = spec.get("microbatches", profile_train.TRAIN["microbatches"])
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    per = {"flash": (kinds.count("local") + kinds.count("global"), mbs),
           "rec": (kinds.count("rec"), mbs),
           "mamba": (kinds.count("mamba"), mbs)}
    spec["launches"] = chip_smoke._launches(
        **{k: v for k, v in per.items() if v[0]})
    monkeypatch.setitem(profile_train.TRAIN, "seq", 64)

    def counted(module, attr, *names, variant=False):
        fn = getattr(module, attr)

        def run(*a, **kw):
            extra = ([f"{names[0]}.{fops.variant(a[0].dtype, a[0].shape[-1])}"]
                     if variant else [])
            count_launch(*names, *extra)
            return fn(*a, **kw)
        monkeypatch.setattr(module, attr, run)
    counted(fops, "attention_fwd_ref", "flash_attention", variant=True)
    counted(fops, "attention_ref", "flash_attention", variant=True)
    counted(fops, "attention_bwd_ref", "flash_attention_bwd", variant=True)
    counted(rglru_ops, "linear_scan_ref", "linear_scan")
    counted(rglru_ops, "linear_scan_bwd_ref", "linear_scan_bwd")
    counted(mamba_ops, "selective_scan_ref", "selective_scan")
    counted(mamba_ops, "selective_scan_bwd_ref", "selective_scan_bwd")
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    try:
        row = chip_smoke.phase_train(torch.device("cpu"), spec)
    finally:
        cfg_base._REGISTRY.pop(f"{arch}-Lrehearsal", None)
    assert row["ok"]
    assert all(s["launches"] == spec["launches"] for s in row["steps_run"])

"""The fused ensemble and the on-device exchange of the port
(``repro_torch.core.ensemble``, ``re.exchange`` with ``device``) against the
JAX package's on the CPU: the Metropolis swap on the reference's own
uniforms, the exchange task's float64 application, ``FusedEnsemble`` from
the same ensemble state (carried across by ``models.convert``) with and
without remat, and the flash-attention ``vmap`` rule that folds the member
axis into the kernel's batch.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.core.ensemble import FusedEnsemble as JaxFusedEnsemble  # noqa: E402
from repro.core.ensemble import (  # noqa: E402
    metropolis_swap_device as jax_swap,
)
from repro.plugins.re_exchange import _device_swaps as jax_device_swaps  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.core import FusedEnsemble, Kernel  # noqa: E402
from repro_torch.core.ensemble import (  # noqa: E402
    _stack_steps,
    draw_uniforms,
    metropolis_swap_device,
)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    ensemble_state_from_numpy,
    ensemble_state_to_flat,
)
from repro_torch.plugins.re_exchange import _device_swaps  # noqa: E402

# one train step of every member agrees with the JAX step at these
# tolerances (tests/test_torch_train.py::test_one_train_step_matches_jax)
STEP_RTOL = 1e-5
STEP_ATOL = 1e-5
N = 4        # the RE pattern's member count (tests/test_system.py:36)


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _swap_both(losses, temps, cycle, key):
    """(reference, port) results of one swap on the reference's uniforms."""
    n = len(losses)
    jl, jt = jnp.asarray(losses, jnp.float32), jnp.asarray(temps, jnp.float32)
    want_t, want_n = jax_swap(jl, jt, cycle, key)
    u = np.asarray(jax.random.uniform(key, (n,), minval=1e-12))
    got_t, got_n = metropolis_swap_device(
        torch.tensor(np.asarray(losses, np.float32)),
        torch.tensor(np.asarray(temps, np.float32)), cycle,
        torch.from_numpy(u.copy()))
    return (np.asarray(want_t), int(want_n)), (got_t.numpy(), int(got_n))


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_metropolis_swap_matches_reference(data):
    """The sweep of tests/test_pst.py (random losses, temperatures, cycle
    and key): the same new temperatures and accepted count as the
    reference, fed the uniforms it draws from its key."""
    n = data.draw(st.integers(2, 9))
    losses = [data.draw(st.floats(0.0, 10.0)) for _ in range(n)]
    temps = [data.draw(st.floats(0.1, 5.0)) for _ in range(n)]
    cycle = data.draw(st.integers(0, 3))
    key = jax.random.PRNGKey(data.draw(st.integers(0, 1000)))
    (want_t, want_n), (got_t, got_n) = _swap_both(losses, temps, cycle, key)
    np.testing.assert_array_equal(got_t, want_t)
    assert got_n == want_n
    np.testing.assert_array_equal(np.sort(got_t),
                                  np.sort(np.asarray(temps, np.float32)))


@pytest.mark.parametrize("cycle", [0, 1])
def test_metropolis_swap_deterministic_cases(cycle):
    """tests/test_runtime.py's case: a huge energy gap always swaps pair
    (cycle % 2, cycle % 2 + 1), and equal losses swap every pair."""
    temps = [1.0, 10.0, 10.0, 10.0] if cycle == 0 else [10.0, 1.0, 10.0, 1.0]
    losses = [10.0, 0.0, 0.0, 0.0] if cycle == 0 else [0.0, 10.0, 0.0, 0.0]
    (want_t, want_n), (got_t, got_n) = _swap_both(
        losses, temps, cycle, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got_t, want_t)
    assert got_n == want_n >= 1
    assert got_t[cycle] == 10.0 and got_t[cycle + 1] == 1.0
    t, n_acc = metropolis_swap_device(torch.ones(5), torch.arange(1.0, 6.0),
                                      cycle, torch.rand(5))
    assert int(n_acc) == 2
    pairs = [(0, 1), (2, 3)] if cycle == 0 else [(1, 2), (3, 4)]
    for i, j in pairs:
        assert (float(t[i]), float(t[j])) == (j + 1.0, i + 1.0)


def test_draw_uniforms_range_and_generator():
    gen = torch.Generator().manual_seed(3)
    u = draw_uniforms(1000, gen)
    assert u.dtype == torch.float32 and u.shape == (1000,)
    assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0
    assert torch.equal(u, draw_uniforms(1000,
                                        torch.Generator().manual_seed(3)))


def test_device_swaps_keep_float64_temps_exact():
    """tests/test_pst.py's case through the port with device="cpu":
    non-float32-representable temperatures come back bit-exact, unswapped
    pairs are not reported accepted, and the decisions equal the
    reference's."""
    temps = [3e-4 * 1.3 ** i for i in range(4)]
    for losses in ([1.0, 1.0, 1.0, 1.0], [0.0, 10.0, 1.0, 1.0]):
        want = jax_device_swaps(losses, temps, 0, 0, None)
        got = _device_swaps(losses, temps, 0, 0, "cpu")
        assert got[1] == want[1]
        assert list(got[0]) == list(want[0])
    new_t, acc = _device_swaps([1.0] * 4, temps, 0, 0, "cpu")
    assert acc == [(0, 1), (2, 3)]
    assert list(new_t) == [temps[1], temps[0], temps[3], temps[2]]
    new_t, acc = _device_swaps([0.0, 10.0, 1.0, 1.0], temps, 0, 0, "cpu")
    assert (0, 1) not in acc
    assert new_t[0] == temps[0] and new_t[1] == temps[1]


@pytest.mark.parametrize("losses,temps,cycle", [
    ([10.0, 0.0, 0.0, 0.0], [1.0, 10.0, 20.0, 40.0], 0),
    ([1.0, 1.0, 1.0, 1.0, 1.0], [1.0, 2.0, 3.0, 4.0, 5.0], 1),
    ([0.0, 10.0, 1.0, 1.0], [3e-4 * 1.3 ** i for i in range(4)], 0),
])
def test_exchange_kernel_on_device_matches_reference(losses, temps, cycle):
    """``re.exchange`` with ``device="cpu"``: the swap decided by
    ``metropolis_swap_device`` gives the reference's ``_device_swaps``
    result on cases whose decisions do not depend on the draws."""
    k = Kernel("re.exchange")
    k.arguments = {"replicas": len(temps), "cycle": cycle, "temps": temps,
                   "losses": losses, "device": "cpu", "seed": 7}
    out = k.execute()
    want_t, want_acc = jax_device_swaps(losses, temps, cycle, 7, None)
    assert out["temps"] == [float(t) for t in want_t]
    assert [tuple(p) for p in out["accepted"]] == want_acc
    assert sorted(out["temps"]) == sorted(temps)


def test_exchange_on_device_true_means_cuda(monkeypatch):
    """``device=True`` resolves to the port's default device, cuda, and
    raises where there is none; on a granted submesh the swap is placed on
    its first rank's device instead (a CPU mesh: the CPU), with the
    reference's swaps."""
    import types
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = Kernel("re.exchange")
    k.arguments = {"replicas": 4, "temps": [1.0, 2.0, 3.0, 4.0],
                   "losses": [1.0, 2.0, 0.5, 3.0], "device": True, "seed": 7,
                   "cycle": 1}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k.execute()
    from repro_torch.plugins.re_exchange import re_exchange, submesh_device
    sub = types.SimpleNamespace(mesh=torch.tensor([[3, 4]]),
                                device_type="cpu")
    assert submesh_device(sub) == torch.device("cpu")
    out = re_exchange(dict(k.arguments), {"submesh": sub})
    want_t, want_acc = jax_device_swaps(k.arguments["losses"],
                                        k.arguments["temps"], 1, 7, None)
    assert out["temps"] == [float(t) for t in want_t]
    assert [tuple(p) for p in out["accepted"]] == want_acc


def _jax_cycles(jfe, key, cycles, shape):
    """The reference's ``FusedEnsemble.run(key)`` unrolled: (initial state
    flat, final state, history, each cycle's uniforms, the first moments
    flat after each cycle)."""
    from repro.core.ensemble import _stack_steps as jax_stack_steps
    from repro.data import SyntheticLM as JaxSyntheticLM
    ens = jfe.init(key)
    flat0 = {k: np.asarray(v) for k, v in _flatten(ens).items()}
    cyc = jfe._build_cycle(1, shape)
    data = [JaxSyntheticLM(jfe.cfg, shape, seed=i) for i in range(jfe.n)]
    hist, uniforms, moments = [], [], []
    for c in range(cycles):
        batches = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            jax.tree.map(jnp.asarray, jax_stack_steps(d, c, 1))
            for d in data])
        key, sub = jax.random.split(key)
        uniforms.append(np.asarray(
            jax.random.uniform(sub, (jfe.n,), minval=1e-12)))
        ens, m = cyc(ens, batches, sub)
        hist.append(jax.device_get(m))
        moments.append({k: np.array(v) for k, v in _flatten(ens).items()
                        if k.startswith("members/opt/m/")})
    return flat0, ens, hist, uniforms, moments


# AdamW's defaults in both packages (repro.optim.adamw.adamw_update)
ADAM_B1 = 0.9
ADAM_EPS = 1e-8

# Elements of the final params that may differ by more than STEP_ATOL, and
# only where the reference's gradient in some cycle is within 10 eps of 0:
# reduced qwen3-moe-30b-a3b has one, the LM head's weight (26, 252) of
# member 3 (see test_fused_ensemble_matches_jax).
NEAR_EPS = {"gemma2-2b": [],
            "qwen3-moe-30b-a3b": [("members/params/head", (3, 26, 252))],
            "grok-1-314b": []}


@pytest.mark.parametrize("arch,remat", [
    ("gemma2-2b", "none"), ("gemma2-2b", "full"),
    ("qwen3-moe-30b-a3b", "none"), ("grok-1-314b", "none")],
    ids=["none", "full", "qwen3-moe-30b-a3b", "grok-1-314b"])
def test_fused_ensemble_matches_jax(arch, remat):
    """Reduced ``arch``, 4 members, 2 cycles of 1 step at
    ShapeSpec("t", "train", 32, 2) from the JAX ensemble's initial state,
    on its uniforms: losses and final state within the one-step
    tolerances, temperatures and accepted counts identical.  ``remat``
    "full" runs the blocks' and the loss chunks' recompute under vmap.

    The MoE case runs the dispatch under vmap and reports losses with
    0.01 aux, which the swap takes as energies.  Its state is held at
    STEP_ATOL except where the reference's gradient in some cycle is
    within 10x AdamW's eps of 0, found from the reference's first moment
    after that cycle (|m| < 10 (1 - b1) eps).  There the first step
    lr g / (|g| + eps) turns a gradient difference of float32 rounding
    into a step difference of the order of lr: member 3's head (26, 252)
    has a gradient of ~1e-8 in cycle 1 (reference m 9.78e-10, port
    8.60e-10), and at lr 3e-4 x 1.3^3 the steps differ by 2.1e-5; after
    cycle 2 the moments agree within 1.1e-4 relative.  Those elements are
    held within their member's largest lr, and exactly the ones in
    NEAR_EPS may leave STEP_ATOL."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(remat=remat)
    cfg = _port_cfg(jcfg)
    cycles = 2
    jfe = JaxFusedEnsemble(jcfg, N)
    flat, jens, jhist, uniforms, moments = _jax_cycles(
        jfe, jax.random.PRNGKey(0), cycles, JaxShapeSpec("t", "train", 32, 2))

    fe = FusedEnsemble(cfg, N, device="cpu")
    ens = ensemble_state_from_numpy(flat, cfg)
    shape = ShapeSpec("t", "train", 32, 2)
    cyc = fe._build_cycle(1, shape)
    data = [SyntheticLM(cfg, shape, seed=i, device="cpu") for i in range(N)]
    lrs = []
    for c, u in enumerate(uniforms):
        lrs.append(ens["temps"].numpy().copy())
        batches = {k: torch.stack([_stack_steps(d, c, 1)[k] for d in data])
                   for k in ("tokens", "labels")}
        ens, m = cyc(ens, batches, torch.from_numpy(u.copy()))
        np.testing.assert_allclose(m["losses"], jhist[c]["losses"],
                                   rtol=STEP_RTOL, atol=1e-7)
        np.testing.assert_array_equal(m["temps"], jhist[c]["temps"])
        assert m["accepted"] == int(jhist[c]["accepted"])
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(jens).items()}
    got = {k: v.float().numpy()
           for k, v in ensemble_state_to_flat(ens, cfg).items()}
    assert set(got) == set(want)
    member_lr = np.max(lrs, axis=0)          # each member's largest lr
    beyond = []
    for k in want:
        err = np.abs(got[k] - want[k])
        near = np.zeros(err.shape, bool)
        if NEAR_EPS[arch] and k.startswith("members/params/"):
            mk = "members/opt/m/" + k[len("members/params/"):]
            for mom in moments:
                near |= np.abs(mom[mk]) < 10 * (1 - ADAM_B1) * ADAM_EPS
            lim = member_lr.reshape((N,) + (1,) * (err.ndim - 1))
            assert (err <= lim)[near].all(), k
            beyond += [(k, tuple(int(i) for i in ix))
                       for ix in np.argwhere(near & (err > STEP_ATOL))]
        np.testing.assert_allclose(np.where(near, want[k], got[k]), want[k],
                                   atol=STEP_ATOL, err_msg=k)
    assert beyond == NEAR_EPS[arch]
    assert int(ens["cycle"]) == cycles
    assert ens["members"]["step"].tolist() == [cycles] * N


def test_fused_moe_losses_include_aux():
    """The fused cycle reports, per member, the reference's
    ``_member_train_step`` value, cross-entropy + 0.01 aux (ROADMAP C10):
    reduced qwen3-moe-30b-a3b's first cycle against the reference's
    cross-entropy and aux on the same members and batches, with an aux
    term large enough that leaving it out fails."""
    from repro.data import SyntheticLM as JaxSyntheticLM
    from repro.models import forward as jax_forward
    from repro.train.losses import chunked_softmax_xent as jax_xent
    jcfg = jax_reduced(jax_get_config("qwen3-moe-30b-a3b"))
    cfg = _port_cfg(jcfg)
    jens = JaxFusedEnsemble(jcfg, N).init(jax.random.PRNGKey(2))
    flat = {k: np.asarray(v) for k, v in _flatten(jens).items()}
    jshape = JaxShapeSpec("t", "train", 32, 2)
    jb = [JaxSyntheticLM(jcfg, jshape, seed=i).batch_at(0) for i in range(N)]

    def parts(p, tokens, labels):
        out = jax_forward(jcfg, p, tokens, mesh=None, remat=False)
        return jax_xent(jcfg, p, out["h"], labels)[0], out["aux"]
    xent, aux = jax.vmap(parts)(
        jens["members"]["params"],
        jnp.stack([jnp.asarray(b["tokens"]) for b in jb]),
        jnp.stack([jnp.asarray(b["labels"]) for b in jb]))
    xent, aux = np.asarray(xent), np.asarray(aux)

    shape = ShapeSpec("t", "train", 32, 2)
    ens = ensemble_state_from_numpy(flat, cfg)
    cyc = FusedEnsemble(cfg, N, device="cpu")._build_cycle(1, shape)
    batches = {k: torch.stack([_stack_steps(SyntheticLM(cfg, shape, seed=i,
                                                        device="cpu"),
                                            0, 1)[k] for i in range(N)])
               for k in ("tokens", "labels")}
    _, m = cyc(ens, batches, torch.full((N,), 0.5))
    assert (0.01 * aux > 100 * STEP_RTOL * xent).all()   # 0.02 against 6e-5
    np.testing.assert_allclose(m["losses"], xent + 0.01 * aux,
                               rtol=STEP_RTOL, atol=1e-7)


def test_fused_ensemble_state_round_trips():
    jcfg = jax_reduced(jax_get_config("gemma2-2b"))
    cfg = _port_cfg(jcfg)
    flat = {k: np.asarray(v) for k, v in
            _flatten(JaxFusedEnsemble(jcfg, 3).init(
                jax.random.PRNGKey(1))).items()}
    back = ensemble_state_to_flat(ensemble_state_from_numpy(flat, cfg), cfg)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_fused_ensemble_run_on_cpu():
    """``run`` makes its members and uniforms from one generator: finite
    losses, the temperature multiset kept, each cycle's swap replayed from
    its losses and the uniforms the generator gives after init."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("gemma2-2b"))
    fe = FusedEnsemble(cfg, N, device="cpu")
    assert torch.equal(fe.temps0, torch.tensor(
        [3e-4 * 1.3 ** i for i in range(N)], dtype=torch.float32))
    ens, hist = fe.run(torch.Generator().manual_seed(0), cycles=2,
                       steps_per_cycle=2, shape=ShapeSpec("t", "train", 16, 2))
    gen = torch.Generator().manual_seed(0)
    fe.init(gen)
    temps = fe.temps0
    for c, m in enumerate(hist):
        assert np.isfinite(m["losses"]).all()
        new_t, n_acc = metropolis_swap_device(
            torch.from_numpy(m["losses"]), temps, c, draw_uniforms(N, gen))
        np.testing.assert_array_equal(m["temps"], new_t.numpy())
        assert m["accepted"] == int(n_acc)
        assert sorted(m["temps"].tolist()) == sorted(fe.temps0.tolist())
        temps = new_t
    assert ens["members"]["step"].tolist() == [4] * N


def test_flash_attention_vmap_folds_members():
    """``flash_attention`` vmapped over 3 members (segment ids too) equals
    a loop of per-member calls in value and gradient, and its rule makes
    one call of the Function for all members."""
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(0)
    n, B, S, H, KH, D = 3, 2, 12, 4, 2, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_(True)
    q, k, v = t(n, B, S, H, D), t(n, B, S, KH, D), t(n, B, S, KH, D)
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, (n, B, S)), -1)
                           .astype(np.int32))
    kw = dict(causal=True, window=5, softcap=20.0, scale=0.3)
    calls = []
    orig = ops.attention_fwd_ref

    def counted(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)
    ops.attention_fwd_ref = counted
    try:
        out = torch.func.vmap(lambda q, k, v, s: flash_attention(
            q, k, v, seg_q=s, seg_kv=s, **kw))(q, k, v, seg)
    finally:
        ops.attention_fwd_ref = orig
    assert calls == [(n * B, S, H, D)]
    do = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    g = torch.autograd.grad(out, (q, k, v), do)
    loop = torch.stack([flash_attention(q[i], k[i], v[i], seg_q=seg[i],
                                        seg_kv=seg[i], **kw)
                        for i in range(n)])
    g_loop = torch.autograd.grad(loop, (q, k, v), do)
    torch.testing.assert_close(out, loop, rtol=0, atol=1e-6)
    for a, b in zip(g, g_loop):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fused_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``fused`` phase on the CPU at a reduced width
    (its layers, remat, bf16 compute, head_dim 64 so that the counted
    variant is the card's, 64 tokens): the plain attention calls are
    counted as the wrappers count kernel launches, and a fused step of 4
    members launches one member's count (two forward and one backward a
    layer); the swaps replay, the task mode and the exchange on the device
    agree."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import resource_handler
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops

    chip_smoke = _chip_smoke()
    F = chip_smoke.FUSED
    cfg = reduced(get_config(F["base"]), layers=F["layers"]).replace(
        name=F["arch"], remat="full", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, cfg.name, cfg)
    monkeypatch.setitem(F, "seq", 64)

    def counted(fn, name):
        def run(q, *a, **kw):
            count_launch(name, f"{name}.{ops.variant(q.dtype, q.shape[-1])}")
            return fn(q, *a, **kw)
        return run
    for attr, name in (("attention_fwd_ref", "flash_attention"),
                       ("attention_ref", "flash_attention"),
                       ("attention_bwd_ref", "flash_attention_bwd")):
        monkeypatch.setattr(ops, attr, counted(getattr(ops, attr), name))
    monkeypatch.setattr(resource_handler, "resolve_device",
                        lambda d: torch.device("cpu"))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    got = chip_smoke.phase_fused(torch.device("cpu"))
    cycles, n = F["cycles"], F["members"]
    # fused: one member's launches a cycle; task mode: every member's
    L = F["layers"]
    assert got == {"flash_attention": 2 * L * cycles * (1 + n),
                   "flash_attention.wgmma": 2 * L * cycles * (1 + n),
                   "flash_attention_bwd": L * cycles * (1 + n),
                   "flash_attention_bwd.wgmma": L * cycles * (1 + n)}

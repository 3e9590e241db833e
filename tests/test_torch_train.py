"""The port's training path against the JAX package's, on the CPU.

Seeded numpy inputs (or a JAX train state, carried across by
``train_state_from_numpy``) go through the JAX function and the port's.
Matmuls run in full f32 on both sides (``tests/conftest.py`` sets the JAX
precision to "highest"; torch's CPU matmuls do not use TF32, and the test
asks for "highest" besides).  Tolerances, f32:
  * data, schedules' rates, compute_cast's choice: exact;
  * optimizer on a small tree: 1e-6 (one f32 rounding of each op);
  * one train step of a reduced model: loss and grad norm 1e-5 relative,
    every param and Adam moment 1e-5 absolute.  The two frameworks sum in
    different orders (measured differences ~1e-6); a param moves by at
    most lr (1 + wd) = 3.3e-4 in the step.
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
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import make_schedule as jax_make_schedule  # noqa: E402
from repro.train import TrainHyper as JaxTrainHyper  # noqa: E402
from repro.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro.train.losses import chunked_softmax_xent as jax_xent  # noqa: E402
from repro.train.step import compute_cast as jax_compute_cast  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    train_state_from_numpy,
    train_state_to_flat,
)
from repro_torch.optim import (  # noqa: E402
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_schedule,
)
from repro_torch.plugins import lm  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainHyper,
    build_eval_step,
    build_train_step,
    chunked_softmax_xent,
    compute_cast,
)
from repro_torch.train.step import decay_mask  # noqa: E402

ARCHS = ["gemma2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
         "qwen3-moe-30b-a3b", "grok-1-314b", "whisper-large-v3",
         "internvl2-26b", "gemma3-4b", "minicpm-2b", "nemotron-4-15b"]
STUB_ARCHS = ["whisper-large-v3", "internvl2-26b"]   # frontends stubbed
# the archs whose one step is also held under remat="dots"
DOTS_ARCHS = ["gemma2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
              "qwen3-moe-30b-a3b", "whisper-large-v3", "internvl2-26b"]
STEP_ATOL = 1e-5
STEP_RTOL = 1e-5
# AdamW's defaults in both packages (repro.optim.adamw.adamw_update)
ADAM_B1 = 0.9
ADAM_EPS = 1e-8
# Archs whose one step holds parameters where the reference's gradient is
# within 10 eps of 0 (|m| < 10 (1 - b1) eps after the step), as
# tests/test_torch_ensemble.py::test_fused_ensemble_matches_jax finds for
# reduced qwen3-moe: there lr g / (|g| + eps) turns float32 rounding of g
# (the two packages' gradients agree within 3e-6 of each leaf's largest)
# into a step difference of the order of lr.  Reduced gemma3-4b has
# gradients of ~5e-10 whose sign the summation order decides (its mlp/wg
# of layer 0 at (10, 65): reference m 5.5e-11, port -4.8e-11), so steps
# 3e-5 apart at lr 3e-4.  Those elements are held within lr; every other
# element, and every moment, at STEP_ATOL.
NEAR_EPS_STEP = ("gemma3-4b",)


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def to_numpy(flat):
    """A ``convert.*_to_flat`` result as numpy; bfloat16 comes back as
    float32 (exact: every bf16 value is an f32)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in flat.items()}


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.mark.parametrize("arch,step", [("gemma2-2b", 0), ("gemma2-2b", 7),
                                       ("qwen3-moe-30b-a3b", 3)])
def test_synthetic_batches_bit_equal_to_jax(arch, step):
    jcfg = jax_reduced(jax_get_config(arch))
    want = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 48, 3),
                          seed=5).batch_at(step)
    got = SyntheticLM(port_cfg(jcfg), ShapeSpec("t", "train", 48, 3),
                      seed=5, device="cpu").batch_at(step)
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == torch.int32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("name", ["cosine", "wsd", "constant"])
def test_schedules_match_jax(name):
    kw = dict(base_lr=3e-4, warmup=3, total_steps=20)
    ours, theirs = make_schedule(name, **kw), jax_make_schedule(name, **kw)
    for step in range(0, 24):
        got = ours(torch.tensor(step, dtype=torch.int32))
        want = theirs(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == float(want), (step, float(got), float(want))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "layers": [{"k": rng.standard_normal((3, 4, 2)).astype(
                np.float32)}]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_and_clip_match_jax(moment_dtype):
    """Two steps of clip + AdamW on a small tree (a 1-D leaf, which does
    not decay), with the count advancing before the bias correction."""
    params, grads = _tree(0), _tree(1)
    jp = jax.tree.map(jnp.asarray, params)
    jo = jax_adamw.adamw_init(jp, moment_dtype)
    tp = _to_torch(params)
    to = adamw_init(tp, moment_dtype)
    assert to["m"]["w"].dtype == getattr(torch, moment_dtype)
    for step in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(x) * (step + 1), grads)
        jg, jnorm = jax_adamw.clip_by_global_norm(g, 1.0)
        jp, jo = jax_adamw.adamw_update(jg, jo, jp, lr=1e-2, wd=0.1)
        tg = _to_torch(jax.tree.map(np.asarray, g))
        tg, tnorm = clip_by_global_norm(tg, 1.0)
        tp, to = adamw_update(tg, to, tp, lr=1e-2, wd=0.1)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        assert int(to["count"]) == int(jo["count"]) == step + 1
        for key in ("w", "b"):
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                       atol=1e-6)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    to[mom][key].float().numpy(),
                    np.asarray(jo[mom][key], np.float32), atol=1e-6)
        np.testing.assert_allclose(tp["layers"][0]["k"].numpy(),
                                   np.asarray(jp["layers"][0]["k"]),
                                   atol=1e-6)
    assert float(global_norm(tp)) > 0


def test_compute_cast_picks_the_jax_leaves():
    """Large (> 1M elements) f32 leaves of 2+ dims go to bf16; 1-D, small,
    non-f32 and ``moe`` leaves stay."""
    shapes = {"embed": {"tok": (1025, 1000)},
              "small": (100, 100),
              "norm": (2_000_000,),
              "moe": {"wi": (2, 1000, 600)},
              "half": (1100, 1000)}

    def build(make):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return make(node)
        return walk(shapes)
    cfg = reduced(get_config("gemma2-2b")).replace(dtype="bfloat16")
    jcfg = jax_reduced(jax_get_config("gemma2-2b")).replace(dtype="bfloat16")
    tp = build(lambda s: torch.zeros(s))
    tp["half"] = tp["half"].to(torch.bfloat16)
    jp = build(lambda s: jax.ShapeDtypeStruct(s, jnp.float32))
    jp["half"] = jax.ShapeDtypeStruct(shapes["half"], jnp.bfloat16)
    got = compute_cast(cfg, tp)
    want = jax.eval_shape(lambda p: jax_compute_cast(jcfg, p), jp)
    flat_got = {k: str(v.dtype).split(".")[-1] for k, v in
                _flatten(got).items()}
    flat_want = {k: str(v.dtype) for k, v in _flatten(want).items()}
    assert flat_got == flat_want
    assert flat_got["embed/tok"] == "bfloat16"
    assert flat_got["norm"] == flat_got["small"] == "float32"
    assert flat_got["moe/wi"] == "float32"
    # the f32 config casts nothing
    assert compute_cast(reduced(get_config("gemma2-2b")), tp) is tp


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_xent_value_and_grads_match_jax(softcap):
    """Several chunks, masked labels (-1), the final softcap; the value and
    its gradients with respect to h and the tied embedding."""
    jcfg = jax_reduced(jax_get_config("gemma2-2b")).replace(
        loss_chunk=16, final_softcap=softcap)
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    emb = (0.02 * rng.standard_normal((cfg.vocab_size, cfg.d_model))).astype(
        np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 64)).astype(np.int32)

    def jloss(h_, e_):
        return jax_xent(jcfg, {"embed": {"tok": e_}}, h_,
                        jnp.asarray(labels))[0]
    jl, (jgh, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tl, cnt = chunked_softmax_xent(cfg, {"embed": {"tok": te}}, th,
                                   torch.from_numpy(labels))
    assert float(cnt) == float((labels >= 0).sum())
    tgh, tge = torch.autograd.grad(tl, (th, te))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), atol=1e-6)


def test_remat_gives_the_same_gradients():
    cfg = reduced(get_config("gemma2-2b"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    leaves = [params["embed"]["tok"], params["layers"][0]["attn"]["wq"]]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    grads = []
    for remat in (False, True):
        for p in leaves:
            p.requires_grad_(True)
        h = forward(cfg, params, toks, remat=remat)["h"]
        grads.append(torch.autograd.grad((h ** 2).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        forward(cfg, params, toks, remat=True, cache_len=32)


def test_decay_mask_follows_the_stacked_layout():
    """The JAX package stacks each scanned layer group into (G, ...)
    leaves, so its AdamW decays those layers' norm scales (2-D there) but
    not a tail layer's; the port's per-layer 1-D scales follow that."""
    cfg = reduced(get_config("gemma2-2b"), layers=3)  # 1 group of 2 + tail
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mask = decay_mask(cfg, params)
    assert mask["layers"][0]["ln1"]["scale"] is True
    assert mask["layers"][1]["ln2_post"]["scale"] is True
    assert mask["layers"][2]["ln1"]["scale"] is False
    assert mask["layers"][2]["mlp"]["wi"] is True
    unscanned = reduced(get_config("recurrentgemma-2b"))   # scan_layers off
    mask = decay_mask(unscanned, init_params(
        unscanned, torch.Generator().manual_seed(0)))
    assert mask["layers"][0]["ln1"]["scale"] is False
    assert mask["final_norm"]["scale"] is False
    assert mask["embed"]["tok"] is True


def _jax_state(arch, microbatches, remat=None):
    jcfg = jax_reduced(jax_get_config(arch)).replace(
        microbatches=microbatches)
    if remat:
        jcfg = jcfg.replace(remat=remat)
    state = jax_make_train_state(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(state).items()}
    return jcfg, state, flat


def test_train_state_round_trips():
    jcfg, _, flat = _jax_state("recurrentgemma-2b", 1)
    cfg = port_cfg(jcfg)
    back = to_numpy(train_state_to_flat(train_state_from_numpy(flat, cfg),
                                        cfg))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("arch,remat", [
    *(pytest.param(a, None, id=a) for a in ARCHS),
    *(pytest.param(a, "dots", id=f"{a}-dots") for a in DOTS_ARCHS)])
def test_one_train_step_matches_jax(arch, remat):
    """One step with microbatches=2 (as ``tests/test_models.py``'s train
    smoke test) from the same state and batch: loss, grad_norm, lr, and
    every param and moment after the step; ``remat`` "dots" replaces the
    config's "full" on both sides."""
    jcfg, jstate, flat = _jax_state(arch, 2, remat)
    cfg = port_cfg(jcfg)
    hyper = dict(warmup=1, total_steps=10)
    jstep = jax.jit(jax_build_train_step(jcfg,
                                         hyper=JaxTrainHyper(**hyper)))
    jbatch = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 32,
                                               4)).batch_at(0)
    jstate, jm = jstep(jstate, jbatch)
    state = train_state_from_numpy(flat, cfg)
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 32, 4),
                        device="cpu").batch_at(0)
    state, m = build_train_step(cfg, TrainHyper(**hyper))(state, batch)
    for key in ("loss", "grad_norm", "lr", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=key)
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(jstate).items()}
    got = to_numpy(train_state_to_flat(state, cfg))
    assert set(got) == set(want)
    n_near = n_all = 0
    for k in want:
        near = np.zeros(want[k].shape, bool)
        if arch in NEAR_EPS_STEP and k.startswith("params/"):
            near = (np.abs(want["opt/m/" + k[len("params/"):]])
                    < 10 * (1 - ADAM_B1) * ADAM_EPS)
            assert (np.abs(got[k] - want[k]) <= float(jm["lr"]))[near].all()
            n_near, n_all = n_near + int(near.sum()), n_all + near.size
        np.testing.assert_allclose(np.where(near, want[k], got[k]), want[k],
                                   atol=STEP_ATOL, err_msg=k)
    assert n_near <= 1e-3 * max(n_all, 1)   # a tail: gemma3-4b 40 of 239,424
    assert int(state["step"]) == 1
    assert all(not p.requires_grad and p.grad is None
               for p in jax.tree.leaves(state["params"]))


def test_wsd_train_step_matches_jax():
    """minicpm-2b's config module names the WSD schedule (``SCHEDULE``, which
    the JAX package's train launcher picks, ``repro/launch/train.py``;
    ``lm.train`` takes it as ``args["schedule"]``): one step of reduced
    minicpm-2b under it from step 19 of 20, inside the decay (lr = base_lr
    0.1^0.5, where the cosine schedule gives another), against the JAX
    step from the same state and batch: loss, grad_norm, lr, every param
    and moment."""
    import importlib
    names = {importlib.import_module(f"{pkg}.configs.minicpm_2b").SCHEDULE
             for pkg in ("repro", "repro_torch")}
    assert names == {"wsd"}
    jcfg, jstate, flat = _jax_state("minicpm-2b", 2)
    cfg = port_cfg(jcfg)
    hyper = dict(warmup=1, total_steps=20, schedule="wsd")
    jstate = {**jstate, "step": jnp.asarray(19, jnp.int32)}
    flat["step"] = np.asarray(19, np.int32)
    jstep = jax.jit(jax_build_train_step(jcfg,
                                         hyper=JaxTrainHyper(**hyper)))
    jbatch = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 32,
                                               4)).batch_at(0)
    jstate, jm = jstep(jstate, jbatch)
    state = train_state_from_numpy(flat, cfg)
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 32, 4),
                        device="cpu").batch_at(0)
    state, m = build_train_step(cfg, TrainHyper(**hyper))(state, batch)
    np.testing.assert_allclose(float(m["lr"]), 3e-4 * 0.1 ** 0.5, rtol=1e-6)
    cosine = make_schedule("cosine", base_lr=3e-4, warmup=1, total_steps=20)
    assert abs(float(cosine(torch.tensor(19))) - float(m["lr"])) > 1e-5
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=key)
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(jstate).items()}
    got = to_numpy(train_state_to_flat(state, cfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL,
                                   err_msg=k)
    assert int(state["step"]) == 20


def test_eval_step_matches_jax():
    from repro.train import build_eval_step as jax_build_eval_step
    jcfg, jstate, flat = _jax_state("gemma2-2b", 1)
    cfg = port_cfg(jcfg)
    jbatch = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 32, 2),
                            seed=1).batch_at(0)
    want = jax_build_eval_step(jcfg)(jstate["params"], jbatch)
    state = train_state_from_numpy(flat, cfg)
    got = build_eval_step(cfg)(state["params"], SyntheticLM(
        cfg, ShapeSpec("t", "train", 32, 2), seed=1,
        device="cpu").batch_at(0))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    assert float(got["ntok"]) == float(want["ntok"])


def test_train_eval_decode_serves_the_trained_member():
    """lm.train -> lm.eval -> lm.decode on reduced:gemma2-2b (fault C1):
    decode serves the member's stored params, not seed-0 params."""
    from repro_torch.core.kernel_plugin import Kernel
    from repro_torch.serve import BatchedServer, Request
    base = {"arch": "reduced:gemma2-2b", "device": "cpu",
            "ensemble": "test_c1", "member": 1}
    try:
        k = Kernel("lm.decode")
        k.arguments = dict(base)
        assert k.execute()["params"] == "seed 0"
        k = Kernel("lm.train")
        k.arguments = dict(base, steps=2, lr=3e-2)
        out = k.execute()
        assert out["step"] == 2 and np.isfinite(out["loss"])
        k = Kernel("lm.eval")
        k.arguments = dict(base)
        assert np.isfinite(k.execute()["loss"])
        k = Kernel("lm.decode")
        k.arguments = dict(base)
        served = k.execute()
        assert served["params"] == "member state at step 2"
        # the same tokens as a server on the stored params
        cfg = lm.resolve_cfg(base["arch"])
        srv = BatchedServer(cfg, lm.STATE_STORE[("test_c1", 1)]["params"],
                            batch=2, prompt_len=8, max_len=13, device="cpu")
        rng = np.random.default_rng(0)
        srv.submit([Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8),
                            max_new_tokens=4) for i in range(2)])
        want = {r.rid: list(r.out_tokens) for r in srv.run()}
        assert served["tokens"] == want
    finally:
        lm.STATE_STORE.pop(("test_c1", 1), None)


def test_dots_remat_trains_through_the_entry_points(monkeypatch, capsys):
    """A config with ``remat="dots"`` (the reference's
    ``dots_with_no_batch_dims_saveable``) trains through
    ``build_train_step``, ``lm.train`` and ``launch.train``, each loss
    bitwise the one of the same config under ``remat="full"``: the policy
    changes what the backward pass keeps, no value (the saved set is
    held against the reference in ``test_torch_remat_dots.py``)."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.core.kernel_plugin import Kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import make_train_state
    full = reduced(get_config("gemma2-2b"))
    losses = {}
    for remat in ("full", "dots"):
        name = f"gemma2-2b-{remat}-test"
        cfg = full.replace(name=name, remat=remat, microbatches=2)
        monkeypatch.setitem(cfg_base._REGISTRY, name, cfg)
        state = make_train_state(cfg, torch.Generator().manual_seed(0))
        batch = SyntheticLM(cfg, ShapeSpec("t", "train", 32, 4),
                            device="cpu").batch_at(0)
        _, m = build_train_step(cfg)(state, batch)
        k = Kernel("lm.train")
        k.arguments = {"arch": name, "device": "cpu", "ensemble": "dots",
                       "member": 0, "steps": 2}
        try:
            out = k.execute()
        finally:
            lm.STATE_STORE.pop(("dots", 0), None)
        hist = launch_train.main(["--arch", name, "--steps", "2", "--batch",
                                  "2", "--seq", "32", "--schedule", "cosine",
                                  "--device", "cpu"])
        losses[remat] = [float(m["loss"]), out["loss"]] + [
            h["loss"] for h in hist]
    capsys.readouterr()
    assert all(np.isfinite(losses["dots"]))
    assert losses["dots"] == losses["full"]


# ------------------------------------------------ encoder and vision inputs

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,step", [("whisper-large-v3", 0),
                                       ("whisper-large-v3", 5),
                                       ("internvl2-26b", 2)])
def test_synthetic_stub_inputs_bit_equal_to_jax(arch, step, dtype):
    """Tokens, then ``vision_embeds`` (float32; a bf16 config's rounded to
    bf16 before the scale), then ``enc_frames`` (the compute dtype), from
    one generator: bitwise the JAX batch, dtypes too."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(dtype=dtype)
    want = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 24, 3),
                          seed=5).batch_at(step)
    got = SyntheticLM(port_cfg(jcfg), ShapeSpec("t", "train", 24, 3),
                      seed=5, device="cpu").batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels", "seg_ids",
                                     "vision_embeds" if "internvl" in arch
                                     else "enc_frames"}
    for name, t in got.items():
        w = np.asarray(want[name])
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), name
        if t.dtype == torch.bfloat16:
            t, w = t.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


def _jax_loss(jcfg, remat):
    """The JAX train step's loss of one microbatch (its ``loss_fn``:
    ``compute_cast``, forward, chunked xent, ``0.01 aux``)."""
    from repro.models import forward as jax_forward

    def loss(params, mb):
        params = jax_compute_cast(jcfg, params)
        out = jax_forward(jcfg, params, mb["tokens"], seg_ids=mb["seg_ids"],
                          vision_embeds=mb.get("vision_embeds"),
                          enc_frames=mb.get("enc_frames"), remat=remat)
        return jax_xent(jcfg, params, out["h"], mb["labels"])[0] \
            + 0.01 * out["aux"]
    return loss


@pytest.mark.parametrize("remat", [False, True, "dots"])
@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_grads_match_jax(arch, remat):
    """Loss and every gradient leaf, the encoder's (``enc/...``) and the
    cross-attention's (``xattn``, ``lnx``) among them, against
    ``jax.grad`` of the JAX step's loss, with remat off, on ("full") and
    on under "dots" (both packages' configs): a rematerialised block that
    closed over the encoder's output would give the encoder no
    gradient."""
    from repro_torch.models.convert import params_from_numpy, params_to_flat
    from repro_torch.train.step import lm_loss
    jcfg, jstate, flat = _jax_state(arch, 1,
                                    "dots" if remat == "dots" else None)
    remat = bool(remat)
    cfg = port_cfg(jcfg)
    jbatch = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 32, 2),
                            seed=3).batch_at(0)
    jl, jg = jax.value_and_grad(_jax_loss(jcfg, remat))(jstate["params"],
                                                        jbatch)
    params = params_from_numpy({k[len("params/"):]: v for k, v in
                                flat.items() if k.startswith("params/")},
                               cfg)
    leaves = list(jax.tree.leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 32, 2), seed=3,
                        device="cpu").batch_at(0)
    loss, _, aux = lm_loss(cfg, compute_cast(cfg, params), batch,
                           remat=remat)
    total = loss + 0.01 * aux
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jl),
                               rtol=STEP_RTOL)
    grads = jax.tree.map(lambda p: p.grad, params)
    got = to_numpy(params_to_flat(grads, cfg))
    want = {k: np.asarray(v) for k, v in _flatten(jg).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL,
                                   err_msg=k)
    picked = [k for k in want if k.startswith("enc/") or "xattn" in k
              or "lnx" in k] if cfg.encoder_layers else []
    # 12 stacked encoder leaves and its final norm, 6 of xattn and lnx
    assert len(picked) == (18 if cfg.encoder_layers else 0)
    for k in picked:
        assert np.abs(got[k]).max() > 0, k


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_stub_eval_step_matches_jax(arch):
    from repro.train import build_eval_step as jax_build_eval_step
    jcfg, jstate, flat = _jax_state(arch, 1)
    cfg = port_cfg(jcfg)
    jbatch = JaxSyntheticLM(jcfg, JaxShapeSpec("t", "train", 32, 2),
                            seed=1).batch_at(0)
    want = jax_build_eval_step(jcfg)(jstate["params"], jbatch)
    state = train_state_from_numpy(flat, cfg)
    got = build_eval_step(cfg)(state["params"], SyntheticLM(
        cfg, ShapeSpec("t", "train", 32, 2), seed=1,
        device="cpu").batch_at(0))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    assert float(got["ntok"]) == float(want["ntok"])


def test_decay_mask_of_the_encoder_follows_the_stacked_layout():
    """ROADMAP C3 on the encoder: the JAX package stacks the encoder's
    layers into (encoder_layers, ...) leaves, so AdamW decays every
    encoder layer's norm scales and biases, not the encoder's final norm;
    the decoder's ``lnx`` (a scanned layer's) decays too."""
    cfg = reduced(get_config("whisper-large-v3"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mask = decay_mask(cfg, params)
    for layer in mask["enc"]["layers"]:
        assert all(jax.tree.leaves(layer))
        assert layer["ln1"] == {"scale": True, "bias": True}
    assert mask["enc"]["final_norm"] == {"scale": False, "bias": False}
    assert mask["layers"][0]["lnx"] == {"scale": True, "bias": True}
    assert mask["final_norm"] == {"scale": False, "bias": False}
    # as the JAX AdamW's ndim >= 2 rule on the stacked leaves
    jcfg = jax_reduced(jax_get_config("whisper-large-v3"))
    jshapes = _flatten(jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0))))
    from repro_torch.models.convert import params_to_flat
    stacked = params_to_flat(jax.tree.map(
        lambda m: torch.tensor(float(m)), mask), cfg)
    for k, v in stacked.items():
        assert bool(v.flatten()[0]) == (len(jshapes[k].shape) >= 2), k


def test_lm_train_and_eval_tasks_carry_the_stub_inputs():
    """``lm.train`` -> ``lm.eval`` on reduced whisper-large-v3 and
    internvl2-26b (their SyntheticLM batches carry the stub inputs): the
    member's loss moves and the encoder's params change."""
    from repro_torch.core.kernel_plugin import Kernel
    for arch in STUB_ARCHS:
        base = {"arch": f"reduced:{arch}", "device": "cpu",
                "ensemble": "test_stub", "member": 0, "seq": 24,
                "batch": 2}
        try:
            cfg = lm.resolve_cfg(base["arch"])
            k = Kernel("lm.train")
            k.arguments = dict(base, steps=1, lr=3e-2)
            k.execute()
            state = lm.STATE_STORE[("test_stub", 0)]
            before = {k_: v.clone() for k_, v in
                      enumerate(jax.tree.leaves(state["params"]))}
            k = Kernel("lm.train")
            k.arguments = dict(base, steps=1, lr=3e-2)
            assert k.execute()["step"] == 2
            moved = [not torch.equal(v, before[i]) for i, v in
                     enumerate(jax.tree.leaves(state["params"]))]
            assert all(moved)
            if cfg.encoder_layers:
                assert "enc" in state["params"]
            k = Kernel("lm.eval")
            k.arguments = dict(base)
            assert np.isfinite(k.execute()["loss"])
        finally:
            lm.STATE_STORE.pop(("test_stub", 0), None)
            lm.CONFIG_STORE.pop(("test_stub", 0), None)


def test_chip_smoke_whisper_train_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``train whisper-large-v3`` phase on the CPU at
    reduced widths (remat, bf16 compute, head_dim 64; 64 tokens, 16
    frames): the plain attention calls are counted as the flash wrappers
    count kernel launches, so the phase's exact counts a step (encoder,
    decoder self- and cross-attention: forward twice, backward once) and
    its check of one microbatch against ``impl="ref"``, with picked leaves
    of the encoder and of ``xattn``, pass."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import profile_train

    root = Path(__file__).resolve().parents[1]
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(chip_smoke)
    arch = "whisper-large-v3"
    spec = dict(next(s for s in chip_smoke.TRAIN_PHASES
                     if s["arch"] == arch))
    cfg = reduced(get_config(arch)).replace(name=arch, remat="full",
                                            dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
    calls = 2 * cfg.num_layers + cfg.encoder_layers
    spec["launches"] = chip_smoke._launches(flash=(calls, 1))
    assert chip_smoke._launches(flash=(96, 1)) == next(
        s for s in chip_smoke.TRAIN_PHASES if s["arch"] == arch)["launches"]
    monkeypatch.setitem(profile_train.TRAIN, "seq", 64)

    def counted(attr, *names):
        fn = getattr(fops, attr)

        def run(*a, **kw):
            count_launch(*names, f"{names[0]}.{fops.variant(a[0].dtype, 64)}")
            return fn(*a, **kw)
        monkeypatch.setattr(fops, attr, run)
    counted("attention_fwd_ref", "flash_attention")
    counted("attention_ref", "flash_attention")
    counted("attention_bwd_ref", "flash_attention_bwd")
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    row = chip_smoke.phase_train(torch.device("cpu"), spec)
    assert row["ok"]
    assert all(s["launches"] == spec["launches"] for s in row["steps_run"])
    grads = row["vs_ref"]["grad_rel_frobenius"]
    assert {"layer0/enc:attn/wq", "layer0/xattn/wv"} <= set(grads)
    held = row["vs_ref"]["f32_held"]
    assert set(held) == {"layer0/xattn/wq", "layer0/xattn/wk"}
    assert all(h["ratio"] == 1.0 for h in held.values())   # plain = plain


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def _flash_calls(cfg):
    """Flash calls of a forward: each attention layer's, a decoder layer's
    cross-attention and each encoder layer's."""
    attn = sum(k in ("global", "local") for k in cfg.layer_kinds)
    return attn * (2 if cfg.encoder_layers else 1) + cfg.encoder_layers


_CHIP_SMOKE = _chip_smoke()
TRAIN_PHASE_ARCHS = [s["arch"] for s in _CHIP_SMOKE.TRAIN_PHASES]
# the train phases added beside the five earlier ones (rehearsed here; the
# earlier ones have rehearsals of their own)
NEW_TRAIN_PHASES = [f"gemma3-4b-L{_CHIP_SMOKE.GEMMA3_LAYERS}", "minicpm-2b",
                    f"nemotron-4-15b-L{_CHIP_SMOKE.NEMOTRON_LAYERS}",
                    f"internvl2-26b-L{_CHIP_SMOKE.INTERNVL_LAYERS}"]


@pytest.mark.parametrize("arch", TRAIN_PHASE_ARCHS)
def test_chip_smoke_train_phase_states_its_configs_launches(arch):
    """Each ``TRAIN_PHASES`` entry's launches a step are the ones its config
    implies at its microbatches (forward twice under remat, backward once):
    flash per attention call, linear_scan per RG-LRU layer, selective_scan
    per Mamba layer, 3 gmm calls per MoE layer; and profile_train times
    the same cell.  An entry with ``remat`` (its base config under that
    policy, which recomputes the attention as "full" does) states its
    base's launches, and profile_train times its base."""
    from repro_torch.launch import profile_train
    cs = _CHIP_SMOKE
    spec = next(s for s in cs.TRAIN_PHASES if s["arch"] == arch)
    if "layers" in spec:   # registered by the phase as _cut_cfg cuts it
        assert arch == f"{spec['base']}-L{spec['layers']}"
    if "remat" in spec:
        assert spec["remat"] != "none"
        arch = spec["base"]
    cfg = profile_train.train_config(arch)
    mbs = spec.get("microbatches", profile_train.TRAIN["microbatches"])
    kinds = cfg.layer_kinds
    per = {"flash": _flash_calls(cfg), "rec": kinds.count("rec"),
           "mamba": kinds.count("mamba"),
           "moe": cfg.num_layers if cfg.num_experts else 0}
    want = cs._launches(**{f: (n, mbs) for f, n in per.items() if n})
    assert spec["launches"] == want
    assert profile_train.ARCHS[arch] == mbs
    if cfg.num_experts:
        assert want["gmm"] == 2 * 3 * cfg.num_layers * mbs


@pytest.mark.parametrize("arch", NEW_TRAIN_PHASES)
def test_chip_smoke_train_phase_rehearsal(arch, monkeypatch):
    """``chip_smoke.py``'s ``train <arch>`` phases of the configurations
    first trained on the card here (gemma3-4b's qk-norm and two rope
    thetas, minicpm-2b under WSD, nemotron-4-15b's LayerNorm, squared ReLU
    and untied head, internvl2-26b's stub vision embeddings) on the CPU at
    reduced widths (remat, bf16 compute, head_dim 64; 64 tokens): the plain
    attention calls are counted as the flash wrappers count launches, so
    the phase's exact counts a step and its check of one microbatch against
    ``impl="ref"`` pass."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import profile_train

    chip_smoke = _chip_smoke()
    spec = dict(next(s for s in chip_smoke.TRAIN_PHASES
                     if s["arch"] == arch))
    cfg = reduced(get_config(spec.get("base", arch))).replace(
        name=arch, remat="full", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, arch, cfg)
    mbs = spec["microbatches"]
    spec["launches"] = chip_smoke._launches(flash=(_flash_calls(cfg), mbs))
    monkeypatch.setitem(profile_train.TRAIN, "seq", 64)

    def counted(attr, *names):
        fn = getattr(fops, attr)

        def run(*a, **kw):
            count_launch(*names, f"{names[0]}.{fops.variant(a[0].dtype, 64)}")
            return fn(*a, **kw)
        monkeypatch.setattr(fops, attr, run)
    counted("attention_fwd_ref", "flash_attention")
    counted("attention_ref", "flash_attention")
    counted("attention_bwd_ref", "flash_attention_bwd")
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    row = chip_smoke.phase_train(torch.device("cpu"), spec)
    assert row["ok"] and row["layers"] == cfg.num_layers
    assert all(s["launches"] == spec["launches"] for s in row["steps_run"])
    assert row["schedule"] == spec.get("schedule", "cosine")
    grads = row["vs_ref"]["grad_rel_frobenius"]
    held = {f"layer0/{w}" for w in spec.get("f32_held", ())}
    assert set(grads) == {"embed"} | {
        w if w == "head" else f"layer0/{w}" for w in spec["picked"]} - held
    assert all(g == 0.0 for g in grads.values())   # plain against plain
    f32 = row["vs_ref"]["f32_held"] or {}
    assert set(f32) == held
    assert all(h["ratio"] == 1.0 for h in f32.values())
    assert all(np.isfinite(row["losses"]))

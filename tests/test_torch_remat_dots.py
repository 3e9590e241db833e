"""``remat="dots"`` (the reference's ``dots_with_no_batch_dims_saveable``)
against the JAX package, on the CPU.

The policy changes no value, only what the backward pass keeps, so a test
of numbers alone cannot tell ``dots`` from ``full``.  Here:

  * the saved set: the products each block keeps under ``dots`` (the
    ``kept`` of the ``_Remat`` nodes under that policy), by count per
    layer and by shape,
    equal the reference's residuals under ``dots`` less those under
    ``full`` (``jax._src.ad_checkpoint.saved_residuals``; a scanned
    group's residual (G, ...) counts as G of its layers'), and every other
    tensor the graph saves is the one ``full`` saves;
  * the backward pass runs no kept product again;
  * one train step under ``dots`` is bitwise the step under ``full``, as is
    a fused ensemble's step under ``vmap``; two threads taking steps at
    once keep their own products;
  * the dry run reckons the kept products.

The numbers against the JAX step under ``dots`` are in
``test_torch_train.py`` (``test_one_train_step_matches_jax``,
``test_stub_grads_match_jax``), ``test_torch_ensemble.py``
(``test_fused_ensemble_matches_jax``) and ``test_torch_tp.py`` (the
tensor-parallel step).
"""
import collections
import threading

import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro.train.losses import chunked_softmax_xent as jax_xent  # noqa: E402
from repro.train.step import compute_cast as jax_compute_cast  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import TrainHyper, build_train_step  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    compute_cast,
    lm_loss,
    make_train_state,
)

ARCHS = ["gemma2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
         "qwen3-moe-30b-a3b", "grok-1-314b", "whisper-large-v3",
         "internvl2-26b", "gemma3-4b", "minicpm-2b", "nemotron-4-15b"]
# The products each reduced layer keeps, read from the reference's
# saved_residuals: gemma2 q, k, v, attention out, MLP wi, wg and wo (its
# post-norm reads wo's output); recurrentgemma's RG-LRU layers wx, wy, the
# gates' wa, wi_g, the mixer's wo, MLP wi, wg, its local-attention layer
# q, k, v, out, wi, wg; Mamba in_proj, x_proj, dt_proj; qwen3 and grok q,
# k, v, out and the router; whisper's encoder q, k, v, out, wi and its
# decoder self- and cross-attention's q, k, v, out and wi.
KEPT_PER_LAYER = {
    "gemma2-2b": [7, 7], "recurrentgemma-2b": [7, 7, 6],
    "falcon-mamba-7b": [3, 3], "qwen3-moe-30b-a3b": [5, 5],
    "grok-1-314b": [5, 5], "whisper-large-v3": [5, 5, 9, 9],
    "internvl2-26b": [6, 6], "gemma3-4b": [7] * 6, "minicpm-2b": [6, 6],
    "nemotron-4-15b": [5, 5]}
STEP_ARCHS = ["gemma2-2b", "recurrentgemma-2b", "falcon-mamba-7b",
              "qwen3-moe-30b-a3b", "whisper-large-v3", "internvl2-26b"]
SHAPE = ("t", "train", 32, 2)


def _key(shape, dtype):
    return tuple(int(n) for n in shape), str(dtype).removeprefix("torch.")


def _reference_extra(arch):
    """The reference's residuals under ``dots`` less those under ``full``,
    as a multiset of (shape, dtype) per layer: a residual of a scanned
    group, (G, ...), is G layers' (...)."""
    def residuals(remat):
        jcfg = jax_reduced(jax_get_config(arch)).replace(remat=remat)
        params = jax_make_train_state(jcfg, jax.random.PRNGKey(0))["params"]
        batch = JaxSyntheticLM(jcfg, JaxShapeSpec(*SHAPE),
                               seed=3).batch_at(0)

        def loss(params, mb):
            params = jax_compute_cast(jcfg, params)
            out = jax_forward(jcfg, params, mb["tokens"],
                              seg_ids=mb["seg_ids"],
                              vision_embeds=mb.get("vision_embeds"),
                              enc_frames=mb.get("enc_frames"), remat=True)
            return jax_xent(jcfg, params, out["h"], mb["labels"])[0] \
                + 0.01 * out["aux"]
        got = collections.Counter()
        for aval, where in saved_residuals(loss, params, batch):
            shape = tuple(aval.shape)
            if "output of scan" in where:
                got[_key(shape[1:], aval.dtype)] += shape[0]
            else:
                got[_key(shape, aval.dtype)] += 1
        return got
    return residuals("dots") - residuals("full")


def _graph_nodes(root, name):
    """The nodes of ``root``'s graph whose class is ``name``."""
    seen, todo, found = set(), [root], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            found.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return found


def _port_saved(arch, remat):
    """(every tensor the loss's graph saves, as a multiset of keys; the
    products each dots block keeps, one list of keys per block)."""
    cfg = reduced(get_config(arch)).replace(remat=remat)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = SyntheticLM(cfg, ShapeSpec(*SHAPE), seed=3,
                        device="cpu").batch_at(0)
    saved = collections.Counter()

    def pack(t):
        saved[_key(t.shape, t.dtype)] += 1
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _, aux = lm_loss(cfg, compute_cast(cfg, params), batch,
                               remat=True)
    total = loss + 0.01 * aux
    kept = [[_key(k.shape, k.dtype) for k in node_kept]
            for node_kept in _kept(total.grad_fn)]
    return saved, kept


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_references_saved_set(arch):
    saved_full, kept_full = _port_saved(arch, "full")
    saved_dots, kept = _port_saved(arch, "dots")
    assert kept_full == []                   # no block under a policy
    assert saved_dots == saved_full          # the blocks' inputs, as full
    assert sorted(len(k) for k in kept) == sorted(KEPT_PER_LAYER[arch])
    got = collections.Counter(k for block in kept for k in block)
    assert got == _reference_extra(arch)


def _kept(root):
    """The products each remat under the dots policy in ``root``'s graph
    keeps, one list a node."""
    return [node.kept for node in _graph_nodes(root, "_RematBackward")
            if node.run.dots]


def test_dots_recompute_of_another_path_raises():
    """A recompute that marks its products in another order than its
    forward pass did (two weights of one shape, as q and k) raises rather
    than take the other's kept output."""
    from repro_torch.models.remat import dot, remat
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g, requires_grad=True)
    ws = {n: torch.randn(8, 8, generator=g, requires_grad=True)
          for n in ("wq", "wk")}
    orders = [("wq", "wk"), ("wk", "wq")]

    def fn(x, ws):
        a, b = orders.pop(0)
        return dot(x, ws[a], a) * dot(x, ws[b], b).sin()
    out = remat(fn, x, ws, policy="dots")
    with pytest.raises(RuntimeError, match="another path"):
        out.sum().backward()


def _count_products(fn):
    """The ``mm`` and ``bmm`` calls ``fn()`` makes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    products = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in products
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


@pytest.mark.parametrize("arch", ["gemma2-2b", "falcon-mamba-7b"])
def test_dots_backward_runs_no_kept_product(arch):
    """The backward pass under ``dots`` makes as many products as under
    ``full`` less one for each kept output: the recompute takes it."""
    n = {}
    for remat in ("full", "dots"):
        cfg = reduced(get_config(arch)).replace(remat=remat)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        batch = SyntheticLM(cfg, ShapeSpec(*SHAPE), device="cpu").batch_at(0)
        loss, _, _ = lm_loss(cfg, params, batch, remat=True)
        n[remat] = _count_products(loss.backward)
    assert n["full"] - n["dots"] == sum(KEPT_PER_LAYER[arch])


def _step(cfg, seed=0):
    state = make_train_state(cfg, torch.Generator().manual_seed(seed))
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 32, 4),
                        device="cpu").batch_at(0)
    state, m = build_train_step(cfg, TrainHyper(warmup=1, total_steps=10))(
        state, batch)
    return state, m


def _assert_bitwise(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_dots_step_is_bitwise_the_full_step(arch):
    """One ``build_train_step`` step with 2 microbatches from the same
    state: loss, grad norm, every param and moment bitwise equal."""
    cfg = reduced(get_config(arch)).replace(microbatches=2)
    full, mf = _step(cfg.replace(remat="full"))
    dots, md = _step(cfg.replace(remat="dots"))
    for k in ("loss", "grad_norm", "aux"):
        assert torch.equal(mf[k], md[k]), k
    _assert_bitwise(full, dots)


def test_dots_fused_step_is_bitwise_the_full_step():
    """The fused ensemble's step (the blocks under ``torch.func.vmap``,
    the kept products unwrapped by ``_Remat``'s rule) under ``dots``
    against ``full``, from the same members."""
    from repro_torch.core import FusedEnsemble
    from repro_torch.core.ensemble import _fused_train_step
    base = reduced(get_config("gemma2-2b"))
    out = {}
    for remat in ("full", "dots"):
        cfg = base.replace(remat=remat)
        fe = FusedEnsemble(cfg, 2, device="cpu")
        members = fe.init(torch.Generator().manual_seed(0))["members"]
        data = SyntheticLM(cfg, ShapeSpec(*SHAPE), device="cpu")
        batch = {k: torch.stack([data.batch_at(i)[k] for i in range(2)])
                 for k in ("tokens", "labels")}
        losses = _fused_train_step(cfg, members, batch,
                                   torch.full((2,), 3e-4))
        out[remat] = (losses, members)
    assert torch.equal(out["full"][0], out["dots"][0])
    _assert_bitwise(out["full"][1], out["dots"][1])


def test_dots_threads_keep_their_own_products():
    """Two threads taking ``dots`` steps at once (a pilot's member tasks
    share a device from two threads): each step bitwise the one taken
    alone."""
    cfgs = [reduced(get_config(a)).replace(remat="dots")
            for a in ("gemma2-2b", "falcon-mamba-7b")]
    alone = [_step(cfg) for cfg in cfgs]
    got = [None, None]

    def run(i):
        got[i] = _step(cfgs[i])
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for (sa, ma), (sb, mb) in zip(alone, got):
        assert torch.equal(ma["loss"], mb["loss"])
        _assert_bitwise(sa, sb)


def _kept_bytes(cfg, shape):
    """The bytes of the products one microbatch keeps, each storage in
    the allocator's blocks; and the most one layer keeps."""
    cfg = cfg.replace(remat="dots")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    mb = SyntheticLM(cfg, shape, device="cpu").batch_at(0)
    mb = {k: v[:shape.global_batch // cfg.microbatches]
          for k, v in mb.items()}
    loss, _, _ = lm_loss(cfg, compute_cast(cfg, params), mb, remat=True)
    per_layer = [sum(dryrun.block_bytes(k.untyped_storage().nbytes())
                     for k in node_kept)
                 for node_kept in _kept(loss.grad_fn)]
    assert len(per_layer) == cfg.num_layers
    return sum(per_layer), max(per_layer)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_dryrun_reckons_the_kept_products(microbatches):
    """``dryrun.reckon`` of reduced gemma2-2b (3 layers, 2 x 256 tokens a
    microbatch, where the activations outweigh the state).  After a
    microbatch's forward pass the live bytes under ``dots`` exceed those
    under ``full`` by exactly the kept products; the peak, in a block's
    backward pass, by the kept products of every layer but the one whose
    products stand where ``full`` recomputes its own, at most all of
    them."""
    cfg = reduced(get_config("gemma2-2b"), layers=3).replace(
        microbatches=microbatches)
    shape = ShapeSpec("t", "train", 256, 2 * microbatches)
    peak, live = {}, {}
    for remat in ("full", "dots"):
        c = cfg.replace(remat=remat)
        peak[remat] = dryrun.reckon(c, shape)["peak_bytes"]
        mb = {k: torch.zeros((2, 256), dtype=torch.int32,
                             device=dryrun.FAKE_DEVICE)
              for k in ("tokens", "labels", "seg_ids")}
        with FakeTensorMode(allow_non_fake_inputs=True), \
                dryrun.MemoryTracker(dryrun.FAKE_DEVICE.type) as mem:
            params = dryrun._params(c, dryrun.FAKE_DEVICE)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            loss = lm_loss(c, params, mb, remat=True)
            live[remat] = mem.live
            del loss
    kept, most = _kept_bytes(cfg, shape)
    assert live["dots"] - live["full"] == kept
    assert kept - most <= peak["dots"] - peak["full"] <= kept


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_train_dots_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``train gemma2-2b-dots`` phase on the CPU at
    reduced widths (bf16 compute, head_dim 64; 64 tokens) after its base's
    ``train gemma2-2b`` phase, the plain attention calls counted as the
    flash wrappers count launches: the dots run's losses and launches a
    step equal the base's, and one microbatch's loss and gradients under
    "dots" equal those under "full" bitwise, as expected on the card."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import count_launch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import profile_train

    cs = _chip_smoke()
    spec = dict(cs.TRAIN_PHASES[-1])
    assert spec["remat"] == "dots" and spec["base"] == "gemma2-2b"
    base_spec = dict(cs.TRAIN_PHASES[0], decode=False)
    cfg = reduced(get_config("gemma2-2b")).replace(
        remat="full", dtype="bfloat16", head_dim=64)
    monkeypatch.setitem(cfg_base._REGISTRY, "gemma2-2b", cfg)
    monkeypatch.setitem(cfg_base._REGISTRY, spec["arch"], cfg.replace(
        name=spec["arch"], remat="dots"))
    launches = cs._launches(flash=(cfg.num_layers, 2))
    spec["launches"] = base_spec["launches"] = launches
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
    dev = torch.device("cpu")
    base = cs.phase_train(dev, base_spec)
    row = cs.phase_train(dev, spec, {base["phase"]: base})
    assert row["ok"] and row["remat"] == "dots" and base["remat"] == "full"
    assert all(s["launches"] == launches for s in row["steps_run"])
    assert row["base_phase"]["same_launches"]
    assert row["losses"] == base["losses"][:spec["steps"]]
    vs = row["vs_full"]
    assert vs["bitwise"] and vs["grad_rel_frobenius_max"] == 0.0
    assert vs["loss"] == vs["loss_full"]
    assert vs["leaves"] == len(list(tree_leaves(init_params(
        cfg, torch.Generator().manual_seed(0)))))

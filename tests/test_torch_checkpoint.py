"""The port's checkpoints (``repro_torch.checkpoint``, ``lm.checkpoint``)
against the JAX package's on the CPU: one layout (``step_<n>/shard_<host>.npz``
+ ``manifest.json`` keyed by the JAX train state's paths), read both ways
with equal values, retention, the async writer, the ``.tmp`` publish, and
bf16 leaves, which the JAX package writes but cannot read back (ROADMAP C4).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint.checkpoint import _flatten as jax_flatten  # noqa: E402
from repro.plugins.lm import resolve_cfg as jax_resolve_cfg  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    train_state_from_numpy,
    train_state_to_flat,
)
from repro_torch.optim.adamw import tree_zip  # noqa: E402
from repro_torch.plugins import lm  # noqa: E402

ARCH = "reduced:gemma2-2b"


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


def _states(seed=0):
    """A JAX train state of reduced gemma2-2b and the same state in the
    port's layout."""
    jstate = jax_make_train_state(jax_resolve_cfg(ARCH),
                                  jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}
    return jstate, train_state_from_numpy(flat, lm.resolve_cfg(ARCH))


def _assert_same_state(a, b):
    pairs = list(tree_zip(a, b))
    assert pairs
    for x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate, want = _states()
    JaxCheckpointer(str(tmp_path)).save(jstate, 5)
    flat, step = Checkpointer(str(tmp_path)).restore(None, device="cpu")
    assert step == 5
    assert sorted(flat) == _manifest(tmp_path, 5)["keys"]
    _assert_same_state(train_state_from_numpy(flat, lm.resolve_cfg(ARCH)),
                       want)


def test_port_checkpoint_restores_in_jax_in_the_same_layout(tmp_path):
    jstate, state = _states(seed=1)
    cfg = lm.resolve_cfg(ARCH)
    Checkpointer(str(tmp_path / "port")).save(train_state_to_flat(state, cfg),
                                              7)
    JaxCheckpointer(str(tmp_path / "jax")).save(jstate, 7)
    mine, ref = _manifest(tmp_path / "port", 7), _manifest(tmp_path / "jax", 7)
    assert mine == ref        # step, keys, shapes and dtypes
    got, step = JaxCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 7
    for (path, a), (_, b) in zip(jax_flatten(got).items(),
                                 jax_flatten(jstate).items()):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    with np.load(tmp_path / "port" / "step_0000000007" / "shard_0.npz") as z:
        assert sorted(z.files) == ref["keys"]


def test_bf16_leaf_from_jax_restores_as_bfloat16(tmp_path):
    """C4: the JAX package writes a bf16 leaf as 2-byte ``|V2`` data and
    cannot restore it; the port reads the manifest's dtype."""
    vals = jnp.asarray([1.5, -2.25, 3.0e4], jnp.bfloat16)
    ck = JaxCheckpointer(str(tmp_path))
    ck.save({"a": vals, "n": jnp.arange(3)}, 3)
    with pytest.raises(TypeError, match="V2"):
        ck.restore({"a": jnp.zeros(3, jnp.bfloat16), "n": jnp.arange(3)})
    got, _ = Checkpointer(str(tmp_path)).restore(
        {"a": None, "n": None}, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert got["a"].float().tolist() == \
        np.asarray(vals, np.float32).tolist()
    assert got["n"].tolist() == [0, 1, 2]
    # the port writes the same 2-byte data and manifest for such a leaf
    Checkpointer(str(tmp_path / "port")).save({"a": got["a"], "n": got["n"]},
                                              3)
    assert _manifest(tmp_path / "port", 3) == _manifest(tmp_path, 3)
    for d in (tmp_path, tmp_path / "port"):
        with np.load(d / "step_0000000003" / "shard_0.npz") as z:
            assert z["a"].dtype == np.dtype("V2")
            raw = z["a"].tobytes()
        assert raw == np.asarray(vals).tobytes()


def test_retention_async_writer_and_tmp_publish(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "layers": [torch.ones(2)]}
    paths = [ck.save(tree, s, blocking=False) for s in (1, 2)]
    tree["w"] += 100.0        # an async save copied its leaves first
    ck.wait()
    assert all(os.path.isdir(p) for p in paths)
    got, step = ck.restore({"w": None, "layers": [None]}, step=1,
                           device="cpu")
    assert step == 1 and got["w"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert got["layers"][0].tolist() == [1.0, 1.0]
    for s in (3, 4):
        ck.save(tree, s)
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    # an unpublished write (a .tmp directory, a step without a manifest)
    # is never listed, and nothing else is left behind
    os.makedirs(tmp_path / "step_0000000009.tmp")
    os.makedirs(tmp_path / "step_0000000008")
    assert ck.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == [
        "step_0000000003", "step_0000000004", "step_0000000008",
        "step_0000000009.tmp"]


def test_resave_of_a_published_step_replaces_it(tmp_path):
    """A preempted ``lm.checkpoint``'s late attempt and its retry save the
    same step of the same state: the port's second save succeeds and
    leaves the published step as it was (no window in which the step is
    unpublished); the JAX package's rename onto the published directory
    raises."""
    ck = Checkpointer(str(tmp_path))
    ck.save({"x": torch.zeros(2)}, 4)
    ck.save({"x": torch.ones(2)}, 4)
    ck.save({"x": torch.ones(2)}, 4, blocking=False)
    ck.wait()
    got, _ = ck.restore(None, device="cpu")
    assert got["x"].tolist() == [0.0, 0.0]
    assert os.listdir(tmp_path) == ["step_0000000004"]
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    jck.save({"x": jnp.zeros(2)}, 4)
    with pytest.raises(OSError):
        jck.save({"x": jnp.ones(2)}, 4)


def test_restore_onto_shardings_needs_the_template(tmp_path):
    """``restore(shardings=...)`` places each leaf by its sharding, so it
    needs the state's template (the placement itself, on gloo meshes:
    ``tests/test_torch_dist_gloo.py::
    test_checkpoint_restores_onto_shardings``); a leaf whose sharding is
    None stays a plain tensor."""
    ck = Checkpointer(str(tmp_path))
    ck.save({"x": torch.zeros(2), "y": torch.ones(3)}, 1)
    with pytest.raises(ValueError, match="template"):
        ck.restore(None, shardings={"x": None, "y": None}, device="cpu")
    got, step = ck.restore({"x": 0, "y": 0}, shardings={"x": None, "y": None},
                           device="cpu")
    assert step == 1 and got["y"].tolist() == [1.0, 1.0, 1.0]
    assert type(got["x"]) is torch.Tensor
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(None, device="cpu")


def test_lm_checkpoint_kernel(tmp_path):
    """``tests/test_system.py``'s train-then-save pipeline on the port's
    kernels: ``lm.checkpoint`` takes the reference's arguments (no arch);
    each checkpoint restores to its member's live state."""
    class TrainThenSave(tcore.Pipeline):
        def stage_1(self, i):
            k = tcore.Kernel("lm.train")
            k.arguments = {"arch": ARCH, "steps": 1, "member": i,
                           "ensemble": "torch_systest_ck", "batch": 2,
                           "seq": 32, "device": "cpu"}
            return k

        def stage_2(self, i):
            k = tcore.Kernel("lm.checkpoint")
            k.arguments = {"dir": str(tmp_path / f"m{i}"), "member": i,
                           "ensemble": "torch_systest_ck"}
            return k

    cl = tcore.SingleClusterEnvironment(cores=2)
    cl.allocate()
    try:
        prof = cl.run(TrainThenSave(stages=2, instances=2))
        assert prof.n_failed == 0
        for i in range(2):
            sid = ("torch_systest_ck", i)
            assert (tmp_path / f"m{i}" / "step_0000000001").is_dir()
            flat, step = Checkpointer(str(tmp_path / f"m{i}")).restore(
                None, device="cpu")
            assert step == 1
            _assert_same_state(
                train_state_from_numpy(flat, lm.CONFIG_STORE[sid]),
                lm.STATE_STORE[sid])
    finally:
        cl.deallocate()
        for i in range(2):
            lm.STATE_STORE.pop(("torch_systest_ck", i), None)
            lm.CONFIG_STORE.pop(("torch_systest_ck", i), None)


def test_encoder_decoder_checkpoint_round_trips_both_packages(tmp_path):
    """reduced whisper-large-v3: its encoder's stacked ``enc/blocks/sub_0``
    leaves and ``enc/final_norm``, and the decoder's ``lnx`` / ``xattn``,
    through both checkpointers: one manifest, equal values both ways."""
    arch = "reduced:whisper-large-v3"
    jstate = jax_make_train_state(jax_resolve_cfg(arch),
                                  jax.random.PRNGKey(2))
    cfg = lm.resolve_cfg(arch)
    state = train_state_from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jstate).items()}, cfg)
    assert len(state["params"]["enc"]["layers"]) == cfg.encoder_layers
    Checkpointer(str(tmp_path / "port")).save(train_state_to_flat(state, cfg),
                                              3)
    JaxCheckpointer(str(tmp_path / "jax")).save(jstate, 3)
    ref = _manifest(tmp_path / "jax", 3)
    assert _manifest(tmp_path / "port", 3) == ref
    assert "params/enc/blocks/sub_0/attn/wq" in ref["keys"]
    got, _ = JaxCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    for (path, a), (_, b) in zip(jax_flatten(got).items(),
                                 jax_flatten(jstate).items()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    flat, _ = Checkpointer(str(tmp_path / "jax")).restore(None, device="cpu")
    _assert_same_state(train_state_from_numpy(flat, cfg), state)

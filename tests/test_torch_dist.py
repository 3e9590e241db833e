"""The port's distribution layer (``repro_torch.dist``) against the JAX
package's ``repro.dist`` on the CPU, with no process group.

* Partition specs, entry for entry: every leaf of the train state, every
  model input of every applicable shape cell, and every decode-cache leaf,
  for every registered arch on ``pod16x16`` and ``pod2x16x16`` (abstract
  meshes on both sides, as ``tests/test_sharding.py``).  The port keeps
  one dict per layer where the JAX package stacks a period's layers into
  ``(G, ...)`` leaves; a stacked leaf's spec is the port's layer leaf's
  spec with a leading None.
* DTensor placements of a spec: ``Shard(d)`` on each mesh dim of dim d's
  entry, an axis group on both of its mesh dims in mesh order.
* ``SlotTopology``: ``tests/test_dist.py``'s cases.
* The expert-parallel dispatch: each model rank's ``_dispatch`` over its
  ``E_local`` experts against the JAX package's ``_moe_local`` with the
  same ``e_base`` and ``E_local`` (f32, 1e-5), so the capacity rule
  (its block from ``T * k // E_local``) is the reference's.

Meshes with process groups: ``tests/test_torch_dist_gloo.py`` (gloo, 2
and 4 ranks) and ``tests/test_torch_dist_dryrun.py`` (fake groups of 256
and 512 ranks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import cell_applicable as jax_cell_applicable  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import cache_specs as jax_cache_specs  # noqa: E402
from repro.train import train_state_specs  # noqa: E402
from repro_torch.configs import SHAPES, get_config, input_specs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.dist import spmd  # noqa: E402
from repro_torch.dist.topology import SlotTopology  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import _layout  # noqa: E402

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list(jax_list_configs())


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _meshes(name):
    shape, axes = MESHES[name]
    return jsh.abstract_mesh(shape, axes), tsh.abstract_mesh(shape, axes)


def _jax_flat(shardings):
    """{"/"-joined path: spec entries} of a JAX sharding pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s.spec) for path, s in flat}


def _port_flat(shardings):
    out = {}
    tsh.tree_map_with_path(
        lambda p, s: out.__setitem__("/".join(p), tuple(s.spec)), shardings)
    return out


def _jax_key(cfg, key: str) -> tuple:
    """(the JAX package's key of the port's leaf ``key``, stacked?)."""
    parts = key.split("/")
    period, G, _ = _layout(cfg)
    for i, part in enumerate(parts):
        if part == "layers" and i + 1 < len(parts):
            n = int(parts[i + 1])
            head, rest = parts[:i], parts[i + 2:]
            if head and head[-1] == "enc":
                return "/".join(head + ["blocks", "sub_0"] + rest), True
            if n < G * period:
                return "/".join(head + ["blocks", f"sub_{n % period}"]
                                + rest), True
            return "/".join(head + ["tail", f"block_{n - G * period}"]
                            + rest), False
    return key, False


def _assert_same_specs(cfg, port: dict, ref: dict):
    """Every port leaf's spec equals its JAX leaf's (minus a stacked
    leaf's leading None), and every JAX leaf is some port leaf's."""
    seen = set()
    for key, spec in port.items():
        jkey, stacked = _jax_key(cfg, key)
        assert jkey in ref, (key, jkey)
        want = ref[jkey]
        if stacked and want:
            assert want[0] is None, (jkey, want)
            want = want[1:]
        assert spec == want, (key, spec, want)
        seen.add(jkey)
    assert seen == set(ref)


def _port_state(cfg):
    with FakeTensorMode():
        params = init_params(cfg, torch.Generator().manual_seed(0))
        z = torch.zeros((), dtype=torch.int32)
        return {"params": params,
                "opt": {"m": params, "v": params, "count": z},
                "step": z}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_jax(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jspecs = train_state_specs(jcfg)
    ref = _jax_flat(jsh.state_shardings(jcfg, jm, jspecs))
    port = _port_flat(tsh.state_shardings(cfg, tm, _port_state(cfg)))
    _assert_same_specs(cfg, port, ref)
    # param_spec itself, on the JAX package's own stacked leaves
    flat, _ = jax.tree_util.tree_flatten_with_path(jspecs)
    for path, x in flat:
        names = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
        assert tuple(tsh.param_spec(cfg, tm, names, x.shape)) == \
            tuple(jsh.param_spec(jcfg, jm, names, x.shape)), names


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg = jax_get_config(arch).replace(param_dtype="bfloat16")
    cfg = get_config(arch).replace(param_dtype="bfloat16")
    n = 0
    for name, shape in SHAPES.items():
        ok, _ = jax_cell_applicable(jcfg, JAX_SHAPES[name])
        if not ok:
            continue
        b = jax_input_specs(jcfg, JAX_SHAPES[name])
        ref = _jax_flat(jsh.batch_shardings(jcfg, jm, b, shape.kind))
        port = _port_flat(tsh.batch_shardings(
            cfg, tm, input_specs(cfg, shape), shape.kind))
        assert port == ref, name
        if shape.kind == "decode":
            B, S = shape.global_batch, shape.seq_len
            ref = _jax_flat(jsh.cache_shardings(
                jcfg, jm, jax_cache_specs(jcfg, B, S)))
            with FakeTensorMode():
                cache = init_cache(cfg, B, S, "cpu")
            port = _port_flat(tsh.cache_shardings(cfg, tm, cache))
            _assert_same_specs(cfg, {f"layers/{k}": v
                                     for k, v in port.items()}, ref)
            n += 1
    assert n or all(s.kind != "decode" for s in SHAPES.values())


def test_fallbacks_and_expert_parallel_specs():
    """``tests/test_dist.py`` and ``tests/test_sharding.py``'s spot checks
    on the port: qwen3's experts over ``model`` on the expert dim,
    minicpm's indivisible vocab falls back, no axis twice."""
    _, tm = _meshes("pod2x16x16")
    spec = tsh.param_spec(get_config("qwen3-moe-30b-a3b"), tm,
                          ("blocks", "sub_0", "moe", "wi"),
                          (24, 128, 2048, 768))
    assert tuple(spec) == (None, "model", None, None)
    _, tm16 = _meshes("pod16x16")
    spec = tsh.param_spec(get_config("minicpm-2b"), tm16, ("embed", "tok"),
                          (122753, 2304))
    assert spec[0] is None and spec[1] == "model"
    spec = tsh.param_spec(get_config("gemma2-2b"), tm, ("embed", "tok"),
                          (256_000, 2304))
    used = [a for e in spec if e for a in (e if isinstance(e, tuple)
                                           else (e,))]
    assert "model" in used and len(used) == len(set(used))
    assert tsh.mesh_axis_sizes(tsh.abstract_mesh((4, 8), ("data", "model"))
                               ) == {"data": 4, "model": 8}


def test_spec_placements_keep_the_jax_order():
    _, tm = _meshes("pod2x16x16")
    assert tsh.spec_placements(tm, tsh.P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.spec_placements(tm, tsh.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert tsh.spec_placements(tm, tsh.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.spec_placements(tm, tsh.P(("data", "pod")))
    ns = tsh.NamedSharding(tm, tsh.P(None, "model"))
    assert ns.placements == (Replicate(), Replicate(), Shard(1))


class _Mesh:
    """A mesh's shape, names and this rank's coordinate, no group."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self._c = shape, names, coord

    def get_coordinate(self):
        return self._c


@pytest.mark.parametrize("coord", [(0, 0, 0), (1, 0, 3), (1, 1, 1)])
def test_local_shard_splits_major_first(coord):
    """An axis group splits a dim major first (``pod`` outer), as the JAX
    package lays out ``P(("pod", "data"))``; uneven shards raise."""
    mesh = _Mesh((2, 2, 4), ("pod", "data", "model"), coord)
    full = torch.arange(8 * 8).reshape(8, 8)
    pl = tsh.spec_placements(mesh, tsh.P(("pod", "data"), "model"))
    got = spmd.local_shard(full, mesh, pl)
    rows = (coord[0] * 2 + coord[1]) * 2
    cols = coord[2] * 2
    assert torch.equal(got, full[rows:rows + 2, cols:cols + 2])
    with pytest.raises(ValueError, match="evenly"):
        spmd.local_shard(torch.zeros(6, 8), mesh, pl)


def test_constrain_helpers_identity_without_mesh():
    cfg = get_config("gemma2-2b")
    x = torch.ones((2, 8, 4))
    assert tsh.constrain_batch(cfg, None, x, "train") is x
    assert tsh.constrain_logits(cfg, None, x) is x
    tree = {"embed": {"tok": x}}
    assert tsh.constrain_like_params(cfg, None, tree)["embed"]["tok"] is x
    # a plain tensor under a mesh is a rank's local shard: passed through
    _, tm = _meshes("pod16x16")
    assert tsh.constrain_batch(cfg, tm, x) is x


# ---------------------------------------------------------------- topology

def test_even_split_accounting():
    topo = SlotTopology.even(np.arange(12), 4, axis_names=("model",))
    assert topo.n_slots == 4
    assert topo.devices_per_slot == 3
    np.testing.assert_array_equal(topo.slot_devices([2])[0], [6, 7, 8])
    np.testing.assert_array_equal(topo.slot_devices([3, 1]),
                                  [[3, 4, 5], [9, 10, 11]])
    with pytest.raises(ValueError, match="not divisible"):
        SlotTopology.even(np.arange(10), 4)
    with pytest.raises(ValueError):
        topo.slot_devices([4])
    with pytest.raises(ValueError):
        topo.slot_devices([])


def test_from_mesh_pod_axis():
    class FakeMesh:
        devices = np.arange(32).reshape(2, 4, 4)
        axis_names = ("pod", "data", "model")

    topo = SlotTopology.from_mesh(FakeMesh())
    assert topo.n_slots == 2
    assert topo.axis_names == ("data", "model")
    assert topo.devices_per_slot == 16
    np.testing.assert_array_equal(topo.slot_devices([1])[0],
                                  np.arange(16, 32).reshape(4, 4))


def test_recarve_drop_and_reachable_counts_match_jax():
    from repro.dist.topology import SlotTopology as JaxSlotTopology
    for n, slots, axes in [(8, 2, ("data",)), (8, 2, ("model",)),
                           (32, 2, ("data", "model")), (4, 4, ("model",))]:
        devs = np.arange(n).reshape((slots, -1) + (1,) * (len(axes) - 1))
        devs = devs.reshape((slots,) + ((n // slots,) if len(axes) == 1
                                        else (n // slots // 4, 4)))
        t, j = SlotTopology(devs, axes), JaxSlotTopology(devs, axes)
        assert t.reachable_slot_counts() == j.reachable_slot_counts()
        assert tsh.shardable_recarve_counts(t) == \
            jsh.shardable_recarve_counts(j)
        for k in j.reachable_slot_counts():
            np.testing.assert_array_equal(t.recarve(k).devices,
                                          j.recarve(k).devices)
        np.testing.assert_array_equal(t.drop([0]).devices,
                                      j.drop([0]).devices)
    t = SlotTopology.even(np.arange(4), 4)
    with pytest.raises(ValueError, match="cannot split"):
        t.recarve(8)
    with pytest.raises(ValueError, match="multiple"):
        t.recarve(6)
    with pytest.raises(ValueError, match="every slot"):
        t.drop([0, 1, 2, 3])


def test_submesh_needs_a_process_group_and_ranks(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    topo = SlotTopology.even([0, 1], 2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        topo.submesh([0])


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("tokens,model", [(32, 2), (64, 4), (384, 2),
                                          (512, 2)])
def test_expert_parallel_dispatch_matches_jax_moe_local(tokens, model):
    """Each model rank's dispatch over its experts equals the reference's
    ``_moe_local(e_base, E_local)`` on the same slice, its capacity block
    taken from ``T * k // E_local``: under 128 rows on every side at 32
    and 64 tokens, over it at 512, and at 384 tokens (E = 8, k = 2) under
    it for the whole population but over it for each of two ranks' four
    experts."""
    jcfg = jax_reduced(jax_get_config("qwen3-moe-30b-a3b")).replace(
        num_experts=8)
    cfg = port_cfg(jcfg)
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((tokens, cfg.d_model)).astype(np.float32)
    x += 2.0 * rng.standard_normal((1, cfg.d_model)).astype(np.float32)
    E_local = cfg.num_experts // model
    xt = torch.from_numpy(x)
    wts, eids, aux = L._route(cfg, tp, xt)
    for j in range(model):
        sl = slice(j * E_local, (j + 1) * E_local)
        jpl = {k: (v[sl] if k != "router" else v) for k, v in jp.items()}
        tpl = {k: (v[sl] if k != "router" else v) for k, v in tp.items()}
        want, jaux = JL._moe_local(jcfg, jpl, jnp.asarray(x), j * E_local,
                                   E_local, 1.25)
        got = L._dispatch(cfg, tpl, xt, wts, eids, j * E_local, E_local,
                          1.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

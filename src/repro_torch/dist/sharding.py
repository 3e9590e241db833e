"""Partition specs for the production meshes, and their DTensor placements
(own copy of ``repro.dist.sharding``'s specs and rules).

Mesh axis conventions
---------------------
Two production meshes are supported (see ``repro_torch.launch.mesh``):

* ``pod16x16``   — axes ``("data", "model")``, 256 ranks (one pod)
* ``pod2x16x16`` — axes ``("pod", "data", "model")``, 512 ranks (two pods)

Axis roles:

* ``model`` — tensor-parallel axis.  Shards the hidden/ff/head/vocab dim of
  weight matrices (Megatron-style), the kv-head or head_dim of decode
  caches, and the vocab dim of logits.
* ``data`` — data-parallel axis.  Shards the batch dim of every input and
  cache; under the ``fsdp`` sharding profile it additionally shards one
  weight dim of each parameter (so parameters are gathered on use).
* ``pod`` — outermost data-parallel axis of the multi-pod mesh.  Batch and
  FSDP sharding use ``("pod", "data")`` combined when divisible.  It is
  also the natural slot axis for the ensemble layer: one replica-exchange
  member per pod (see ``repro_torch.dist.topology``).
* ``slot`` — leading axis of a *multi-slot* submesh returned by
  ``SlotTopology.submesh``; treated as an additional (outermost)
  data-parallel axis, so a task spanning k slots gets k-fold wider batch
  sharding.

Per-arch behaviour is selected by ``cfg.sharding_profile``:

* ``fsdp``  — 2D: tensor-parallel over ``model`` + parameter sharding over
  the data axes (minicpm, gemma2/3, recurrentgemma, whisper).
* ``tp``    — tensor-parallel only; parameters replicated across the data
  axes (nemotron, internvl, falcon-mamba, grok's giant experts).
* ``tp_ep`` — like ``tp`` but MoE expert weights are sharded over ``model``
  on the *expert* dim (expert parallelism; qwen3-moe, E=128).

Divisibility-fallback rule
--------------------------
A dim is sharded over a mesh axis (or axis tuple) only when its size is
*exactly divisible* by the axis size.  Every placement therefore tries an
ordered list of candidate dims and axis groups and takes the first exact
fit; when nothing fits, the dim (or the whole leaf) stays replicated.
Example: minicpm-2b's vocab 122753 is not divisible by 16, so the
vocab-parallel embedding falls back to sharding d_model=2304 over ``model``
and leaves the vocab dim whole; long_500k's batch of 1 leaves the batch dim
unsharded.  No mesh axis is ever assigned to two dims of the same array.
DTensor accepts uneven shards; the port never makes one (``spmd.
check_even`` raises).

Specs and placements
--------------------
A spec (``P``) has one entry per tensor dim: None, an axis name, or a
tuple of axis names, as a JAX ``PartitionSpec``.  ``spec_placements``
turns it into DTensor placements, one per mesh dim: ``Shard(d)`` on each
mesh dim named in dim d's entry, ``Replicate()`` on the others.  A dim
sharded over an axis group such as ``("pod", "data")`` gets ``Shard(d)``
on both mesh dims; DTensor splits such a dim over its mesh dims in mesh
order, major first, which is the JAX order of the group (the groups keep
mesh order; a group out of mesh order raises).  The shardings below
(``NamedSharding``) carry both: ``.spec`` and ``.placements``.

A mesh is a ``DeviceMesh`` (names in ``mesh_dim_names``) or an
``AbstractMesh`` (shape and axis names, no process group: the spec logic
of ``abstract_mesh``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig

MODEL_AXIS = "model"
# widest-first; "slot" is the leading axis of a multi-slot submesh built by
# repro_torch.dist.topology.SlotTopology.submesh (extra data parallelism for
# tasks spanning several pilot slots)
DATA_AXES = ("slot", "pod", "data")

# Leaf names that are always replicated: norms/gains/biases and small
# per-channel vectors (gathering them is cheaper than the bookkeeping).
_REPLICATED_LEAVES = frozenset({
    "scale", "bias", "q_norm", "k_norm", "a_param", "dt_bias", "D",
    "conv_b", "router", "pos",
})


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``;
    compares equal to ``tuple(jax_spec)`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


# ---------------------------------------------------------------- mesh utils

@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without devices or process groups:
    what the spec functions read (``DeviceMesh`` gives the same through
    ``shape`` and ``mesh_dim_names``)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    """AbstractMesh((16, 16), ("data", "model"))."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)}")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a mesh for specs needs named dims "
                         "(DeviceMesh(..., mesh_dim_names=...))")
    return tuple(names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} for DeviceMesh and AbstractMesh alike."""
    return dict(zip(axis_names(mesh), (int(s) for s in tuple(mesh.shape))))


def shardable_recarve_counts(topology) -> List[int]:
    """Slot counts reachable by ``SlotTopology.recarve`` that keep the
    sharding contract intact.

    ``recarve`` grows by splitting the FIRST slot axis.  When that axis is
    the tensor-parallel ``model`` axis, any split would change the axis
    size every weight matrix was sharded against — existing ``tp``/``fsdp``
    placements become invalid mid-run — so only the current count
    survives.  Splitting a data axis (``data``/``pod``/``slot``) only
    narrows batch parallelism, which the divisibility-fallback rule
    already tolerates, so every topologically reachable count is fine.
    The static validator (``repro_torch.analysis``, E108) checks cores
    requests against THIS list, not the raw topological one."""
    counts = topology.reachable_slot_counts()
    if topology.axis_names and topology.axis_names[0] == MODEL_AXIS:
        return [topology.n_slots]
    return counts


def data_axis_groups(mesh) -> List[Tuple[str, ...]]:
    """Candidate data-parallel axis groups, widest first."""
    names = axis_names(mesh)
    present = tuple(a for a in DATA_AXES if a in names)
    groups: List[Tuple[str, ...]] = []
    if len(present) > 1:
        groups.append(present)
    groups.extend((a,) for a in reversed(present))  # "data" before "pod"
    return groups


def _group_size(sizes: Dict[str, int], group: Tuple[str, ...]) -> int:
    return math.prod(sizes[a] for a in group)


def _entry(group: Tuple[str, ...]):
    return group[0] if len(group) == 1 else group


def _assign(entries: List[Any], used: set, shape: Tuple[int, ...],
            dims: Sequence[int], groups: Sequence[Tuple[str, ...]],
            sizes: Dict[str, int]) -> None:
    """Place the first group that exactly divides one of ``dims``.

    ``dims`` are tried in preference order; a dim that is already assigned
    or indivisible falls through to the next candidate (the fallback rule).
    """
    for d in dims:
        if d < 0 or d >= len(shape) or entries[d] is not None:
            continue
        for g in groups:
            if any(a in used for a in g):
                continue
            if shape[d] % _group_size(sizes, g) == 0:
                entries[d] = _entry(g)
                used.update(g)
                return


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(k) for k in path)


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (the port's
    parameter, state and cache layout); a path is the keys and list
    indices from the root, as strings."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ---------------------------------------------------------------- placements

def spec_placements(mesh, spec: Sequence[Any]) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where dim d's entry names that mesh dim, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"axis group {group} is not in mesh order "
                             f"{names}: DTensor cannot split dim {d} so")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX ``NamedSharding``'s role): ``.spec`` the
    entries per tensor dim, ``.placements`` the DTensor placements."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


# ---------------------------------------------------------------- params

def _param_dim_prefs(cfg: ModelConfig, names: Tuple[str, ...],
                     shape: Tuple[int, ...]) -> Tuple[List[int], List[int]]:
    """(tensor-parallel dim candidates, fsdp dim candidates) for a leaf.

    Dims are counted from the RIGHT so stacked leaves (the JAX package's
    scanned ``(G, ...)`` groups, a fused ensemble's member axis) use the
    same rules as one layer's.
    """
    nd = len(shape)
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    if nd < 2 or leaf in _REPLICATED_LEAVES:
        return [], []
    r = lambda i: nd + i  # noqa: E731  (negative offset -> absolute dim)

    if leaf == "tok" or parent == "embed":       # (V, D): vocab-parallel
        return [r(-2), r(-1)], [r(-1), r(-2)]
    if leaf == "head":                           # (D, V)
        return [r(-1), r(-2)], [r(-2), r(-1)]
    if parent in ("attn", "xattn"):
        if leaf == "wo":                         # (q_dim, D)
            return [r(-2)], [r(-1)]
        return [r(-1)], [r(-2)]                  # wq/wk/wv: (D, out)
    if parent == "moe":
        if cfg.sharding_profile == "tp_ep":      # expert-parallel: (E, ·, ·)
            return [r(-3)], []
        if leaf == "wo":                         # (E, F, D): TP on F
            return [r(-2), r(-3)], [r(-1)]
        return [r(-1), r(-3)], [r(-2)]           # wi/wg: (E, D, F)
    if parent in ("mlp", "rec"):
        if leaf == "wo":                         # (F, D) / (W, D)
            return [r(-2)], [r(-1)]
        return [r(-1)], [r(-2)]                  # wi/wg/wx/wy/wa/wi_g/conv_w
    if parent == "mamba":
        if leaf in ("x_proj", "out_proj", "A_log"):   # (d_inner, ·)
            return [r(-2)], [r(-1)]
        return [r(-1)], [r(-2)]                  # in_proj/conv_w/dt_proj
    # unknown leaf: prefer the largest dims
    order = sorted(range(nd), key=lambda d: -shape[d])
    return order, list(order)


def param_spec(cfg: ModelConfig, mesh, path: Sequence[Any],
               shape: Sequence[int]) -> P:
    """PartitionSpec for one parameter/optimizer leaf.

    ``path`` is the tree path (a tuple of names like ``("embed", "tok")``
    or ``("params", "layers", "3", "attn", "wq")``); rules key on the
    trailing two names so the same spec serves params, grads and Adam
    moments.
    """
    names = _path_names(path)
    shape = tuple(shape)
    sizes = mesh_axis_sizes(mesh)
    entries: List[Any] = [None] * len(shape)
    used: set = set()
    tp_dims, dp_dims = _param_dim_prefs(cfg, names, shape)
    if MODEL_AXIS in sizes and tp_dims:
        _assign(entries, used, shape, tp_dims, [(MODEL_AXIS,)], sizes)
    if cfg.sharding_profile == "fsdp" and dp_dims:
        _assign(entries, used, shape, dp_dims, data_axis_groups(mesh), sizes)
    return P(*entries)


def state_shardings(cfg: ModelConfig, mesh, specs):
    """``NamedSharding``s for a params / train-state / opt-state tree.

    ``specs`` is any tree of tensors (or objects with ``shape``) in the
    port's layout.
    """
    def one(path, x):
        return NamedSharding(mesh, param_spec(cfg, mesh, path,
                                              tuple(x.shape)))
    return tree_map_with_path(one, specs)


# ---------------------------------------------------------------- batches

def batch_spec(mesh, shape: Tuple[int, ...],
               sizes: Optional[Dict[str, int]] = None) -> P:
    """Batch dim 0 over the widest divisible data-axis group; rest whole."""
    sizes = sizes or mesh_axis_sizes(mesh)
    entries: List[Any] = [None] * len(shape)
    if shape:
        _assign(entries, set(), shape, [0], data_axis_groups(mesh), sizes)
    return P(*entries)


def batch_shardings(cfg: ModelConfig, mesh, specs, kind: str = "train"):
    """``NamedSharding``s for a model-input tree (tokens/labels/...).

    All input leaves are batch-major, so every leaf gets its batch dim
    sharded over the data axes when divisible (long_500k's batch of 1 stays
    replicated).  ``kind`` ("train" | "prefill" | "decode" | "serve") is
    accepted for future kind-specific layouts (e.g. sequence sharding).
    """
    del kind
    sizes = mesh_axis_sizes(mesh)
    return tree_map_with_path(
        lambda _, x: NamedSharding(mesh, batch_spec(mesh, tuple(x.shape),
                                                    sizes)), specs)


# ---------------------------------------------------------------- caches

def cache_spec(cfg: ModelConfig, mesh, path, shape: Tuple[int, ...],
               sizes: Optional[Dict[str, int]] = None) -> P:
    """The spec of one decode-cache leaf: kv caches shard batch over the
    data axes and kv-heads over ``model`` (falling back to head_dim when
    num_kv_heads is indivisible — GQA configs have few kv heads);
    recurrent/SSM states shard batch and the channel dim.  ``pos`` rings
    are replicated."""
    sizes = sizes or mesh_axis_sizes(mesh)
    names = _path_names(path)
    leaf = names[-1]
    nd = len(shape)
    if leaf in ("k", "v", "xk", "xv") and nd >= 4:
        batch_dim, tp_dims = nd - 4, [nd - 2, nd - 1]
    elif leaf == "h" and cfg.ssm_state and nd >= 3:
        batch_dim, tp_dims = nd - 3, [nd - 2, nd - 1]   # (B, d_inner, n)
    elif leaf == "h" and not cfg.ssm_state and nd >= 2:
        batch_dim, tp_dims = nd - 2, [nd - 1]           # (B, lru_width)
    elif leaf == "conv" and nd >= 3:
        batch_dim, tp_dims = nd - 3, [nd - 1]           # (B, cw-1, C)
    else:
        return P()
    entries: List[Any] = [None] * nd
    used: set = set()
    if MODEL_AXIS in sizes:
        _assign(entries, used, shape, tp_dims, [(MODEL_AXIS,)], sizes)
    _assign(entries, used, shape, [batch_dim], data_axis_groups(mesh), sizes)
    return P(*entries)


def cache_shardings(cfg: ModelConfig, mesh, specs):
    """``NamedSharding``s for a decode-cache tree (the port's per-layer
    list of dicts, ``models.init_cache``'s layout)."""
    sizes = mesh_axis_sizes(mesh)
    return tree_map_with_path(
        lambda path, x: NamedSharding(
            mesh, cache_spec(cfg, mesh, path, tuple(x.shape), sizes)), specs)


# ---------------------------------------------------- in-graph constraints

def _constrain(x, mesh, spec: P):
    """``x`` laid out by ``spec``: a DTensor is redistributed; a plain
    tensor under a mesh is a rank's local shard, which the model code
    computes on (``spmd``), already in that layout, and passes through."""
    from repro_torch.dist import spmd
    if not spmd.is_dtensor(x):
        return x
    return spmd.redistribute(x, spec_placements(mesh, spec))


def constrain_batch(cfg: ModelConfig, mesh, x, kind: str = "train"):
    """Constrain an activation (batch-major) to the data-parallel layout.

    Identity when ``mesh`` is None (single-device runs).  Divisibility is
    re-derived from the shape, so microbatched slices (B // nmb) resolve
    their own fallback.
    """
    del kind
    if mesh is None:
        return x
    return _constrain(x, mesh, batch_spec(mesh, tuple(x.shape)))


def logits_spec(mesh, shape: Tuple[int, ...]) -> P:
    """(..., V) logits: batch over data axes, vocab over model."""
    sizes = mesh_axis_sizes(mesh)
    entries: List[Any] = [None] * len(shape)
    used: set = set()
    if len(shape) >= 2 and MODEL_AXIS in sizes:
        _assign(entries, used, shape, [len(shape) - 1], [(MODEL_AXIS,)],
                sizes)
    _assign(entries, used, shape, [0], data_axis_groups(mesh), sizes)
    return P(*entries)


def constrain_logits(cfg: ModelConfig, mesh, logits):
    """Constrain (..., V) logits: batch over data axes, vocab over model.

    The vocab dim falls back to replicated when V is indivisible
    (minicpm-2b's 122753).
    """
    if mesh is None:
        return logits
    return _constrain(logits, mesh, logits_spec(mesh, tuple(logits.shape)))


def constrain_like_params(cfg: ModelConfig, mesh, tree):
    """Constrain a params-shaped tree (gradients) to the param layout:
    each DTensor leaf is redistributed to its parameter's placements."""
    if mesh is None:
        return tree
    return tree_map_with_path(
        lambda path, g: _constrain(g, mesh, param_spec(cfg, mesh, path,
                                                       tuple(g.shape))),
        tree)
